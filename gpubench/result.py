"""What a driver hands back to the harness: the run's counts and clocks,
the numbers the comparison judges, and what the metric readers read."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from gpubench.trace import Reduced


@dataclasses.dataclass
class Result:
    setup_s: float  # process start to the window's start
    compile_s: float  # of the program's kernels, inside setup_s
    window_s: float  # host clock; a traced run's profiled window
    attempted: int  # steps or chunks issued in the window
    failed: int  # chunks whose scores never reached the host
    work: int  # examples trained or candidates scored in the window
    flops_per_item: int  # the model's operations per example or candidate
    host_s: List[float]  # host time inside each call of the timed entry
    bytes: Dict[str, int]  # work bytes of the window, by layer
    numbers: Dict[str, float]  # compared against the cell's limits
    memory_peak_bytes: int
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    reduced: Optional[Reduced] = None  # the traced window
    peaks: Optional[Dict[str, float]] = None  # the card's (peaks.py)
    dtype: str = "float32"  # the configuration's compute dtype


@dataclasses.dataclass
class Run:
    """What the harness hands a driver: the cell's configuration and
    traffic (their JSON), the run's arguments, the device, the program
    builder and the reference of the configuration's model (`programs/
    <model>.py`, `reference/<model>.py`), and `clock()`, seconds since the
    process started."""

    workload: str
    cfg: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    program: object
    model: object
    clock: object
