"""The traced run: a torch.profiler capture of the window, reduced to device
busy time, device time under the program's `## ... ##` spans, the device
operations by name, and idle gaps by what the host was doing.

The reduction reads the profiler's raw events (no chrome trace is written)
through `events_of(prof)` into plain `Event`s, so it can be tested on
events made by hand. A device operation (kernel, memcpy, memset) belongs
to every span whose host interval holds its launch: the launch's host
time, found through the CUPTI correlation id, falls inside the span.
Backward kernels are launched on autograd's thread while the main thread
waits inside `## train_backward ##`, so spans are matched by time and not
by thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
from collections import defaultdict
from typing import Dict, Iterable, Iterator, List, Tuple

WINDOW_SPAN = "## gpubench_window ##"
DEVICE_KINDS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_KINDS = ("cuda_runtime", "cuda_driver")
# idle gaps shorter than this are launch latency, not host work
MIN_GAP_NS = 5_000
NAME_CHARS = 120


@dataclasses.dataclass(frozen=True)
class Event:
    kind: str  # "device", "launch", "span", "op"
    name: str
    start_ns: int
    end_ns: int
    corr: int = 0  # a device operation's and its launch's correlation id
    ext: int = 0  # the launching operator's id (an operator's own)


def _kind(e) -> str:
    """An event's activity kind. Where the profiler's event has no
    `activity_type` (torch 2.11), from its device and name: device events
    are CUDA ones that are no span's mirror; launches are the CUDA runtime
    and driver calls."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return at()
    name = e.name()
    if str(e.device_type()).endswith("CUDA"):
        return ("gpu_user_annotation" if e.is_user_annotation()
                else "kernel")
    if e.is_user_annotation():
        return "user_annotation"
    if name.startswith("cu"):
        return "cuda_runtime"
    return "cpu_op"


def events_of(prof) -> List[Event]:
    """The profiler's raw kineto events as `Event`s. A device operation
    and its launch share a correlation id; both are linked to the id of
    the operator that launched them."""
    out: List[Event] = []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if kind in DEVICE_KINDS:
            out.append(Event("device", e.name(), start, end,
                             e.correlation_id(), e.linked_correlation_id()))
        elif kind in LAUNCH_KINDS:
            out.append(Event("launch", e.name(), start, end,
                             e.correlation_id(), e.linked_correlation_id()))
        elif kind == "user_annotation" and e.name().startswith("## "):
            out.append(Event("span", e.name(), start, end))
        elif kind == "cpu_op":
            out.append(Event("op", e.name(), start, end, 0,
                             e.correlation_id()))
    return out


@dataclasses.dataclass
class Reduced:
    """A traced window. `spans` maps the tuple of span names holding a
    device operation's launch to [device seconds, operations]."""

    window_s: float
    busy_s: float
    spans: Dict[Tuple[str, ...], List[float]]
    ops: Dict[str, float]
    gaps: Dict[str, float]

    def device_s(self, *prefixes: str) -> float:
        """Device seconds of the operations launched inside any span whose
        name starts with one of `prefixes` (each operation once)."""
        return sum(v[0] for names, v in self.spans.items()
                   if any(n.startswith(p) for n in names for p in prefixes))

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def reduce(events: Iterable[Event], window: str = WINDOW_SPAN) -> Reduced:
    """Reduce a traced window's events (see `Reduced`). The window is the
    host interval of the span named `window`; device operations are
    clipped to it."""
    events = list(events)
    wins = [e for e in events if e.kind == "span" and e.name == window]
    if not wins:
        raise ValueError(f"no {window} span in the trace")
    w0, w1 = wins[0].start_ns, wins[0].end_ns
    launches = {e.corr: e for e in events if e.kind == "launch"}
    op_names = {e.ext: e.name for e in events if e.kind == "op" and e.ext}
    span_evs = [e for e in events if e.kind == "span" and e.name != window]

    ops: Dict[str, float] = defaultdict(float)
    busy: List[Tuple[int, int]] = []
    device = []  # (clipped start, clipped end, launch host time, event)
    for e in events:
        if e.kind != "device":
            continue
        s, t = max(e.start_ns, w0), min(e.end_ns, w1)
        if t <= s:
            continue
        busy.append((s, t))
        ops[e.name[:NAME_CHARS]] += (t - s) * 1e-9
        launch = launches.get(e.corr)
        device.append((s, t, launch.start_ns if launch else e.start_ns, e))
    held = _held(span_evs, [d[2] for d in device])
    per_spans: Dict[Tuple[str, ...], List[float]] = defaultdict(
        lambda: [0.0, 0])
    for (s, t, _, _), names in zip(device, held):
        acc = per_spans[names]
        acc[0] += (t - s) * 1e-9
        acc[1] += 1
    merged = _merge(busy)
    busy_s = sum(t - s for s, t in merged) * 1e-9

    # each idle gap, labelled by the innermost span and op that launched
    # the device operation ending it (what the host was busy with)
    first_at = {}
    for (s, _, _, e), names in zip(device, held):
        if s not in first_at or e.start_ns < first_at[s][0].start_ns:
            first_at[s] = (e, names)
    gaps: Dict[str, float] = defaultdict(float)
    prev = w0
    for s, t in merged:
        if s - prev >= MIN_GAP_NS:
            gaps[_label(first_at.get(s), launches, op_names)] += (
                (s - prev) * 1e-9)
        prev = max(prev, t)
    if w1 - prev >= MIN_GAP_NS:
        gaps["(window end: no device work queued)"] += (w1 - prev) * 1e-9
    return Reduced(window_s=(w1 - w0) * 1e-9, busy_s=busy_s,
                   spans=dict(per_spans), ops=dict(ops), gaps=dict(gaps))


def _held(spans: List[Event], times: List[int]) -> List[Tuple[str, ...]]:
    """For each host time, the sorted names of the spans holding it: one
    sweep over the spans' starts and ends and the sorted times."""
    bounds = sorted([(e.start_ns, 0, e.name) for e in spans]
                    + [(e.end_ns, 2, e.name) for e in spans])
    order = sorted(range(len(times)), key=times.__getitem__)
    out: List[Tuple[str, ...]] = [()] * len(times)
    active: Dict[str, int] = defaultdict(int)
    key: Tuple[str, ...] = ()
    j = 0
    for i in order:
        t = times[i]
        changed = False
        # a span holds the times from its start to its end, both included
        while j < len(bounds) and (bounds[j][0] < t or (
                bounds[j][0] == t and bounds[j][1] == 0)):
            _, kind, name = bounds[j]
            active[name] += 1 if kind == 0 else -1
            if not active[name]:
                del active[name]
            changed = True
            j += 1
        if changed:
            key = tuple(sorted(active))
        out[i] = key
    return out


def _label(first, launches, op_names) -> str:
    if first is None:
        return "(unknown)"
    e, names = first
    launch = launches.get(e.corr)
    span = max(names, key=len) if names else "(no span)"
    ext = e.ext or (launch.ext if launch is not None else 0)
    op = op_names.get(ext, "(no op)")
    return f"{span} {op}"[:NAME_CHARS]


@contextlib.contextmanager
def captured(enabled: bool) -> Iterator[List[Reduced]]:
    """Profile the body when `enabled`; the body wraps its window in
    `window()`. Yields a list that holds the `Reduced` window afterwards."""
    out: List[Reduced] = []
    if not enabled:
        yield out
        return
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield out
    out.append(reduce(events_of(prof)))


def window():
    """The span that marks the measured window in a traced run."""
    from torch.profiler import record_function

    return record_function(WINDOW_SPAN)
