"""Planner constants for an NVIDIA H100 SXM.

Counterpart of torchrec_tpu/planner/constants.py, whose device specs and
fused-kernel costs are another accelerator's and do not enter here. Each
number below is one of three kinds, named beside it:

* spec: a published H100 SXM or DGX H100 figure;
* measured: an H100 measurement of this repo's kernels, made by
  chip_smoke.py (phase 18 re-measures the costs; section 6 of PERF.md
  holds the kernels' shares of their bounds);
* default: a planning default that is no measurement, copied as the JAX
  planner has it.

The update cost has no whole-shard stream term: the card's update kernels
(K3, the fused K4) read and write only the rows a batch touches, so an
update's time does not grow with the shard's size, and splitting a large
table over more ranks does not make its update cheaper, as it does under
the JAX planner's scatter model.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """One card and its links. Bytes and bytes/s."""

    name: str
    hbm_cap: int  # device memory
    hbm_bw: float  # device memory rate
    intra_bw: float  # to another card of its host, one direction
    inter_bw: float  # to another host, one direction
    host_bw: float  # to its host's memory, one direction (UVM misses)
    ddr_cap: int  # host memory per card


@dataclasses.dataclass(frozen=True)
class CostModel:
    """Time of the fused kernels and efficiency of the others.

    lookup_s(slots): the forward pooled lookup of `slots` ids, seconds;
    update_s(rows, shard_bytes): one fused optimizer update touching
    `rows` rows of a shard of `shard_bytes`, seconds; the fractions: the
    share of the HBM rate that the UVM cache's hits (fused), the dense
    autodiff route and the quantized lookup reach.
    """

    lookup_s: Callable[[float], float]
    update_s: Callable[[float, float], float]
    fused_bw_fraction: float
    dense_bw_fraction: float
    quant_bw_fraction: float


H100_SXM = DeviceSpec(
    name="H100 SXM",
    hbm_cap=80 * 10**9,  # spec: 80 GB HBM3
    hbm_bw=3.35e12,  # spec: 3.35 TB/s
    intra_bw=450e9,  # spec: NVLink 4, 900 GB/s both directions
    inter_bw=50e9,  # spec: one 400 Gb/s NDR InfiniBand port per GPU
    host_bw=64e9,  # spec: PCIe Gen5 x16, 128 GB/s both directions
    ddr_cap=256 * 10**9,  # spec: DGX H100's 2 TB of host memory over 8 GPUs
)

# measured (chip_smoke.py phase 18, `measure_costs`; NVIDIA H100 80GB
# HBM3 at 700 W): K1's device time over one B=8192 batch of bench.py's
# DLRM, 212,992 slots, 0.07881 ms
LOOKUP_NS_PER_SLOT = 0.3700
# measured (the same run): the whole of apply_fused_update under
# ROWWISE_ADAGRAD, the DMP's default (sort, segment sum, the fused K4), on
# bench.py's packed tables: its device time, 0.58050 ms at 212,992 slots
# and 0.13431 ms at 26,624, gives the cost per row; its host time per
# call at 26,624 slots, 0.56845 ms, the fixed cost every update call adds
# (a one-card step is host bound)
UPDATE_FIXED_S = 5.6845e-4
UPDATE_NS_PER_ROW = 2.3941
# measured: shares of their bounds (PERF.md section 6): K1 at L=1 (the
# fused lookup), index_add_ at K3's shape (the scatter-add of the dense
# autodiff route), Kq at int8
FUSED_KERNEL_BW_FRACTION = 0.798
DENSE_KERNEL_BW_FRACTION = 0.448
QUANT_KERNEL_BW_FRACTION = 0.599


def h100_lookup_s(slots: float) -> float:
    """Forward pooled lookup time (seconds)."""
    return slots * LOOKUP_NS_PER_SLOT * 1e-9


def h100_update_s(rows_touched: float, shard_bytes: float) -> float:
    """Fused update time (seconds): a fixed cost and a cost per touched
    row; the shard's size does not enter."""
    del shard_bytes
    return UPDATE_FIXED_S + rows_touched * UPDATE_NS_PER_ROW * 1e-9


H100_COSTS = CostModel(
    lookup_s=h100_lookup_s,
    update_s=h100_update_s,
    fused_bw_fraction=FUSED_KERNEL_BW_FRACTION,
    dense_bw_fraction=DENSE_KERNEL_BW_FRACTION,
    quant_bw_fraction=QUANT_KERNEL_BW_FRACTION,
)

# default: the UVM cache keeps this share of a table on the device, and
# its misses reach this share of the host link's rate
UVM_CACHE_LOAD_FACTOR = 0.2
UVM_CACHING_BW_FRACTION = 0.5

# default: the estimates' per-rank batch, pooling factor and caching ratio
BATCH_SIZE_DEFAULT = 512
POOLING_FACTOR_DEFAULT = 1.0
CACHING_RATIO_DEFAULT = 0.2

MIN_CW_DIM = 32  # default: the narrowest column shard
STORAGE_RESERVE_PERCENT = 0.15  # default: device memory kept for the rest

BIGINT = 2**62
