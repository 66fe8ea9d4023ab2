"""K2-K7: the fused embedding-update kernels as hand-written CUDA kernels.

Counterparts of six functions of torchrec_tpu/ops/pallas_embedding.py,
with the same names and arguments minus the TPU's wave sizes (`T`, `TB`,
`window_rows`, `max_block_share`, `skip_blocks`) and `interpret`:

* K2 `scatter_rows_write`  (:189, `_scatter_write_kernel` :154)
* K3 `fused_update_sgd`    (:577, `_sgd_kernel` :457)
* K4 `fused_update_rowwise_adagrad` (:617): on its default route one
  kernel that also does K5's work (`rowwise_adagrad_kernel`); on its other
  routes its scaled RMW (`_scaled_update_kernel` :477, `scaled_row_update`)
* K5 `rowwise_momentum_stream` (:902, `_rowwise_mom_stream_kernel` :737)
* K6 `fused_update_adagrad` (:1033, `_adagrad_kernel` :503)
* K7 `fused_update_adam`    (:1089, `_adam_kernel` :531)

and the half-table forms of K3 and the fused K4, `fused_update_sgd_half`
(K3h) and `fused_update_rowwise_adagrad_half` (K4h), which stand for what
the JAX package runs in XLA for bf16 / fp16 tables
(torchrec_tpu/ops/fused_update.py:534-543 and :647-656: `_sr_set` with
`stochastic_round`, or a rounded scatter-add): the same f32 arithmetic on
the widened rows, then the row written back rounded, stochastically with
the port's counter-based bits (ops/stochastic_rounding.py) or to nearest.

The kernels live in csrc/fused_update.cu, one library built with nvcc for
sm_90a at first use and bound with ctypes (ops/cuda_build.py). All are
bound by bytes: scattered 512-byte rows (K2-K4 move two or three per real
slot, K6 five, K7 seven) or 4-byte momentum words (K5), with a few flops
per element; the source says how each one moves its bytes.

The JAX functions return new arrays; these update `weights` and the
momenta IN PLACE and return the same tensors, so callers port one to one.
CUDA tensors launch the kernel, at any D >= 1: rows that are whole aligned
quads (D % 4 == 0, aligned tensors) move as vectors, every other table by
the masked path, which the launcher picks from D and the pointers. Every
kernel but K5 gives a row `lanes_per_row(D)` lanes (ops/lane_groups.py),
so a warp moves several rows of up to 64 columns at once (`row_geometry`,
`fused_geometry`, `moment_geometry`). CPU tensors take the plain PyTorch
version (`*_reference`). Nothing falls back: a failed build or launch
raises.

Slots whose id is not a real row (0 <= id < R) are skipped: the sentinels
are 2**31 - 1 (`run_total_row_grads`) and R + pos (`dedup_row_grads`).
Real ids must be unique (K2-K4, K6, K7) or sorted (K5), as the callers
guarantee. `lr`, `weight_decay`, `eps` and the betas are Python floats,
passed by value, and K7's step is a device tensor, so no launch waits on
the device.

Each wrapper runs under the `## update_kernel ##` span, its launch or its
plain version alike, and counts its launches under its own name
(utils/tracing.py): `fused_update_rowwise_adagrad` is the fused K4 + K5
kernel, `scaled_row_update` K4's scaled RMW on its other routes.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Callable, Tuple

import torch

from torchrec_tpu_torch.ops.cuda_build import CudaLibrary
from torchrec_tpu_torch.ops.lane_groups import lanes_per_row
from torchrec_tpu_torch.ops.stochastic_rounding import (
    SR_SEED,
    sr_bits,
    stochastic_round,
)
from torchrec_tpu_torch.utils import tracing

_P, _I64, _F32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
_INT, _U32 = ctypes.c_int, ctypes.c_uint32
# the half table types the kernels take, by their entry points' code
HALF_TYPES = {torch.bfloat16: 0, torch.float16: 1}


def _bind(lib: ctypes.CDLL) -> None:
    sigs = {
        "trt_scatter_rows_write_f32":
            [_P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P],
        "trt_fused_update_sgd_f32":
            [_P, _P, _P, _I64, _I64, _I64, _INT, _INT, _F32, _F32, _P],
        "trt_scaled_row_update_f32":
            [_P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _P],
        "trt_rowwise_momentum_f32": [_P, _P, _P, _P, _I64, _I64, _F32, _P],
        "trt_fused_rowwise_adagrad_f32":
            [_P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _F32, _F32, _F32,
             _P],
        "trt_fused_update_adagrad_f32":
            [_P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _F32, _F32, _F32,
             _P],
        "trt_fused_update_adam_f32":
            [_P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT]
            + [_F32] * 7 + [_P],
        "trt_fused_update_sgd_half":
            [_P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _F32, _F32, _INT,
             _INT, _U32, _I64, _P],
        "trt_fused_rowwise_adagrad_half":
            [_P, _P, _P, _P, _P, _I64, _I64, _I64, _INT, _INT, _F32, _F32,
             _F32, _INT, _INT, _U32, _I64, _P],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("fused_update.cu", _bind)

KERNEL_SPAN = "## update_kernel ##"


def _in_span(wrapper: Callable) -> Callable:
    """`wrapper` (a launch, or its plain version on the CPU) under
    KERNEL_SPAN."""

    @functools.wraps(wrapper)
    def spanned(*args, **kwargs):
        with tracing.span(KERNEL_SPAN):
            return wrapper(*args, **kwargs)
    return spanned


# -- checks and launch ---------------------------------------------------------


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int,
           rows: int = -1) -> None:
    if t.dtype != dtype or t.dim() != dim:
        raise TypeError(f"{name} must be a {dim}-D {dtype} tensor, got "
                        f"{t.dtype} {tuple(t.shape)}")
    if rows >= 0 and t.shape[0] != rows:
        raise ValueError(f"{name} has {t.shape[0]} rows, expected {rows}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _same_device(*ts: torch.Tensor) -> torch.device:
    devices = {t.device for t in ts}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _check_rows(weights: torch.Tensor, uids: torch.Tensor,
                src: torch.Tensor, src_name: str) -> torch.device:
    _check("weights", weights, torch.float32, 2)
    _check("uids", uids, torch.int32, 1)
    _check(src_name, src, torch.float32, 2, uids.shape[0])
    if src.shape[1] != weights.shape[1]:
        raise ValueError(f"{src_name} has width {src.shape[1]}, weights "
                         f"{weights.shape[1]}")
    return _same_device(weights, uids, src)


def _launch(name: str, device: torch.device, call: Callable) -> None:
    lib = LIBRARY.load()
    with torch.cuda.device(device):
        err = call(lib, torch.cuda.current_stream(device).cuda_stream)
    LIBRARY.check(name, err)
    tracing.count(name)


def _real_slots(uids: torch.Tensor, R: int) -> torch.Tensor:
    """Positions of the slots whose id is a real row (the plain versions
    only: this waits for the device)."""
    return torch.nonzero((uids >= 0) & (uids < R)).squeeze(1)


def _div(num: float, den: torch.Tensor) -> torch.Tensor:
    """num / den rounded once, as the kernels and JAX compute it
    (`float / Tensor` in PyTorch multiplies by a reciprocal instead)."""
    return torch.full_like(den, num) / den


# -- K2, K3, K3h and K4's scaled RMW: the row kernel's geometry ----------------


# Slots a warp of the row kernel takes, by lanes per row: the fastest of
# the powers of two from the warp's lane groups to 32 in a sweep on an
# H100 at 212,992 slots (compare_update_kernels.py --sweep, D = 8, 10, 32
# and 64 on the Criteo Kaggle tables; PERF.md). K3h on bf16 rows, swept
# at D = 10 and 64, is fastest at the same counts. A group walks its share
# of the slots one after another: one to four steps here.
ROW_SLOTS = {1: 32, 2: 32, 4: 16, 8: 16, 16: 8, 32: 32}


def row_slots_per_warp(D: int) -> int:
    """Slots a warp of the row kernel takes at width D: ROW_SLOTS by
    `lanes_per_row(D)`, a multiple of the warp's lane groups; 32 on the
    one-row-a-warp path (D > 64)."""
    return ROW_SLOTS[lanes_per_row(D)]


def row_geometry(D: int) -> Tuple[int, int]:
    """(lanes per row, slots per warp) of the row kernel of K2, K3, K3h
    and K4's scaled RMW (csrc/fused_update.cu, `row_update_kernel`)."""
    return lanes_per_row(D), row_slots_per_warp(D)


# -- K2 ------------------------------------------------------------------------


def scatter_rows_write_reference(weights: torch.Tensor, uids: torch.Tensor,
                                 rows: torch.Tensor) -> torch.Tensor:
    """Plain version of K2: weights[uids[t]] = rows[t] where uids[t] is a
    real row, in place."""
    sel = _real_slots(uids, weights.shape[0])
    weights.index_copy_(0, uids[sel].long(), rows[sel])
    return weights


@_in_span
def scatter_rows_write(weights: torch.Tensor, uids: torch.Tensor,
                       rows: torch.Tensor) -> torch.Tensor:
    """K2: weights[uids[t]] = rows[t] in place, for real uids[t]; sentinel
    slots are skipped and their rows never read. weights [R, D] f32; uids
    [N] int32, unique among real slots; rows [N, D] f32. Returns
    `weights`."""
    dev = _check_rows(weights, uids, rows, "rows")
    if dev.type == "cpu":
        return scatter_rows_write_reference(weights, uids, rows)
    (R, D), N = weights.shape, uids.shape[0]
    if N == 0 or D == 0:
        return weights
    group, slots = row_geometry(D)
    _launch("scatter_rows_write", dev, lambda lib, s:
            lib.trt_scatter_rows_write_f32(
                weights.data_ptr(), uids.data_ptr(), rows.data_ptr(),
                R, D, N, group, slots, s))
    return weights


# -- K3 ------------------------------------------------------------------------


def fused_update_sgd_reference(weights: torch.Tensor, uids: torch.Tensor,
                               g: torch.Tensor, lr: float,
                               weight_decay: float = 0.0) -> torch.Tensor:
    """Plain version of K3: W[id] = W[id] - lr * (g + wd * W[id]) for the
    real slots, in place."""
    sel = _real_slots(uids, weights.shape[0])
    ids = uids[sel].long()
    w, gg = weights[ids], g[sel]
    if weight_decay:
        gg = gg + weight_decay * w
    weights.index_copy_(0, ids, w - lr * gg)
    return weights


@_in_span
def fused_update_sgd(weights: torch.Tensor, uids: torch.Tensor,
                     g: torch.Tensor, lr: float,
                     weight_decay: float = 0.0) -> torch.Tensor:
    """K3: in-place SGD on unique touched rows,
    W[id] -= lr * (g + weight_decay * W[id]); slots whose id is not a real
    row (the 2**31 - 1 sentinels between run totals) are skipped.
    weights [R, D] f32; uids [N] int32; g [N, D] f32. Returns `weights`."""
    dev = _check_rows(weights, uids, g, "g")
    lr, weight_decay = float(lr), float(weight_decay)
    if dev.type == "cpu":
        return fused_update_sgd_reference(weights, uids, g, lr, weight_decay)
    (R, D), N = weights.shape, uids.shape[0]
    if N == 0 or D == 0:
        return weights
    group, slots = row_geometry(D)
    _launch("fused_update_sgd", dev, lambda lib, s:
            lib.trt_fused_update_sgd_f32(
                weights.data_ptr(), uids.data_ptr(), g.data_ptr(),
                R, D, N, group, slots, lr, weight_decay, s))
    return weights


# -- K4's scaled RMW -----------------------------------------------------------


def scaled_row_update_reference(weights: torch.Tensor, uids: torch.Tensor,
                                g: torch.Tensor,
                                scale: torch.Tensor) -> torch.Tensor:
    """Plain version of K4's kernel: W[id] = W[id] + scale[t] * g[t] for
    the real slots, in place."""
    sel = _real_slots(uids, weights.shape[0])
    ids = uids[sel].long()
    weights.index_copy_(0, ids, weights[ids] + scale[sel, None] * g[sel])
    return weights


@_in_span
def scaled_row_update(weights: torch.Tensor, uids: torch.Tensor,
                      g: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """K4's scaled RMW: W[id] += scale[t] * g[t] in place for unique real
    ids; the row write of the rowwise routes the fused kernel does not
    take (`mom_impl="xla"`)."""
    dev = _check_rows(weights, uids, g, "g")
    _check("scale", scale, torch.float32, 1, uids.shape[0])
    _same_device(weights, scale)
    if dev.type == "cpu":
        return scaled_row_update_reference(weights, uids, g, scale)
    (R, D), N = weights.shape, uids.shape[0]
    if N == 0 or D == 0:
        return weights
    group, slots = row_geometry(D)
    _launch("scaled_row_update", dev, lambda lib, s:
            lib.trt_scaled_row_update_f32(
                weights.data_ptr(), uids.data_ptr(), g.data_ptr(),
                scale.data_ptr(), R, D, N, group, slots, s))
    return weights


# -- K5 ------------------------------------------------------------------------


def rowwise_momentum_stream_reference(
    momentum: torch.Tensor, uids: torch.Tensor, g_sq: torch.Tensor,
    eps: float = 1.0e-8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K5: momentum[u] += g_sq over the real slots, in
    place; inv[p] = -1 / (sqrt(momentum[uids[p]]) + eps) afterwards, 0 at
    sentinel slots."""
    R = momentum.shape[0]
    real = (uids >= 0) & (uids < R)
    ids = torch.where(real, uids, 0).long()
    momentum.index_add_(0, ids, torch.where(real, g_sq, 0.0))
    inv = _div(-1.0, torch.sqrt(momentum[ids]) + eps)
    inv = torch.where(real, inv, 0.0)
    return momentum, inv, torch.zeros((), dtype=torch.bool,
                                      device=momentum.device)


@_in_span
def rowwise_momentum_stream(
    momentum: torch.Tensor, uids: torch.Tensor, g_sq: torch.Tensor,
    eps: float = 1.0e-8,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K5: rowwise-momentum accumulate and per-slot inverse scale.

    momentum [R] f32, updated in place; uids [N] int32 SORTED ascending
    (`dedup_row_grads` output: real ids, then sentinels >= R; duplicates
    are allowed and every slot of a run gets the run's new momentum);
    g_sq [N] f32. Returns (momentum, inv_scale [N], overflowed) with
    inv_scale[p] = -1 / (sqrt(new_m[uids[p]]) + eps), 0 at sentinel slots.
    `overflowed` is always a False tensor: unlike the TPU kernel's
    contribution windows, nothing here can overflow.
    """
    _check("momentum", momentum, torch.float32, 1)
    _check("uids", uids, torch.int32, 1)
    _check("g_sq", g_sq, torch.float32, 1, uids.shape[0])
    dev = _same_device(momentum, uids, g_sq)
    eps = float(eps)
    if dev.type == "cpu":
        return rowwise_momentum_stream_reference(momentum, uids, g_sq, eps)
    R, N = momentum.shape[0], uids.shape[0]
    inv = torch.empty((N,), dtype=torch.float32, device=dev)
    if N:
        _launch("rowwise_momentum_stream", dev, lambda lib, s:
                lib.trt_rowwise_momentum_f32(
                    momentum.data_ptr(), uids.data_ptr(), g_sq.data_ptr(),
                    inv.data_ptr(), R, N, eps, s))
    return momentum, inv, torch.zeros((), dtype=torch.bool, device=dev)


# -- K4 ------------------------------------------------------------------------

def fused_slots_per_warp(N: int) -> int:
    """Slots each warp of the fused kernel walks, one after another, at a
    row a warp (D > 64): the largest power of two up to 32 at most
    sqrt(N / 16384). A warp's walk is a chain of memory latencies, one per
    real slot, which ends the launch when N is small; every warp costs its
    scheduling, which adds up when N is large. On an H100 this picks the
    fastest of 1-32 at BERT4Rec's training shape (N 2,048: 1 slot, 1.9 us
    against 18 us at 32) and the DLRM's (N 212,992: 2 slots, 0.114 ms
    against 0.127 ms at 32); see PERF.md."""
    slots = 1
    while slots < 32 and (2 * slots) ** 2 * 16384 <= N:
        slots *= 2
    return slots


def fused_geometry(D: int, N: int) -> Tuple[int, int]:
    """(lanes per row, slots per warp) of the fused rowwise kernel (K4 and
    K4h) over N slots of width D. D > 64: a warp a row and
    `fused_slots_per_warp(N)`. Narrow rows: `lanes_per_row(D)` lanes, so
    P = 32 / G rows a warp, and each lane group walks
    `fused_slots_per_warp(4 * N)` slots, P times that a warp, at most 32:
    a group moves a quarter of a wide row's bytes or less a step, so it
    takes more slots before its warp's scheduling costs more than the
    latency it hides. From sweeps on an H100 (compare_update_kernels.py
    --sweep, profile_rowwise.py; PERF.md) at the shapes of the paths that
    run it: BERT4Rec's 2,048 slots at D=64 (one slot a group; two are
    26 % slower), and the Criteo Kaggle batch's 212,992 (four a group) for
    the f32 DeepFM at D=10 (level with two), the Criteo Kaggle DLRM at
    D=64 (1.5 % faster than two) and the bf16 DeepFM at D=10 (7 %
    faster)."""
    G = lanes_per_row(D)
    if G == 32:
        return G, fused_slots_per_warp(N)
    return G, min(32, (32 // G) * fused_slots_per_warp(4 * N))


def row_mean_sq(g: torch.Tensor) -> torch.Tensor:
    """mean(g * g, dim=1) of g [N, D], summed in the fused kernel's order
    (csrc/fused_update.cu, rowwise_adagrad_kernel), so that every route of
    the rowwise update rounds g_sq alike: lane l of a warp takes float4
    c * 32 + l of each 128-column chunk c, sums ((x² + y²) + z²) + w² and
    adds the chunks in ascending order; the 32 lanes' partials are then
    halved pairwise (lanes l and l + 16, then l + 8, ...) and the total is
    divided by D once."""
    N, D = g.shape
    chunks = -(-D // 128)
    sq = g * g
    if D % 128:
        sq = torch.nn.functional.pad(sq, (0, chunks * 128 - D))
    a = sq.view(N, chunks, 32, 4)
    a = ((a[..., 0] + a[..., 1]) + a[..., 2]) + a[..., 3]  # [N, chunks, 32]
    part = a[:, 0]
    for c in range(1, chunks):
        part = part + a[:, c]
    for half in (16, 8, 4, 2, 1):
        part = part[:, :half] + part[:, half:2 * half]
    total = part[:, 0]
    return total / torch.full_like(total, D)  # one rounded division


def _rowwise_adagrad(weights, momentum, uids, g, lr, eps, weight_decay,
                     momentum_stream, w_impl, mom_fn, scaled_fn, write_fn):
    """The logic of pallas_embedding.fused_update_rowwise_adagrad
    (:640-734), over the given K5 / K4 / K2 callables."""
    R = weights.shape[0]
    valid = uids < R  # dedup sentinels are R + pos, never negative
    ids = uids.clamp(max=R - 1).long()
    # L2 weight decay folds into g before the accumulator (FBGEMM)
    if weight_decay:
        g = g + weight_decay * weights[ids]
    g_sq = row_mean_sq(g) * valid.to(torch.float32)
    if momentum_stream:
        _, inv, _ = mom_fn(momentum, uids, g_sq, eps)
        scale = lr * inv
    else:
        m_rows = momentum[ids] + g_sq
        momentum.index_add_(0, ids, g_sq)  # sentinels add 0 to row R-1
        scale = torch.where(
            valid, _div(-lr, torch.sqrt(m_rows) + eps), 0.0)
    if w_impl == "write":
        write_fn(weights, uids, weights[ids] + scale[:, None] * g)
    else:
        scaled_fn(weights, uids, g.contiguous(), scale.contiguous())
    return weights, momentum


def _check_adagrad(weights, momentum, uids, g, w_impl) -> torch.device:
    if w_impl not in ("rmw", "write"):
        raise ValueError(f"w_impl must be 'rmw' or 'write', got {w_impl!r}")
    dev = _check_rows(weights, uids, g, "g")
    _check("momentum", momentum, torch.float32, 1, weights.shape[0])
    _same_device(weights, momentum)
    return dev


def fused_update_rowwise_adagrad_reference(
    weights, momentum, uids, g, lr, eps=1.0e-8, weight_decay=0.0,
    momentum_stream=False, w_impl="rmw",
):
    """Plain version of `fused_update_rowwise_adagrad`, on the plain
    versions of K5, K4's scaled RMW and K2; on the default route
    (`momentum_stream=True`, `w_impl="rmw"`) the fused kernel equals it
    bit for bit."""
    _check_adagrad(weights, momentum, uids, g, w_impl)
    return _rowwise_adagrad(
        weights, momentum, uids, g, float(lr), float(eps),
        float(weight_decay), momentum_stream, w_impl,
        rowwise_momentum_stream_reference, scaled_row_update_reference,
        scatter_rows_write_reference)


def rowwise_adagrad_unfused(
    weights, momentum, uids, g, lr, eps=1.0e-8, weight_decay=0.0,
    momentum_stream=True, w_impl="rmw",
):
    """The rowwise update as separate launches: torch ops for the weight
    decay fold, g_sq and the scale, K5 (or torch index ops) for the
    momentum, the scaled RMW (or a gather and K2) for the rows. The
    wrapper takes it for CUDA tensors on every route but the fused one;
    on the default route it is what the fused kernel replaced."""
    _check_adagrad(weights, momentum, uids, g, w_impl)
    return _rowwise_adagrad(
        weights, momentum, uids, g, float(lr), float(eps),
        float(weight_decay), momentum_stream, w_impl,
        rowwise_momentum_stream, scaled_row_update, scatter_rows_write)


@_in_span
def fused_update_rowwise_adagrad(
    weights: torch.Tensor, momentum: torch.Tensor, uids: torch.Tensor,
    g: torch.Tensor, lr: float, eps: float = 1.0e-8,
    weight_decay: float = 0.0, momentum_stream: bool = False,
    w_impl: str = "rmw",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4: in-place rowwise Adagrad on unique touched rows.

    weights [R, D] f32 and momentum [R] f32 (mean(g^2) per row) are
    updated in place and returned; uids [N] int32 SORTED unique
    (`dedup_row_grads` output, sentinels R + pos); g [N, D] f32 total
    row gradients. Weight decay folds into g before g_sq. On the default
    route (`momentum_stream=True`, `w_impl="rmw"`) one kernel does the
    whole update, K5's momentum step included, at any D: a row of up to
    512 columns in registers, a wider one in two passes with the same
    sums. Otherwise the momentum step runs through K5
    (`momentum_stream=True`) or torch index ops, and the rows are written
    by the scaled RMW (`"rmw"`) or gathered, scaled and written by K2
    (`"write"`).
    """
    dev = _check_adagrad(weights, momentum, uids, g, w_impl)
    lr, eps, wd = float(lr), float(eps), float(weight_decay)
    if dev.type == "cpu":
        return fused_update_rowwise_adagrad_reference(
            weights, momentum, uids, g, lr, eps, wd, momentum_stream, w_impl)
    (R, D), N = weights.shape, uids.shape[0]
    if not momentum_stream or w_impl != "rmw":
        return rowwise_adagrad_unfused(weights, momentum, uids, g, lr, eps,
                                       wd, momentum_stream, w_impl)
    if N == 0 or D == 0:
        return weights, momentum
    group, slots = fused_geometry(D, N)
    _launch("fused_update_rowwise_adagrad", dev, lambda lib, s:
            lib.trt_fused_rowwise_adagrad_f32(
                weights.data_ptr(), momentum.data_ptr(), uids.data_ptr(),
                g.data_ptr(), R, D, N, group, slots, lr, eps, wd, s))
    return weights, momentum


# -- K6 and K7 -----------------------------------------------------------------


# Slots a warp of the moment kernel takes, by lanes per row (D <= 64; a warp
# a row takes 32 slots at D > 64): the fastest of K6 and K7 together in a
# sweep on an H100 at the Kaggle batch's 212,992 slots (D = 3, 8, 10, 32
# and 64; compare_update_kernels.py --sweep, PERF.md), one or two steps a
# lane group.
MOMENT_SLOTS = {1: 32, 2: 16, 4: 8, 8: 8, 16: 4, 32: 32}


def moment_geometry(D: int) -> Tuple[int, int]:
    """(lanes per row, slots per warp) of the moment kernel of K6 and K7
    (csrc/fused_update.cu, `moment_update_kernel`)."""
    G = lanes_per_row(D)
    return G, MOMENT_SLOTS[G]


def adagrad_rows(w: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
                 lr: float, eps: float, weight_decay: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6's arithmetic on gathered rows, rounded where `_adagrad_kernel`
    (pallas_embedding.py:503-528) and the CUDA kernel round: returns
    (new rows, new momentum)."""
    if weight_decay:
        g = g + weight_decay * w
    m = m + g * g
    return w - lr * g / (torch.sqrt(m) + eps), m


def adam_bias_correction(step: torch.Tensor, beta1: float,
                         beta2: float) -> torch.Tensor:
    """[1 / (1 - beta1**t), 1 / (1 - beta2**t)] in f32 on `step`'s device,
    t = step as f32, as pallas_embedding.fused_update_adam (:1111-1114)
    computes it: device ops only, so nothing waits for the step."""
    t = step.to(torch.float32)
    return torch.stack([_div(1.0, 1.0 - torch.full_like(t, b) ** t)
                        for b in (beta1, beta2)])


def adam_rows(w: torch.Tensor, m1: torch.Tensor, m2: torch.Tensor,
              g: torch.Tensor, lr: float, bc: torch.Tensor, eps: float,
              weight_decay: float, beta1: float, beta2: float
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7's arithmetic on gathered rows, rounded where `_adam_kernel`
    (pallas_embedding.py:531-565) and the CUDA kernel round; bc from
    `adam_bias_correction`. 1 - beta is taken in double before it meets
    f32, as JAX takes the kernel's Python constants. Returns (new rows,
    new m1, new m2)."""
    if weight_decay:
        g = g + weight_decay * w
    m1 = beta1 * m1 + (1.0 - beta1) * g
    m2 = beta2 * m2 + (1.0 - beta2) * g * g
    w = w - lr * (m1 * bc[0]) / (torch.sqrt(m2 * bc[1]) + eps)
    return w, m1, m2


def _check_moments(weights, uids, g, **moments) -> torch.device:
    dev = _check_rows(weights, uids, g, "g")
    for name, m in moments.items():
        _check(name, m, torch.float32, 2, weights.shape[0])
        if m.shape[1] != weights.shape[1]:
            raise ValueError(f"{name} has width {m.shape[1]}, weights "
                             f"{weights.shape[1]}")
    _same_device(weights, *moments.values())
    return dev


def fused_update_adagrad_reference(weights, momentum, uids, g, lr,
                                   eps=1.0e-8, weight_decay=0.0):
    """Plain version of K6, in place on the real slots."""
    sel = _real_slots(uids, weights.shape[0])
    ids = uids[sel].long()
    w, m = adagrad_rows(weights[ids], momentum[ids], g[sel], float(lr),
                        float(eps), float(weight_decay))
    weights.index_copy_(0, ids, w)
    momentum.index_copy_(0, ids, m)
    return weights, momentum


@_in_span
def fused_update_adagrad(
    weights: torch.Tensor, momentum: torch.Tensor, uids: torch.Tensor,
    g: torch.Tensor, lr: float, eps: float = 1.0e-8,
    weight_decay: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K6: in-place elementwise Adagrad on unique touched rows.

    weights and momentum [R, D] f32 are updated in place and returned;
    uids [N] int32, unique among real slots (`run_total_row_grads`
    output, sentinels 2**31 - 1); g [N, D] f32 total row gradients.
    g += wd * W; m += g * g; W -= lr * g / (sqrt(m) + eps).
    """
    dev = _check_moments(weights, uids, g, momentum=momentum)
    lr, eps, wd = float(lr), float(eps), float(weight_decay)
    if dev.type == "cpu":
        return fused_update_adagrad_reference(weights, momentum, uids, g,
                                              lr, eps, wd)
    (R, D), N = weights.shape, uids.shape[0]
    if N == 0 or D == 0:
        return weights, momentum
    group, slots = moment_geometry(D)
    _launch("fused_update_adagrad", dev, lambda lib, s:
            lib.trt_fused_update_adagrad_f32(
                weights.data_ptr(), momentum.data_ptr(), uids.data_ptr(),
                g.data_ptr(), R, D, N, group, slots, lr, eps, wd, s))
    return weights, momentum


def fused_update_adam_reference(weights, momentum1, momentum2, uids, g, lr,
                                step, eps=1.0e-8, weight_decay=0.0,
                                beta1=0.9, beta2=0.999):
    """Plain version of K7, in place on the real slots."""
    bc = adam_bias_correction(step, beta1, beta2)
    sel = _real_slots(uids, weights.shape[0])
    ids = uids[sel].long()
    w, m1, m2 = adam_rows(weights[ids], momentum1[ids], momentum2[ids],
                          g[sel], float(lr), bc, float(eps),
                          float(weight_decay), float(beta1), float(beta2))
    weights.index_copy_(0, ids, w)
    momentum1.index_copy_(0, ids, m1)
    momentum2.index_copy_(0, ids, m2)
    return weights, momentum1, momentum2


@_in_span
def fused_update_adam(
    weights: torch.Tensor, momentum1: torch.Tensor, momentum2: torch.Tensor,
    uids: torch.Tensor, g: torch.Tensor, lr: float, step: torch.Tensor,
    eps: float = 1.0e-8, weight_decay: float = 0.0, beta1: float = 0.9,
    beta2: float = 0.999,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K7: in-place elementwise Adam on unique touched rows.

    weights, momentum1 and momentum2 [R, D] f32 are updated in place and
    returned; uids and g as K6; step the already incremented 0-d int
    tensor on the tables' device, as in the JAX call
    (fused_update.py:1121-1125). The bias corrections are computed from
    it on the device (`adam_bias_correction`) and read by the kernel.
    """
    dev = _check_moments(weights, uids, g, momentum1=momentum1,
                         momentum2=momentum2)
    _same_device(weights, step)
    lr, eps, wd = float(lr), float(eps), float(weight_decay)
    beta1, beta2 = float(beta1), float(beta2)
    if dev.type == "cpu":
        return fused_update_adam_reference(
            weights, momentum1, momentum2, uids, g, lr, step, eps, wd,
            beta1, beta2)
    (R, D), N = weights.shape, uids.shape[0]
    if N == 0 or D == 0:
        return weights, momentum1, momentum2
    bc = adam_bias_correction(step, beta1, beta2)
    group, slots = moment_geometry(D)
    _launch("fused_update_adam", dev, lambda lib, s:
            lib.trt_fused_update_adam_f32(
                weights.data_ptr(), momentum1.data_ptr(),
                momentum2.data_ptr(), uids.data_ptr(), g.data_ptr(),
                bc.data_ptr(), R, D, N, group, slots, lr, eps, wd, beta1,
                1.0 - beta1, beta2, 1.0 - beta2, s))
    return weights, momentum1, momentum2


# -- K3h and K4h: half-precision tables ----------------------------------------


def round_rows(w32: torch.Tensor, upd: torch.Tensor, dtype: torch.dtype,
               rows: torch.Tensor, step: torch.Tensor,
               stochastic_rounding: bool = True,
               row_base: int = 0) -> torch.Tensor:
    """The half kernels' epilogue on rows [N, D]: w32 + upd rounded to
    `dtype`, stochastically with sr_bits(step, row_base + rows[i], column)
    (JAX's `stochastic_round(w + upd)`; `row_base` is the shard's first
    row across the group, so that two shards' rows of one local index draw
    different bits), or as JAX's deterministic `w + upd.astype(dtype)`:
    upd rounded to `dtype`, added in f32, rounded to nearest-even again."""
    if stochastic_rounding:
        return stochastic_round(w32 + upd, dtype,
                                sr_bits(step, rows + row_base, w32.shape[1]))
    return (w32 + upd.to(dtype).float()).to(dtype)


def _check_half(weights: torch.Tensor, uids: torch.Tensor, g: torch.Tensor,
                step: torch.Tensor) -> torch.device:
    if weights.dtype not in HALF_TYPES or weights.dim() != 2:
        raise TypeError(f"weights must be a 2-D bf16 or fp16 tensor, got "
                        f"{weights.dtype} {tuple(weights.shape)}")
    if not weights.is_contiguous():
        raise ValueError("weights must be contiguous")
    _check("uids", uids, torch.int32, 1)
    _check("g", g, torch.float32, 2, uids.shape[0])
    if g.shape[1] != weights.shape[1]:
        raise ValueError(f"g has width {g.shape[1]}, weights "
                         f"{weights.shape[1]}")
    if step.dim() != 0 or step.dtype != torch.int32:
        raise TypeError(f"step must be a 0-d int32 tensor, got {step.dtype} "
                        f"{tuple(step.shape)}")
    return _same_device(weights, uids, g, step)


def fused_update_sgd_half_reference(
    weights: torch.Tensor, uids: torch.Tensor, g: torch.Tensor, lr: float,
    step: torch.Tensor, weight_decay: float = 0.0,
    stochastic_rounding: bool = True, row_base: int = 0,
) -> torch.Tensor:
    """Plain version of K3h: W[id] = round(W[id] - lr * (g + wd * W[id]))
    on the real slots, in place, with K3h's f32 arithmetic."""
    sel = _real_slots(uids, weights.shape[0])
    ids = uids[sel].long()
    w, gg = weights[ids].float(), g[sel]
    if weight_decay:
        gg = gg + weight_decay * w
    weights.index_copy_(0, ids, round_rows(
        w, -(lr * gg), weights.dtype, ids, step, stochastic_rounding,
        row_base))
    return weights


@_in_span
def fused_update_sgd_half(
    weights: torch.Tensor, uids: torch.Tensor, g: torch.Tensor, lr: float,
    step: torch.Tensor, weight_decay: float = 0.0,
    stochastic_rounding: bool = True, row_base: int = 0,
) -> torch.Tensor:
    """K3h: K3 on a bf16 / fp16 table, in place. weights [R, D] bf16 or
    fp16; uids [N] int32, unique among real slots (`run_total_row_grads`,
    sentinels 2**31 - 1); g [N, D] f32; step the optimizer's 0-d int32
    step tensor before its increment, on the table's device (read there by
    the kernel, never by the host). Each touched row becomes
    round(W - lr * (g + wd * W)) in f32, rounded stochastically with
    sr_bits(step, row_base + row, column) or to nearest (`round_rows`).
    It is the row kernel of K2 and K3 on a half table, with their lanes
    per row and slots per warp (`row_geometry`). Returns `weights`."""
    dev = _check_half(weights, uids, g, step)
    lr, weight_decay = float(lr), float(weight_decay)
    if dev.type == "cpu":
        return fused_update_sgd_half_reference(
            weights, uids, g, lr, step, weight_decay, stochastic_rounding,
            row_base)
    (R, D), N = weights.shape, uids.shape[0]
    if N == 0 or D == 0:
        return weights
    group, slots = row_geometry(D)
    _launch("fused_update_sgd_half", dev, lambda lib, s:
            lib.trt_fused_update_sgd_half(
                weights.data_ptr(), uids.data_ptr(), g.data_ptr(),
                step.data_ptr(), R, D, N, group, slots, lr, weight_decay,
                HALF_TYPES[weights.dtype], int(stochastic_rounding),
                SR_SEED, int(row_base), s))
    return weights


def _check_half_adagrad(weights, momentum, uids, g, step) -> torch.device:
    dev = _check_half(weights, uids, g, step)
    _check("momentum", momentum, torch.float32, 1, weights.shape[0])
    _same_device(weights, momentum)
    return dev


def fused_update_rowwise_adagrad_half_reference(
    weights: torch.Tensor, momentum: torch.Tensor, uids: torch.Tensor,
    g: torch.Tensor, lr: float, step: torch.Tensor, eps: float = 1.0e-8,
    weight_decay: float = 0.0, stochastic_rounding: bool = True,
    row_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4h, in place on the real slots, rounded where the
    fused kernel rounds (g_sq in `row_mean_sq`'s order)."""
    sel = _real_slots(uids, weights.shape[0])
    ids = uids[sel].long()
    w, gg = weights[ids].float(), g[sel]
    if weight_decay:
        gg = gg + weight_decay * w
    m = momentum[ids] + row_mean_sq(gg)
    momentum.index_copy_(0, ids, m)
    scale = lr * _div(-1.0, torch.sqrt(m) + eps)
    weights.index_copy_(0, ids, round_rows(
        w, scale[:, None] * gg, weights.dtype, ids, step,
        stochastic_rounding, row_base))
    return weights, momentum


@_in_span
def fused_update_rowwise_adagrad_half(
    weights: torch.Tensor, momentum: torch.Tensor, uids: torch.Tensor,
    g: torch.Tensor, lr: float, step: torch.Tensor, eps: float = 1.0e-8,
    weight_decay: float = 0.0, stochastic_rounding: bool = True,
    row_base: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """K4h: the fused rowwise Adagrad on a bf16 / fp16 table, in place.
    weights [R, D] bf16 or fp16; momentum [R] f32; uids [N] int32 SORTED
    unique (`dedup_row_grads`, sentinels R + pos); g [N, D] f32; step as
    `fused_update_sgd_half`. The fused K4's f32 update, then each row
    rounded as K3h rounds it, at any D as the fused K4. Returns
    (weights, momentum)."""
    dev = _check_half_adagrad(weights, momentum, uids, g, step)
    lr, eps, wd = float(lr), float(eps), float(weight_decay)
    if dev.type == "cpu":
        return fused_update_rowwise_adagrad_half_reference(
            weights, momentum, uids, g, lr, step, eps, wd,
            stochastic_rounding, row_base)
    (R, D), N = weights.shape, uids.shape[0]
    if N == 0 or D == 0:
        return weights, momentum
    group, slots = fused_geometry(D, N)
    _launch("fused_update_rowwise_adagrad_half", dev, lambda lib, s:
            lib.trt_fused_rowwise_adagrad_half(
                weights.data_ptr(), momentum.data_ptr(), uids.data_ptr(),
                g.data_ptr(), step.data_ptr(), R, D, N, group, slots, lr,
                eps, wd,
                HALF_TYPES[weights.dtype], int(stochastic_rounding), SR_SEED,
                int(row_base), s))
    return weights, momentum
