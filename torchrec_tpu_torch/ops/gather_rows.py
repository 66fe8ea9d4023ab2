"""K8: the embedding row gather as a hand-written CUDA kernel.

Counterpart of `gather_rows` in torchrec_tpu/ops/pallas_embedding.py
(:91-146, the Pallas body `_gather_kernel` at :70). The CUDA source is
csrc/gather_rows.cu; it is compiled with `nvcc` for sm_90a into a shared
library with a plain C interface on first use and bound with `ctypes`
(ops/cuda_build.py). A row takes `lanes_per_row(D)` lanes
(ops/lane_groups.py), passed to the launch: at D <= 64 a warp copies
several rows, one per lane group; wider rows take a warp each. The routed
gather takes the same lanes a token, its route-only mode one thread.

`gather_rows` is a `torch.autograd.Function`. Its forward launches the
kernel for CUDA tensors and takes the plain PyTorch version,
`gather_rows_reference`, only for CPU tensors; a failed build or launch
raises, nothing falls back. The TPU kernel's wave size `T` and `interpret`
are not taken: any N works. Its backward is the JAX VJP's dense
scatter-add, `zeros((R, D)).at[flat_ids].add(d_rows, mode="drop")`
(`_gather_rows_bwd`, :139-143), an XLA op there and `index_add_` here:
the forward CLIPS ids to [0, R-1], the backward DROPS ids >= R and wraps
ids in [-R, -1] numpy-style, as JAX does.

`routed_gather_rows` is K8 redesigned for the sharded sequence path
(parallel/sequence_strategies.py): one launch routes each token of a
padded [F, B, L] batch to its owning shard, masks padding and other
shards' rows, and gathers, where the JAX package composes `_route`
(torchrec_tpu/parallel/strategies.py:829-836), `gather_rows` and
`rows * owned` (torchrec_tpu/parallel/sequence_strategies.py:101-110).
`route_tokens` is the same kernel without W: the route alone, for the
fused update. Both are plain functions for the sharded path, which runs
outside autograd; CUDA tensors launch, CPU tensors take
`routed_gather_rows_reference` / `route_tokens_reference`. A masked token
gives zeros where JAX multiplies by the mask, so a non-finite row under it
gives 0 here and NaN there, and a row with negative entries +0.0 here and
-0.0 there (equal as values).

Launches count (utils/tracing.py) as `gather_rows` (K8, also from K1's
backward), `routed_gather_rows` and `route_tokens`.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from torchrec_tpu_torch.ops.cuda_build import CudaLibrary
from torchrec_tpu_torch.ops.lane_groups import lanes_per_row
from torchrec_tpu_torch.utils import tracing


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.trt_gather_rows_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    fn = lib.trt_routed_gather_rows_f32
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int64] * 6 + [
        ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("gather_rows.cu", _bind)

_routed_fn = None


def _check(weights: torch.Tensor, flat_ids: torch.Tensor) -> None:
    if weights.dtype != torch.float32 or weights.dim() != 2:
        raise TypeError(
            f"weights must be a 2-D float32 tensor, got {weights.dtype} "
            f"{tuple(weights.shape)}"
        )
    if flat_ids.dtype != torch.int32 or flat_ids.dim() != 1:
        raise TypeError(
            f"flat_ids must be a 1-D int32 tensor, got {flat_ids.dtype} "
            f"{tuple(flat_ids.shape)}"
        )
    if weights.device != flat_ids.device:
        raise ValueError(
            f"tensors on different devices: {weights.device}, "
            f"{flat_ids.device}"
        )
    if weights.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {weights.device}")
    for name, t in (("weights", weights), ("flat_ids", flat_ids)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weights.shape[0] == 0 and flat_ids.numel():
        raise ValueError("weights has no rows to gather")


def gather_rows_reference(
    weights: torch.Tensor, flat_ids: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: W[clip(ids, 0, R-1)]."""
    R = weights.shape[0]
    return weights[flat_ids.clamp(0, max(R - 1, 0)).long()]


def gather_rows_forward(
    weights: torch.Tensor, flat_ids: torch.Tensor
) -> torch.Tensor:
    """The forward alone, outside autograd: K8 for CUDA tensors, the plain
    version for CPU tensors."""
    _check(weights, flat_ids)
    if weights.device.type == "cpu":
        return gather_rows_reference(weights, flat_ids)
    R, D = weights.shape
    N = flat_ids.shape[0]
    out = torch.empty((N, D), dtype=torch.float32, device=weights.device)
    if N == 0 or D == 0:
        return out
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(weights.device).cuda_stream
    with torch.cuda.device(weights.device):
        err = lib.trt_gather_rows_f32(
            weights.data_ptr(), flat_ids.data_ptr(), out.data_ptr(), R, D, N,
            lanes_per_row(D), stream,
        )
    LIBRARY.check("gather_rows", err)
    tracing.count("gather_rows")
    return out


def scatter_add_rows(
    num_rows: int, flat_ids: torch.Tensor, rows: torch.Tensor
) -> torch.Tensor:
    """zeros((num_rows, D)).at[flat_ids].add(rows, mode="drop"): ids in
    [-R, -1] wrap to R + id, ids outside [-R, R-1] add nothing. Dropped
    slots add an exact zero to row 0, so nothing waits for the device."""
    idx = flat_ids.long()
    idx = torch.where(idx < 0, idx + num_rows, idx)
    keep = (idx >= 0) & (idx < num_rows)
    out = torch.zeros((num_rows, rows.shape[-1]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add_(0, torch.where(keep, idx, 0),
                          torch.where(keep[:, None], rows, 0.0))


class GatherRows(torch.autograd.Function):
    """K8 forward; dense scatter-add backward to the table, no gradient to
    the ids."""

    @staticmethod
    def forward(ctx, weights: torch.Tensor,
                flat_ids: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(flat_ids)
        ctx.num_rows = weights.shape[0]
        return gather_rows_forward(weights, flat_ids)

    @staticmethod
    def backward(ctx, d_rows: torch.Tensor):
        (flat_ids,) = ctx.saved_tensors
        return scatter_add_rows(ctx.num_rows, flat_ids, d_rows), None


def gather_rows(weights: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """weights [R, D] f32, flat_ids [N] int32 -> rows [N, D] f32, ids
    clipped to [0, R-1]. CUDA tensors launch K8; CPU tensors take
    `gather_rows_reference`. Differentiable in `weights` (see
    `GatherRows`)."""
    return GatherRows.apply(weights, flat_ids)


# -- the routed gather ------------------------------------------------------


def route_tokens_reference(
    ids: torch.Tensor, lengths: torch.Tensor, shard_rows: torch.Tensor,
    local_off: torch.Tensor, rank: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch route of ids [F, B, L] to row shards of
    `shard_rows[f]` rows: (the row in its owner's packed shard, [F, B, L];
    owned by `rank` and not padding, [F, B, L] bool), with Python's floor
    division and modulo."""
    sr = shard_rows[:, None, None]
    owner = torch.div(ids, sr, rounding_mode="floor")
    local = torch.remainder(ids, sr) + local_off[:, None, None]
    col = torch.arange(ids.shape[2], device=ids.device)
    owned = (owner == rank) & (col[None, None, :] < lengths[:, :, None])
    return local, owned


def routed_gather_rows_reference(
    weights: torch.Tensor, ids: torch.Tensor, lengths: torch.Tensor,
    shard_rows: torch.Tensor, local_off: torch.Tensor, rank: int,
) -> torch.Tensor:
    """Plain PyTorch version: the route, W[clip(local)], zeros where not
    owned -> [F, B, L, D]."""
    local, owned = route_tokens_reference(ids, lengths, shard_rows,
                                          local_off, rank)
    rows = gather_rows_reference(weights, local.reshape(-1))
    return torch.where(owned[..., None],
                       rows.reshape(*local.shape, weights.shape[1]), 0.0)


def _check_route(ids: torch.Tensor, lengths: torch.Tensor,
                 shard_rows: torch.Tensor, local_off: torch.Tensor) -> None:
    """What the kernel reads: contiguous int32 ids [F, B, L], lengths
    [F, B] and per-feature shard rows and offsets [F], on one device."""
    if ids.dim() != 3:
        raise TypeError(f"ids must be [F, B, L], got {tuple(ids.shape)}")
    F, B, _ = ids.shape
    i32, dev = torch.int32, ids.device
    if (ids.dtype != i32 or lengths.dtype != i32 or shard_rows.dtype != i32
            or local_off.dtype != i32 or lengths.shape != (F, B)
            or shard_rows.shape != (F,) or local_off.shape != (F,)):
        raise TypeError(
            "ids [F, B, L], lengths [F, B], shard_rows and local_off [F] "
            "must be int32, got " + ", ".join(
                f"{t.dtype} {tuple(t.shape)}"
                for t in (ids, lengths, shard_rows, local_off)))
    if not (ids.is_contiguous() and lengths.is_contiguous()
            and shard_rows.is_contiguous() and local_off.is_contiguous()):
        raise ValueError("ids, lengths, shard_rows and local_off must be "
                         "contiguous")
    if (lengths.device != dev or shard_rows.device != dev
            or local_off.device != dev):
        raise ValueError("ids, lengths, shard_rows and local_off must be on "
                         "one device")


def _launch_routed(weights: Optional[torch.Tensor], ids, lengths,
                   shard_rows, local_off, rank: int,
                   out: Optional[torch.Tensor],
                   local: Optional[torch.Tensor],
                   owned: Optional[torch.Tensor]) -> None:
    global _routed_fn
    if _routed_fn is None:
        _routed_fn = LIBRARY.load().trt_routed_gather_rows_f32
    F, B, L = ids.shape
    R, D = (0, 0) if weights is None else weights.shape
    dev = ids.device
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (
        None if weights is None else weights.data_ptr(), ids.data_ptr(),
        lengths.data_ptr(), shard_rows.data_ptr(), local_off.data_ptr(),
        None if out is None else out.data_ptr(),
        None if local is None else local.data_ptr(),
        None if owned is None else owned.data_ptr(),
        R, D, F, B, L, rank, 1 if weights is None else lanes_per_row(D),
        stream,
    )
    if dev.index == torch.cuda.current_device():
        err = _routed_fn(*args)
    else:
        with torch.cuda.device(dev):
            err = _routed_fn(*args)
    LIBRARY.check("routed_gather_rows", err)


def routed_gather_rows(
    weights: torch.Tensor, ids: torch.Tensor, lengths: torch.Tensor,
    shard_rows: torch.Tensor, local_off: torch.Tensor, rank: int,
) -> torch.Tensor:
    """The sharded sequence forward: weights [R, D] f32 (this shard), ids
    [F, B, L] and lengths [F, B] int32, shard_rows / local_off [F] int32
    -> rows [F, B, L, D] f32, zero where the token is padding or its row
    lives on another shard. One kernel launch for CUDA tensors,
    `routed_gather_rows_reference` for CPU tensors. Not differentiable:
    the sharded path runs outside autograd."""
    _check_route(ids, lengths, shard_rows, local_off)
    if weights.dtype != torch.float32 or weights.dim() != 2:
        raise TypeError(f"weights must be a 2-D float32 tensor, got "
                        f"{weights.dtype} {tuple(weights.shape)}")
    if not weights.is_contiguous():
        raise ValueError("weights must be contiguous")
    if weights.device != ids.device:
        raise ValueError(f"weights on {weights.device}, ids on {ids.device}")
    if ids.device.type == "cpu":
        return routed_gather_rows_reference(weights, ids, lengths,
                                            shard_rows, local_off, rank)
    out = torch.empty((*ids.shape, weights.shape[1]), dtype=torch.float32,
                      device=ids.device)
    if out.numel() == 0:
        return out
    if weights.shape[0] == 0:
        raise ValueError("weights has no rows to gather")
    _launch_routed(weights, ids, lengths, shard_rows, local_off, rank, out,
                   None, None)
    tracing.count("routed_gather_rows")
    return out


def route_tokens(
    ids: torch.Tensor, lengths: torch.Tensor, shard_rows: torch.Tensor,
    local_off: torch.Tensor, rank: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The route alone, the routed gather's kernel without W: (local
    [F, B, L] int32, owned [F, B, L] bool), as `route_tokens_reference`
    computes them. One launch for CUDA tensors, the plain version for CPU
    tensors."""
    _check_route(ids, lengths, shard_rows, local_off)
    if ids.device.type == "cpu":
        return route_tokens_reference(ids, lengths, shard_rows, local_off,
                                      rank)
    local = torch.empty(ids.shape, dtype=torch.int32, device=ids.device)
    owned = torch.empty(ids.shape, dtype=torch.bool, device=ids.device)
    if ids.numel() == 0:
        return local, owned
    _launch_routed(None, ids, lengths, shard_rows, local_off, rank, None,
                   local, owned)
    tracing.count("route_tokens")
    return local, owned
