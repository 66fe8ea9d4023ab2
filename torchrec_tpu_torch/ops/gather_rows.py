"""K8: the embedding row gather as a hand-written CUDA kernel.

Counterpart of `gather_rows` in torchrec_tpu/ops/pallas_embedding.py
(:91-146, the Pallas body `_gather_kernel` at :70). The CUDA source is
csrc/gather_rows.cu; it is compiled with `nvcc` for sm_90a into a shared
library with a plain C interface on first use and bound with `ctypes`
(ops/cuda_build.py).

`gather_rows` is a `torch.autograd.Function`. Its forward launches the
kernel for CUDA tensors and takes the plain PyTorch version,
`gather_rows_reference`, only for CPU tensors; a failed build or launch
raises, nothing falls back. The TPU kernel's wave size `T` and `interpret`
are not taken: any N works. Its backward is the JAX VJP's dense
scatter-add, `zeros((R, D)).at[flat_ids].add(d_rows, mode="drop")`
(`_gather_rows_bwd`, :139-143), an XLA op there and `index_add_` here:
the forward CLIPS ids to [0, R-1], the backward DROPS ids >= R and wraps
ids in [-R, -1] numpy-style, as JAX does.
"""

from __future__ import annotations

import ctypes

import torch

from torchrec_tpu_torch.ops.cuda_build import CudaLibrary


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.trt_gather_rows_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("gather_rows.cu", _bind)

# Kernel launches made by `gather_rows` and K1's backward in this process.
LAUNCHES = 0


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
    global LAUNCHES
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
            stream,
        )
    LIBRARY.check("gather_rows", err)
    LAUNCHES += 1
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
