"""The DLRM's dot interaction as one hand-written CUDA kernel a direction.

For dense [B, D] and sparse [B, F, D], with C = [dense; sparse] the
[B, n, D] rows of each example (n = F + 1), the forward returns
[B, D + P]: `dense` followed by the upper triangle (offset 1) of each
example's n x n Gram matrix C C^T, row-major in `torch.triu_indices(n, n,
1)` order (P = n (n - 1) / 2), which is what the DLRM's InteractionArch
returns. The backward spreads the output gradient's P products into the
symmetric n x n matrix S with a zero diagonal and returns
`d_dense = grad_out[:, :D] + (S C)[:, 0]` and `d_sparse = (S C)[:, 1:]`.

The CUDA source is csrc/dot_interaction.cu; it is compiled with `nvcc`
for sm_90a into a shared library with a plain C interface on first use
and bound with `ctypes` (ops/cuda_build.py). No `pl.pallas_call` is
replaced: the JAX package leaves the interaction's einsum and upper-
triangle gather to XLA. The kernel takes the place of the composition
that the plain version below spells out: the concatenation that builds C,
the Gram `torch.bmm`, the gather and the output's concatenation, and in
the backward the gather's sorted scatter and the bmm's two products. The
forward sums each product as one f32 FMA chain over ascending d, the
order of a SIMT GEMM thread; it takes (n, D) from its inputs and reads C
in float4s where D is a multiple of 4 and the pointers 16-byte aligned,
else element by element. n is at most `MAX_ROWS`.

`dot_interaction` is a `torch.autograd.Function`: CUDA tensors launch the
kernels, CPU tensors take `dot_interaction_reference` and
`dot_interaction_backward_reference` (the explicit `S C`); a failed build
or launch raises, nothing falls back. Launches count (utils/tracing.py)
as `dot_interaction` and `dot_interaction_bwd`.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from torchrec_tpu_torch.ops.cuda_build import CudaLibrary
from torchrec_tpu_torch.utils import tracing


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.trt_dot_interaction_fwd_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.trt_dot_interaction_bwd_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("dot_interaction.cu", _bind)

# the largest n = F + 1 the kernels take (kMaxRows in the source)
MAX_ROWS = 64


def _check(dense: torch.Tensor, sparse: torch.Tensor) -> None:
    if dense.dim() != 2 or sparse.dim() != 3:
        raise ValueError(
            f"dense must be [B, D] and sparse [B, F, D], got "
            f"{tuple(dense.shape)} and {tuple(sparse.shape)}"
        )
    B, D = dense.shape
    if sparse.shape[0] != B or sparse.shape[2] != D or sparse.shape[1] < 1:
        raise ValueError(
            f"sparse must be [{B}, F >= 1, {D}], got {tuple(sparse.shape)}"
        )
    if dense.device != sparse.device:
        raise ValueError(
            f"tensors on different devices: {dense.device}, {sparse.device}"
        )
    if dense.device.type == "cpu":
        if not dense.is_floating_point() or sparse.dtype != dense.dtype:
            raise TypeError(
                f"dense and sparse must share one floating dtype, got "
                f"{dense.dtype} and {sparse.dtype}"
            )
        return
    if dense.device.type != "cuda":
        raise ValueError(f"unsupported device {dense.device}")
    if dense.dtype != torch.float32 or sparse.dtype != torch.float32:
        raise TypeError(
            f"the kernel takes float32, got {dense.dtype} and {sparse.dtype}"
        )
    if not (dense.is_contiguous() and sparse.is_contiguous()):
        raise ValueError("dense and sparse must be contiguous")
    if sparse.shape[1] + 1 > MAX_ROWS:
        raise ValueError(
            f"the kernel takes at most {MAX_ROWS - 1} sparse features, got "
            f"{sparse.shape[1]}"
        )


def dot_interaction_reference(dense: torch.Tensor,
                              sparse: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the forward: the Gram bmm of
    C = [dense; sparse], its upper triangle, after `dense`."""
    n = sparse.shape[1] + 1
    combined = torch.cat([dense[:, None, :], sparse], dim=1)
    gram = torch.bmm(combined, combined.transpose(1, 2))
    iu, ju = torch.triu_indices(n, n, offset=1, device=dense.device)
    return torch.cat([dense, gram[:, iu, ju]], dim=1)


def dot_interaction_backward_reference(
    grad_out: torch.Tensor, dense: torch.Tensor, sparse: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward: S from grad_out's products,
    then (d_dense, d_sparse) from S C."""
    B, D = dense.shape
    n = sparse.shape[1] + 1
    combined = torch.cat([dense[:, None, :], sparse], dim=1)
    iu, ju = torch.triu_indices(n, n, offset=1, device=dense.device)
    S = grad_out.new_zeros((B, n, n))
    S[:, iu, ju] = grad_out[:, D:]
    S = S + S.transpose(1, 2)
    d_combined = torch.bmm(S, combined)
    return grad_out[:, :D] + d_combined[:, 0], d_combined[:, 1:].contiguous()


def dot_interaction_forward(dense: torch.Tensor,
                            sparse: torch.Tensor) -> torch.Tensor:
    """The forward alone, outside autograd: the kernel for CUDA tensors,
    the plain version for CPU tensors."""
    _check(dense, sparse)
    if dense.device.type == "cpu":
        return dot_interaction_reference(dense, sparse)
    B, D = dense.shape
    n = sparse.shape[1] + 1
    out = torch.empty((B, D + n * (n - 1) // 2), dtype=torch.float32,
                      device=dense.device)
    if B == 0:
        return out
    lib = LIBRARY.load()
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream(dense.device).cuda_stream
        err = lib.trt_dot_interaction_fwd_f32(
            dense.data_ptr(), sparse.data_ptr(), out.data_ptr(), B, n, D,
            stream)
    LIBRARY.check("dot_interaction", err)
    tracing.count("dot_interaction")
    return out


def dot_interaction_backward(
    grad_out: torch.Tensor, dense: torch.Tensor, sparse: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backward alone: (d_dense, d_sparse) from the kernel for CUDA
    tensors, from the plain version for CPU tensors."""
    _check(dense, sparse)
    B, D = dense.shape
    n = sparse.shape[1] + 1
    if tuple(grad_out.shape) != (B, D + n * (n - 1) // 2):
        raise ValueError(
            f"grad_out must be [{B}, {D + n * (n - 1) // 2}], got "
            f"{tuple(grad_out.shape)}"
        )
    if dense.device.type == "cpu":
        return dot_interaction_backward_reference(grad_out, dense, sparse)
    if grad_out.dtype != torch.float32 or grad_out.device != dense.device:
        raise TypeError(
            f"grad_out must be float32 on {dense.device}, got "
            f"{grad_out.dtype} on {grad_out.device}"
        )
    grad_out = grad_out.contiguous()
    d_dense = torch.empty_like(dense)
    d_sparse = torch.empty_like(sparse)
    if B == 0:
        return d_dense, d_sparse
    lib = LIBRARY.load()
    with torch.cuda.device(dense.device):
        stream = torch.cuda.current_stream(dense.device).cuda_stream
        err = lib.trt_dot_interaction_bwd_f32(
            grad_out.data_ptr(), dense.data_ptr(), sparse.data_ptr(),
            d_dense.data_ptr(), d_sparse.data_ptr(), B, n, D, stream)
    LIBRARY.check("dot_interaction_bwd", err)
    tracing.count("dot_interaction_bwd")
    return d_dense, d_sparse


class DotInteraction(torch.autograd.Function):
    """The kernel's forward and backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, dense: torch.Tensor,
                sparse: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(dense, sparse)
        return dot_interaction_forward(dense, sparse)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        dense, sparse = ctx.saved_tensors
        return dot_interaction_backward(grad_out, dense, sparse)


def dot_interaction(dense: torch.Tensor,
                    sparse: torch.Tensor) -> torch.Tensor:
    """dense [B, D] and sparse [B, F, D] -> [B, D + (F+1) F / 2]: `dense`
    beside the pairwise dot products of its rows and sparse's, the upper
    triangle of their Gram matrix. float32 contiguous CUDA tensors launch
    the kernels; CPU tensors take the plain versions. Differentiable in
    both inputs (see `DotInteraction`)."""
    return DotInteraction.apply(dense, sparse)
