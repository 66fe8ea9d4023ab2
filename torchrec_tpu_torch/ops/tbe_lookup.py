"""K1: the pooled embedding lookup as a hand-written CUDA kernel.

Counterpart of `tbe_lookup_pooled` in torchrec_tpu/ops/pallas_embedding.py
(:298-372, the Pallas body `_lookup_kernel` at :235). The CUDA source is
csrc/tbe_lookup.cu; it is compiled with `nvcc` for sm_90a into a shared
library with a plain C interface on first use and bound with `ctypes`
(ops/cuda_build.py). A row takes `lanes_per_row(D)` lanes
(ops/lane_groups.py): at D <= 64 a warp pools several bags, one per lane
group; wider rows take a warp each.

`tbe_lookup_pooled` is a `torch.autograd.Function`. Its forward launches
the kernel for CUDA tensors and takes the plain PyTorch version,
`tbe_lookup_pooled_reference`, only for CPU tensors; a failed build or
launch raises, nothing falls back. Its backward ports the Pallas VJP
(`_tbe_lookup_bwd`, :380-394): `d_W` is the dense scatter-add of
`coeff[b, l] * d_out[b]` with JAX's drop/wrap index semantics, and
`d_coeff[b, l] = <W[clip(ids[b, l])], d_out[b]>` with the rows gathered
through K8 (ops/gather_rows.py), as the Pallas VJP gathers them through
its `gather_rows`. The ids get no gradient.

K1h is the same kernel over bf16 / fp16 tables (the rows widened to f32,
the sum and the output f32), where the JAX package pools such tables with
an XLA gather and einsum (torchrec_tpu/ops/embedding.py:77-116). The same
wrapper and Function take it: the table's dtype picks the kernel, each with
its own launch counter (utils/tracing.py). Its VJP is K1's; `d_coeff`
gathers the half rows with plain torch indexing, since K8 takes f32
tables only, and `d_W` comes back in the table's dtype.

K1j, `tbe_lookup_jagged_forward`, is the offsets form of the same lookup
(the same source file), with no JAX counterpart: a jagged batch's bags
pool `ids[offsets[b]:offsets[b + 1]]`, so a multi-hot batch of bags of
many lengths moves its real ids only, where the padded form reads max L
slots a bag. It is a forward alone; the sharded EBC's DATA_PARALLEL
strategy takes it outside autograd and updates from the pooled cotangent
itself (parallel/strategies.py).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from torchrec_tpu_torch.ops.cuda_build import CudaLibrary
from torchrec_tpu_torch.ops.gather_rows import (
    gather_rows_forward,
    gather_rows_reference,
    scatter_add_rows,
)
from torchrec_tpu_torch.ops.lane_groups import lanes_per_row
from torchrec_tpu_torch.utils import tracing


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.trt_tbe_lookup_pooled_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    fn = lib.trt_tbe_lookup_pooled_half
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int
    fn = lib.trt_tbe_lookup_jagged
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("tbe_lookup.cu", _bind)

# the table dtypes the kernels take: K1 f32, K1h bf16 (code 0) and fp16 (1)
HALF_TYPES = {torch.bfloat16: 0, torch.float16: 1}
TABLE_TYPES = (torch.float32, *HALF_TYPES)
# the span around each launch, or the plain version on the CPU
KERNEL_SPAN = "## lookup_kernel ##"


def _check(weights: torch.Tensor, flat_ids: torch.Tensor,
           coeff: torch.Tensor) -> None:
    if weights.dtype not in TABLE_TYPES or weights.dim() != 2:
        raise TypeError(
            f"weights must be a 2-D float32, bfloat16 or float16 tensor, got "
            f"{weights.dtype} {tuple(weights.shape)}"
        )
    if flat_ids.dtype != torch.int32 or flat_ids.dim() != 2:
        raise TypeError(
            f"flat_ids must be a 2-D int32 tensor, got {flat_ids.dtype} "
            f"{tuple(flat_ids.shape)}"
        )
    if coeff.dtype != torch.float32 or coeff.shape != flat_ids.shape:
        raise TypeError(
            f"coeff must be float32 of shape {tuple(flat_ids.shape)}, got "
            f"{coeff.dtype} {tuple(coeff.shape)}"
        )
    devices = {weights.device, flat_ids.device, coeff.device}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    if weights.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {weights.device}")
    for name, t in (("weights", weights), ("flat_ids", flat_ids),
                    ("coeff", coeff)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weights.shape[0] == 0 and flat_ids.numel():
        raise ValueError("weights has no rows to look up")


def tbe_lookup_pooled_reference(
    weights: torch.Tensor, flat_ids: torch.Tensor, coeff: torch.Tensor
) -> torch.Tensor:
    """Plain PyTorch version: out[b] = sum_l coeff[b, l] * W[clip(ids)],
    half rows widened to f32."""
    R = weights.shape[0]
    rows = weights[flat_ids.clamp(0, max(R - 1, 0)).long()].float()
    return (rows * coeff[..., None]).sum(-2)


def tbe_lookup_pooled_forward(
    weights: torch.Tensor, flat_ids: torch.Tensor, coeff: torch.Tensor
) -> torch.Tensor:
    """The forward alone, outside autograd: K1 (K1h for a half table) for
    CUDA tensors, the plain version for CPU tensors. Launches count as
    `tbe_lookup` (K1) and `tbe_lookup_half` (K1h)."""
    _check(weights, flat_ids, coeff)
    with tracing.span(KERNEL_SPAN):
        if weights.device.type == "cpu":
            return tbe_lookup_pooled_reference(weights, flat_ids, coeff)
        R, D = weights.shape
        NB, L = flat_ids.shape
        out = torch.empty((NB, D), dtype=torch.float32, device=weights.device)
        if NB == 0 or D == 0:
            return out
        group = lanes_per_row(D)
        lib = LIBRARY.load()
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        half = HALF_TYPES.get(weights.dtype)
        with torch.cuda.device(weights.device):
            if half is None:
                err = lib.trt_tbe_lookup_pooled_f32(
                    weights.data_ptr(), flat_ids.data_ptr(),
                    coeff.data_ptr(), out.data_ptr(), R, D, NB, L, group,
                    stream,
                )
            else:
                err = lib.trt_tbe_lookup_pooled_half(
                    weights.data_ptr(), flat_ids.data_ptr(),
                    coeff.data_ptr(), out.data_ptr(), R, D, NB, L, group,
                    half, stream,
                )
        LIBRARY.check("tbe_lookup_pooled", err)
        tracing.count("tbe_lookup" if half is None else "tbe_lookup_half")
        return out


class TbeLookupPooled(torch.autograd.Function):
    """K1 forward; the Pallas VJP's backward (see the module docstring)."""

    @staticmethod
    def forward(ctx, weights: torch.Tensor, flat_ids: torch.Tensor,
                coeff: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(weights, flat_ids, coeff)
        return tbe_lookup_pooled_forward(weights, flat_ids, coeff)

    @staticmethod
    def backward(ctx, d_out: torch.Tensor):
        weights, flat_ids, coeff = ctx.saved_tensors
        NB, L = flat_ids.shape
        d_w = d_coeff = None
        if ctx.needs_input_grad[0]:
            row_grads = d_out[:, None, :] * coeff[:, :, None]
            d_w = scatter_add_rows(weights.shape[0], flat_ids.reshape(-1),
                                   row_grads.reshape(NB * L, -1))
            d_w = d_w.to(weights.dtype)
        if ctx.needs_input_grad[2]:
            flat = flat_ids.reshape(-1)
            rows = (gather_rows_forward(weights, flat)
                    if weights.dtype == torch.float32
                    else gather_rows_reference(weights, flat).float())
            d_coeff = (rows.reshape(NB, L, -1) * d_out[:, None, :]).sum(-1)
        return d_w, None, d_coeff


def tbe_lookup_pooled(
    weights: torch.Tensor, flat_ids: torch.Tensor, coeff: torch.Tensor
) -> torch.Tensor:
    """Fused gather + pool: out[b] = sum_l coeff[b, l] * W[clip(ids[b, l])].

    weights [R, D] f32, bf16 or fp16; flat_ids [NB, L] int32 global rows
    (clamped to [0, R-1]); coeff [NB, L] f32 carrying the validity mask,
    per-sample weights and 1/len for MEAN. Returns [NB, D] f32. CUDA
    tensors launch K1 (K1h for a half table); CPU tensors take
    `tbe_lookup_pooled_reference`. Slots whose coefficient
    is 0 are not read by the kernel, so with a non-finite row there the two
    differ (the reference gives 0 * inf = nan). Differentiable in `weights`
    and `coeff` (see `TbeLookupPooled`).
    """
    return TbeLookupPooled.apply(weights, flat_ids, coeff)


# the cap of a jagged lookup that takes every id of every bag
NO_CAP = 2**31 - 1


def _check_jagged(weights: torch.Tensor, ids: torch.Tensor,
                  offsets: torch.Tensor,
                  coeff: Optional[torch.Tensor]) -> None:
    if weights.dtype not in TABLE_TYPES or weights.dim() != 2:
        raise TypeError(
            f"weights must be a 2-D float32, bfloat16 or float16 tensor, got "
            f"{weights.dtype} {tuple(weights.shape)}"
        )
    for name, t in (("ids", ids), ("offsets", offsets)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise TypeError(f"{name} must be a 1-D int32 tensor, got "
                            f"{t.dtype} {tuple(t.shape)}")
    if offsets.shape[0] < 1:
        raise ValueError("offsets needs at least one entry")
    if coeff is not None and (coeff.dtype != torch.float32
                              or coeff.shape != ids.shape):
        raise TypeError(
            f"coeff must be float32 of shape {tuple(ids.shape)}, got "
            f"{coeff.dtype} {tuple(coeff.shape)}"
        )
    tensors = [("weights", weights), ("ids", ids), ("offsets", offsets)]
    if coeff is not None:
        tensors.append(("coeff", coeff))
    devices = {t.device for _, t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    if weights.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {weights.device}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if weights.shape[0] == 0 and ids.numel():
        raise ValueError("weights has no rows to look up")


def jagged_padded(
    ids: torch.Tensor, offsets: torch.Tensor,
    coeff: Optional[torch.Tensor] = None, cap: int = NO_CAP,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bags of the offsets form padded to `cap` slots (to the longest
    bag where `cap` is NO_CAP), K1's input for the same sums: [NB, L]
    int32 ids, 0 in a pad slot, and [NB, L] f32 coefficients, 0 in a pad
    slot and 1 on a real id where `coeff` is None."""
    lengths = (offsets[1:] - offsets[:-1]).clamp(max=cap)
    L = cap if cap < NO_CAP else (
        int(lengths.max()) if lengths.numel() else 0)
    col = torch.arange(L, device=ids.device)
    real = col[None, :] < lengths[:, None]
    src = (offsets[:-1, None].long() + col[None, :]).clamp(
        0, max(ids.shape[0] - 1, 0))
    flat = torch.where(real, ids[src], 0) if L else src.to(torch.int32)
    c = real.float()
    if coeff is not None and L:
        c = torch.where(real, coeff[src], 0.0)
    return flat.to(torch.int32).contiguous(), c.contiguous()


def tbe_lookup_jagged_reference(
    weights: torch.Tensor, ids: torch.Tensor, offsets: torch.Tensor,
    coeff: Optional[torch.Tensor] = None, cap: int = NO_CAP,
) -> torch.Tensor:
    """Plain PyTorch version of the offsets form: the bags padded to `cap`
    slots (`jagged_padded`), then K1's plain version over them. A bag
    padded to the padded route's L sums as K1's plain version sums that
    route's bag, bit for bit (torch's sum over the slots groups its terms
    by their number)."""
    return tbe_lookup_pooled_reference(
        weights, *jagged_padded(ids, offsets, coeff, cap))


def tbe_lookup_jagged_forward(
    weights: torch.Tensor, ids: torch.Tensor, offsets: torch.Tensor,
    coeff: Optional[torch.Tensor] = None, cap: int = NO_CAP,
) -> torch.Tensor:
    """K1j, the offsets form of the pooled lookup, outside autograd: bag b
    pools W[clip(ids[n])] times coeff[n] (times 1 where `coeff` is None)
    for n from offsets[b] over its first min(offsets[b + 1] - offsets[b],
    cap) ids, so only the batch's real ids are read.

    weights [R, D] f32, bf16 or fp16 (a half table's coefficients already
    rounded to its dtype, as `pooled_lookup` rounds them); ids [N] int32
    global rows (slots past offsets[-1] are read by no bag); offsets
    [NB + 1] int32; coeff [N] f32 or None. Returns [NB, D] f32. CUDA
    tensors launch the kernel (counted as `tbe_lookup_jagged`, f32 and half
    tables alike); CPU tensors take `tbe_lookup_jagged_reference`."""
    _check_jagged(weights, ids, offsets, coeff)
    with tracing.span(KERNEL_SPAN):
        if weights.device.type == "cpu":
            return tbe_lookup_jagged_reference(weights, ids, offsets, coeff,
                                               cap)
        R, D = weights.shape
        NB = offsets.shape[0] - 1
        out = torch.empty((NB, D), dtype=torch.float32, device=weights.device)
        if NB == 0 or D == 0:
            return out
        lib = LIBRARY.load()
        stream = torch.cuda.current_stream(weights.device).cuda_stream
        with torch.cuda.device(weights.device):
            err = lib.trt_tbe_lookup_jagged(
                weights.data_ptr(), ids.data_ptr(), offsets.data_ptr(),
                None if coeff is None else coeff.data_ptr(), out.data_ptr(),
                R, D, NB, min(int(cap), NO_CAP), lanes_per_row(D),
                HALF_TYPES.get(weights.dtype, -1), stream,
            )
        LIBRARY.check("tbe_lookup_jagged", err)
        tracing.count("tbe_lookup_jagged")
        return out
