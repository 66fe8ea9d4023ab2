"""Kq: the int-N row-wise quantized lookup as a hand-written CUDA kernel.

It stands for XLA code of the JAX package, not a Pallas kernel: the
gather, unpack, dequantize and pooling of `dequantize_rows` and
`quant_embedding_bag_lookup` (torchrec_tpu/ops/quant.py:68-109), the hot
sparse operation of every quantized request. The CUDA source is
csrc/quant_lookup.cu, compiled with `nvcc` for sm_90a on first use and
bound with `ctypes` (ops/cuda_build.py). A row takes `lanes_per_row(D)`
lanes (ops/lane_groups.py), passed to the launch: at D <= 64 a warp pools
several bags, one per lane group; wider rows take a warp each.

Two wrappers, each with its own launch counter (utils/tracing.py), each
launch, or plain version on the CPU, under the `## lookup_kernel ##` span:

* `quant_lookup_pooled` (counter `quant_lookup`): out[b] = sum_l
  coeff[b, l] * deq(ids[b, l]);
* `quant_lookup_rows` (counter `quant_lookup_rows`): out[n] = deq(ids[n]),
  times coeff[n] when given (PoolingMode.NONE's rows times the mask).

where deq(r) = q[r] * scale[r] + shift[r], each product and sum rounded
on its own, the pooled sum taken in slot order. CUDA tensors launch the
kernel, CPU tensors take the plain versions (`*_reference`); a failed
build or launch raises, nothing falls back. Ids are clamped to [0, R-1]
as K1 clamps them (a negative id reads row 0, where JAX's gather wraps
it). Inference only: nothing here is differentiable.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from torchrec_tpu_torch.ops.cuda_build import CudaLibrary
from torchrec_tpu_torch.ops.lane_groups import lanes_per_row
from torchrec_tpu_torch.utils import tracing


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.trt_quant_lookup_pooled
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 4 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.trt_quant_lookup_rows
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64] * 3 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("quant_lookup.cu", _bind)

BITS = (8, 4, 2)
KERNEL_SPAN = "## lookup_kernel ##"


def quant_dim(data: torch.Tensor, bits: int) -> int:
    """Row width D of packed data [R, D * bits / 8]."""
    return data.shape[1] * 8 // bits


def _check(data, scale, shift, ids, coeff, bits) -> None:
    if bits not in BITS:
        raise ValueError(f"bits must be one of {BITS}, got {bits}")
    if data.dtype != torch.uint8 or data.dim() != 2:
        raise TypeError(f"data must be a 2-D uint8 tensor, got {data.dtype} "
                        f"{tuple(data.shape)}")
    R = data.shape[0]
    for name, t in (("scale", scale), ("shift", shift)):
        if t.dtype != torch.float32 or tuple(t.shape) != (R,):
            raise TypeError(f"{name} must be float32 of shape ({R},), got "
                            f"{t.dtype} {tuple(t.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    tensors = [("data", data), ("scale", scale), ("shift", shift),
               ("ids", ids)]
    if coeff is not None:
        if coeff.dtype != torch.float32 or coeff.shape != ids.shape:
            raise TypeError(f"coeff must be float32 of shape "
                            f"{tuple(ids.shape)}, got {coeff.dtype} "
                            f"{tuple(coeff.shape)}")
        tensors.append(("coeff", coeff))
    devices = {t.device for _, t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on different devices: {devices}")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {data.device}")
    for name, t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if R == 0 and ids.numel():
        raise ValueError("data has no rows to look up")


def dequantize_reference(data: torch.Tensor, scale: torch.Tensor,
                         shift: torch.Tensor, ids: torch.Tensor,
                         bits: int) -> torch.Tensor:
    """Plain version of the gather, unpack and dequantize: [..., D] f32
    rows of ids [...] (clamped to [0, R-1]), q * scale + shift rounded
    per operation."""
    R = data.shape[0]
    D = quant_dim(data, bits)
    flat = ids.reshape(-1).clamp(0, max(R - 1, 0)).long()
    packed = data[flat]  # [N, D * bits / 8]
    per_byte = 8 // bits
    if per_byte > 1:
        shifts = torch.arange(0, 8, bits, dtype=torch.uint8,
                              device=data.device)
        q = (packed[:, :, None] >> shifts) & ((1 << bits) - 1)
        q = q.reshape(packed.shape[0], D)
    else:
        q = packed
    rows = q.to(torch.float32) * scale[flat][:, None] + shift[flat][:, None]
    return rows.reshape(*ids.shape, D)


def quant_lookup_pooled_reference(data, scale, shift, flat_ids, coeff,
                                  bits: int) -> torch.Tensor:
    """Plain version of the pooled lookup: [NB, D], the slots added in
    order to a zero sum, as the kernel adds them."""
    rows = dequantize_reference(data, scale, shift, flat_ids, bits)
    out = torch.zeros((flat_ids.shape[0], rows.shape[-1]),
                      dtype=torch.float32, device=data.device)
    for slot in range(flat_ids.shape[1]):
        out = out + coeff[:, slot, None] * rows[:, slot]
    return out


def quant_lookup_rows_reference(data, scale, shift, ids, bits: int,
                                coeff: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """Plain version of the unpooled lookup: [N, D] rows, times coeff [N]
    when given."""
    rows = dequantize_reference(data, scale, shift, ids, bits)
    return rows if coeff is None else rows * coeff[:, None]


def quant_lookup_pooled(data: torch.Tensor, scale: torch.Tensor,
                        shift: torch.Tensor, flat_ids: torch.Tensor,
                        coeff: torch.Tensor, bits: int) -> torch.Tensor:
    """Fused int-N gather, dequantize and pool.

    data uint8 [R, D * bits / 8]; scale, shift f32 [R]; flat_ids int32
    [NB, L]; coeff f32 [NB, L] carrying the validity mask, per-sample
    weights and, for the sharded MEAN, 1 / length. Returns [NB, D] f32.
    CUDA tensors launch Kq, CPU tensors take the plain version. A slot
    whose coefficient is 0 is not read by the kernel."""
    _check(data, scale, shift, flat_ids, coeff, bits)
    if flat_ids.dim() != 2:
        raise TypeError(f"flat_ids must be 2-D, got {tuple(flat_ids.shape)}")
    with tracing.span(KERNEL_SPAN):
        if data.device.type == "cpu":
            return quant_lookup_pooled_reference(data, scale, shift,
                                                 flat_ids, coeff, bits)
        lib = LIBRARY.load()
        R, D = data.shape[0], quant_dim(data, bits)
        NB, L = flat_ids.shape
        out = torch.empty((NB, D), dtype=torch.float32, device=data.device)
        if NB == 0 or D == 0:
            return out
        stream = torch.cuda.current_stream(data.device).cuda_stream
        with torch.cuda.device(data.device):
            err = lib.trt_quant_lookup_pooled(
                data.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                flat_ids.data_ptr(), coeff.data_ptr(), out.data_ptr(), R, D,
                NB, L, bits, lanes_per_row(D), stream)
        LIBRARY.check("quant_lookup_pooled", err)
        tracing.count("quant_lookup")
        return out


def quant_lookup_rows(data: torch.Tensor, scale: torch.Tensor,
                      shift: torch.Tensor, ids: torch.Tensor, bits: int,
                      coeff: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused int-N gather and dequantize: ids int32 [N] -> [N, D] f32,
    each row times coeff [N] when given. CUDA tensors launch Kq's unpooled
    mode, CPU tensors take the plain version."""
    _check(data, scale, shift, ids, coeff, bits)
    if ids.dim() != 1:
        raise TypeError(f"ids must be 1-D, got {tuple(ids.shape)}")
    with tracing.span(KERNEL_SPAN):
        if data.device.type == "cpu":
            return quant_lookup_rows_reference(data, scale, shift, ids, bits,
                                               coeff)
        lib = LIBRARY.load()
        R, D = data.shape[0], quant_dim(data, bits)
        N = ids.shape[0]
        out = torch.empty((N, D), dtype=torch.float32, device=data.device)
        if N == 0 or D == 0:
            return out
        stream = torch.cuda.current_stream(data.device).cuda_stream
        with torch.cuda.device(data.device):
            err = lib.trt_quant_lookup_rows(
                data.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                ids.data_ptr(), None if coeff is None else coeff.data_ptr(),
                out.data_ptr(), R, D, N, bits, lanes_per_row(D), stream)
        LIBRARY.check("quant_lookup_rows", err)
        tracing.count("quant_lookup_rows")
        return out
