"""K1: the pooled embedding lookup as a hand-written CUDA kernel.

Counterpart of `tbe_lookup_pooled` in torchrec_tpu/ops/pallas_embedding.py
(:298-372, the Pallas body `_lookup_kernel` at :235). The CUDA source is
csrc/tbe_lookup.cu; it is compiled with `nvcc` for sm_90a into a shared
library with a plain C interface on first use and bound with `ctypes`
(ops/cuda_build.py).

`tbe_lookup_pooled` launches the kernel for CUDA tensors and takes the plain
PyTorch version, `tbe_lookup_pooled_reference`, only for CPU tensors. A
failed build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from torchrec_tpu_torch.ops.cuda_build import CudaLibrary


def _bind(lib: ctypes.CDLL) -> None:
    fn = lib.trt_tbe_lookup_pooled_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
        ctypes.c_void_p
    ]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("tbe_lookup.cu", _bind)

# Kernel launches made by `tbe_lookup_pooled` in this process.
LAUNCHES = 0


def _check(weights: torch.Tensor, flat_ids: torch.Tensor,
           coeff: torch.Tensor) -> None:
    if weights.dtype != torch.float32 or weights.dim() != 2:
        raise TypeError(
            f"weights must be a 2-D float32 tensor, got {weights.dtype} "
            f"{tuple(weights.shape)}"
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
    """Plain PyTorch version: out[b] = sum_l coeff[b, l] * W[clip(ids)]."""
    R = weights.shape[0]
    rows = weights[flat_ids.clamp(0, max(R - 1, 0)).long()]
    return (rows * coeff[..., None]).sum(-2)


def tbe_lookup_pooled(
    weights: torch.Tensor, flat_ids: torch.Tensor, coeff: torch.Tensor
) -> torch.Tensor:
    """Fused gather + pool: out[b] = sum_l coeff[b, l] * W[clip(ids[b, l])].

    weights [R, D] f32; flat_ids [NB, L] int32 global rows (clamped to
    [0, R-1]); coeff [NB, L] f32 carrying the validity mask, per-sample
    weights and 1/len for MEAN. Returns [NB, D] f32. CUDA tensors launch K1;
    CPU tensors take `tbe_lookup_pooled_reference`. Slots whose coefficient
    is 0 are not read by the kernel, so with a non-finite row there the two
    differ (the reference gives 0 * inf = nan).
    """
    global LAUNCHES
    _check(weights, flat_ids, coeff)
    if torch.is_grad_enabled() and (weights.requires_grad or coeff.requires_grad):
        raise NotImplementedError(
            "tbe_lookup_pooled has no backward yet: K1's autograd Function "
            "comes with the row-gather kernel K8 (ROADMAP queue 1 item 5). "
            "Call it under torch.no_grad() or torch.inference_mode()."
        )
    if weights.device.type == "cpu":
        return tbe_lookup_pooled_reference(weights, flat_ids, coeff)
    R, D = weights.shape
    NB, L = flat_ids.shape
    out = torch.empty((NB, D), dtype=torch.float32, device=weights.device)
    if NB == 0 or D == 0:
        return out
    lib = LIBRARY.load()
    stream = torch.cuda.current_stream(weights.device).cuda_stream
    with torch.cuda.device(weights.device):
        err = lib.trt_tbe_lookup_pooled_f32(
            weights.data_ptr(), flat_ids.data_ptr(), coeff.data_ptr(),
            out.data_ptr(), R, D, NB, L, stream,
        )
    LIBRARY.check("tbe_lookup_pooled", err)
    LAUNCHES += 1
    return out
