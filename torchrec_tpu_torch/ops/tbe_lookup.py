"""K1: the pooled embedding lookup as a hand-written CUDA kernel.

Counterpart of `tbe_lookup_pooled` in torchrec_tpu/ops/pallas_embedding.py
(:298-372, the Pallas body `_lookup_kernel` at :235). The CUDA source is
csrc/tbe_lookup.cu; it is compiled with `nvcc` for sm_90a into a shared
library with a plain C interface on first use and bound with `ctypes`.

`tbe_lookup_pooled` launches the kernel for CUDA tensors and takes the plain
PyTorch version, `tbe_lookup_pooled_reference`, only for CPU tensors. A
failed build or launch raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCE = CSRC / "tbe_lookup.cu"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Kernel launches made by `tbe_lookup_pooled` in this process.
LAUNCHES = 0

_LIB: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the K1 kernel "
            "is built from csrc/tbe_lookup.cu at first use"
        )
    return path


def library_path() -> Path:
    """Where the library built from the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"libtbe_lookup_{digest}.so"


def build(force: bool = False) -> dict:
    """Compile csrc/tbe_lookup.cu unless the library for this exact source
    and these flags exists. Returns {"path", "seconds", "compiled", "ptxas"}; `ptxas` holds
    `-Xptxas -v`'s register and spill report when it compiled."""
    out = library_path()
    if out.exists() and not force:
        return {"path": str(out), "seconds": 0.0, "compiled": False,
                "ptxas": ""}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
           str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return {"path": str(out), "seconds": seconds, "compiled": True,
            "ptxas": proc.stdout + proc.stderr}


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build()["path"])
        fn = lib.trt_tbe_lookup_pooled_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int64] * 4 + [
            ctypes.c_void_p
        ]
        fn.restype = ctypes.c_int
        lib.trt_cuda_error_string.argtypes = [ctypes.c_int]
        lib.trt_cuda_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


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
            "comes with the training slice. Call it under torch.no_grad() "
            "or torch.inference_mode()."
        )
    if weights.device.type == "cpu":
        return tbe_lookup_pooled_reference(weights, flat_ids, coeff)
    R, D = weights.shape
    NB, L = flat_ids.shape
    out = torch.empty((NB, D), dtype=torch.float32, device=weights.device)
    if NB == 0 or D == 0:
        return out
    lib = _library()
    stream = torch.cuda.current_stream(weights.device).cuda_stream
    with torch.cuda.device(weights.device):
        err = lib.trt_tbe_lookup_pooled_f32(
            weights.data_ptr(), flat_ids.data_ptr(), coeff.data_ptr(),
            out.data_ptr(), R, D, NB, L, stream,
        )
    if err != 0:
        raise RuntimeError(
            "tbe_lookup_pooled launch failed: "
            f"{lib.trt_cuda_error_string(err).decode()} ({err})"
        )
    LAUNCHES += 1
    return out
