"""Build a CUDA source of csrc/ into a shared library and load it.

Each kernel source has a plain C interface. It is compiled with `nvcc` for
sm_90a on first use into csrc/_build/ (git-ignored), under a name that
hashes the source and the flags, so an edit of either rebuilds it; the
library is written to a temporary name and renamed into place, so a build
cut short never leaves a half-written library behind. It is loaded with
`ctypes`; nothing here imports PyTorch's C++ headers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Optional

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels "
            "are built from torchrec_tpu_torch/csrc/ at first use"
        )
    return path


class CudaLibrary:
    """One csrc/ source built into one shared library.

    source: file name under csrc/; bind: sets `argtypes`/`restype` of the
    library's entry points after it is loaded. Every library exports
    `trt_cuda_error_string(int) -> const char*`.
    """

    def __init__(self, source: str, bind: Callable[[ctypes.CDLL], None]):
        self.source = CSRC / source
        self._bind = bind
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        """Where the library built from the current source and flags
        lives."""
        h = hashlib.sha256(self.source.read_bytes())
        h.update("\0".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}_{h.hexdigest()[:12]}.so"

    def build(self, force: bool = False) -> dict:
        """Compile the source unless the library for this exact source and
        these flags exists. Returns {"path", "seconds", "compiled",
        "ptxas"}; `ptxas` holds `-Xptxas -v`'s register and spill report
        when it compiled."""
        out = self.path()
        if out.exists() and not force:
            return {"path": str(out), "seconds": 0.0, "compiled": False,
                    "ptxas": ""}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.{id(self)}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(self.source)]
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

    def load(self) -> ctypes.CDLL:
        """The loaded library, built first if needed."""
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(self.build()["path"])
                lib.trt_cuda_error_string.argtypes = [ctypes.c_int]
                lib.trt_cuda_error_string.restype = ctypes.c_char_p
                self._bind(lib)
                self._lib = lib
            return self._lib

    def check(self, name: str, err: int) -> None:
        """Raise if a launch returned a CUDA error."""
        if err != 0:
            msg = self.load().trt_cuda_error_string(err).decode()
            raise RuntimeError(f"{name} launch failed: {msg} ({err})")
