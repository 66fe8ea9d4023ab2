"""Build a C++ source of csrc/ with g++ into a shared library and load it.

The port's own recipe, for the ctypes-loaded host libraries (the serving
queue, csrc/serving_queue.cpp). A source is built on first use into
csrc/_build/ (git-ignored) under a name that hashes the source and the
flags, compiled to a private temporary file and published with
`os.replace`, so a process racing the compile never loads a half-written
library. A failed build raises with g++'s output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = CSRC / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-pthread", "-std=c++17")


def native_lib_path(src_basename: str) -> Path:
    """Where the library built from the current source and flags lives."""
    src = CSRC / src_basename
    h = hashlib.sha256(src.read_bytes())
    h.update("\0".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


def build_native_lib(src_basename: str, force: bool = False) -> ctypes.CDLL:
    """Build csrc/<src_basename> unless its library exists (or `force`),
    and load it. Raises RuntimeError with g++'s output if it fails."""
    src = CSRC / src_basename
    out = native_lib_path(src_basename)
    if force or not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = ["g++", *GXX_FLAGS, str(src), "-o", str(tmp)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise RuntimeError(f"g++ could not run: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(
                f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, out)
    return ctypes.CDLL(str(out))
