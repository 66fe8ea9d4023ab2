"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets; dense rates without sparsity, at the card's full power limit).
A share of a peak or a roofline is stated against these, with the card's
power limit printed beside it (`power_limit_w`)."""

from __future__ import annotations

import subprocess
from typing import Dict, Optional

# NVIDIA H100 SXM (torch.cuda.get_device_name: "NVIDIA H100 80GB HBM3")
H100_SXM: Dict[str, float] = {
    "float32": 67e12,  # outside the tensor cores
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
    "fp8": 1979e12,
    "int8": 1979e12,
    "hbm_bytes_per_s": 3.35e12,
}

PEAKS = {"NVIDIA H100 80GB HBM3": H100_SXM}


def peaks_for(kind: str) -> Optional[Dict[str, float]]:
    """The peaks of the card named `kind`, None for a card not listed
    (its shares are then not reported)."""
    return PEAKS.get(kind)


def power_limit_w() -> Optional[float]:
    """The first card's power limit in W from nvidia-smi, None where it
    cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.TimeoutExpired):
        return None
