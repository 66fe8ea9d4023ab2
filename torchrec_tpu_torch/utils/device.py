"""Device choice for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the one asked for, else the
    current CUDA card. Raises when none is asked for and no card is
    present, so that nothing carries on quietly on the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())
