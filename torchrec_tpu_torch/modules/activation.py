"""Activation modules, and the flax-style LayerNorm they and BERT4Rec use.

Counterpart of torchrec_tpu/modules/activation.py. `LayerNorm` is flax's
`nn.LayerNorm` as a `torch.nn.LayerNorm`: epsilon 1e-6 (torch's default
is 1e-5), scale ones, bias zeros. `SwishLayerNorm` computes
x * sigmoid(LayerNorm(x)); flax infers the width from the input, torch
takes it at construction. `flax_names` maps the flax auto-name of its
LayerNorm to its attribute, for the weight bridge.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


class LayerNorm(nn.LayerNorm):
    """flax `nn.LayerNorm`: epsilon 1e-6, scale ones, bias zeros."""

    def __init__(self, dim: int, device: DeviceLike = None):
        super().__init__(dim, eps=1e-6, device=resolve_device(device),
                         dtype=torch.float32)

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        nn.init.ones_(self.weight)
        nn.init.zeros_(self.bias)


class SwishLayerNorm(nn.Module):
    """x * sigmoid(LayerNorm(x)) over the last dim, of width `input_dims`."""

    flax_names = {"LayerNorm_0": "norm"}

    def __init__(self, input_dims: int, device: DeviceLike = None):
        super().__init__()
        self.norm = LayerNorm(input_dims, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * torch.sigmoid(self.norm(x))
