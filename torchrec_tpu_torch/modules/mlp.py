"""Perceptron / MLP building blocks.

Counterpart of torchrec_tpu/modules/mlp.py. `dtype` is the compute dtype;
parameters stay fp32. `flax_names` maps the flax auto-names of a module's
children to its attributes, for the weight bridge (utils/jax_bridge.py).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


class Perceptron(nn.Module):
    """Linear + activation, initialised U(-1/sqrt(in), 1/sqrt(in)) for
    weight and bias alike."""

    flax_names = {"Dense_0": "linear"}

    def __init__(
        self,
        in_size: int,
        out_size: int,
        bias: bool = True,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.linear = nn.Linear(
            in_size, out_size, bias=bias, device=resolve_device(device),
            dtype=torch.float32,
        )
        self.activation = activation
        self.dtype = dtype

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        bound = 1.0 / self.linear.in_features ** 0.5
        for p in self.linear.parameters():
            p.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.linear.weight, self.linear.bias
        if self.dtype is not None:
            x, w = x.to(self.dtype), w.to(self.dtype)
            b = None if b is None else b.to(self.dtype)
        return self.activation(F.linear(x, w, b))


class MLP(nn.Module):
    """Stack of Perceptrons."""

    def __init__(
        self,
        in_size: int,
        layer_sizes: Sequence[int],
        bias: bool = True,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
        dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        sizes = [in_size, *layer_sizes]
        self.perceptrons = nn.ModuleList(
            Perceptron(sizes[i], sizes[i + 1], bias=bias,
                       activation=activation, dtype=dtype, device=device)
            for i in range(len(layer_sizes))
        )
        self.flax_names = {f"Perceptron_{i}": f"perceptrons.{i}"
                           for i in range(len(layer_sizes))}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for p in self.perceptrons:
            x = p(x)
        return x
