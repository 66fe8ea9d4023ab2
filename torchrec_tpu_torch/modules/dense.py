"""flax's `nn.Dense` as an `nn.Linear`, and its kernel initializer.

flax draws a Dense kernel [in, out] lecun_normal: a normal truncated at 2
sigma and scaled to variance 1/fan_in, with fan_in the kernel's
second-to-last dim. The port keeps the [out, in] weight of `nn.Linear`
(utils/jax_bridge.py transposes), and biases are zero.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

# flax's variance_scaling: the std of a standard normal truncated to
# [-2, 2], by which the truncated draw is divided
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> None:
    """Draw `tensor` in place from flax's lecun_normal for `fan_in`."""
    std = (1.0 / fan_in) ** 0.5 / _TRUNCATED_STD
    nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)


class Dense(nn.Linear):
    """flax `nn.Dense`: lecun_normal kernel, zero bias (none when `bias`
    is False, flax's use_bias=False), fp32."""

    def __init__(self, in_features: int, out_features: int,
                 device: DeviceLike = None, bias: bool = True):
        super().__init__(in_features, out_features, bias=bias,
                         device=resolve_device(device), dtype=torch.float32)

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        lecun_normal_(self.weight, self.in_features, generator)
        if self.bias is not None:
            nn.init.zeros_(self.bias)
