"""Cross networks, the DCN / DCN-V2 family (ref torchrec/modules/crossnet.py).

Counterpart of torchrec_tpu/modules/crossnet.py. Each variant maps
[B, N] to [B, N] through `num_layers` crosses x_{l+1} = x0 * f_l(x_l) +
x_l. The JAX package leaves them to XLA outside any Pallas kernel; here
they are `nn.Linear`s (flax-style `Dense`, modules/dense.py) and tensor
ops. `flax_names` maps each flax child or parameter (`cross_{i}`, `V_{i}`,
`W_{i}`, `weight_{i}`, `bias_{i}`, `V_{i}_{e}`, `C_{i}_{e}`, `U_{i}_{e}`,
`gate_{i}_{e}`) to its attribute, for the weight bridge. Kernels are
drawn lecun_normal and biases are zero, as flax draws them.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from torchrec_tpu_torch.modules.dense import Dense, lecun_normal_
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


class CrossNet(nn.Module):
    """Full rank: x_{l+1} = x0 * (W_l x_l + b_l) + x_l (ref
    crossnet.py:19)."""

    def __init__(self, in_features: int, num_layers: int,
                 device: DeviceLike = None):
        super().__init__()
        self.cross = nn.ModuleList(Dense(in_features, in_features, device)
                                   for _ in range(num_layers))
        self.flax_names = {f"cross_{i}": f"cross.{i}"
                           for i in range(num_layers)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x
        for layer in self.cross:
            x = x0 * layer(x) + x
        return x


class LowRankCrossNet(nn.Module):
    """x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l with rank-`low_rank`
    factors (ref crossnet.py:92)."""

    def __init__(self, in_features: int, num_layers: int, low_rank: int,
                 device: DeviceLike = None):
        super().__init__()
        self.V = nn.ModuleList(Dense(in_features, low_rank, device,
                                     bias=False) for _ in range(num_layers))
        self.W = nn.ModuleList(Dense(low_rank, in_features, device)
                               for _ in range(num_layers))
        self.flax_names = {f"{n}_{i}": f"{n}.{i}" for n in ("V", "W")
                           for i in range(num_layers)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x
        for v, w in zip(self.V, self.W):
            x = x0 * w(v(x)) + x
        return x


class VectorCrossNet(nn.Module):
    """DCN-V1: x_{l+1} = x0 <x_l, w_l> + b_l + x_l, with w_l [N, 1] (ref
    crossnet.py:191)."""

    def __init__(self, in_features: int, num_layers: int,
                 device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.weights = nn.ParameterList(
            nn.Parameter(torch.empty(in_features, 1, device=dev))
            for _ in range(num_layers))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.empty(in_features, device=dev))
            for _ in range(num_layers))
        self.flax_names = {
            **{f"weight_{i}": f"weights.{i}" for i in range(num_layers)},
            **{f"bias_{i}": f"biases.{i}" for i in range(num_layers)}}

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """Each w_l lecun_normal over its N rows, each b_l zero."""
        for w, b in zip(self.weights, self.biases):
            lecun_normal_(w, w.shape[0], generator)
            nn.init.zeros_(b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x
        for w, b in zip(self.weights, self.biases):
            x = x0 * (x @ w) + b + x
        return x


class LowRankMixtureCrossNet(nn.Module):
    """DCN-V2's mixture of low-rank experts (ref crossnet.py:271): expert e
    of layer i is x0 * U(tanh(C(tanh(V x)))); with more than one expert
    their outputs are mixed by a softmax over the gates' scores, one
    [N, 1] gate per expert."""

    def __init__(self, in_features: int, num_layers: int,
                 num_experts: int = 1, low_rank: int = 1,
                 device: DeviceLike = None):
        super().__init__()
        N, r, E = in_features, low_rank, num_experts
        self.num_experts = E

        def per_expert(make):
            return nn.ModuleList(nn.ModuleList(make() for _ in range(E))
                                 for _ in range(num_layers))

        self.V = per_expert(lambda: Dense(N, r, device, bias=False))
        self.C = per_expert(lambda: Dense(r, r, device, bias=False))
        self.U = per_expert(lambda: Dense(r, N, device))
        names = ("V", "C", "U")
        if E > 1:
            self.gate = per_expert(lambda: Dense(N, 1, device, bias=False))
            names += ("gate",)
        self.flax_names = {f"{n}_{i}_{e}": f"{n}.{i}.{e}" for n in names
                           for i in range(num_layers) for e in range(E)}

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x0 = x
        for i in range(len(self.V)):
            experts = []
            for e in range(self.num_experts):
                v = self.V[i][e](x)
                c = self.C[i][e](torch.tanh(v))
                experts.append(x0 * self.U[i][e](torch.tanh(c)))
            if self.num_experts == 1:
                out = experts[0]
            else:
                gates = torch.softmax(torch.cat(
                    [g(x) for g in self.gate[i]], dim=-1), dim=-1)  # [B, E]
                out = torch.einsum("bne,be->bn",
                                   torch.stack(experts, dim=-1), gates)
            x = out + x
        return x
