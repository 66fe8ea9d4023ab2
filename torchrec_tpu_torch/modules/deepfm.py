"""DeepFM's interaction modules (ref torchrec/modules/deepfm.py:35,133).

Counterpart of torchrec_tpu/modules/deepfm.py. Both take a list of
tensors, [B, ...] each, flattened to [B, -1] and concatenated. The JAX
package leaves them to XLA outside any Pallas kernel; here they are
tensor ops and the deep module's `nn.Linear`.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn


def _flatten_cat(inputs: Sequence[torch.Tensor]) -> torch.Tensor:
    """Each input viewed as [B, -1], concatenated along dim 1."""
    B = inputs[0].shape[0]
    return torch.cat([x.reshape(B, -1) for x in inputs], dim=1)


class DeepFM(nn.Module):
    """DeepFM's deep part: the dense `deep_module` over the flattened
    concatenation of its inputs."""

    def __init__(self, deep_module: nn.Module):
        super().__init__()
        self.deep_module = deep_module

    def forward(self, embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
        return self.deep_module(_flatten_cat(embeddings))


class FactorizationMachine(nn.Module):
    """The O(N) factorization-machine interaction over the flattened
    concatenation x [B, N]: 0.5 * ((sum x)^2 - sum x^2) per row, [B, 1].
    A difference of two large sums: it cancels, so compare it with a
    tolerance relative to (sum x)^2 + sum x^2."""

    def forward(self, embeddings: Sequence[torch.Tensor]) -> torch.Tensor:
        x = _flatten_cat(embeddings)
        sum_sq = torch.square(torch.sum(x, dim=1, keepdim=True))
        sq_sum = torch.sum(torch.square(x), dim=1, keepdim=True)
        return 0.5 * (sum_sq - sq_sum)
