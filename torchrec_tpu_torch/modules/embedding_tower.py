"""Embedding towers: an embedding module beside its interaction module.

Counterpart of torchrec_tpu/modules/embedding_tower.py. The distributed
layer places a whole tower on one rank (parallel/tower_sharding.py).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_modules import SparseInput


class EmbeddingTower(nn.Module):
    """An embedding module and its interaction module.

    Contract: the interaction module takes the pooled values [B, sum(table
    dims x features)] in declaration order, the input the sharded tower
    gives it on its rank, so that the authored and the sharded paths
    agree."""

    def __init__(self, embedding_module: nn.Module,
                 interaction_module: nn.Module):
        super().__init__()
        self.embedding_module = embedding_module
        self.interaction_module = interaction_module

    def forward(self, features: SparseInput) -> torch.Tensor:
        embeddings = self.embedding_module(features)
        values = getattr(embeddings, "values", embeddings)
        return self.interaction_module(values)


class EmbeddingTowerCollection(nn.Module):
    """Towers whose outputs are concatenated along dim 1, in tower
    order."""

    def __init__(self, towers: Sequence[EmbeddingTower]):
        super().__init__()
        self.towers = nn.ModuleList(towers)
        self.flax_names = {f"towers_{i}": f"towers.{i}"
                           for i in range(len(self.towers))}

    def forward(self, features: SparseInput) -> torch.Tensor:
        return torch.cat([tower(features) for tower in self.towers], dim=1)
