"""ShardedEmbeddingBag: one raw embedding bag, sharded.

Counterpart of torchrec_tpu/parallel/sharded_bag.py: an adapter over
ShardedEmbeddingBagCollection with one table and one implicit feature,
whose inputs are (ids [B, L], lengths [B][, per-sample weights [B, L]])
tensors instead of a keyed batch. It is an `nn.Module` holding the
collection's buffers; `update` changes them in place.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel.sharded_ebc import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.strategies import ArrayLike
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingEnv
from torchrec_tpu_torch.sparse.jagged import PaddedSparseBatch
from torchrec_tpu_torch.utils.device import DeviceLike

_FEATURE = "__bag__"


class ShardedEmbeddingBag(nn.Module):
    """One sharded embedding bag on `env` (default: ShardingEnv(device),
    and `device` defaults to the current CUDA card):
    forward(ids [B, L], lengths [B][, per_sample_weights [B, L]]) ->
    pooled [B, D]."""

    def __init__(
        self,
        env: Optional[ShardingEnv],
        num_embeddings: int,
        embedding_dim: int,
        sharding: ParameterSharding,
        pooling: PoolingType = PoolingType.SUM,
        is_weighted: bool = False,
        optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
        optim_kwargs: Optional[dict] = None,
        name: str = "embedding_bag",
        device: DeviceLike = None,
    ):
        super().__init__()
        self.name = name
        self.is_weighted = is_weighted
        cfg = EmbeddingBagConfig(num_embeddings=num_embeddings,
                                 embedding_dim=embedding_dim, name=name,
                                 feature_names=[_FEATURE], pooling=pooling)
        self.ebc = ShardedEmbeddingBagCollection(
            env or ShardingEnv(device), (cfg,), {name: sharding},
            is_weighted=is_weighted, optim=optim, optim_kwargs=optim_kwargs)

    def init(self, generator: Optional[torch.Generator] = None):
        return self.ebc.init(generator)

    def shard_from_dense(self, weights: ArrayLike):
        return self.ebc.shard_from_dense({self.name: weights})

    def unshard_to_dense(self) -> np.ndarray:
        return self.ebc.unshard_to_dense()[self.name]

    @staticmethod
    def _batch(ids: torch.Tensor, lengths: torch.Tensor,
               per_sample_weights: Optional[torch.Tensor]
               ) -> PaddedSparseBatch:
        return PaddedSparseBatch(
            ids=ids[None], lengths=lengths[None], keys=(_FEATURE,),
            weights=None if per_sample_weights is None
            else per_sample_weights[None])

    def forward(self, ids: torch.Tensor, lengths: torch.Tensor,
                per_sample_weights: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
        return self.ebc(self._batch(ids, lengths, per_sample_weights)).values

    def update(self, ids: torch.Tensor, lengths: torch.Tensor,
               d_pooled: torch.Tensor, learning_rate: float,
               per_sample_weights: Optional[torch.Tensor] = None):
        """Fused optimizer step, in place.

        Args:
            ids, lengths, per_sample_weights: the forward's inputs.
            d_pooled: the cotangent of the forward's output.
            learning_rate: the fused optimizer's.
        """
        return self.ebc.update(self._batch(ids, lengths, per_sample_weights),
                               d_pooled, learning_rate)
