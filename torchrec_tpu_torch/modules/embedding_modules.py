"""Unsharded EmbeddingBagCollection.

Counterpart of torchrec_tpu/modules/embedding_modules.py (:40-129). A model
is authored with this module as if on one device; DistributedModelParallel
later replaces it with a ShardedEmbeddingBagCollection that holds the
tables in the plan's layout. Build it on `device="meta"` when the DMP will
shard it, so that the unsharded tables are never allocated.

Input is the padded [F, B, L] `PaddedSparseBatch`; a KeyedJaggedTensor is
converted with `to_padded(max_feature_length)`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    pooling_type_to_mode,
)
from torchrec_tpu_torch.ops.embedding import batched_embedding_lookup
from torchrec_tpu_torch.sparse.jagged import (
    KeyedJaggedTensor,
    KeyedTensor,
    PaddedSparseBatch,
)
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

SparseInput = Union[PaddedSparseBatch, KeyedJaggedTensor]


def embedding_names_by_table(
    tables: Sequence[EmbeddingBagConfig],
) -> List[List[str]]:
    """Output names per table; a feature shared by several tables is
    named `feature@table`."""
    shared: Dict[str, int] = {}
    for cfg in tables:
        for f in cfg.feature_names:
            shared[f] = shared.get(f, 0) + 1
    return [
        [f"{f}@{cfg.name}" if shared[f] > 1 else f for f in cfg.feature_names]
        for cfg in tables
    ]


def as_padded(features: SparseInput, max_length: int) -> PaddedSparseBatch:
    if isinstance(features, PaddedSparseBatch):
        return features
    if isinstance(features, KeyedJaggedTensor):
        return features.to_padded(max_length)
    raise TypeError(f"unsupported sparse input: {type(features)}")


class EmbeddingBagCollection(nn.Module):
    """Sparse batch [F x B x L] -> KeyedTensor [B, sum(D_f)] of pooled
    embeddings.

    tables: table configs, each owning >= 1 feature names; is_weighted:
    use per-sample weights; max_feature_length: the L a KeyedJaggedTensor
    is padded to. Tables are fp32 parameters, as in the JAX module.
    """

    def __init__(
        self,
        tables: Sequence[EmbeddingBagConfig],
        is_weighted: bool = False,
        max_feature_length: int = 1,
        device: DeviceLike = None,
    ):
        super().__init__()
        names = [cfg.name for cfg in tables]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate table names in {names}")
        self.tables: Tuple[EmbeddingBagConfig, ...] = tuple(tables)
        self.is_weighted = is_weighted
        self.max_feature_length = max_feature_length
        self._emb_names = embedding_names_by_table(self.tables)
        dev = resolve_device(device)
        self.embedding_bags = nn.ParameterDict({
            cfg.name: nn.Parameter(torch.empty(
                cfg.num_embeddings, cfg.embedding_dim, device=dev,
                dtype=torch.float32,
            ))
            for cfg in self.tables
        })

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """U(weight_init_min, weight_init_max) per table."""
        for cfg in self.tables:
            self.embedding_bags[cfg.name].uniform_(
                cfg.get_weight_init_min(), cfg.get_weight_init_max(),
                generator=generator,
            )

    @property
    def embedding_names(self) -> List[str]:
        return [n for names in self._emb_names for n in names]

    def forward(self, features: SparseInput) -> KeyedTensor:
        sb = as_padded(features, self.max_feature_length)
        key_index = {k: i for i, k in enumerate(sb.keys)}
        outputs: List[torch.Tensor] = []
        for cfg in self.tables:
            fidx = torch.as_tensor(
                [key_index[f] for f in cfg.feature_names],
                device=sb.ids.device,
            )
            psw = None
            if self.is_weighted and sb.weights is not None:
                psw = sb.weights[fidx]
            pooled = batched_embedding_lookup(
                self.embedding_bags[cfg.name],
                sb.ids[fidx],
                sb.lengths[fidx],
                [0] * len(cfg.feature_names),
                pooling=pooling_type_to_mode(cfg.pooling),
                per_sample_weights=psw,
            )  # [f, B, D]
            outputs.extend(pooled.unbind(0))
        return KeyedTensor.from_tensor_list(self.embedding_names, outputs)
