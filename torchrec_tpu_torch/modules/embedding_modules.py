"""Unsharded EmbeddingBagCollection and EmbeddingCollection.

Counterpart of torchrec_tpu/modules/embedding_modules.py (:40-203). A model
is authored with these modules as if on one device; DistributedModelParallel
later replaces each with a ShardedEmbeddingBagCollection or
ShardedEmbeddingCollection that holds the tables in the plan's layout.
Build them on `device="meta"` when the DMP will shard them, so that the
unsharded tables are never allocated. Unsharded, both are differentiable in
their tables (and the EBC in its per-sample weights): K1's and K8's
autograd Functions carry the gradients.

Input is the padded [F, B, L] `PaddedSparseBatch`; a KeyedJaggedTensor is
converted with `to_padded(max_feature_length)`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    BaseEmbeddingConfig,
    EmbeddingBagConfig,
    EmbeddingConfig,
    pooling_type_to_mode,
)
from torchrec_tpu_torch.ops.embedding import (
    PoolingMode,
    batched_embedding_lookup,
)
from torchrec_tpu_torch.sparse.jagged import (
    JaggedTensor,
    KeyedJaggedTensor,
    KeyedTensor,
    PaddedSparseBatch,
)
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

SparseInput = Union[PaddedSparseBatch, KeyedJaggedTensor]


def embedding_names_by_table(
    tables: Sequence[BaseEmbeddingConfig],
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


def _table_parameters(tables: Sequence[BaseEmbeddingConfig],
                      device: DeviceLike) -> nn.ParameterDict:
    """One uninitialised fp32 [R, D] parameter per table, by table name."""
    names = [cfg.name for cfg in tables]
    if len(set(names)) != len(names):
        raise ValueError(f"duplicate table names in {names}")
    dev = resolve_device(device)
    return nn.ParameterDict({
        cfg.name: nn.Parameter(torch.empty(
            cfg.num_embeddings, cfg.embedding_dim, device=dev,
            dtype=torch.float32,
        ))
        for cfg in tables
    })


@torch.no_grad()
def _reset_tables(tables: Sequence[BaseEmbeddingConfig],
                  params: nn.ParameterDict,
                  generator: Optional[torch.Generator]) -> None:
    """U(weight_init_min, weight_init_max) per table."""
    for cfg in tables:
        params[cfg.name].uniform_(
            cfg.get_weight_init_min(), cfg.get_weight_init_max(),
            generator=generator,
        )


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
        self.tables: Tuple[EmbeddingBagConfig, ...] = tuple(tables)
        self.is_weighted = is_weighted
        self.max_feature_length = max_feature_length
        self._emb_names = embedding_names_by_table(self.tables)
        self.embedding_bags = _table_parameters(self.tables, device)
        self.flax_names = {cfg.name: f"embedding_bags.{cfg.name}"
                           for cfg in self.tables}

    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """U(weight_init_min, weight_init_max) per table."""
        _reset_tables(self.tables, self.embedding_bags, generator)

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


class EmbeddingCollection(nn.Module):
    """Sparse batch [F x B x L] -> per-token embeddings {feature: [B, L, D]}
    for sequence models; pad tokens are zero rows.

    tables: table configs, all of one embedding_dim (ValueError
    otherwise); max_feature_length: the L a KeyedJaggedTensor is padded
    to. Tables are fp32 parameters drawn U(-sqrt(1/R), sqrt(1/R)) by
    default, as in the JAX module.
    """

    def __init__(
        self,
        tables: Sequence[EmbeddingConfig],
        max_feature_length: int = 1,
        device: DeviceLike = None,
    ):
        super().__init__()
        dims = {cfg.embedding_dim for cfg in tables}
        if len(dims) > 1:
            raise ValueError(
                f"All tables in an EmbeddingCollection must share one "
                f"embedding_dim, got {sorted(dims)}"
            )
        self.tables: Tuple[EmbeddingConfig, ...] = tuple(tables)
        self.max_feature_length = max_feature_length
        self._emb_names = embedding_names_by_table(self.tables)
        self.embeddings = _table_parameters(self.tables, device)
        self.flax_names = {cfg.name: f"embeddings.{cfg.name}"
                           for cfg in self.tables}

    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """U(weight_init_min, weight_init_max) per table."""
        _reset_tables(self.tables, self.embeddings, generator)

    @property
    def embedding_dim(self) -> int:
        return self.tables[0].embedding_dim

    @property
    def embedding_names(self) -> List[str]:
        return [n for names in self._emb_names for n in names]

    def forward(
        self, features: SparseInput, as_jagged: bool = False
    ) -> Dict[str, Union[torch.Tensor, JaggedTensor]]:
        """-> {embedding name: [B, L, D]}; with `as_jagged=True`
        {embedding name: JaggedTensor.from_dense_lengths(rows, lengths)},
        each row's valid tokens first in B*L slots.

        Args:
            features: the [F, B, L] batch, padded or jagged.
            as_jagged: return JaggedTensors.
        """
        sb = as_padded(features, self.max_feature_length)
        key_index = {k: i for i, k in enumerate(sb.keys)}
        out: Dict[str, Union[torch.Tensor, JaggedTensor]] = {}
        for cfg, enames in zip(self.tables, self._emb_names):
            fidx = torch.as_tensor(
                [key_index[f] for f in cfg.feature_names],
                device=sb.ids.device,
            )
            rows = batched_embedding_lookup(
                self.embeddings[cfg.name],
                sb.ids[fidx],
                sb.lengths[fidx],
                [0] * len(cfg.feature_names),
                pooling=PoolingMode.NONE,
            )  # [f, B, L, D]
            for name, r, lengths in zip(enames, rows.unbind(0),
                                        sb.lengths[fidx].unbind(0)):
                out[name] = (JaggedTensor.from_dense_lengths(r, lengths)
                             if as_jagged else r)
        return out
