"""Table grouping for sharded embedding collections.

Counterpart of torchrec_tpu/parallel/embedding_sharding.py. Tables are
grouped by (sharding type, embedding dim, data type): one group is one
table-batched weight array, one lookup and, across devices, one set of
collectives. Pooling may differ per table inside a group; it travels as
per-feature flags into the pooling coefficients. An EmbeddingCollection's
tables (EmbeddingConfig) have no pooling and are grouped as SUM tables, as
the JAX package groups them; the sequence strategies never pool.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from torchrec_tpu_torch.modules.embedding_configs import (
    BaseEmbeddingConfig,
    DataType,
    PoolingType,
    pooling_type_to_mode,
)
from torchrec_tpu_torch.ops.embedding import PoolingMode
from torchrec_tpu_torch.parallel.types import (
    ParameterSharding,
    ShardingType,
)
from torchrec_tpu_torch.sparse.jagged import PaddedSparseBatch


@dataclasses.dataclass(frozen=True)
class ShardedTableMeta:
    """Static per-table metadata inside a group."""

    name: str
    rows: int
    dim: int
    pooling: PoolingMode
    feature_names: Tuple[str, ...]
    embedding_names: Tuple[str, ...]
    rank: int = 0  # TABLE_WISE placement; the host of TWRW / TWCW


@dataclasses.dataclass(frozen=True)
class GroupMeta:
    """Static metadata of one sharding group."""

    sharding_type: ShardingType
    tables: Tuple[ShardedTableMeta, ...]
    dim: int
    is_weighted: bool
    data_type: DataType = DataType.FP32

    @property
    def features(self) -> Tuple[str, ...]:
        return tuple(f for t in self.tables for f in t.feature_names)

    @property
    def embedding_names(self) -> Tuple[str, ...]:
        return tuple(n for t in self.tables for n in t.embedding_names)

    @property
    def feature_table(self) -> np.ndarray:
        """[F] table index of each feature."""
        return np.asarray(
            [ti for ti, t in enumerate(self.tables) for _ in t.feature_names],
            dtype=np.int32,
        )

    @property
    def feature_pooling_mean(self) -> np.ndarray:
        """[F] bool: the feature uses MEAN pooling."""
        return np.asarray(
            [t.pooling is PoolingMode.MEAN
             for t in self.tables for _ in t.feature_names],
            dtype=bool,
        )


class GroupedInputDistMixin:
    """Per-group feature selection and input dist shared by the sharded
    modules (the host class defines ``self.groups`` and
    ``self.strategies``)."""

    def _group_batch(self, sb: PaddedSparseBatch,
                     group_idx: int) -> PaddedSparseBatch:
        feats = self.groups[group_idx].features
        key_index = {k: i for i, k in enumerate(sb.keys)}
        return sb.select_features([key_index[f] for f in feats])

    def input_dist(self, sb: PaddedSparseBatch) -> Tuple:
        """The batch's input dist, one per group: the strategy's
        `input_dist` of the group's features, or None where the strategy
        has none and gathers in the step (DATA_PARALLEL). Feed it to
        `forward` / `update`'s `dist` to skip the in-step dist."""
        return tuple(
            strat.input_dist(self._group_batch(sb, gi))
            if strat.supports_input_dist else None
            for gi, strat in enumerate(self.strategies))


def group_tables(
    tables: Sequence[BaseEmbeddingConfig],
    embedding_names_per_table: Sequence[Sequence[str]],
    plan: Dict[str, ParameterSharding],
    is_weighted: bool = False,
) -> List[GroupMeta]:
    """Partition tables into sharding groups, in the order each group's
    first table comes, keeping table order within each group (the sharded
    module restores the output feature order). A table's `rank` is its
    TABLE_WISE placement, `ranks[0]` (0 when unset), and otherwise its
    plan's `host` (0 when unset), as the JAX function sets it. The compute
    kernel is not read: the DMP splits an EBC's FUSED_UVM_CACHING tables
    out before grouping (parallel/uvm_ebc.py), and a tower's or an EC's
    such table stays on the device, as in JAX."""
    groups: Dict[Tuple[ShardingType, int, DataType],
                 List[ShardedTableMeta]] = {}
    for cfg, enames in zip(tables, embedding_names_per_table):
        ps = plan.get(cfg.name)
        if ps is None:
            raise ValueError(f"no sharding plan entry for table {cfg.name}")
        meta = ShardedTableMeta(
            name=cfg.name,
            rows=cfg.num_embeddings,
            dim=cfg.embedding_dim,
            pooling=pooling_type_to_mode(
                getattr(cfg, "pooling", PoolingType.SUM)),
            feature_names=tuple(cfg.feature_names),
            embedding_names=tuple(enames),
            rank=((ps.ranks[0] if ps.ranks else 0)
                  if ps.sharding_type is ShardingType.TABLE_WISE
                  else (ps.host or 0)),
        )
        key = (ps.sharding_type, cfg.embedding_dim, cfg.data_type)
        groups.setdefault(key, []).append(meta)
    return [
        GroupMeta(
            sharding_type=key[0],
            tables=tuple(metas),
            dim=key[1],
            is_weighted=is_weighted,
            data_type=key[2],
        )
        for key, metas in groups.items()
    ]
