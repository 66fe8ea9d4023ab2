"""ShardedEmbeddingCollection: sharded unpooled embeddings.

Counterpart of torchrec_tpu/parallel/sharded_ec.py. The tables are grouped
as the sharded EBC groups them, one sequence strategy per group
(parallel/sequence_strategies.py); the output is {embedding name: [B, L,
D]} per-token rows of the rank's slice of the batch (B_loc rows at world
size n), pad tokens zero, the layout BERT4Rec consumes. It is an
`nn.Module` that replaces the authored EmbeddingCollection, holding the
shards and fused optimizer state as its strategies' buffers; `init`,
`shard_from_dense`, `unshard_to_dense`, the optimizer state in and out and
`check_trainable` come from ShardedEmbeddingModule, and `update` changes
the buffers in place.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    SparseInput,
    as_padded,
    embedding_names_by_table,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel.embedding_sharding import group_tables
from torchrec_tpu_torch.parallel.sequence_strategies import (
    create_sequence_sharding_strategy,
)
from torchrec_tpu_torch.parallel.sharded_ebc import (
    ShardedEmbeddingModule,
    group_spans,
)
from torchrec_tpu_torch.parallel.strategies import EmbeddingGroupState
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingEnv
from torchrec_tpu_torch.utils import tracing


class ShardedEmbeddingCollection(ShardedEmbeddingModule):
    """Sharded EC. max_feature_length: the L a KeyedJaggedTensor input is
    padded to, as in the unsharded module it replaces. optim /
    optim_kwargs: the fused optimizer of every group and its fused_params.
    `injected` holds {embedding name: [B, L, D]}."""

    def __init__(
        self,
        env: ShardingEnv,
        tables: Sequence[EmbeddingConfig],
        plan: Dict[str, ParameterSharding],
        max_feature_length: int = 1,
        optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
        optim_kwargs: Optional[dict] = None,
    ):
        super().__init__(env, tables, max_feature_length)
        if len({t.embedding_dim for t in self.tables}) > 1:
            raise ValueError("EmbeddingCollection tables must share one dim")
        self.groups = group_tables(
            self.tables, embedding_names_by_table(self.tables), plan)
        self.strategies = nn.ModuleList(
            create_sequence_sharding_strategy(env, g, optim, optim_kwargs)
            for g in self.groups
        )
        self._fwd_spans = group_spans("ec_fwd", self.groups)
        self._update_spans = group_spans("ec_update", self.groups)

    def forward(self, features: Optional[SparseInput],
                as_jagged: bool = False,
                dist: Optional[Sequence] = None) -> Dict[str, torch.Tensor]:
        """-> {embedding name: [B, L, D]} per-token rows (pad rows zero).
        `as_jagged` is accepted and ignored, as the JAX DMP's stand-in
        for an EmbeddingCollection ignores it: the rows stay dense.
        `dist`: the batch's `input_dist`, as the sharded EBC takes it."""
        del as_jagged
        if self.injected is not None:
            return self.injected
        sb = (None if features is None
              else as_padded(features, self.max_feature_length))
        out: Dict[str, torch.Tensor] = {}
        for gi, (strat, group) in enumerate(zip(self.strategies,
                                                self.groups)):
            d = None if dist is None else dist[gi]
            with tracing.span(self._fwd_spans[gi]):
                rows = (strat(self._group_batch(sb, gi)) if d is None
                        else strat.forward_from_dist(d))  # [F_g, B, L, D]
            out.update(zip(group.embedding_names, rows.unbind(0)))
        return out

    @torch.no_grad()
    def update(self, features: Optional[SparseInput],
               d_tokens: Mapping[str, torch.Tensor],
               learning_rate: float, dist: Optional[Sequence] = None
               ) -> Tuple[EmbeddingGroupState, ...]:
        """Fused optimizer step, in place, from the cotangents of the
        forward's outputs, {embedding name: [B, L, D]}, from each group's
        dist where `dist` has one."""
        sb = (None if features is None
              else as_padded(features, self.max_feature_length))
        for gi, (strat, group) in enumerate(zip(self.strategies,
                                                self.groups)):
            d = torch.stack([d_tokens[n] for n in group.embedding_names])
            dg = None if dist is None else dist[gi]
            with tracing.span(self._update_spans[gi]):
                if dg is None:
                    strat.update(self._group_batch(sb, gi), d,
                                 learning_rate)
                else:
                    strat.update_from_dist(dg, d, learning_rate)
        return self.states
