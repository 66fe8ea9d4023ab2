"""Sequence (unpooled) sharding strategies for EmbeddingCollection.

Counterpart of torchrec_tpu/parallel/sequence_strategies.py. A sequence
strategy keeps the storage layout of its pooled strategy (so sharding,
unsharding and the optimizer state are inherited) and drops the pooling
reduction: the forward returns per-token rows [F, B, L, D] with pad tokens
and rows another shard owns zeroed, and the update takes the per-token
cotangent [F, B, L, D] as the row gradients, unscaled.

ROW_WISE on n devices is all_gather(ids) -> lookup of the owned rows ->
psum_scatter over the batch; on the one device of this slice the
collectives are identities. For an fp32 table the forward is one launch of
the routed gather per group (ops/gather_rows.routed_gather_rows: route,
mask and row gather in one kernel) and the update one launch of its
route-only mode (`route_tokens`) before `apply_fused_update`. bf16 and
fp16 tables compose the forward's route, gather and mask from torch ops
(the routed gather is K8's, f32 only, as in JAX) and train as fp32 ones
do, their update rounding each row in K4h / K3h.
DATA_PARALLEL, TABLE_WISE and TABLE_ROW_WISE come with the multi-GPU slice
(ROADMAP queue 1 item 8) and raise here.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchrec_tpu_torch.ops.embedding import lookup_rows
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    apply_fused_update,
)
from torchrec_tpu_torch.ops.gather_rows import route_tokens, routed_gather_rows
from torchrec_tpu_torch.parallel.embedding_sharding import GroupMeta
from torchrec_tpu_torch.parallel.strategies import RwEmbeddingSharding
from torchrec_tpu_torch.parallel.types import ShardingEnv, ShardingType
from torchrec_tpu_torch.sparse.jagged import PaddedSparseBatch


class RwSequenceEmbeddingSharding(RwEmbeddingSharding):
    """Row shards; each token's row comes from its owning shard (zeros
    elsewhere), summed to the batch owner on n devices."""

    def _route_args(self, sb: PaddedSparseBatch) -> tuple:
        """The routed kernel's inputs: int32 ids and lengths, contiguous (no
        copy for a batch from `to_padded`), the per-feature shard rows and
        offsets, and this device's rank."""
        return (sb.ids.to(torch.int32).contiguous(),
                sb.lengths.to(torch.int32).contiguous(),
                self.feat_shard_rows, self.feat_local_off, self.env.rank)

    def forward(self, sb: PaddedSparseBatch) -> torch.Tensor:
        """Per-token rows [F, B, L, D], zero where the token is padding or
        its row lives on another shard."""
        w = self.weights[0]
        if w.dtype == torch.float32:
            return routed_gather_rows(w, *self._route_args(sb))
        local, owned = self._route(sb.ids, sb.lengths, self.env.rank)
        rows = lookup_rows(w, local.reshape(-1)).reshape(
            *local.shape, w.shape[-1])
        return rows * owned.to(rows.dtype)[..., None]

    def update(self, sb: PaddedSparseBatch, d_tokens: torch.Tensor,
               learning_rate: float) -> None:
        """Fused optimizer step from the per-token cotangent [F, B, L, D],
        in place, on the owned rows of the valid tokens."""
        local, owned = route_tokens(*self._route_args(sb))
        apply_fused_update(
            self.weights[0], self._opt_local(), local.reshape(-1),
            d_tokens.reshape(-1, self.dim), owned.reshape(-1),
            learning_rate, **self.optim_kwargs)


def create_sequence_sharding_strategy(
    env: ShardingEnv,
    meta: GroupMeta,
    optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
    optim_kwargs: Optional[dict] = None,
) -> RwSequenceEmbeddingSharding:
    if meta.sharding_type is not ShardingType.ROW_WISE:
        raise NotImplementedError(
            f"sequence sharding {meta.sharding_type.value}: only ROW_WISE "
            "is ported; DATA_PARALLEL, TABLE_WISE and TABLE_ROW_WISE come "
            "with the multi-GPU slice (ROADMAP queue 1 item 8)"
        )
    return RwSequenceEmbeddingSharding(env, meta, optim, optim_kwargs)
