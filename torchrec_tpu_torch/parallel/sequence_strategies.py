"""Sequence (unpooled) sharding strategies for EmbeddingCollection.

Counterpart of torchrec_tpu/parallel/sequence_strategies.py. A sequence
strategy keeps the storage layout of its pooled strategy (so sharding,
unsharding and the optimizer state are inherited) and drops the pooling
reduction: the forward returns per-token rows [F, B_loc, L, D] of the
local batch with pad tokens zeroed, and the update takes the per-token
cotangent [F, B_loc, L, D] as the row gradients, unscaled. The
collectives are the pooled strategies' (parallel/comm.py):

    ROW_WISE       all_gather(ids) -> the owned rows of the global batch,
                   zeros elsewhere -> reduce_scatter over the batch; the
                   update all_gathers ids and the cotangent;
    TABLE_WISE     all_gather(ids) -> the rows of the rank's features ->
                   all_to_all of the [f_max, B, L, D] rows (split batch,
                   concat feature slots); the mirror all_to_all routes
                   the cotangent back;
    DATA_PARALLEL  the local batch's rows; the update all_gathers every
                   rank's (ids, cotangent rows, valid);
    TABLE_ROW_WISE the host's slots of the staggered global batch (the
                   pooled TWRW's input dist, either routing) -> the rows
                   this local rank owns, zeros elsewhere -> reduce_scatter
                   over the intra-host group -> all_to_all over the
                   cross-host group; the update routes the cotangent back
                   (cross all_to_all, intra all_gather).

ROW_WISE, TABLE_WISE and TABLE_ROW_WISE take their pooled strategy's
input dist; their `forward_from_dist` / `update_from_dist` replace the
pooled bodies with the token ones, and `forward` / `update` run them on
the batch's dist.

Kernels. An fp32 table's rows come from one launch of the routed gather
(ops/gather_rows.routed_gather_rows: route, mask and row gather in one
kernel). ROW_WISE routes by its row blocks. DATA_PARALLEL and TABLE_WISE
give each feature (or feature slot) a shard of 2**31 - 1 rows, so that
every id from 0 up routes to rank 0 at its table's row offset, and clip the
row to the packed table as JAX's gather clips it: an id at or past its
table's rows reads a later table's row, or the last packed row, in both
packages. A negative id gives zeros here, where JAX's `w[gids]` reads
row gids of the packed table (the row before the table's first for -1).
TABLE_ROW_WISE routes by its host's row blocks with `my` its local rank.
The ROW_WISE and TABLE_ROW_WISE updates route with one launch of the
kernel's route-only mode (`route_tokens`). A masked token is +0.0 here and
rows * 0 in JAX (-0.0 under a negative entry): equal as values. bf16 and
fp16 tables compose the route, the gather and the mask from torch ops (the
routed gather is K8's, f32 only, as in JAX) and train as fp32 ones do,
their update rounding each row in K4h / K3h.
"""

from __future__ import annotations

from typing import Optional

import torch

from torchrec_tpu_torch.ops.embedding import lookup_rows
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    apply_fused_update,
)
from torchrec_tpu_torch.ops.gather_rows import (
    route_tokens,
    route_tokens_reference,
    routed_gather_rows,
)
from torchrec_tpu_torch.parallel import comm
from torchrec_tpu_torch.parallel.embedding_sharding import GroupMeta
from torchrec_tpu_torch.parallel.hierarchical_strategies import (
    TwRwEmbeddingSharding,
)
from torchrec_tpu_torch.parallel.strategies import (
    BaseEmbeddingShardingStrategy,
    DpEmbeddingSharding,
    RwEmbeddingSharding,
    TwEmbeddingSharding,
    _token_mask,
)
from torchrec_tpu_torch.parallel.types import ShardingEnv, ShardingType

# the shard size that holds every row of a table: ids 0 .. 2**31 - 2
WHOLE_TABLE = 2**31 - 1


def token_rows(w: torch.Tensor, ids: torch.Tensor, lengths: torch.Tensor,
               shard_rows: torch.Tensor, local_off: torch.Tensor,
               rank: int) -> torch.Tensor:
    """[F, B, L, D] rows of the tokens `rank` owns (ops/gather_rows.py's
    route), zero elsewhere: one routed gather for an fp32 table, the route,
    the gather and the mask in torch ops for a half one."""
    ids = ids.to(torch.int32).contiguous()
    lengths = lengths.to(torch.int32).contiguous()
    if w.dtype == torch.float32:
        return routed_gather_rows(w, ids, lengths, shard_rows, local_off,
                                  rank)
    local, owned = route_tokens_reference(ids, lengths, shard_rows,
                                          local_off, rank)
    rows = lookup_rows(w, local.reshape(-1)).reshape(*local.shape,
                                                     w.shape[-1])
    return rows * owned.to(rows.dtype)[..., None]


def _whole_tables(strat: BaseEmbeddingShardingStrategy, slots: int) -> None:
    strat.register_buffer("whole_table", torch.full(
        (slots,), WHOLE_TABLE, dtype=torch.int32, device=strat.env.device),
        persistent=False)


class DpSequenceEmbeddingSharding(DpEmbeddingSharding):
    """Replicated table; the local batch's rows; the sparse gradient
    synced by all_gather."""

    def _build(self) -> None:
        super()._build()
        _whole_tables(self, len(self.meta.features))

    def forward(self, sb):
        return token_rows(self.weights, sb.ids, sb.lengths,
                          self.whole_table, self.feat_row_off, 0)

    def update(self, sb, d_tokens, learning_rate):
        self._apply(self._gids(sb.ids),
                    _token_mask(sb.lengths, sb.ids.shape[2]), d_tokens,
                    learning_rate)


def _reduce_rows(env, rows: torch.Tensor, group=None) -> torch.Tensor:
    """reduce_scatter of per-token rows over the batch axis: a half table's
    in f32 (one rank's row and zeros: the f32 sum is exact)."""
    if env.group is None or rows.dtype == torch.float32:
        return comm.reduce_scatter(env, rows, 1, group=group)
    return comm.reduce_scatter(env, rows.float(), 1, group=group).to(
        rows.dtype)


def _route(ids, lengths, shard_rows, local_off, my):
    """The route-only launch on int32 copies of ids and lengths."""
    return route_tokens(ids.to(torch.int32).contiguous(),
                        lengths.to(torch.int32).contiguous(), shard_rows,
                        local_off, my)


class RwSequenceEmbeddingSharding(RwEmbeddingSharding):
    """Row shards; each token's row comes from its owning rank (zeros
    elsewhere), summed to the batch's rank by the reduce_scatter."""

    def forward_from_dist(self, sb_g):
        """Per-token rows [F, B_loc, L, D] from the global batch, zero
        where the token is padding."""
        rows = token_rows(self.weights[0], sb_g.ids, sb_g.lengths,
                          self.feat_shard_rows, self.feat_local_off,
                          self.rank)
        return _reduce_rows(self.env, rows)

    def update_from_dist(self, sb_g, d_tokens, learning_rate):
        """Fused optimizer step from the per-token cotangent [F, B_loc,
        L, D], in place, on the owned rows of the valid tokens."""
        d_g = comm.all_gather(self.env, d_tokens, 1)
        local, owned = _route(sb_g.ids, sb_g.lengths, self.feat_shard_rows,
                              self.feat_local_off, self.rank)
        apply_fused_update(
            self.weights[0], self._opt_local(), local.reshape(-1),
            d_g.reshape(-1, self.dim), owned.reshape(-1), learning_rate,
            **self._fused_kwargs())


class TwSequenceEmbeddingSharding(TwEmbeddingSharding):
    """The table's rank looks up the global batch's tokens of its
    features; the all_to_all returns the rows to the batch's ranks."""

    def _build(self) -> None:
        super()._build()
        _whole_tables(self, self.f_max)

    def forward_from_dist(self, sb_g):
        len_m = sb_g.lengths[self.my_feats] * self.my_valid[:, None].to(
            sb_g.lengths.dtype)
        rows = token_rows(self.weights[0], sb_g.ids[self.my_feats], len_m,
                          self.whole_table, self.my_rowoff, 0)
        slots = comm.all_to_all(self.env, rows, 1, 0)  # [n f_max, B_loc, ..]
        return slots[self.out_pos]

    def update_from_dist(self, sb_g, d_tokens, learning_rate):
        d_m = self._slots_back(d_tokens)  # [f_max, B, L, D]
        ids_m, len_m, _ = self._mine(sb_g.ids, sb_g.lengths, None)
        apply_fused_update(
            self.weights[0], self._opt_local(), ids_m.reshape(-1),
            d_m.reshape(-1, self.dim),
            _token_mask(len_m, sb_g.ids.shape[2]).reshape(-1), learning_rate,
            **self._fused_kwargs())


class TwRwSequenceEmbeddingSharding(TwRwEmbeddingSharding):
    """A table pinned to a host, its rows split over the host's local
    ranks: the owning local rank gives each token of the host's slots its
    row (zeros elsewhere), the intra-host reduce_scatter sums them, the
    cross-host all_to_all returns the slots to the batch's ranks."""

    def forward_from_dist(self, dist):
        """Per-token rows [F, B_loc, L, D]: one routed gather over the
        host's slots with my = l."""
        ids_m, len_m, _ = dist
        rows = token_rows(self.weights[0], ids_m, len_m, self.my_sr,
                          self.my_off, self.l)  # [f_max, B, L, D]
        return self._to_batch_owners(
            _reduce_rows(self.env, rows, self.intra))

    def update_from_dist(self, dist, d_tokens, learning_rate):
        """Fused optimizer step from the per-token cotangent [F, B_loc, L,
        D], in place: cross all_to_all, intra all_gather, the route-only
        launch, the fused update of the owned rows."""
        ids_m, len_m, _ = dist
        d_full = comm.all_gather(self.env, self._slots_back(d_tokens), 1,
                                 group=self.intra)  # [f_max, B, L, D]
        local, owned = _route(ids_m, len_m, self.my_sr, self.my_off, self.l)
        apply_fused_update(
            self.weights[0], self._opt_local(), local.reshape(-1),
            d_full.reshape(-1, self.dim), owned.reshape(-1), learning_rate,
            **self._fused_kwargs())


SEQUENCE_STRATEGY_REGISTRY = {
    ShardingType.DATA_PARALLEL: DpSequenceEmbeddingSharding,
    ShardingType.ROW_WISE: RwSequenceEmbeddingSharding,
    ShardingType.TABLE_WISE: TwSequenceEmbeddingSharding,
    ShardingType.TABLE_ROW_WISE: TwRwSequenceEmbeddingSharding,
}


def create_sequence_sharding_strategy(
    env: ShardingEnv,
    meta: GroupMeta,
    optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
    optim_kwargs: Optional[dict] = None,
) -> BaseEmbeddingShardingStrategy:
    cls = SEQUENCE_STRATEGY_REGISTRY.get(meta.sharding_type)
    if cls is None:
        raise NotImplementedError(
            f"sequence sharding {meta.sharding_type.value}: an "
            "EmbeddingCollection takes DATA_PARALLEL, ROW_WISE, TABLE_WISE "
            "and TABLE_ROW_WISE, as in the JAX package"
        )
    return cls(env, meta, optim, optim_kwargs)
