"""Hierarchical sharding: TABLE_ROW_WISE (TWRW) and TABLE_COLUMN_WISE (TWCW).

Counterpart of torchrec_tpu/parallel/hierarchical_strategies.py. The world
is H hosts of Lc local ranks (`ShardingEnv.local_size`), rank h * Lc + l
being local rank l of host h. A table is pinned to one host (its plan's
`host`); its rows (TWRW) or its columns (TWCW) are split over that host's
Lc ranks, so that the reduce and concat traffic stays inside the host and
only the batch routing crosses hosts. The collectives run over the env's
subgroups (`ShardingEnv.subgroups()`): the intra-host group of the rank's
host and the cross-host group of its local index, JAX's
`axis_index_groups`.

Layouts, rank r holding what JAX's device r holds:

    TWRW  [n, rows_loc, D]: on each rank of host h, for each table of h,
          its l-th block of ceil(R / Lc) rows, the tables concatenated;
    TWCW  [n, rows_loc, D / Lc]: on each rank of host h, every row of
          each table of h, columns [l D / Lc, (l + 1) D / Lc); each column
          shard keeps its own rowwise optimizer state ("cwrow", S = Lc).

A rank builds and loads only its [1, ...] block (`_place`), as the flat
strategies do.

The stagger. The global batch gathered in rank order is viewed as [H, Lc]
blocks of B / n rows and transposed to [Lc, H], so that after the
intra-host split (block l) and the cross-host split (sub-block h) rank
(h, l) holds its own batch block h * Lc + l.

The input dist (`input_dist`) is this rank's view of its host's feature
slots over the staggered global batch, the tuple (ids [f_max, B, L],
lengths [f_max, B], per-sample weights or None), f_max slots per host (a
pad slot reads feature 0 with its lengths 0):
- input_routing="allgather": the batch all_gathered (ids and lengths in
  one call), staggered, the host's slots selected;
- input_routing="a2a": each host sent only its own features' blocks, an
  all_to_all over the cross-host group, then a non-tiled all_gather over
  the intra-host group, which yields the staggered order itself; bit for
  bit the same tuple.

TWRW forward: the route of the routed gather (ops/gather_rows) with this
host's per-slot shard rows and offsets and `my = l` -> K1 over the owned
rows -> reduce_scatter over the intra group (batch axis) -> all_to_all
over the cross group (split the batch, concat the slots) -> the slots in
canonical feature order (`out_pos`). Its update routes the cotangent back
(cross all_to_all, intra all_gather) and applies the fused update to the
owned rows. TWCW's forward pools its columns of every row, then an intra
all_to_all swaps the batch split for the column concat (split 1, concat
2) before the cross all_to_all; its update's second all_to_all splits the
columns and concatenates the batch. One K1 launch per forward, one
`apply_fused_update` per update.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.ops.embedding import pooled_lookup
from torchrec_tpu_torch.ops.fused_update import apply_fused_update
from torchrec_tpu_torch.ops.gather_rows import route_tokens_reference
from torchrec_tpu_torch.parallel import comm
from torchrec_tpu_torch.parallel.strategies import (
    BaseEmbeddingShardingStrategy,
    _cdiv,
    _pad_rows_tile,
    _pool_coeff,
    _token_mask,
    gather_batch,
)
from torchrec_tpu_torch.sparse.jagged import PaddedSparseBatch

# (ids [f_max, B, L], lengths [f_max, B], per-sample weights or None)
HostDist = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor]]


class TwRwEmbeddingSharding(BaseEmbeddingShardingStrategy):
    """A table pinned to a host, its rows split over the host's local
    ranks (owner = id // sr, local row = id % sr + the table's offset)."""

    supports_input_dist = True

    def _build(self) -> None:
        n, Lc = self.n, self.env.local_size
        if n % Lc:
            raise ValueError(f"world {n} not divisible by local size {Lc}")
        H = n // Lc
        self.H, self.Lc = H, Lc
        self.h, self.l = divmod(self.rank, Lc)
        tables = self.meta.tables
        per_host: List[List[int]] = [[] for _ in range(H)]
        for ti, t in enumerate(tables):
            if not 0 <= t.rank < H:
                raise ValueError(f"table {t.name} pinned to host {t.rank} "
                                 f"outside {H} hosts")
            per_host[t.rank].append(ti)
        self.per_host = per_host
        feats_of_table: List[List[int]] = [[] for _ in tables]
        for fi, ti in enumerate(self.meta.feature_table):
            feats_of_table[ti].append(fi)
        self.f_max = max((sum(len(feats_of_table[ti]) for ti in tids)
                          for tids in per_host), default=1) or 1
        # per-table row shard size over the Lc local ranks
        self.table_sr = np.asarray([_cdiv(t.rows, Lc) for t in tables],
                                   np.int64)
        F = len(self.meta.features)
        self.host_feats = np.zeros((H, self.f_max), np.int64)
        self.host_feat_valid = np.zeros((H, self.f_max), bool)
        self.host_feat_sr = np.ones((H, self.f_max), np.int64)
        self.host_feat_off = np.zeros((H, self.f_max), np.int64)
        out_pos = np.zeros((F,), np.int64)
        self.table_local_off: Dict[int, int] = {}
        for h, tids in enumerate(per_host):
            slot = off = 0
            for ti in tids:
                self.table_local_off[ti] = off
                for fi in feats_of_table[ti]:
                    self.host_feats[h, slot] = fi
                    self.host_feat_valid[h, slot] = True
                    self.host_feat_sr[h, slot] = self.table_sr[ti]
                    self.host_feat_off[h, slot] = off
                    out_pos[fi] = h * self.f_max + slot
                    slot += 1
                off += self._table_rows_loc(ti)
        self.rows_loc = _pad_rows_tile(max(
            (sum(self._table_rows_loc(ti) for ti in tids)
             for tids in per_host), default=1) or 1)
        self.intra, self.cross = self.env.subgroups()
        dev, h = self.env.device, self.h
        for name, arr, dtype in (
                ("my_feats", self.host_feats[h], torch.int64),
                ("my_valid", self.host_feat_valid[h], torch.bool),
                ("my_sr", self.host_feat_sr[h], torch.int32),
                ("my_off", self.host_feat_off[h], torch.int32),
                ("my_mean", self.meta.feature_pooling_mean[
                    self.host_feats[h]], torch.bool),
                ("route_feats", self.host_feats.reshape(-1), torch.int64),
                ("out_pos", out_pos, torch.int64)):
            self.register_buffer(name, torch.as_tensor(
                arr, dtype=dtype, device=dev), persistent=False)

    def _table_rows_loc(self, ti: int) -> int:
        """Rows table ti takes in a rank's block."""
        return int(self.table_sr[ti])

    def weights_shape(self) -> Tuple[int, ...]:
        return (self.n, self.rows_loc, self.dim)

    def _place(self, out, i, rows, start=0):
        # local rank l of the table's host owns rows [l sr, (l + 1) sr)
        if self.meta.tables[i].rank != self.h:
            return
        sr, off = int(self.table_sr[i]), self.table_local_off[i]
        first = self.l * sr
        lo, hi = max(start, first), min(start + rows.shape[0], first + sr)
        if lo < hi:
            dst = off + lo - first
            out[0, dst:dst + hi - lo] = rows[lo - start:hi - start].to(
                out.device)

    def _host_block(self, w: torch.Tensor, ti: int, rows: int
                    ) -> torch.Tensor:
        """[Lc, rows, ...]: table ti's rows in each local rank of its host
        (w in the global layout)."""
        h, off = self.meta.tables[ti].rank, self.table_local_off[ti]
        return w[h * self.Lc:(h + 1) * self.Lc, off:off + rows]

    def _tables_of(self, w):
        return {t.name: self._host_block(w, ti, int(self.table_sr[ti]))
                .reshape(-1, *w.shape[2:])[:t.rows]
                for ti, t in enumerate(self.meta.tables)}

    def _table_span(self, i):
        off = self.table_local_off[i]
        return off, off + self._table_rows_loc(i)

    def _host_span(self, g: torch.Tensor, i: int) -> torch.Tensor:
        """Table i's host's ranks of `g`, a span of every rank's block."""
        h = self.meta.tables[i].rank
        return g[h * self.Lc:(h + 1) * self.Lc]

    def _table_of_span(self, g, i, rowwise):
        return self._host_span(g, i).reshape(
            -1, *g.shape[2:])[:self.meta.tables[i].rows]

    # -- the input dist -------------------------------------------------------

    def _stagger(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """The gathered batch's [H, Lc] blocks along `axis` reordered to
        [Lc, H]."""
        shape = x.shape
        x = x.reshape(*shape[:axis], self.H, self.Lc,
                      shape[axis] // self.n, *shape[axis + 1:])
        return x.transpose(axis, axis + 1).reshape(shape)

    def _route_feature_major(self, x: torch.Tensor) -> torch.Tensor:
        """The routed input dist of a local feature-major x [F, B_loc,
        ...]: each host's feature slots all_to_all'ed over the cross-host
        group ([f_max, H B_loc, ...] ordered by source host), then
        all_gathered (non-tiled) over the intra-host group ([Lc, f_max, H
        B_loc, ...] ordered by source local rank) -> [f_max, B, ...] of
        this host's slots in the staggered batch order."""
        sel = x[self.route_feats].reshape(self.H, self.f_max, *x.shape[1:])
        y = comm.all_to_all(self.env, sel, 0, 2, group=self.cross)[0]
        z = comm.all_gather(self.env, y, 0, tiled=False, group=self.intra)
        z = z.movedim(0, 1)
        return z.reshape(self.f_max, -1, *x.shape[2:])

    def _route_inputs(self, sb: PaddedSparseBatch) -> HostDist:
        """input_routing="a2a": the ids and lengths routed in one call
        pair, the per-sample weights in another."""
        L = sb.ids.shape[2]
        ints = torch.cat([sb.ids, sb.lengths.to(sb.ids.dtype)[:, :, None]],
                         dim=2)
        ints = self._route_feature_major(ints)
        len_m = ints[:, :, L].to(sb.lengths.dtype) * self.my_valid[
            :, None].to(sb.lengths.dtype)
        psw_m = (None if sb.weights is None
                 else self._route_feature_major(sb.weights))
        return ints[:, :, :L], len_m, psw_m

    def input_dist(self, sb: PaddedSparseBatch) -> HostDist:
        """This rank's view of its host's feature slots over the staggered
        global batch (see the module docstring), under either routing."""
        if self.input_routing == "a2a":
            return self._route_inputs(sb)
        ids_g, len_g, psw_g = gather_batch(self.env, sb)
        ids_m = self._stagger(ids_g[self.my_feats], 1)
        len_m = self._stagger(len_g[self.my_feats], 1) * self.my_valid[
            :, None].to(len_g.dtype)
        psw_m = (None if psw_g is None
                 else self._stagger(psw_g[self.my_feats], 1))
        return ids_m, len_m, psw_m

    # -- compute --------------------------------------------------------------

    def _route(self, ids_m: torch.Tensor, len_m: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local row of each slot's id, and whether this local rank owns it
        and it is not padding."""
        return route_tokens_reference(ids_m, len_m, self.my_sr, self.my_off,
                                      self.l)

    def _to_batch_owners(self, x: torch.Tensor) -> torch.Tensor:
        """[H f_max, B / n, ...] slots of the intra-host result [f_max,
        B / Lc, ...], over the cross-host group, in canonical feature
        order."""
        cross = comm.all_to_all(self.env, x, 1, 0, group=self.cross)
        return cross[self.out_pos]

    def _slots_back(self, d: torch.Tensor) -> torch.Tensor:
        """The local batch's cotangent [F, B_loc, ...] -> this host's slots
        [f_max, B / Lc, ...]: scattered into every host's slots, then the
        cross-host all_to_all."""
        slots = d.new_zeros((self.H * self.f_max, *d.shape[1:]))
        slots[self.out_pos] = d
        return comm.all_to_all(self.env, slots, 0, 1, group=self.cross)

    def forward_from_dist(self, dist: HostDist) -> torch.Tensor:
        """Pooled output [F, B_loc, D]: the partial sums of the owned rows
        over the host's slots, reduce_scatter over the intra group, the
        slots to the batch's ranks over the cross group."""
        ids_m, len_m, psw_m = dist
        w = self.weights
        local, owned = self._route(ids_m, len_m)
        coeff = _pool_coeff(len_m, ids_m.shape[2], self.my_mean, psw_m,
                            w.dtype) * owned.to(w.dtype)
        partial = pooled_lookup(w[0], local, coeff)  # [f_max, B, D]
        intra = comm.reduce_scatter(self.env, partial, 1, group=self.intra)
        return self._to_batch_owners(intra)

    def update_from_dist(self, dist: HostDist, d_pooled: torch.Tensor,
                         learning_rate: float) -> None:
        """Fused optimizer step, in place: the cotangent routed back (cross
        all_to_all, intra all_gather, in the staggered order of the dist),
        the owned rows updated."""
        ids_m, len_m, psw_m = dist
        d_full = comm.all_gather(self.env, self._slots_back(d_pooled), 1,
                                 group=self.intra)  # [f_max, B, D]
        local, owned = self._route(ids_m, len_m)
        coeff = _pool_coeff(len_m, ids_m.shape[2], self.my_mean, psw_m,
                            self.weights.dtype)
        row_grads = d_full[:, :, None, :] * coeff[:, :, :, None]
        apply_fused_update(
            self.weights[0], self._opt_local(), local.reshape(-1),
            row_grads.reshape(-1, row_grads.shape[-1]), owned.reshape(-1),
            learning_rate, **self._fused_kwargs())


class TwCwEmbeddingSharding(TwRwEmbeddingSharding):
    """A table pinned to a host, its columns split over the host's local
    ranks; every rank of the host holds all its rows. Each column shard
    keeps its own rowwise optimizer state."""

    def _build(self) -> None:
        super()._build()
        if self.dim % self.Lc:
            raise ValueError(f"TWCW needs dim {self.dim} divisible by local "
                             f"size {self.Lc}")
        self.cols_loc = self.dim // self.Lc

    def _table_rows_loc(self, ti: int) -> int:
        return self.meta.tables[ti].rows

    def weights_shape(self) -> Tuple[int, ...]:
        return (self.n, self.rows_loc, self.cols_loc)

    def rowwise_shards(self) -> int:
        return self.Lc

    def _place(self, out, i, rows, start=0):
        if self.meta.tables[i].rank != self.h:
            return
        off = self.table_local_off[i] + start
        cols = slice(self.l * self.cols_loc, (self.l + 1) * self.cols_loc)
        out[0, off:off + rows.shape[0]] = rows[:, cols].to(out.device)

    def _tables_of(self, w):
        return {t.name: self._host_block(w, ti, t.rows).permute(1, 0, 2)
                .reshape(t.rows, self.dim)
                for ti, t in enumerate(self.meta.tables)}

    def _table_of_span(self, g, i, rowwise):
        block = self._host_span(g, i)
        if rowwise:
            return block  # [Lc, R]
        return block.permute(1, 0, 2).reshape(self.meta.tables[i].rows,
                                              self.dim)

    def _place_rowwise(self, out, i, v):
        t = self.meta.tables[i]
        if v.dim() == 1 and self.Lc == 1:  # the plain row space at Lc = 1
            v = v[None]
        if tuple(v.shape) != (self.Lc, t.rows):
            raise ValueError(f"momentum of {t.name}: expected "
                             f"({self.Lc}, {t.rows}), got {tuple(v.shape)}")
        if t.rank == self.h:
            off = self.table_local_off[i]
            out[0, off:off + t.rows] = v[self.l].to(out.device)

    def _rowwise_of(self, m):
        return {t.name: self._host_block(m, ti, t.rows)
                for ti, t in enumerate(self.meta.tables)}

    def forward_from_dist(self, dist: HostDist) -> torch.Tensor:
        """Pooled output [F, B_loc, D]: this rank's columns of the host's
        slots pooled, the intra all_to_all (split the batch, concat the
        columns), the slots to the batch's ranks over the cross group."""
        ids_m, len_m, psw_m = dist
        w = self.weights
        coeff = _pool_coeff(len_m, ids_m.shape[2], self.my_mean, psw_m,
                            w.dtype)
        pooled = pooled_lookup(w[0], ids_m + self.my_off[:, None, None],
                               coeff)  # [f_max, B, D / Lc]
        intra = comm.all_to_all(self.env, pooled, 1, 2, group=self.intra)
        return self._to_batch_owners(intra)

    def update_from_dist(self, dist: HostDist, d_pooled: torch.Tensor,
                         learning_rate: float) -> None:
        """Fused optimizer step, in place: the cotangent routed back (cross
        all_to_all, then the intra all_to_all that splits the columns and
        concatenates the batch), every valid token's row updated."""
        ids_m, len_m, psw_m = dist
        L = ids_m.shape[2]
        d2 = comm.all_to_all(self.env, self._slots_back(d_pooled), 2, 1,
                             group=self.intra)  # [f_max, B, D / Lc]
        coeff = _pool_coeff(len_m, L, self.my_mean, psw_m,
                            self.weights.dtype)
        row_grads = d2[:, :, None, :] * coeff[:, :, :, None]
        apply_fused_update(
            self.weights[0], self._opt_local(),
            (ids_m + self.my_off[:, None, None]).reshape(-1),
            row_grads.reshape(-1, self.cols_loc),
            _token_mask(len_m, L).reshape(-1), learning_rate,
            **self._fused_kwargs())
