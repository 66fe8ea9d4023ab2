"""Sharding strategies: DATA_PARALLEL, ROW_WISE, TABLE_WISE, COLUMN_WISE.

Counterpart of torchrec_tpu/parallel/strategies.py. Each strategy is a
module that holds one table group's shard in the JAX package's layout at
world size n, rank r holding what JAX's device r holds:

    DATA_PARALLEL  [R, D] replicated: the tables concatenated, padded to
                   ROW_TILE rows;
    ROW_WISE       [n, rows_loc, D]: each table's rows split into n
                   contiguous blocks of ceil(R / n) rows, the tables'
                   blocks concatenated per rank, padded to ROW_TILE;
    TABLE_WISE     [n, rows_max, D]: whole tables on the rank of their
                   plan (`ShardedTableMeta.rank`), concatenated per rank;
    COLUMN_WISE    [n, R, D / n]: column block j of every row on rank j.

A rank's buffer is its own block, [1, ...] of the three sharded layouts
(the local view inside JAX's shard_map) or the whole replicated table.
`init_weights`, `shard_from_dense` and `shard_rowwise` allocate only that
block and write into it the part of each table the rank holds (JAX builds
its tables inside a jitted program whose out_shardings materialize each
device's shard only): no rank holds the global layout, and a table reaches
the device one slice at a time. `unshard_to_dense` all_gathers the blocks
first (a collective: every rank calls it). Full momenta pack as the weights do, the rowwise momentum as
the weights without their last axis; COLUMN_WISE keeps one rowwise state
per column shard, `[n, R]` per table, saved as JAX's "cwrow" form. The
whole optimizer state moves per table in the JAX strategies' canonical
form (`unshard_opt_to_tables` / `shard_opt_from_tables`), which does not
depend on the plan.

The collectives (parallel/comm.py) are JAX's:

    ROW_WISE     all_gather(ids) -> masked lookup of the owned rows
                 (partial sums) -> reduce_scatter over the batch; the
                 update all_gathers ids and the cotangent;
    TABLE_WISE   all_gather(ids) -> lookup of the rank's features ->
                 all_to_all (split batch, concat feature slots); the
                 update routes the cotangent back with the mirror
                 all_to_all;
    COLUMN_WISE  all_gather(ids) -> lookup of the local columns ->
                 all_to_all (split batch, concat columns); the update's
                 all_to_all splits columns and concatenates the batch;
    DATA_PARALLEL  the local batch's lookup, no collective; the update
                 all_gathers every rank's (ids, row gradients, valid) and
                 applies the same fused update on every replica.

Each forward is one K1 launch per group and each update one
`apply_fused_update`. Without a process group every collective is the
identity; with one, even of one rank, each is a torch.distributed call.
The ids and lengths of a batch travel in one all_gather.

The input dist. RW, TW and CW split each forward and update into the
batch's dist, `input_dist(sb)` (the all_gather of the ids, lengths and
per-sample weights: a PaddedSparseBatch of the global batch, which depends
on nothing but the batch), and the rest, `forward_from_dist(dist)` /
`update_from_dist(dist, d, lr)`; `forward(sb)` is
`forward_from_dist(input_dist(sb))`. The DMP's prefetched step computes a
batch's dist once, ahead of its step, for its forward and its update
(JAX's cross-batch input-dist prefetch). DATA_PARALLEL looks up its local
batch and has none (`supports_input_dist` False), as in JAX.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    data_type_to_torch_dtype,
)
from torchrec_tpu_torch.ops.embedding import pooled_lookup
from torchrec_tpu_torch.ops.tbe_lookup import tbe_lookup_jagged_forward
from torchrec_tpu_torch.ops.gather_rows import route_tokens_reference
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    FusedOptimizerState,
    apply_fused_update,
    check_trainable,
    fused_state_shapes,
)
from torchrec_tpu_torch.parallel import comm
from torchrec_tpu_torch.parallel.embedding_sharding import GroupMeta
from torchrec_tpu_torch.parallel.types import ShardingEnv, ShardingType
from torchrec_tpu_torch.sparse.jagged import (
    KeyedJaggedTensor,
    PaddedSparseBatch,
    lengths_to_offsets,
)
from torchrec_tpu_torch.utils import tracing

# Per-device packed row counts are padded to this tile, as in the JAX
# package, so that a shard round-trips between the two packages unchanged.
ROW_TILE = 128
# init_weights draws each table in chunks of this many rows, so that a rank
# holds its block and one chunk, never a whole table
INIT_CHUNK_ROWS = 1 << 16
# the span (utils/tracing.py) around a lookup's route to the kernel: its
# global ids, mask and pooling coefficients
ROUTE_SPAN = "## lookup_route ##"

ArrayLike = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass
class EmbeddingGroupState:
    """Sharded weights and fused optimizer state of one group (views of the
    strategy's buffers)."""

    weights: torch.Tensor
    opt: FusedOptimizerState


def as_tensor(x: ArrayLike, device=None) -> torch.Tensor:
    """A torch tensor of a numpy array or tensor, on `device`. numpy has no
    bf16: JAX's bf16 arrays reach numpy as `ml_dtypes.bfloat16`, which torch
    cannot read, so they go through f32, which holds them exactly."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.tensor(arr, device=device)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _pad_rows_tile(rows: int) -> int:
    return _cdiv(int(rows), ROW_TILE) * ROW_TILE


def _token_mask(lengths: torch.Tensor, L: int) -> torch.Tensor:
    """[F, B, L] bool validity mask from [F, B] lengths."""
    col = torch.arange(L, device=lengths.device)
    return col[None, None, :] < lengths[:, :, None]


def _pool_coeff(
    lengths: torch.Tensor,
    L: int,
    mean_flags: torch.Tensor,
    psw: Optional[torch.Tensor],
    dtype: torch.dtype,
) -> torch.Tensor:
    """[F, B, L] pooling coefficient: mask * sample weight / (len if MEAN).
    mean_flags: [F] bool, True where the feature's table pools by MEAN."""
    coeff = _token_mask(lengths, L).to(dtype)
    if psw is not None:
        coeff = coeff * psw.to(dtype)
    denom = lengths.to(dtype).clamp(min=1.0)[:, :, None]
    return torch.where(mean_flags[:, None, None], coeff / denom, coeff)


def gather_batch(env: ShardingEnv, sb: PaddedSparseBatch) -> Tuple[
        torch.Tensor, torch.Tensor, Optional[torch.Tensor]]:
    """(ids, lengths, per-sample weights) of the global batch, each
    all_gathered over the batch axis 1; ids and lengths travel in one
    call."""
    if env.group is None:
        return sb.ids, sb.lengths, sb.weights
    L = sb.ids.shape[2]
    ints = torch.cat([sb.ids, sb.lengths.to(sb.ids.dtype)[:, :, None]],
                     dim=2)
    ints = comm.all_gather(env, ints, 1)
    psw = (None if sb.weights is None
           else comm.all_gather(env, sb.weights, 1))
    return ints[:, :, :L], ints[:, :, L].to(sb.lengths.dtype), psw


class JaggedRoute(NamedTuple):
    """A jagged batch's route on the device (`DpEmbeddingSharding.
    jagged_route`): global ids [N] int32, offsets [F B + 1] int32, each
    value's bag [N], valid [N], the coefficients [N] in the table's dtype
    or None, the batch's F and B, and the cap on a bag's values."""

    gids: torch.Tensor
    offsets: torch.Tensor
    bag: torch.Tensor
    valid: torch.Tensor
    coeff: Optional[torch.Tensor]
    features: int
    batch: int
    cap: int


class BaseEmbeddingShardingStrategy(nn.Module):
    """One table group sharded one way. Holds this rank's block of the
    group's shard as the buffer `weights` and the fused optimizer state as
    the buffers `momentum1` / `momentum2` (None where the optimizer keeps
    none; fp32, shaped like `weights` or like it without its last axis)
    and `step`.

    optim / optim_kwargs: the fused optimizer and its fused_params (see
    ops/fused_update.apply_fused_update), and `input_routing`: "allgather"
    (the default) or "a2a", the routed input dist of the hierarchical
    strategies (parallel/hierarchical_strategies.py). A flat strategy has
    none: it warns and all_gathers the ids, as the JAX strategies do.
    """

    supports_input_dist = False
    # takes a KeyedJaggedTensor as it comes (`jagged_route`, then
    # `forward_jagged` / `update_jagged`); the sharded EBC pads the batch
    # for the others
    supports_jagged = False

    def __init__(
        self,
        env: ShardingEnv,
        meta: GroupMeta,
        optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
        optim_kwargs: Optional[dict] = None,
    ):
        super().__init__()
        self.env = env
        self.meta = meta
        self.optim = optim
        self.optim_kwargs = dict(optim_kwargs or {})
        self.input_routing = self.optim_kwargs.pop("input_routing",
                                                   "allgather")
        if self.input_routing != "allgather" and not hasattr(
                self, "_route_inputs"):
            warnings.warn(
                f"input_routing={self.input_routing!r} requested but "
                f"{type(self).__name__} has no routed input dist: flat "
                "strategies always all_gather ids; only the hierarchical "
                "strategies (TWRW / TWCW and TWRW sequence) route a2a. "
                "Falling back to allgather.", stacklevel=2)
            self.input_routing = "allgather"
        self.n = env.world_size
        self.rank = env.rank
        self.dim = meta.dim
        # table storage dtype; pooled outputs and optimizer state are fp32
        self.w_dtype = data_type_to_torch_dtype(meta.data_type)
        self._build()
        shape = self.local_shape()
        self.register_buffer("weights", torch.zeros(
            shape, dtype=self.w_dtype, device=env.device))
        for name, kind in zip(("momentum1", "momentum2"),
                              fused_state_shapes(optim)):
            mshape = {"row": shape[:-1], "full": shape}.get(kind)
            self.register_buffer(name, None if mshape is None else torch.zeros(
                mshape, dtype=torch.float32, device=env.device))
        self.register_buffer("step", torch.zeros(
            (), dtype=torch.int32, device=env.device))

    # -- layout ---------------------------------------------------------------

    def _build(self) -> None:
        raise NotImplementedError

    def weights_shape(self) -> Tuple[int, ...]:
        """The JAX strategy's global layout."""
        raise NotImplementedError

    @property
    def sharded(self) -> bool:
        """The layout has a rank axis (every strategy but DATA_PARALLEL)."""
        return len(self.weights_shape()) == 3

    def local_shape(self) -> Tuple[int, ...]:
        """This rank's block of the layout: the buffers' shape."""
        ws = self.weights_shape()
        return (1, *ws[1:]) if self.sharded else ws

    def _global(self, local: torch.Tensor) -> torch.Tensor:
        """The global layout from every rank's block (an all_gather)."""
        if not self.sharded or self.n == 1:
            return local
        return comm.all_gather(self.env, local, 0)

    def sr_row_base(self) -> int:
        """The first row of this rank's block across the group, which keys
        a half table's stochastic-rounding bits: rank * rows per block (0
        for the replicated DATA_PARALLEL table, whose replicas must round
        alike)."""
        return self.rank * self.weights_shape()[1] if self.sharded else 0

    def _place(self, out: torch.Tensor, i: int, rows: torch.Tensor,
               start: int = 0) -> None:
        """Write the part this rank holds of rows [start, start + len(rows))
        of table i (canonical [R, D] or [R], on any device) into the rank's
        block `out`. Only that part moves to `out`'s device."""
        raise NotImplementedError

    def _tables_of(self, w: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-table [R, D] views of a tensor in the global layout."""
        raise NotImplementedError

    def _place_rowwise(self, out: torch.Tensor, i: int,
                       v: torch.Tensor) -> None:
        """Write this rank's part of table i's canonical rowwise momentum
        [R] into its rowwise block `out`, placed as its rows are."""
        t = self.meta.tables[i]
        if tuple(v.shape) != (t.rows,):
            raise ValueError(f"momentum of {t.name}: expected ({t.rows},), "
                             f"got {tuple(v.shape)}")
        self._place(out, i, v)

    def _rowwise_of(self, m: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Per-table canonical views of a global rowwise momentum."""
        return self._tables_of(m)

    def init_weights(
        self, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """This rank's block of the weights with each table drawn from
        U(-b, b), b = sqrt(1 / rows), as the JAX strategy draws them. Every
        rank draws every table, in chunks of INIT_CHUNK_ROWS rows, from the
        same generator and keeps its part of each chunk, so the ranks'
        blocks are of one set of tables, the same under every plan and
        world size."""
        out = torch.zeros(self.local_shape(), dtype=self.w_dtype,
                          device=self.weights.device)
        for i, t in enumerate(self.meta.tables):
            bound = (1.0 / t.rows) ** 0.5
            for start in range(0, t.rows, INIT_CHUNK_ROWS):
                rows = torch.empty((min(INIT_CHUNK_ROWS, t.rows - start),
                                    t.dim), device=out.device)
                self._place(out, i, rows.uniform_(-bound, bound,
                                                  generator=generator), start)
        return out

    def shard_from_dense(self, dense: Mapping[str, ArrayLike],
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """This rank's block of the packed unsharded per-table [R_t, D]
        arrays (numpy, including JAX's `ml_dtypes.bfloat16`, or torch), in
        `dtype` (default: the table's; pass torch.float32 for momenta,
        which never live in half precision)."""
        out = torch.zeros(self.local_shape(), dtype=dtype or self.w_dtype,
                          device=self.weights.device)
        for i, t in enumerate(self.meta.tables):
            table = as_tensor(dense[t.name])  # stays where it is
            if tuple(table.shape) != (t.rows, t.dim):
                raise ValueError(
                    f"table {t.name}: expected {(t.rows, t.dim)}, got "
                    f"{tuple(table.shape)}"
                )
            self._place(out, i, table)
        return out

    def unshard_tensors(self, weights: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        """Per-table [R, D] tensors of this rank's block `weights` and the
        other ranks', on its device, in its dtype (views where the layout
        allows; a collective at world size > 1)."""
        return self._tables_of(self._global(weights))

    def _table_span(self, i: int) -> Tuple[int, int]:
        """The rows [lo, hi) of a block's axis 1 that table i takes in the
        ranks that hold it (a sharded layout)."""
        raise NotImplementedError

    def _table_of_span(self, g: torch.Tensor, i: int,
                       rowwise: bool) -> torch.Tensor:
        """Table i from `g` [n, hi - lo, ...], its span of every rank's
        block: [R, D], or a rowwise momentum's canonical [R] / [S, R]."""
        return g.reshape(-1, *g.shape[2:])[:self.meta.tables[i].rows]

    def unshard_table_to_host(self, t: torch.Tensor, i: int,
                              rowwise: bool = False) -> np.ndarray:
        """Table i of this rank's block `t` (the weights, a full momentum
        or, with rowwise, a rowwise momentum) and the other ranks', as a
        numpy array on the host. At world size n one all_gather of table
        i's span of the blocks, never the whole layout (bf16 tables come
        back as fp32, which holds them exactly: numpy has no bf16)."""
        if not self.sharded or self.n == 1:
            of = self._rowwise_of if rowwise else self._tables_of
            v = of(t)[self.meta.tables[i].name]
        else:
            lo, hi = self._table_span(i)
            g = comm.all_gather(self.env, t[:, lo:hi].contiguous(), 0)
            v = self._table_of_span(g, i, rowwise)
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy().copy()

    def unshard_to_dense(self, weights: torch.Tensor) -> Dict[str, np.ndarray]:
        """Per-table [R, D] numpy arrays, gathered one table at a time
        (`unshard_table_to_host`)."""
        return {t.name: self.unshard_table_to_host(weights, i)
                for i, t in enumerate(self.meta.tables)}

    def rowwise_shards(self) -> int:
        """Column shards that carry a rowwise momentum of their own (1: the
        plain row space)."""
        return 1

    def unshard_rowwise(self, m: torch.Tensor) -> Dict[str, np.ndarray]:
        """Per-table canonical numpy form of a rowwise momentum block
        shaped like `weights` without its last axis: [R], or [S, R] for
        S = rowwise_shards() column shards; one table at a time."""
        return {t.name: self.unshard_table_to_host(m, i, rowwise=True)
                for i, t in enumerate(self.meta.tables)}

    def shard_rowwise(self, per_table: Mapping[str, ArrayLike]) -> torch.Tensor:
        """Inverse of unshard_rowwise: this rank's rowwise momentum block."""
        out = torch.zeros(self.local_shape()[:-1], dtype=torch.float32,
                          device=self.weights.device)
        for i, t in enumerate(self.meta.tables):
            self._place_rowwise(out, i, as_tensor(per_table[t.name]).float())
        return out

    # -- fused optimizer state ------------------------------------------------

    @property
    def opt(self) -> FusedOptimizerState:
        return FusedOptimizerState(momentum1=self.momentum1,
                                   momentum2=self.momentum2, step=self.step,
                                   optim=self.optim)

    def _opt_local(self) -> FusedOptimizerState:
        """The state with the leading rank axis stripped (views); the
        replicated layout has none."""
        opt = self.opt
        if not self.sharded:
            return opt
        return dataclasses.replace(
            opt,
            momentum1=None if opt.momentum1 is None else opt.momentum1[0],
            momentum2=None if opt.momentum2 is None else opt.momentum2[0])

    def _fused_kwargs(self) -> dict:
        return {**self.optim_kwargs, "sr_row_base": self.sr_row_base()}

    def unshard_opt_to_tables(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The optimizer state per table, in the canonical form of the JAX
        strategies' `unshard_opt_to_tables`: {table: {"m1__full" [R, D] |
        "m1__row" [R] | "m1__cwrow" [S, R] (S > 1 column shards), the same
        for "m2", "step": int32}}."""
        out: Dict[str, Dict[str, np.ndarray]] = {
            t.name: {} for t in self.meta.tables}
        for tag, kind in zip(("m1", "m2"), fused_state_shapes(self.optim)):
            if kind == "none":
                continue
            m = getattr(self, f"momentum{tag[1]}")
            if kind == "full":
                per, label = self.unshard_to_dense(m), "full"
            else:
                per = self.unshard_rowwise(m)
                label = "row" if self.rowwise_shards() == 1 else "cwrow"
            for name, arr in per.items():
                out[name][f"{tag}__{label}"] = arr
        step = np.asarray(self.step.item(), np.int32)
        for entry in out.values():
            entry["step"] = step
        return out

    @staticmethod
    def _convert_rowspace(arr: np.ndarray, s_target: int) -> np.ndarray:
        """A canonical rowwise momentum, [R] or [S, R], in the row space of
        `s_target` column shards, as JAX converts it: unchanged when S
        matches; [S, R] -> [R] by the mean over shards (the rowwise
        accumulator is mean(g^2) over a shard's columns, and column shards
        are of equal width, so the mean of the shards' accumulators is the
        whole row's); [R] -> [s_target, R] by replication, with a warning
        (each shard's own history is lost). The result is 1-D for the plain
        row space and [s_target, R] otherwise."""
        arr = np.asarray(arr)
        if arr.ndim == 2 and arr.shape[0] == s_target and s_target > 1:
            return arr
        src_s = arr.shape[0] if arr.ndim == 2 else 1
        if arr.ndim == 2:
            arr = arr.mean(axis=0)
        if s_target == 1:
            return arr
        warnings.warn(
            f"Restoring rowwise optimizer state into a plan with "
            f"{s_target} column shards (checkpoint had {src_s}): "
            "per-column-shard accumulator history is not recoverable; "
            "each shard resumes from the full-row mean accumulator "
            "(unbiased, but not bit-identical to uninterrupted training).",
            stacklevel=2,
        )
        return np.tile(arr, (s_target, 1))

    @torch.no_grad()
    def shard_opt_from_tables(
        self, per_table: Mapping[str, Mapping[str, ArrayLike]]
    ) -> None:
        """Load `unshard_opt_to_tables`' form, saved under any plan, into
        the momentum and step buffers: a rowwise momentum takes "row" or
        "cwrow" and goes through `_convert_rowspace`. Raises unless every
        table carries the momenta this optimizer keeps, at their row
        counts, and a step (where JAX restarts the group's state); the
        group's step is the largest, as the JAX strategies take it."""
        for tag, kind in zip(("m1", "m2"), fused_state_shapes(self.optim)):
            if kind == "none":
                continue
            per = {}
            for t in self.meta.tables:
                entry = per_table.get(t.name, {})
                keys = ((f"{tag}__full",) if kind == "full"
                        else (f"{tag}__row", f"{tag}__cwrow"))
                arr = next((entry[k] for k in keys if k in entry), None)
                if arr is None:
                    raise ValueError(f"{self.optim.name} state of table "
                                     f"{t.name} has no {' or '.join(keys)}")
                if kind != "full":
                    arr = np.asarray(arr, np.float32)
                    if arr.shape[-1] != t.rows:
                        raise ValueError(
                            f"{tag} of {t.name}: {arr.shape[-1]} rows, "
                            f"expected {t.rows}")
                    arr = self._convert_rowspace(arr, self.rowwise_shards())
                per[t.name] = arr
            setattr(self, f"momentum{tag[1]}",
                    self.shard_from_dense(per, torch.float32)
                    if kind == "full" else self.shard_rowwise(per))
        steps = [per_table.get(t.name, {}).get("step")
                 for t in self.meta.tables]
        if any(s is None for s in steps):
            raise ValueError("every table's state needs a step")
        self.step.fill_(max(int(s) for s in steps))

    @torch.no_grad()
    def reset_opt(self) -> None:
        """Zero the momentum and the step, as a fresh init_opt."""
        for t in (self.momentum1, self.momentum2, self.step):
            if t is not None:
                t.zero_()

    def check_trainable(self) -> None:
        """Raise unless this group's table dtype and fused_params are
        ported."""
        check_trainable(self.w_dtype, self.optim_kwargs)

    # -- compute --------------------------------------------------------------

    def input_dist(self, sb: PaddedSparseBatch) -> PaddedSparseBatch:
        """The batch's input dist: the global batch, its ids, lengths and
        per-sample weights all_gathered (replicated on every rank)."""
        ids_g, len_g, psw_g = gather_batch(self.env, sb)
        return PaddedSparseBatch(ids=ids_g, lengths=len_g, keys=sb.keys,
                                 weights=psw_g)

    def forward_from_dist(self, sb_g: PaddedSparseBatch) -> torch.Tensor:
        """forward() on the input dist of its batch: the strategy's
        forward body (`_fwd_gathered`) on the global batch."""
        return self._fwd_gathered(self.weights, sb_g.ids, sb_g.lengths,
                                  sb_g.weights, sb_g.ids.shape[2])

    def update_from_dist(self, sb_g: PaddedSparseBatch,
                         d_pooled: torch.Tensor,
                         learning_rate: float) -> None:
        """update() on the input dist of its batch: the strategy's update
        body (`_upd_gathered`) on the global batch."""
        self._upd_gathered(sb_g.ids, sb_g.lengths, sb_g.weights, d_pooled,
                           learning_rate, sb_g.ids.shape[2])

    def forward(self, sb: PaddedSparseBatch) -> torch.Tensor:
        """The local batch's pooled output [F, B_loc, D] fp32."""
        return self.forward_from_dist(self.input_dist(sb))

    def update(self, sb: PaddedSparseBatch, d_pooled: torch.Tensor,
               learning_rate: float) -> None:
        """Fused optimizer step, in place.

        Args:
            sb: the local batch.
            d_pooled: the cotangent of its pooled output [F, B_loc, D].
            learning_rate: the fused optimizer's.
        """
        self.update_from_dist(self.input_dist(sb), d_pooled, learning_rate)


def _row_offsets(meta: GroupMeta) -> np.ndarray:
    """[T] first row of each table in the tables' concatenation."""
    rows = [t.rows for t in meta.tables]
    return np.concatenate([[0], np.cumsum(rows)[:-1]]).astype(np.int64)


class DpEmbeddingSharding(BaseEmbeddingShardingStrategy):
    """Replicated tables, [R, D]. The forward looks up the local batch; the
    update all_gathers every rank's (ids, row gradients, valid) and applies
    one fused update to them on every replica, so the replicas stay equal
    and the gradient stays sparse (JAX's DDP stand-in)."""

    def _build(self) -> None:
        self.row_offsets = _row_offsets(self.meta)
        self.total_rows = _pad_rows_tile(
            sum(t.rows for t in self.meta.tables))
        dev = self.env.device
        self.register_buffer("feat_row_off", torch.as_tensor(
            self.row_offsets[self.meta.feature_table], dtype=torch.int32,
            device=dev), persistent=False)
        self.register_buffer("feat_mean", torch.as_tensor(
            self.meta.feature_pooling_mean, device=dev), persistent=False)

    def weights_shape(self) -> Tuple[int, ...]:
        return (self.total_rows, self.dim)

    def _place(self, out, i, rows, start=0):
        off = int(self.row_offsets[i]) + start
        out[off:off + rows.shape[0]] = rows.to(out.device)

    def _tables_of(self, w):
        return {t.name: w[int(off):int(off) + t.rows]
                for off, t in zip(self.row_offsets, self.meta.tables)}

    def _gids(self, ids: torch.Tensor) -> torch.Tensor:
        return ids + self.feat_row_off[:, None, None]

    def forward(self, sb):
        L = sb.ids.shape[2]
        with tracing.span(ROUTE_SPAN):
            coeff = _pool_coeff(sb.lengths, L, self.feat_mean, sb.weights,
                                self.weights.dtype)
            gids = self._gids(sb.ids)
        return pooled_lookup(self.weights, gids, coeff)

    def _gather_flat(self, gids: torch.Tensor, valid: torch.Tensor,
                     grads: torch.Tensor):
        """Every rank's flat (ids [N], valid [N], grads [N, D]) in rank
        order: the ids and the mask travel in one all_gather."""
        if self.env.group is None:
            return gids, valid, grads
        ints = torch.stack([gids.to(torch.int32), valid.to(torch.int32)], 1)
        ints = comm.all_gather(self.env, ints, 0)
        return (ints[:, 0], ints[:, 1].bool(),
                comm.all_gather(self.env, grads, 0))

    def _apply(self, gids, valid, grads, lr) -> None:
        ids_all, valid_all, grads_all = self._gather_flat(
            gids.reshape(-1), valid.reshape(-1), grads.reshape(-1, self.dim))
        apply_fused_update(self.weights, self.opt, ids_all, grads_all,
                           valid_all, lr, **self._fused_kwargs())

    def update(self, sb, d_pooled, learning_rate):
        L = sb.ids.shape[2]
        coeff = _pool_coeff(sb.lengths, L, self.feat_mean, sb.weights,
                            self.weights.dtype)
        row_grads = d_pooled[:, :, None, :] * coeff[:, :, :, None]
        self._apply(self._gids(sb.ids), _token_mask(sb.lengths, L),
                    row_grads, learning_rate)

    # -- the jagged route ------------------------------------------------------

    @property
    def supports_jagged(self) -> bool:
        """Without a process group: the update's all_gather would need the
        same number of values on every rank, which a jagged batch does
        not promise."""
        return self.env.group is None

    def jagged_route(self, kjt: KeyedJaggedTensor,
                     max_length: int) -> JaggedRoute:
        """A jagged batch's route to K1j and the update, on the device with
        nothing read back. A bag takes its first `max_length` values, as
        the padded route truncates it; values past offsets[-1] are
        invalid. The coefficients are `_pool_coeff`'s, value by value: None
        for a batch of SUM features and no per-sample weights, where every
        one would be 1."""
        with tracing.span(ROUTE_SPAN):
            N, B = kjt.values.shape[0], kjt.stride
            offsets = lengths_to_offsets(kjt.lengths.to(torch.int32))
            pos = torch.arange(N, dtype=torch.int32, device=offsets.device)
            bag = (torch.searchsorted(offsets, pos, right=True) - 1).clamp(
                0, max(offsets.shape[0] - 2, 0))
            valid = (pos < offsets[-1]) & (pos - offsets[bag] < max_length)
            feature = bag // B
            gids = (kjt.values.to(torch.int32)
                    + self.feat_row_off[feature]).contiguous()
            coeff = None
            mean = bool(self.meta.feature_pooling_mean.any())
            if kjt.weights is not None or mean:
                dtype = self.weights.dtype
                coeff = valid.to(dtype)
                if kjt.weights is not None:
                    coeff = coeff * kjt.weights.to(dtype)
                if mean:
                    lengths = kjt.lengths.clamp(max=max_length)
                    denom = lengths.to(dtype).clamp(min=1.0)[bag]
                    coeff = torch.where(self.feat_mean[feature],
                                        coeff / denom, coeff)
            return JaggedRoute(gids, offsets, bag, valid, coeff,
                               len(kjt.keys), B, max_length)

    def forward_jagged(self, route: JaggedRoute) -> torch.Tensor:
        """The pooled output [F, B, D] fp32 of a jagged batch, K1j over its
        real values (no [F, B, L] layout is built)."""
        coeff = route.coeff
        if coeff is not None:  # rounded to the table's dtype, as K1's
            coeff = coeff.to(self.weights.dtype).float().contiguous()
        out = tbe_lookup_jagged_forward(self.weights, route.gids,
                                        route.offsets, coeff, route.cap)
        return out.reshape(route.features, route.batch, self.dim)

    def update_jagged(self, route: JaggedRoute, d_pooled: torch.Tensor,
                      learning_rate: float) -> None:
        """The fused update from a jagged batch: each real value's row
        gradient [N, D] is its bag's cotangent (times its coefficient),
        then `apply_fused_update` over the N values."""
        row_grads = d_pooled.reshape(-1, self.dim).index_select(0, route.bag)
        if route.coeff is not None:
            row_grads = row_grads * route.coeff[:, None]
        self._apply(route.gids, route.valid, row_grads, learning_rate)


class RwEmbeddingSharding(BaseEmbeddingShardingStrategy):
    """Row-wise: each table's rows split into n contiguous blocks of
    ceil(R / n) rows (the last one padded); rank d owns block d of every
    table. A row a rank does not own is masked out of its partial sums."""

    def _build(self) -> None:
        self.shard_rows = np.asarray(
            [_cdiv(t.rows, self.n) for t in self.meta.tables], np.int64)
        self.local_offsets = np.concatenate(
            [[0], np.cumsum(self.shard_rows)[:-1]]).astype(np.int64)
        self.rows_loc = _pad_rows_tile(int(self.shard_rows.sum()))
        ft = self.meta.feature_table
        dev = self.env.device
        # per-feature routing constants; buffers so that .to() moves them
        self.register_buffer("feat_shard_rows", torch.as_tensor(
            self.shard_rows[ft], dtype=torch.int32, device=dev),
            persistent=False)
        self.register_buffer("feat_local_off", torch.as_tensor(
            self.local_offsets[ft], dtype=torch.int32, device=dev),
            persistent=False)
        self.register_buffer("feat_mean", torch.as_tensor(
            self.meta.feature_pooling_mean, device=dev), persistent=False)

    def weights_shape(self) -> Tuple[int, ...]:
        return (self.n, self.rows_loc, self.dim)

    def _place(self, out, i, rows, start=0):
        # this rank owns the table's rows [rank * sr, (rank + 1) * sr)
        sr, off = int(self.shard_rows[i]), int(self.local_offsets[i])
        first = self.rank * sr
        lo, hi = max(start, first), min(start + rows.shape[0], first + sr)
        if lo < hi:
            dst = off + lo - first
            out[0, dst:dst + hi - lo] = rows[lo - start:hi - start].to(
                out.device)

    def _tables_of(self, w):
        return {t.name: w[:, int(off):int(off + sr)].reshape(
                    -1, *w.shape[2:])[: t.rows]
                for sr, off, t in zip(self.shard_rows, self.local_offsets,
                                      self.meta.tables)}

    def _table_span(self, i):
        off = int(self.local_offsets[i])
        return off, off + int(self.shard_rows[i])

    def _route(self, ids_g: torch.Tensor, lengths_g: torch.Tensor,
               my: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local row of each gathered id, and whether rank `my` owns it
        and it is not padding."""
        return route_tokens_reference(ids_g, lengths_g, self.feat_shard_rows,
                                      self.feat_local_off, my)

    def _fwd_gathered(self, w, ids_g, len_g, psw_g, L):
        """Forward body on global-batch inputs: the partial sums of the
        rows this rank owns, [F, B, D] fp32."""
        local, owned = self._route(ids_g, len_g, self.rank)
        coeff = _pool_coeff(len_g, L, self.feat_mean, psw_g, w.dtype)
        coeff = coeff * owned.to(w.dtype)
        return pooled_lookup(w[0], local, coeff)

    supports_input_dist = True

    def forward_from_dist(self, sb_g: PaddedSparseBatch) -> torch.Tensor:
        """Pooled output [F, B_loc, D] from the global batch: the partial
        sums of the owned rows, reduce_scatter over the batch."""
        part = self._fwd_gathered(self.weights, sb_g.ids, sb_g.lengths,
                                  sb_g.weights, sb_g.ids.shape[2])
        return comm.reduce_scatter(self.env, part, 1)

    def _upd_gathered(self, ids_g, len_g, psw_g, d_g, lr, L) -> None:
        """Update body on global-batch inputs (d_g: the gathered [F, B, D]
        cotangent): the owned rows' per-token gradients through the fused
        optimizer, in place."""
        local, owned = self._route(ids_g, len_g, self.rank)
        coeff = _pool_coeff(len_g, L, self.feat_mean, psw_g,
                            self.weights.dtype)
        row_grads = d_g[:, :, None, :] * coeff[:, :, :, None]
        apply_fused_update(
            self.weights[0], self._opt_local(), local.reshape(-1),
            row_grads.reshape(-1, self.dim), owned.reshape(-1), lr,
            **self._fused_kwargs())

    def update_from_dist(self, sb_g, d_pooled, learning_rate):
        """Fused optimizer step from the global batch and the cotangent of
        the local batch's pooled output [F, B_loc, D], in place: the
        cotangent all_gathered, the owned rows updated."""
        d_g = comm.all_gather(self.env, d_pooled, 1)
        self._upd_gathered(sb_g.ids, sb_g.lengths, sb_g.weights, d_g,
                           learning_rate, sb_g.ids.shape[2])


class TwEmbeddingSharding(BaseEmbeddingShardingStrategy):
    """Table-wise: whole tables on the rank of their plan. Each rank pools
    its own features over the global batch, f_max feature slots (pad slots
    pool nothing); an all_to_all turns the feature slots of the global
    batch into every feature of the local batch."""

    def _build(self) -> None:
        n = self.n
        tables = self.meta.tables
        per_dev: List[List[int]] = [[] for _ in range(n)]
        for ti, t in enumerate(tables):
            if not 0 <= t.rank < n:
                raise ValueError(f"table {t.name} placed on rank {t.rank} "
                                 f"outside a world of {n} ranks")
            per_dev[t.rank].append(ti)
        ft = self.meta.feature_table
        feats_of_table: List[List[int]] = [[] for _ in tables]
        for fi, ti in enumerate(ft):
            feats_of_table[ti].append(fi)
        self.f_max = max((sum(len(feats_of_table[ti]) for ti in tids)
                          for tids in per_dev), default=1) or 1
        self.rows_max = _pad_rows_tile(max(
            (sum(tables[ti].rows for ti in tids) for tids in per_dev),
            default=1) or 1)
        # [n, f_max]: the feature of each (rank, slot); a pad slot reads
        # feature 0 with its lengths masked to 0
        dev_feats = np.zeros((n, self.f_max), np.int64)
        dev_valid = np.zeros((n, self.f_max), bool)
        dev_rowoff = np.zeros((n, self.f_max), np.int64)
        # canonical feature -> rank * f_max + slot
        out_pos = np.zeros((len(ft),), np.int64)
        self.table_dev_rowoff = np.zeros((len(tables),), np.int64)
        for d, tids in enumerate(per_dev):
            slot = rowoff = 0
            for ti in tids:
                self.table_dev_rowoff[ti] = rowoff
                for fi in feats_of_table[ti]:
                    dev_feats[d, slot] = fi
                    dev_valid[d, slot] = True
                    dev_rowoff[d, slot] = rowoff
                    out_pos[fi] = d * self.f_max + slot
                    slot += 1
                rowoff += tables[ti].rows
        dev, r = self.env.device, self.rank
        for name, arr, dtype in (
                ("my_feats", dev_feats[r], torch.int64),
                ("my_valid", dev_valid[r], torch.bool),
                ("my_rowoff", dev_rowoff[r], torch.int32),
                ("my_mean", self.meta.feature_pooling_mean[dev_feats[r]],
                 torch.bool),
                ("out_pos", out_pos, torch.int64)):
            self.register_buffer(name, torch.as_tensor(
                arr, dtype=dtype, device=dev), persistent=False)

    def weights_shape(self) -> Tuple[int, ...]:
        return (self.n, self.rows_max, self.dim)

    def _place(self, out, i, rows, start=0):
        if self.meta.tables[i].rank == self.rank:
            off = int(self.table_dev_rowoff[i]) + start
            out[0, off:off + rows.shape[0]] = rows.to(out.device)

    def _tables_of(self, w):
        return {t.name: w[t.rank, int(off):int(off) + t.rows]
                for off, t in zip(self.table_dev_rowoff, self.meta.tables)}

    def _table_span(self, i):
        off = int(self.table_dev_rowoff[i])
        return off, off + self.meta.tables[i].rows

    def _table_of_span(self, g, i, rowwise):
        return g[self.meta.tables[i].rank]

    def _mine(self, ids_g, len_g, psw_g):
        """This rank's feature slots of the global batch: ids rebased to
        the rank's packed rows, lengths (0 in pad slots), weights."""
        ids_m = ids_g[self.my_feats] + self.my_rowoff[:, None, None]
        len_m = len_g[self.my_feats] * self.my_valid[:, None].to(len_g.dtype)
        psw_m = None if psw_g is None else psw_g[self.my_feats]
        return ids_m, len_m, psw_m

    supports_input_dist = True

    def _fwd_gathered(self, w, ids_g, len_g, psw_g, L):
        """Forward body on the global batch: this rank's features pooled,
        the feature slots all_to_all'ed to the batch's ranks."""
        ids_m, len_m, psw_m = self._mine(ids_g, len_g, psw_g)
        coeff = _pool_coeff(len_m, L, self.my_mean, psw_m, w.dtype)
        pooled = pooled_lookup(w[0], ids_m, coeff)
        slots = comm.all_to_all(self.env, pooled, 1, 0)  # [n f_max, B_loc, D]
        return slots[self.out_pos]

    def _slots_back(self, d: torch.Tensor) -> torch.Tensor:
        """The local batch's cotangent [F, B_loc, ...] -> this rank's
        feature slots of the global batch [f_max, B, ...]: scattered into
        every rank's slots, then the mirror all_to_all."""
        slots = d.new_zeros((self.n * self.f_max, *d.shape[1:]))
        slots[self.out_pos] = d
        return comm.all_to_all(self.env, slots, 0, 1)

    def _upd_gathered(self, ids_g, len_g, psw_g, d_pooled, lr, L):
        """Update body on the global batch (d_pooled: the local batch's
        cotangent [F, B_loc, D], routed back to this rank's features)."""
        d_m = self._slots_back(d_pooled)  # [f_max, B, D]
        ids_m, len_m, psw_m = self._mine(ids_g, len_g, psw_g)
        coeff = _pool_coeff(len_m, L, self.my_mean, psw_m,
                            self.weights.dtype)
        row_grads = d_m[:, :, None, :] * coeff[:, :, :, None]
        apply_fused_update(
            self.weights[0], self._opt_local(), ids_m.reshape(-1),
            row_grads.reshape(-1, self.dim),
            _token_mask(len_m, L).reshape(-1), lr, **self._fused_kwargs())

class CwEmbeddingSharding(BaseEmbeddingShardingStrategy):
    """Column-wise: each table's columns split into n equal blocks; rank j
    holds columns [j D/n, (j+1) D/n) of every row, pools them over the
    global batch, and an all_to_all turns the global batch's column block
    into the local batch's whole rows. Each column shard keeps its own
    rowwise optimizer state."""

    def _build(self) -> None:
        if self.dim % self.n:
            raise ValueError(f"COLUMN_WISE requires embedding_dim {self.dim} "
                             f"divisible by world size {self.n}")
        self.cols_loc = self.dim // self.n
        self.row_offsets = _row_offsets(self.meta)
        self.total_rows = _pad_rows_tile(
            sum(t.rows for t in self.meta.tables))
        dev = self.env.device
        self.register_buffer("feat_row_off", torch.as_tensor(
            self.row_offsets[self.meta.feature_table], dtype=torch.int32,
            device=dev), persistent=False)
        self.register_buffer("feat_mean", torch.as_tensor(
            self.meta.feature_pooling_mean, device=dev), persistent=False)

    def weights_shape(self) -> Tuple[int, ...]:
        return (self.n, self.total_rows, self.cols_loc)

    def rowwise_shards(self) -> int:
        return self.n

    def _place(self, out, i, rows, start=0):
        off = int(self.row_offsets[i]) + start
        cols = slice(self.rank * self.cols_loc, (self.rank + 1) * self.cols_loc)
        out[0, off:off + rows.shape[0]] = rows[:, cols].to(out.device)

    def _tables_of(self, w):
        full = w.transpose(0, 1).reshape(self.total_rows, self.dim)
        return {t.name: full[int(off):int(off) + t.rows]
                for off, t in zip(self.row_offsets, self.meta.tables)}

    def _table_span(self, i):
        off = int(self.row_offsets[i])
        return off, off + self.meta.tables[i].rows

    def _table_of_span(self, g, i, rowwise):
        if rowwise:
            return g  # [n, R]: each column shard's own accumulator
        return g.transpose(0, 1).reshape(self.meta.tables[i].rows, self.dim)

    def _place_rowwise(self, out, i, v):
        t = self.meta.tables[i]
        if v.dim() == 1 and self.n == 1:  # the plain row space at n = 1
            v = v[None]
        if tuple(v.shape) != (self.n, t.rows):
            raise ValueError(f"momentum of {t.name}: expected "
                             f"({self.n}, {t.rows}), got {tuple(v.shape)}")
        off = int(self.row_offsets[i])
        out[0, off:off + t.rows] = v[self.rank].to(out.device)

    def _rowwise_of(self, m):
        return {t.name: m[:, int(off):int(off) + t.rows]
                for off, t in zip(self.row_offsets, self.meta.tables)}

    supports_input_dist = True

    def _fwd_gathered(self, w, ids_g, len_g, psw_g, L):
        """Forward body on the global batch: the local columns pooled, the
        batch split and the columns concatenated by one all_to_all."""
        coeff = _pool_coeff(len_g, L, self.feat_mean, psw_g, w.dtype)
        pooled = pooled_lookup(
            w[0], ids_g + self.feat_row_off[:, None, None],
            coeff)  # [F, B, D / n]
        return comm.all_to_all(self.env, pooled, 1, 2)  # [F, B_loc, D]

    def _upd_gathered(self, ids_g, len_g, psw_g, d_pooled, lr, L):
        """Update body on the global batch (d_pooled: the local batch's
        cotangent [F, B_loc, D], its columns split back)."""
        d_g = comm.all_to_all(self.env, d_pooled, 2, 1)  # [F, B, D / n]
        coeff = _pool_coeff(len_g, L, self.feat_mean, psw_g,
                            self.weights.dtype)
        row_grads = d_g[:, :, None, :] * coeff[:, :, :, None]
        apply_fused_update(
            self.weights[0], self._opt_local(),
            (ids_g + self.feat_row_off[:, None, None]).reshape(-1),
            row_grads.reshape(-1, self.cols_loc),
            _token_mask(len_g, L).reshape(-1), lr, **self._fused_kwargs())

STRATEGY_REGISTRY = {
    ShardingType.DATA_PARALLEL: DpEmbeddingSharding,
    ShardingType.ROW_WISE: RwEmbeddingSharding,
    ShardingType.TABLE_WISE: TwEmbeddingSharding,
    ShardingType.COLUMN_WISE: CwEmbeddingSharding,
}


def create_sharding_strategy(
    env: ShardingEnv,
    meta: GroupMeta,
    optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
    optim_kwargs: Optional[dict] = None,
) -> BaseEmbeddingShardingStrategy:
    # the hierarchical strategies import this module
    from torchrec_tpu_torch.parallel.hierarchical_strategies import (
        TwCwEmbeddingSharding,
        TwRwEmbeddingSharding,
    )

    cls = {**STRATEGY_REGISTRY,
           ShardingType.TABLE_ROW_WISE: TwRwEmbeddingSharding,
           ShardingType.TABLE_COLUMN_WISE: TwCwEmbeddingSharding,
           }[meta.sharding_type]
    return cls(env, meta, optim, optim_kwargs)
