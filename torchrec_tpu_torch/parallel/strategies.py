"""Sharding strategies: ROW_WISE forward and fused update.

Counterpart of torchrec_tpu/parallel/strategies.py. Each strategy is a
module that holds one table group's shard in the JAX package's layout,
[n_dev, rows_loc, D]: each table's rows are split into n contiguous blocks
of ceil(R / n) rows, the tables' blocks are concatenated per device, and
the per-device row count is padded up to ROW_TILE. `unshard_to_dense`
inverts that packing exactly; full momenta, [n_dev, rows_loc, D] fp32,
pack as the weights do, and the rowwise momentum, [n_dev, rows_loc], the
same way (`unshard_rowwise` / `shard_rowwise`). The whole optimizer state
moves per table in the JAX strategies' canonical form
(`unshard_opt_to_tables` / `shard_opt_from_tables`).

ROW_WISE forward on n devices is all_gather(ids) -> masked lookup of the
rows this device owns (partial sums) -> psum_scatter over the batch; the
update all_gathers ids and cotangents and applies the fused optimizer to
the owned rows. On the one device of this slice the collectives are
identities: the forward is one K1 launch per group and the update one
`apply_fused_update`. The collectives for n > 1 and the DATA_PARALLEL /
TABLE_WISE / COLUMN_WISE / hierarchical strategies come with later slices
and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    data_type_to_torch_dtype,
)
from torchrec_tpu_torch.ops.embedding import pooled_lookup
from torchrec_tpu_torch.ops.gather_rows import route_tokens_reference
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    FusedOptimizerState,
    apply_fused_update,
    check_trainable,
    fused_state_shapes,
)
from torchrec_tpu_torch.parallel.embedding_sharding import GroupMeta
from torchrec_tpu_torch.parallel.types import ShardingEnv, ShardingType
from torchrec_tpu_torch.sparse.jagged import PaddedSparseBatch

# Per-device packed row counts are padded to this tile, as in the JAX
# package, so that a shard round-trips between the two packages unchanged.
ROW_TILE = 128

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


class BaseEmbeddingShardingStrategy(nn.Module):
    """One table group sharded one way. Holds the group's shard as the
    buffer `weights` and the fused optimizer state as the buffers
    `momentum1` / `momentum2` (None where the optimizer keeps none; fp32,
    shaped weights_shape() or weights_shape()[:-1]) and `step`.

    optim / optim_kwargs: the fused optimizer and its fused_params (see
    ops/fused_update.apply_fused_update).
    """

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
        self.n = env.world_size
        self.dim = meta.dim
        # table storage dtype; pooled outputs and optimizer state are fp32
        self.w_dtype = data_type_to_torch_dtype(meta.data_type)
        self._build()
        self.register_buffer("weights", torch.zeros(
            self.weights_shape(), dtype=self.w_dtype, device=env.device))
        for name, kind in zip(("momentum1", "momentum2"),
                              fused_state_shapes(optim)):
            shape = {"row": self.weights_shape()[:-1],
                     "full": self.weights_shape()}.get(kind)
            self.register_buffer(name, None if shape is None else torch.zeros(
                shape, dtype=torch.float32, device=env.device))
        self.register_buffer("step", torch.zeros(
            (), dtype=torch.int32, device=env.device))

    def _build(self) -> None:
        raise NotImplementedError

    def weights_shape(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def _place(self, out: torch.Tensor, i: int, table: torch.Tensor) -> None:
        """Write table i's unsharded [R, D] rows into the packed `out`."""
        raise NotImplementedError

    def init_weights(
        self, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """Packed weights with each table drawn from U(-b, b),
        b = sqrt(1 / rows), as the JAX strategy draws them."""
        out = torch.zeros(self.weights_shape(), dtype=self.w_dtype,
                          device=self.weights.device)
        for i, t in enumerate(self.meta.tables):
            bound = (1.0 / t.rows) ** 0.5
            table = torch.empty((t.rows, t.dim), device=out.device)
            self._place(out, i, table.uniform_(-bound, bound,
                                               generator=generator))
        return out

    def shard_from_dense(self, dense: Mapping[str, ArrayLike],
                         dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """Pack unsharded per-table [R_t, D] arrays (numpy, including JAX's
        `ml_dtypes.bfloat16`, or torch) into this strategy's layout, in
        `dtype` (default: the table's; pass torch.float32 for momenta,
        which never live in half precision)."""
        out = torch.zeros(self.weights_shape(), dtype=dtype or self.w_dtype,
                          device=self.weights.device)
        for i, t in enumerate(self.meta.tables):
            table = as_tensor(dense[t.name], out.device)
            if tuple(table.shape) != (t.rows, t.dim):
                raise ValueError(
                    f"table {t.name}: expected {(t.rows, t.dim)}, got "
                    f"{tuple(table.shape)}"
                )
            self._place(out, i, table)
        return out

    def unshard_to_dense(self, weights: torch.Tensor) -> Dict[str, np.ndarray]:
        """Per-table [R, D] numpy arrays (bf16 tables come back as fp32,
        which holds them exactly: numpy has no bf16)."""
        raise NotImplementedError

    def unshard_tensors(self, weights: torch.Tensor
                        ) -> Dict[str, torch.Tensor]:
        """Per-table [R, D] tensors of `weights`, on its device, in its
        dtype (views where the layout allows)."""
        raise NotImplementedError

    def unshard_rowwise(self, m: torch.Tensor) -> Dict[str, np.ndarray]:
        """Per-table [R] numpy view of a rowwise momentum array shaped
        weights_shape()[:-1]."""
        raise NotImplementedError

    def shard_rowwise(self, per_table: Mapping[str, ArrayLike]) -> torch.Tensor:
        """Inverse of unshard_rowwise: the plan-shaped rowwise momentum."""
        raise NotImplementedError

    # -- fused optimizer state ------------------------------------------------

    @property
    def opt(self) -> FusedOptimizerState:
        return FusedOptimizerState(momentum1=self.momentum1,
                                   momentum2=self.momentum2, step=self.step,
                                   optim=self.optim)

    def _opt_local(self) -> FusedOptimizerState:
        """The state with the leading device axis stripped (views)."""
        opt = self.opt
        return dataclasses.replace(
            opt,
            momentum1=None if opt.momentum1 is None else opt.momentum1[0],
            momentum2=None if opt.momentum2 is None else opt.momentum2[0])

    def unshard_opt_to_tables(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The optimizer state per table, in the canonical form of the JAX
        strategies' `unshard_opt_to_tables`: {table: {"m1__full" [R, D] |
        "m1__row" [R], the same for "m2", "step": int32}}."""
        out: Dict[str, Dict[str, np.ndarray]] = {
            t.name: {} for t in self.meta.tables}
        for tag, kind in zip(("m1", "m2"), fused_state_shapes(self.optim)):
            if kind == "none":
                continue
            m = getattr(self, f"momentum{tag[1]}")
            per = (self.unshard_to_dense(m) if kind == "full"
                   else self.unshard_rowwise(m))
            for name, arr in per.items():
                out[name][f"{tag}__{kind}"] = arr
        step = np.asarray(self.step.item(), np.int32)
        for entry in out.values():
            entry["step"] = step
        return out

    @torch.no_grad()
    def shard_opt_from_tables(
        self, per_table: Mapping[str, Mapping[str, ArrayLike]]
    ) -> None:
        """Load `unshard_opt_to_tables`' form into the momentum and step
        buffers. Raises unless every table carries the momenta this
        optimizer keeps, at their shapes, and a step; the group's step is
        the largest, as the JAX strategies take it."""
        for tag, kind in zip(("m1", "m2"), fused_state_shapes(self.optim)):
            if kind == "none":
                continue
            key = f"{tag}__{kind}"
            per = {}
            for t in self.meta.tables:
                arr = per_table.get(t.name, {}).get(key)
                if arr is None:
                    raise ValueError(f"{self.optim.name} state of table "
                                     f"{t.name} has no {key}")
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

    def update(self, sb: PaddedSparseBatch, d_pooled: torch.Tensor,
               learning_rate: float) -> None:
        raise NotImplementedError


class RwEmbeddingSharding(BaseEmbeddingShardingStrategy):
    """Row-wise: each table's rows split into n contiguous blocks of
    ceil(R / n) rows (the last one padded); device d owns block d of every
    table. A row a table does not own is masked out of the pooling."""

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

    def _place(self, out, i, table):
        t = self.meta.tables[i]
        sr, off = int(self.shard_rows[i]), int(self.local_offsets[i])
        blocks = torch.zeros((self.n * sr, t.dim), dtype=out.dtype,
                             device=out.device)
        blocks[: t.rows] = table
        out[:, off:off + sr] = blocks.reshape(self.n, sr, t.dim)

    def unshard_tensors(self, weights):
        out = {}
        for sr, off, t in zip(self.shard_rows, self.local_offsets,
                              self.meta.tables):
            tbl = weights[:, int(off):int(off + sr), :].reshape(-1, t.dim)
            out[t.name] = tbl[: t.rows]
        return out

    def unshard_to_dense(self, weights):
        w = weights.detach().cpu()
        if w.dtype == torch.bfloat16:
            w = w.float()
        return {name: t.numpy().copy()
                for name, t in self.unshard_tensors(w).items()}

    def unshard_rowwise(self, m):
        m = m.detach().cpu()
        return {
            t.name: m[:, int(off):int(off + sr)].reshape(-1)[: t.rows]
            .numpy().copy()
            for sr, off, t in zip(self.shard_rows, self.local_offsets,
                                  self.meta.tables)
        }

    def shard_rowwise(self, per_table):
        out = torch.zeros(self.weights_shape()[:-1], dtype=torch.float32,
                          device=self.weights.device)
        for sr, off, t in zip(self.shard_rows, self.local_offsets,
                              self.meta.tables):
            v = as_tensor(per_table[t.name]).float()
            if tuple(v.shape) != (t.rows,):
                raise ValueError(f"momentum of {t.name}: expected "
                                 f"({t.rows},), got {tuple(v.shape)}")
            blocks = torch.zeros((self.n * int(sr),), dtype=torch.float32)
            blocks[: t.rows] = v
            out[:, int(off):int(off + sr)] = blocks.reshape(self.n, int(sr))
        return out

    def _route(self, ids_g: torch.Tensor, lengths_g: torch.Tensor,
               my: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Local row of each gathered id, and whether device `my` owns it
        and it is not padding."""
        return route_tokens_reference(ids_g, lengths_g, self.feat_shard_rows,
                                      self.feat_local_off, my)

    def _fwd_gathered(self, w, ids_g, len_g, psw_g, L):
        """Forward body on global-batch inputs: the partial sums of the
        rows this device owns, [F, B, D] fp32."""
        local, owned = self._route(ids_g, len_g, self.env.rank)
        coeff = _pool_coeff(len_g, L, self.feat_mean, psw_g, w.dtype)
        coeff = coeff * owned.to(w.dtype)
        return pooled_lookup(w[0], local, coeff)

    def forward(self, sb: PaddedSparseBatch) -> torch.Tensor:
        """Pooled output [F, B, D]. On one device the all_gather of the
        ids and the psum_scatter of the partial sums are identities."""
        return self._fwd_gathered(self.weights, sb.ids, sb.lengths,
                                  sb.weights, sb.ids.shape[2])

    def _upd_gathered(self, ids_g, len_g, psw_g, d_g, lr, L) -> None:
        """Update body on global-batch inputs (d_g: the gathered [F, B, D]
        cotangent): the owned rows' per-token gradients through the fused
        optimizer, in place."""
        local, owned = self._route(ids_g, len_g, self.env.rank)
        coeff = _pool_coeff(len_g, L, self.feat_mean, psw_g,
                            self.weights.dtype)
        row_grads = d_g[:, :, None, :] * coeff[:, :, :, None]
        apply_fused_update(
            self.weights[0], self._opt_local(), local.reshape(-1),
            row_grads.reshape(-1, self.dim), owned.reshape(-1), lr,
            **self.optim_kwargs)

    def update(self, sb, d_pooled, learning_rate):
        """Fused optimizer step from the cotangent of the pooled output
        [F, B, D], in place. On one device the all_gathers of the ids and
        of the cotangent are identities."""
        self._upd_gathered(sb.ids, sb.lengths, sb.weights, d_pooled,
                           learning_rate, sb.ids.shape[2])


def create_sharding_strategy(
    env: ShardingEnv,
    meta: GroupMeta,
    optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
    optim_kwargs: Optional[dict] = None,
) -> BaseEmbeddingShardingStrategy:
    if meta.sharding_type is not ShardingType.ROW_WISE:
        raise NotImplementedError(
            f"sharding type {meta.sharding_type.value}: only ROW_WISE is "
            "ported; the other strategies come with the multi-GPU slice"
        )
    return RwEmbeddingSharding(env, meta, optim, optim_kwargs)
