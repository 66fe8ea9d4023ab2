"""Embedding-tower sharding: each tower's tables beside its interaction
module on one rank.

Counterpart of torchrec_tpu/parallel/tower_sharding.py. A tower is its
tables and its interaction module, placed whole on one rank. The rank
looks its towers' features up over the global batch, runs their
interactions there and sends the small [B, d_out] outputs back to the
ranks of the batch, instead of [F, B, D] pooled rows.

Layout: rank r holds its towers' tables row-concatenated in one
[1, rows_max, D] block, padded to ROW_TILE rows (JAX's [n, rows_max, D]
layout, device r's block), and builds and loads only that block. Every
table must share one embedding_dim. The interaction modules are
replicated: every rank holds every tower's, so that a rank steps them
all alike.

Forward: one all_gather of the ids and lengths (and one of the
per-sample weights); one K1 lookup of all the rank's tower features, each
token's coefficient JAX's `_slot_pooled` builds (the token mask, times the
per-sample weight, divided by the length for a MEAN table); each of the
rank's towers' interaction on its [B, F_t x D] pooled values; the outputs
padded to d_out_max in the rank's t_max slots (zeros where the rank has no
tower) and one all_to_all into the batch-sharded layout; each tower's
[:, :d_out] in tower order. The JAX module runs one program on every
device and picks each device's branch with `lax.switch`; here a rank
loops over its own towers.

Update: the cotangent's all_to_all back to the towers' ranks; each of the
rank's towers' interaction backward, giving the pooled values'
cotangent and the interaction's gradient; the row gradients d_pooled x
coeff of every tower of the rank through one `apply_fused_update` (K3
under EXACT_SGD, the fused K4 under ROWWISE_ADAGRAD); the interaction
gradients summed over the ranks (one all_reduce: only the owner's is not
zero, as JAX's `psum`) and stepped by SGD at `interaction_lr` (default:
the update's learning rate). The update reuses the pooled values of the
forward that came just before it on the same batch object (the DMP's
train step makes such a pair), where JAX looks them up again: the numbers
are the same, and a train step makes one K1 launch and one ids all_gather
instead of two. Called on another batch, it looks them up itself.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    PoolingType,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    SparseInput,
    as_padded,
)
from torchrec_tpu_torch.modules.utils import reset_seeded
from torchrec_tpu_torch.ops.embedding import pooled_lookup
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    FusedOptimizerState,
    apply_fused_update,
    check_trainable,
    fused_state_shapes,
)
from torchrec_tpu_torch.parallel import comm
from torchrec_tpu_torch.parallel.strategies import (
    INIT_CHUNK_ROWS,
    ArrayLike,
    _pad_rows_tile,
    _pool_coeff,
    _token_mask,
    as_tensor,
    gather_batch,
)
from torchrec_tpu_torch.parallel.types import ShardingEnv
from torchrec_tpu_torch.sparse.jagged import PaddedSparseBatch


@dataclasses.dataclass
class TowerSpec:
    """One tower: its tables, its interaction module (an nn.Module taking
    the pooled values [B, sum(table dims x features)] to [B, d_out]), its
    rank and d_out."""

    tables: Tuple[EmbeddingBagConfig, ...]
    interaction: nn.Module
    device: int
    d_out: int


def _on_device(m: nn.Module, device: torch.device) -> nn.Module:
    """`m` on `device`: allocated there, uninitialised, when it is on
    `meta`, else moved."""
    if any(t.is_meta for t in (*m.parameters(), *m.buffers())):
        return m.to_empty(device=device)
    return m.to(device)


class ShardedEmbeddingTowerCollection(nn.Module):
    """The towers over `env`, their tables under the fused optimizer
    `optim` with `optim_kwargs` (ops/fused_update.apply_fused_update's
    fused_params; `input_routing` is ignored, as in JAX), their
    interactions under SGD at `interaction_lr`. `max_feature_length` is
    the L a KeyedJaggedTensor input is padded to.

    `injected`: while set, `forward` returns it (the DMP's train step sets
    it to the output it computed outside autograd)."""

    def __init__(
        self,
        env: ShardingEnv,
        towers: Sequence[TowerSpec],
        optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
        optim_kwargs: Optional[dict] = None,
        interaction_lr: Optional[float] = None,
        max_feature_length: int = 1,
    ):
        super().__init__()
        self.env = env
        self.towers = list(towers)
        self.optim = optim
        self.optim_kwargs = dict(optim_kwargs or {})
        self.optim_kwargs.pop("input_routing", None)
        self.interaction_lr = interaction_lr
        self.max_feature_length = max_feature_length
        self.injected = None
        self._saved = None
        n, rank = env.world_size, env.rank
        dims = {t.embedding_dim for tw in self.towers for t in tw.tables}
        if len(dims) != 1:
            raise ValueError(
                f"tower tables must share embedding_dim, got {sorted(dims)}")
        self.dim = dims.pop()
        for tw in self.towers:
            if not 0 <= tw.device < n:
                raise ValueError(f"tower device {tw.device} outside mesh {n}")
        self.tables = tuple(t for tw in self.towers for t in tw.tables)
        per_dev: List[List[int]] = [[] for _ in range(n)]
        for ti, tw in enumerate(self.towers):
            per_dev[tw.device].append(ti)
        self.per_dev = per_dev
        self.t_max = max((len(ts) for ts in per_dev), default=1) or 1
        self.d_out_max = max(tw.d_out for tw in self.towers)
        self.out_offsets = np.concatenate(
            [[0], np.cumsum([tw.d_out for tw in self.towers])]).astype(int)
        self.total_d_out = int(self.out_offsets[-1])
        # canonical feature order: declaration order across towers
        self.features: List[str] = [
            f for tw in self.towers for t in tw.tables for f in t.feature_names]
        self.rows_max = _pad_rows_tile(max(
            (sum(t.num_embeddings for ti in ts for t in self.towers[ti].tables)
             for ts in per_dev), default=1) or 1)
        # tower -> its slot in the all_to_all'd layout, rank * t_max + slot
        self.slot_pos = [0] * len(self.towers)
        self.table_rowoff: Dict[str, Tuple[int, int]] = {}  # -> (rank, off)
        for d, ts in enumerate(per_dev):
            rowoff = 0
            for s, ti in enumerate(ts):
                self.slot_pos[ti] = d * self.t_max + s
                for t in self.towers[ti].tables:
                    self.table_rowoff[t.name] = (d, rowoff)
                    rowoff += t.num_embeddings
        # this rank's towers and their features, in order
        self.mine = per_dev[rank]
        self.my_features: List[str] = []
        rowoffs, means, self.my_feature_counts = [], [], []
        for ti in self.mine:
            count = 0
            for t in self.towers[ti].tables:
                for f in t.feature_names:
                    self.my_features.append(f)
                    rowoffs.append(self.table_rowoff[t.name][1])
                    means.append(getattr(t, "pooling", PoolingType.SUM)
                                 is PoolingType.MEAN)
                    count += 1
            self.my_feature_counts.append(count)
        dev = env.device
        self.register_buffer("my_rowoff", torch.as_tensor(
            rowoffs, dtype=torch.int32, device=dev), persistent=False)
        self.register_buffer("my_mean", torch.as_tensor(
            means, dtype=torch.bool, device=dev), persistent=False)
        self.interactions = nn.ModuleList(
            _on_device(tw.interaction, dev) for tw in self.towers)
        shape = (1, self.rows_max, self.dim)
        self.register_buffer("weights", torch.zeros(shape, device=dev))
        for name, kind in zip(("momentum1", "momentum2"),
                              fused_state_shapes(optim)):
            mshape = {"row": shape[:-1], "full": shape}.get(kind)
            self.register_buffer(name, None if mshape is None else
                                 torch.zeros(mshape, device=dev))
        self.register_buffer("step", torch.zeros((), dtype=torch.int32,
                                                 device=dev))

    # -- state ----------------------------------------------------------------

    @property
    def opt(self) -> FusedOptimizerState:
        return FusedOptimizerState(momentum1=self.momentum1,
                                   momentum2=self.momentum2, step=self.step,
                                   optim=self.optim)

    def _place(self, out: torch.Tensor, name: str, rows: torch.Tensor,
               start: int = 0) -> None:
        """Write rows [start, start + len(rows)) of table `name` into the
        rank's block `out` when the rank holds the table."""
        d, off = self.table_rowoff[name]
        if d == self.env.rank:
            out[0, off + start:off + start + rows.shape[0]] = rows.to(
                out.device)

    @torch.no_grad()
    def reset_opt(self) -> None:
        """Zero the momenta and the step, as a fresh init_opt."""
        for t in (self.momentum1, self.momentum2, self.step):
            if t is not None:
                t.zero_()

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw every table from U(-b, b), b = sqrt(1 / rows), as the JAX
        module draws them, and every interaction's parameters (their
        modules' seeded reset_parameters), all from `generator`; zero the
        fused optimizer state. Every rank draws every table, in chunks of
        INIT_CHUNK_ROWS rows, in tower order, and keeps its own."""
        out = torch.zeros_like(self.weights)
        for t in self.tables:
            bound = (1.0 / t.num_embeddings) ** 0.5
            for start in range(0, t.num_embeddings, INIT_CHUNK_ROWS):
                rows = torch.empty(
                    (min(INIT_CHUNK_ROWS, t.num_embeddings - start),
                     t.embedding_dim), device=out.device)
                self._place(out, t.name, rows.uniform_(
                    -bound, bound, generator=generator), start)
        self.weights = out
        for m in self.interactions:
            reset_seeded(m, generator)
        self.reset_opt()

    def shard_tables_from_dense(
            self, dense: Mapping[str, ArrayLike]) -> torch.Tensor:
        """The rank's block of the per-table [R, D] arrays (every table)."""
        out = torch.zeros_like(self.weights)
        for t in self.tables:
            table = as_tensor(dense[t.name])
            if tuple(table.shape) != (t.num_embeddings, t.embedding_dim):
                raise ValueError(f"table {t.name}: expected "
                                 f"{(t.num_embeddings, t.embedding_dim)}, "
                                 f"got {tuple(table.shape)}")
            self._place(out, t.name, table)
        return out

    def unshard_tables(self, weights: Optional[torch.Tensor] = None
                       ) -> Dict[str, torch.Tensor]:
        """Per-table [R, D] tensors of `weights` (default: the module's
        block) and the other ranks', on the device (an all_gather at world
        size n: every rank calls it)."""
        w = self.weights if weights is None else weights
        if self.env.world_size > 1:
            w = comm.all_gather(self.env, w, 0)
        return {t.name: w[d, off:off + t.num_embeddings]
                for t in self.tables
                for d, off in (self.table_rowoff[t.name],)}

    def _table_to_host(self, block: torch.Tensor, name: str) -> np.ndarray:
        """Table `name` of `block` (the weights or a momentum, leading rank
        axis) as a host array: at world size n one all_gather of the
        table's rows of every rank's block, never the whole layout."""
        d, off = self.table_rowoff[name]
        rows = next(t.num_embeddings for t in self.tables if t.name == name)
        part = block[:, off:off + rows]
        if self.env.world_size > 1:
            part = comm.all_gather(self.env, part.contiguous(), 0)
        else:
            d = 0
        return part[d].detach().cpu().numpy().copy()

    def unshard_to_dense(self, weights: Optional[torch.Tensor] = None
                         ) -> Dict[str, np.ndarray]:
        """Per-table [R, D] numpy arrays of `weights` (default: the
        module's block), gathered one table at a time."""
        w = self.weights if weights is None else weights
        return {t.name: self._table_to_host(w, t.name) for t in self.tables}

    def unshard_opt_to_tables(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The fused optimizer state per table, in the form of the
        strategies' `unshard_opt_to_tables`: {table: {"m1__row" [R] |
        "m1__full" [R, D], the same for "m2", "step"}}."""
        out: Dict[str, Dict[str, np.ndarray]] = {t.name: {}
                                                 for t in self.tables}
        for tag, kind in zip(("m1", "m2"), fused_state_shapes(self.optim)):
            if kind == "none":
                continue
            m = getattr(self, f"momentum{tag[1]}")
            for t in self.tables:
                out[t.name][f"{tag}__{kind}"] = self._table_to_host(m, t.name)
        step = np.asarray(self.step.item(), np.int32)
        for entry in out.values():
            entry["step"] = step
        return out

    @torch.no_grad()
    def load_tables(self, dense: Mapping[str, ArrayLike]) -> None:
        """Load (a subset of) the tables; the others and the interaction
        parameters stay, the fused optimizer state restarts, as the JAX
        module's `load_tables`."""
        for name, arr in dense.items():
            if name not in self.table_rowoff:
                raise ValueError(f"no tower table {name!r}")
            self._place(self.weights, name, as_tensor(arr))
        self.reset_opt()

    def check_trainable(self) -> None:
        check_trainable(torch.float32, self.optim_kwargs)

    # -- compute --------------------------------------------------------------

    def _lookup(self, sb: PaddedSparseBatch):
        """The rank's tower features over the global batch: (ids rebased
        to its block, coefficients, token mask, pooled [F_mine, B, D]);
        None when the rank has no tower."""
        ids_g, len_g, psw_g = gather_batch(self.env, sb)
        if not self.mine:
            return None
        L = ids_g.shape[2]
        key_index = {k: i for i, k in enumerate(sb.keys)}
        sel = torch.as_tensor([key_index[f] for f in self.my_features],
                              dtype=torch.long, device=ids_g.device)
        ids_m = ids_g[sel] + self.my_rowoff[:, None, None]
        len_m = len_g[sel]
        psw_m = None if psw_g is None else psw_g[sel]
        coeff = _pool_coeff(len_m, L, self.my_mean, psw_m, torch.float32)
        pooled = pooled_lookup(self.weights[0], ids_m, coeff)
        return ids_m, coeff, _token_mask(len_m, L), pooled

    def _tower_inputs(self, pooled: torch.Tensor) -> List[torch.Tensor]:
        """Each of the rank's towers' interaction input [B, F_t x D]."""
        B = pooled.shape[1]
        return [p.transpose(0, 1).reshape(B, -1)
                for p in pooled.split(self.my_feature_counts)]

    def forward(self, features: SparseInput,
                dist: Optional[Any] = None) -> torch.Tensor:
        """-> [B_loc, sum(d_out)], the towers' outputs in tower order.

        Args:
            features: the local batch, padded or jagged.
            dist: ignored (towers have no input dist ahead of the step).
        """
        del dist  # towers have no input dist ahead of the step
        if self.injected is not None:
            return self.injected
        sb = as_padded(features, self.max_feature_length)
        looked = self._lookup(sb)
        B = sb.ids.shape[1] * self.env.world_size
        outs = torch.zeros((self.t_max, B, self.d_out_max),
                           device=self.weights.device)
        if looked is not None:
            for s, (ti, x) in enumerate(zip(self.mine,
                                            self._tower_inputs(looked[3]))):
                outs[s, :, :self.towers[ti].d_out] = self.interactions[ti](x)
        if not torch.is_inference_mode_enabled():
            self._saved = (features, looked)
        slots = comm.all_to_all(self.env, outs, 1, 0)  # [n t_max, B_loc, .]
        return torch.cat([slots[self.slot_pos[ti], :, :tw.d_out]
                          for ti, tw in enumerate(self.towers)], dim=1)

    def _interaction_params(self) -> List[nn.Parameter]:
        return [p for m in self.interactions for p in m.parameters()]

    @torch.no_grad()
    def update(self, features: SparseInput, d_out: torch.Tensor,
               learning_rate: float, dist: Optional[Any] = None) -> None:
        """One fused step, in place, from the cotangent of the forward's
        output [B_loc, sum(d_out)]: the tables under the fused optimizer at
        `learning_rate`, the interaction parameters under SGD at
        `interaction_lr` (default: `learning_rate`).

        Args:
            features: the forward's batch.
            d_out: the cotangent of its output.
            learning_rate: the fused optimizer's.
            dist: ignored.
        """
        del dist
        saved, self._saved = self._saved, None
        if saved is not None and saved[0] is features:
            looked = saved[1]
        else:
            looked = self._lookup(as_padded(features,
                                            self.max_feature_length))
        B_loc = d_out.shape[0]
        slot_d = d_out.new_zeros((self.env.world_size * self.t_max, B_loc,
                                  self.d_out_max))
        for ti, tw in enumerate(self.towers):
            lo, hi = self.out_offsets[ti], self.out_offsets[ti + 1]
            slot_d[self.slot_pos[ti], :, :tw.d_out] = d_out[:, lo:hi]
        d_slots = comm.all_to_all(self.env, slot_d, 0, 1)  # [t_max, B, .]
        grads = {id(p): torch.zeros_like(p)
                 for p in self._interaction_params()}
        if looked is None:
            self.step.add_(1)  # JAX's update steps every device
        else:
            ids_m, coeff, valid, pooled = looked
            d_pooled = []
            for s, (ti, x) in enumerate(zip(self.mine,
                                            self._tower_inputs(pooled))):
                inter = self.interactions[ti]
                params = list(inter.parameters())
                x = x.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = inter(x)
                got = torch.autograd.grad(
                    out, [x, *params],
                    d_slots[s, :, :self.towers[ti].d_out], allow_unused=True)
                d_pooled.append(got[0].reshape(x.shape[0], -1, self.dim)
                                .transpose(0, 1))
                for p, g in zip(params, got[1:]):
                    if g is not None:
                        grads[id(p)] += g
            d_pooled = torch.cat(d_pooled)  # [F_mine, B, D]
            row_grads = d_pooled[:, :, None, :] * coeff[:, :, :, None]
            opt = self.opt
            apply_fused_update(
                self.weights[0], dataclasses.replace(
                    opt,
                    momentum1=None if opt.momentum1 is None
                    else opt.momentum1[0],
                    momentum2=None if opt.momentum2 is None
                    else opt.momentum2[0]),
                ids_m.reshape(-1), row_grads.reshape(-1, self.dim),
                valid.reshape(-1), learning_rate, **self.optim_kwargs)
        # the interactions' gradients summed over the ranks (only the
        # owner's is not zero), then SGD
        params = self._interaction_params()
        flat = [grads[id(p)] for p in params]
        comm.all_reduce_sum(self.env, flat)
        lr = (self.interaction_lr if self.interaction_lr is not None
              else learning_rate)
        for p, g in zip(params, flat):
            p.sub_(lr * g)


class ShardedEmbeddingTower(ShardedEmbeddingTowerCollection):
    """One sharded tower: the collection of one tower, its forward the
    tower's [B_loc, d_out]."""

    def __init__(
        self,
        env: ShardingEnv,
        tower: TowerSpec,
        optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
        optim_kwargs: Optional[dict] = None,
        interaction_lr: Optional[float] = None,
        max_feature_length: int = 1,
    ):
        super().__init__(env, [tower], optim=optim, optim_kwargs=optim_kwargs,
                         interaction_lr=interaction_lr,
                         max_feature_length=max_feature_length)
