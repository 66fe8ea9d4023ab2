"""Host-resident EmbeddingBagCollections: the FUSED_UVM_CACHING tables.

Counterpart of torchrec_tpu/parallel/uvm_ebc.py (`UvmEmbeddingBagCollection`)
and of the JAX DMP's UVM split (torchrec_tpu/parallel/dmp.py,
`_build_uvm_split`, `_merge_uvm`, `_split_uvm_grad`).

`UvmEmbeddingBagCollection` holds one `UvmCachedEmbedding` per table
(ops/uvm_cache.py): the table and its momenta in pinned host memory, a
cache of max(min_cache_rows, int(R * cache_load_factor)) rows, at most R,
on the device. Its forward stages each table's features' ids into the
cache and makes one K1 lookup per feature (SUM on the cache, then divided
by the length for a MEAN table, as JAX divides); its update makes ONE
`apply_fused_update` per table over all its features, so that a row two
features share in a batch is combined, not updated twice. It is driven
from the host and is not an nn.Module: its state is the host tables, the
caches and their directories.

`UvmSplitEmbeddingBagCollection` is what an EmbeddingBagCollection with
FUSED_UVM_CACHING tables becomes under the DMP: a
ShardedEmbeddingBagCollection over its other tables (or none) and the
UVM tables' collection, its output the KeyedTensor in the module's
declared column order (JAX's `perm`), its update the cotangent split back
with `inv_perm`. At world size n the UVM collection lives on one rank,
the first UVM table's `ranks[0]` (0 when unset), which serves the global
batch as JAX's single controller does: the UVM features' ids reach it by
the all_gather TABLE_WISE makes; it stages, looks up and updates over the
global batch, so its hits and misses equal JAX's; an all_to_all sends
each rank its rows of the pooled values, and the cotangent (divided by n
as every sparse cotangent) comes back to it the same way.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    EmbeddingBagConfig,
    pooling_type_to_mode,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    SparseInput,
    as_padded,
    embedding_names_by_table,
)
from torchrec_tpu_torch.ops.embedding import PoolingMode
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    check_trainable,
    fused_state_shapes,
)
from torchrec_tpu_torch.ops.uvm_cache import (
    HostArray,
    UvmCachedEmbedding,
    host_tensor,
)
from torchrec_tpu_torch.parallel import comm
from torchrec_tpu_torch.parallel.sharded_ebc import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.strategies import gather_batch
from torchrec_tpu_torch.parallel.types import (
    ComputeKernel,
    ParameterSharding,
    ShardingEnv,
)
from torchrec_tpu_torch.sparse.jagged import KeyedTensor, PaddedSparseBatch
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

# rows drawn per chunk by `init`: at most 1 GiB of f32 at D = 1
INIT_CHUNK_FLOATS = 1 << 28

HostBatch = Tuple[np.ndarray, np.ndarray]  # (ids [F, B, L], lengths [F, B])


def _host_batch(sb: PaddedSparseBatch) -> HostBatch:
    return sb.ids.cpu().numpy(), sb.lengths.cpu().numpy()


class UvmEmbeddingBagCollection:
    """Several host-resident tables, each with its row cache on `device`.

    tables: EmbeddingBagConfigs; weights: {name: [R, D] numpy array or CPU
    tensor}, copied unless already a host tensor this class would make
    (pinned for a card), which is adopted. optim / optim_kwargs: the fused
    optimizer and its fused_params (`input_routing` and `emb_impl` are
    dropped, as JAX drops them). A table name ending in `.m2` or `.step`
    raises: `momentum_dict` uses those suffixes.
    """

    def __init__(
        self,
        tables: Sequence[EmbeddingBagConfig],
        weights: Mapping[str, HostArray],
        cache_load_factor: float = 0.2,
        min_cache_rows: int = 1024,
        optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
        optim_kwargs: Optional[dict] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        optim_kwargs = dict(optim_kwargs or {})
        optim_kwargs.pop("input_routing", None)
        optim_kwargs.pop("emb_impl", None)
        self.tables = tuple(tables)
        for t in self.tables:
            if t.name.endswith((".m2", ".step")):
                raise ValueError(
                    f"UVM table name {t.name!r} ends in a reserved "
                    "checkpoint suffix ('.m2'/'.step')")
        self._emb_names = embedding_names_by_table(self.tables)
        self.embedding_names = tuple(
            n for names in self._emb_names for n in names)
        self.optim = optim
        self._uvm: Dict[str, UvmCachedEmbedding] = {}
        for t in self.tables:
            rows = max(min_cache_rows, int(t.num_embeddings * cache_load_factor))
            self._uvm[t.name] = UvmCachedEmbedding(
                weights[t.name], cache_rows=min(rows, t.num_embeddings),
                optim=optim, optim_kwargs=optim_kwargs, device=self.device)

    @property
    def width(self) -> int:
        """The pooled output's width, sum(D) over the features."""
        return sum(t.embedding_dim * len(t.feature_names) for t in self.tables)

    def _features(self, sb: PaddedSparseBatch, t: EmbeddingBagConfig
                  ) -> List[int]:
        key_index = {k: i for i, k in enumerate(sb.keys)}
        return [key_index[f] for f in t.feature_names]

    def forward(self, sb: PaddedSparseBatch,
                host: Optional[HostBatch] = None) -> KeyedTensor:
        """-> KeyedTensor [B, sum(D)] in table order. `host`: the batch's
        (ids, lengths) as numpy, when the caller has them (else copied
        from the device)."""
        ids_np = (host or _host_batch(sb))[0]
        outputs, names = [], []
        for t, enames in zip(self.tables, self._emb_names):
            uvm = self._uvm[t.name]
            fidx = self._features(sb, t)
            slots = torch.from_numpy(uvm.prepare(ids_np[fidx])).to(
                self.device)
            sel = torch.as_tensor(fidx, device=sb.lengths.device)
            lengths = sb.lengths[sel]
            psw = None if sb.weights is None else sb.weights[sel]
            mean = pooling_type_to_mode(t.pooling) is PoolingMode.MEAN
            for j, ename in enumerate(enames):
                pooled = uvm.lookup_pooled(
                    slots[j], lengths[j], None if psw is None else psw[j])
                if mean:
                    denom = lengths[j].to(pooled.dtype).clamp(min=1.0)
                    pooled = pooled / denom[:, None]
                outputs.append(pooled)
                names.append(ename)
        return KeyedTensor.from_tensor_list(names, outputs)

    @torch.no_grad()
    def update(self, sb: PaddedSparseBatch, d_values: torch.Tensor,
               learning_rate: float,
               host: Optional[HostBatch] = None) -> None:
        """One fused step per table from the cotangent of the forward's
        values [B, sum(D)]: every feature's per-token gradients d x coeff
        (the token mask, times the per-sample weight, divided by the
        length for a MEAN table) through one update."""
        ids_np, len_np = host or _host_batch(sb)
        L = sb.ids.shape[2]
        col = np.arange(L)
        pos = 0
        for t, enames in zip(self.tables, self._emb_names):
            uvm = self._uvm[t.name]
            fidx = self._features(sb, t)
            slots = uvm.prepare(ids_np[fidx])
            mean = pooling_type_to_mode(t.pooling) is PoolingMode.MEAN
            all_grads, all_masks = [], []
            for j in range(len(enames)):
                d = d_values[:, pos:pos + t.embedding_dim]
                pos += t.embedding_dim
                f = fidx[j]
                mask = col[None, :] < len_np[f][:, None]
                coeff = torch.from_numpy(mask).to(d.device, torch.float32)
                if sb.weights is not None:
                    coeff = coeff * sb.weights[f].to(torch.float32)
                row_grads = d[:, None, :] * coeff[:, :, None]
                if mean:
                    denom = torch.from_numpy(np.maximum(len_np[f], 1)).to(
                        d.device, torch.float32)
                    row_grads = row_grads / denom[:, None, None]
                all_grads.append(row_grads.reshape(-1, t.embedding_dim))
                all_masks.append(mask.reshape(-1))
            uvm.update(slots.reshape(-1), torch.cat(all_grads),
                       np.concatenate(all_masks), learning_rate)

    def flush(self) -> None:
        for uvm in self._uvm.values():
            uvm.flush()

    def state_dict(self) -> Dict[str, np.ndarray]:
        """Copies of the flushed host tables by name."""
        self.flush()
        return {t.name: self._uvm[t.name].table.numpy().copy()
                for t in self.tables}

    def momentum_dict(self) -> Dict[str, np.ndarray]:
        """The flushed momenta by table, as JAX's: the first moment under
        the table's name, the second under `<name>.m2`, and the step under
        `<name>.step` (int32) where a momentum is kept and the step is not
        0."""
        self.flush()
        out: Dict[str, np.ndarray] = {}
        for t in self.tables:
            uvm = self._uvm[t.name]
            if uvm.host_momentum1 is not None:
                out[t.name] = uvm.host_momentum1.numpy().copy()
            if uvm.host_momentum2 is not None:
                out[t.name + ".m2"] = uvm.host_momentum2.numpy().copy()
            if uvm.host_momentum1 is not None and int(uvm.step):
                out[t.name + ".step"] = np.asarray(int(uvm.step), np.int32)
        return out

    def load_momentum(self, momentum: Mapping[str, HostArray]) -> None:
        """Restore momenta (and steps) in `momentum_dict`'s form;
        invalidates the caches, so that no resident row keeps a stale
        momentum."""
        for name, m in momentum.items():
            if name.endswith(".step"):
                uvm = self._uvm[name[:-len(".step")]]
                uvm.invalidate()
                uvm.step.fill_(int(np.asarray(m)))
                continue
            slot = "host_momentum1"
            if name.endswith(".m2"):
                name, slot = name[:-len(".m2")], "host_momentum2"
            uvm = self._uvm[name]
            host = getattr(uvm, slot)
            if host is None:
                raise ValueError(f"table {name} has no momentum state")
            uvm.invalidate()
            host.numpy()[:] = np.asarray(m, np.float32)

    def reset(self, weights: Optional[Mapping[str, HostArray]] = None,
              flush: bool = True) -> None:
        """JAX's rebuild of the collection with new weights, in place: the
        tables in `weights` take them (the others keep their flushed
        values, or, with flush=False, the host tables as they are) and
        every cache, momentum, step and counter starts fresh, as a new
        collection's would."""
        weights = weights or {}
        for t in self.tables:
            uvm = self._uvm[t.name]
            uvm.invalidate(flush)
            if t.name in weights:
                w = torch.as_tensor(np.asarray(weights[t.name], np.float32)
                                    if not isinstance(weights[t.name],
                                                      torch.Tensor)
                                    else weights[t.name])
                if tuple(w.shape) != tuple(uvm.table.shape):
                    raise ValueError(f"table {t.name}: expected "
                                     f"{tuple(uvm.table.shape)}, got "
                                     f"{tuple(w.shape)}")
                uvm.table.copy_(w)
            for h, _ in uvm._momentum_pairs():
                h.zero_()
            uvm.step.zero_()
            uvm.hits = uvm.misses = uvm._clock = 0

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        return {name: {"hits": u.hits, "misses": u.misses}
                for name, u in self._uvm.items()}


def table_of_entry(name: str) -> str:
    """The table of a `momentum_dict` entry (`<table>[.m2|.step]`)."""
    for suffix in (".m2", ".step"):
        if name.endswith(suffix):
            return name[:-len(suffix)]
    return name


def canonical_to_momentum(name: str, entry: Mapping[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """A table's fused optimizer state in the strategies' canonical form
    ({"m1__row" | "m1__full", "m2__...", "step"}) -> its `momentum_dict`
    entries (`<name>`, `<name>.m2`, and `<name>.step` where a momentum is
    kept and the step is not 0). A column-sharded rowwise momentum
    ("__cwrow", [S, R]) enters the row space as its mean over the shards,
    JAX's rule."""
    out: Dict[str, np.ndarray] = {}
    for tag, suffix in (("m1", ""), ("m2", ".m2")):
        key = next((k for k in entry if k.startswith(tag + "__")), None)
        if key is not None:
            arr = np.asarray(entry[key])
            out[name + suffix] = (arr.mean(axis=0) if key.endswith("cwrow")
                                  else arr)
    if name in out and int(np.asarray(entry.get("step", 0))):
        out[name + ".step"] = np.asarray(entry["step"], np.int32)
    return out


def momentum_to_canonical(name: str, moms: Mapping[str, np.ndarray]
                          ) -> Dict[str, np.ndarray]:
    """The inverse: a table's `momentum_dict` entries -> the canonical
    form (a momentum's kind from its rank; the step 0 where `.step` is
    absent, as momentum_dict leaves it out at 0)."""
    out: Dict[str, np.ndarray] = {
        "step": np.asarray(moms.get(name + ".step", 0), np.int32)}
    for tag, suffix in (("m1", ""), ("m2", ".m2")):
        if name + suffix in moms:
            arr = np.asarray(moms[name + suffix])
            out[f"{tag}__{'row' if arr.ndim == 1 else 'full'}"] = arr
    return out


def uvm_tables_of(plan: Mapping[str, ParameterSharding], tables: Sequence
                  ) -> List:
    """The tables `plan` puts under FUSED_UVM_CACHING, in order."""
    return [t for t in tables if getattr(plan.get(t.name), "compute_kernel",
                                         None) is ComputeKernel.FUSED_UVM_CACHING]


class UvmSplitEmbeddingBagCollection(nn.Module):
    """An EmbeddingBagCollection with FUSED_UVM_CACHING tables under the
    DMP: `device_part`, a ShardedEmbeddingBagCollection over the other
    tables (None when every table is UVM), and `uvm`, the
    UvmEmbeddingBagCollection of the UVM tables on its owner rank (None
    on the other ranks). The host tables are allocated here and drawn by
    `init` or loaded by `shard_from_dense`; the caches start empty.

    `injected`: while set, `forward` returns it (the DMP's train step sets
    it to the KeyedTensor it computed outside autograd).
    """

    def __init__(
        self,
        env: ShardingEnv,
        tables: Sequence[EmbeddingBagConfig],
        plan: Dict[str, ParameterSharding],
        is_weighted: bool = False,
        max_feature_length: int = 1,
        optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
        optim_kwargs: Optional[dict] = None,
    ):
        super().__init__()
        self.env = env
        self.tables = tuple(tables)
        self.max_feature_length = max_feature_length
        self.optim = optim
        self.optim_kwargs = dict(optim_kwargs or {})
        uvm_tables = uvm_tables_of(plan, self.tables)
        uvm_names = {t.name for t in uvm_tables}
        dev_tables = tuple(t for t in self.tables if t.name not in uvm_names)
        self.uvm_tables = tuple(uvm_tables)
        self.device_part = (ShardedEmbeddingBagCollection(
            env, dev_tables, plan, is_weighted=is_weighted,
            max_feature_length=max_feature_length, optim=optim,
            optim_kwargs=optim_kwargs) if dev_tables else None)
        ranks = plan[uvm_tables[0].name].ranks
        self.owner = ranks[0] if ranks else 0
        self.uvm: Optional[UvmEmbeddingBagCollection] = None
        if env.rank == self.owner:
            # the host tables pinned on one thread each
            with ThreadPoolExecutor(len(self.uvm_tables)) as pool:
                host = list(pool.map(lambda t: host_tensor(
                    (t.num_embeddings, t.embedding_dim), env.device),
                    self.uvm_tables))
            self.uvm = UvmEmbeddingBagCollection(
                self.uvm_tables,
                {t.name: h for t, h in zip(self.uvm_tables, host)},
                optim=optim, optim_kwargs=optim_kwargs, device=env.device)
        self.uvm_features = tuple(f for t in self.uvm_tables
                                  for f in t.feature_names)
        self.uvm_width = sum(t.embedding_dim * len(t.feature_names)
                             for t in self.uvm_tables)
        # JAX's _build_uvm_split: the module's column blocks in declared
        # order, from [device columns, UVM columns]
        enames = embedding_names_by_table(self.tables)
        self.embedding_names = tuple(n for ns in enames for n in ns)
        self.length_per_key = tuple(t.embedding_dim for t, ns in
                                    zip(self.tables, enames) for _ in ns)
        starts: Dict[Tuple[str, int], int] = {}
        off = 0
        for ts in (dev_tables, self.uvm_tables):
            for t in ts:
                for j in range(len(t.feature_names)):
                    starts[(t.name, j)] = off
                    off += t.embedding_dim
        perm = np.concatenate([
            np.arange(starts[(t.name, j)], starts[(t.name, j)] + t.embedding_dim)
            for t in self.tables for j in range(len(t.feature_names))])
        self.register_buffer("perm", torch.as_tensor(
            perm, dtype=torch.long, device=env.device), persistent=False)
        self.register_buffer("inv_perm", torch.as_tensor(
            np.argsort(perm), dtype=torch.long, device=env.device),
            persistent=False)
        self.dev_width = off - self.uvm_width
        self.injected = None
        self._saved = None

    # -- state ----------------------------------------------------------------

    @torch.no_grad()
    def init(self, generator: Optional[torch.Generator] = None) -> None:
        """Draw the device tables (ShardedEmbeddingBagCollection.init), then
        each UVM table from U(get_weight_init_min, get_weight_init_max),
        JAX's bounds, in chunks of at most 1 GiB drawn on the env's device
        and copied into the host table (every rank draws, so that the
        generator stays in step; the owner keeps them); zero the fused
        optimizer state and empty the caches."""
        if self.device_part is not None:
            self.device_part.init(generator)
        if self.uvm is not None:
            self.uvm.reset(flush=False)
        for t in self.uvm_tables:
            chunk = max(1, INIT_CHUNK_FLOATS // t.embedding_dim)
            host = None if self.uvm is None else self.uvm._uvm[t.name].table
            for start in range(0, t.num_embeddings, chunk):
                rows = torch.empty(
                    (min(chunk, t.num_embeddings - start), t.embedding_dim),
                    device=self.env.device).uniform_(
                        t.get_weight_init_min(), t.get_weight_init_max(),
                        generator=generator)
                if host is not None:
                    host[start:start + rows.shape[0]].copy_(rows)

    @torch.no_grad()
    def shard_from_dense(self, dense: Mapping[str, HostArray]) -> None:
        """Load per-table [R, D] weights, as the JAX DMP's `load_tables`
        does for such a module: the device tables (all of them, when any
        is given) through the device part, which restarts its optimizer
        state; the UVM tables given replace theirs, and every UVM cache,
        momentum and step starts fresh."""
        dev = {k: v for k, v in dense.items()
               if k not in {t.name for t in self.uvm_tables}}
        if dev:
            self.device_part.shard_from_dense(dev)
        uvm = {t.name: dense[t.name] for t in self.uvm_tables
               if t.name in dense}
        if uvm and self.uvm is not None:
            self.uvm.reset(uvm)

    def unshard_opt_to_tables(self) -> Dict[str, Dict[str, np.ndarray]]:
        """The device tables' fused optimizer state in the strategies'
        canonical form (the UVM momenta are `uvm_momentum_dict`'s)."""
        if self.device_part is None:
            return {}
        return self.device_part.unshard_opt_to_tables()

    def shard_opt_from_tables(self, per_table) -> None:
        if self.device_part is not None:
            self.device_part.shard_opt_from_tables(per_table)

    def unshard_to_dense(self) -> Dict[str, np.ndarray]:
        """Every table as a host array: the device tables one at a time,
        the UVM ones flushed (at world size n broadcast from the owner)."""
        out = ({} if self.device_part is None
               else self.device_part.unshard_to_dense())
        out.update(self._from_owner(
            None if self.uvm is None else self.uvm.state_dict(),
            {t.name: ((t.num_embeddings, t.embedding_dim), np.float32)
             for t in self.uvm_tables}))
        return out

    def uvm_momentum_dict(self) -> Dict[str, np.ndarray]:
        """The UVM tables' `momentum_dict` (at world size n broadcast from
        the owner)."""
        mine = None if self.uvm is None else self.uvm.momentum_dict()
        spec = None
        if self.env.group is not None:
            names = [None if mine is None else {
                k: (v.shape, v.dtype) for k, v in mine.items()}]
            torch.distributed.broadcast_object_list(
                names, src=self.owner, group=self.env.group)
            spec = names[0]
        return self._from_owner(mine, spec)

    def uvm_steps(self) -> Dict[str, int]:
        """Each UVM table's optimizer step (at world size n broadcast from
        the owner): `momentum_dict` leaves it out where the optimizer keeps
        no momentum."""
        steps = [None if self.uvm is None else {
            n: int(c.step) for n, c in self.uvm._uvm.items()}]
        if self.env.group is not None:
            torch.distributed.broadcast_object_list(
                steps, src=self.owner, group=self.env.group)
        return steps[0]

    def _from_owner(self, mine: Optional[Dict[str, np.ndarray]],
                    spec) -> Dict[str, np.ndarray]:
        if self.env.group is None:
            return dict(mine)
        out = {}
        for name, (shape, dtype) in spec.items():
            out[name] = comm.broadcast_host(
                self.env, None if mine is None else mine[name], shape,
                dtype, self.owner)
        return out

    def check_trainable(self) -> None:
        if self.device_part is not None:
            self.device_part.check_trainable()
        check_trainable(torch.float32, self.optim_kwargs)

    def cache_stats(self) -> Dict[str, Dict[str, int]]:
        """The UVM tables' hits and misses ({} on a rank that holds none)."""
        return {} if self.uvm is None else self.uvm.cache_stats()

    # -- compute --------------------------------------------------------------

    def _uvm_batch(self, sb: PaddedSparseBatch):
        """(the global batch of the UVM features, its host copy on the
        owner, else None)."""
        key_index = {k: i for i, k in enumerate(sb.keys)}
        sub = sb.select_features([key_index[f] for f in self.uvm_features])
        ids_g, len_g, psw_g = gather_batch(self.env, sub)
        sb_g = PaddedSparseBatch(ids=ids_g, lengths=len_g, keys=sub.keys,
                                 weights=psw_g)
        return sb_g, None if self.uvm is None else _host_batch(sb_g)

    def _from_owner_rows(self, vals: torch.Tensor, B_loc: int
                         ) -> torch.Tensor:
        """The owner's [B, W] as this rank's [B_loc, W] (an all_to_all)."""
        if self.env.group is None:
            return vals
        x = vals.reshape(self.env.world_size, B_loc, -1)
        return comm.all_to_all(self.env, x, 0, 0)[self.owner]

    def _to_owner_rows(self, d: torch.Tensor) -> torch.Tensor:
        """Every rank's [B_loc, W] cotangent as the owner's [B, W] (an
        all_to_all; zeros on the other ranks)."""
        if self.env.group is None:
            return d
        n = self.env.world_size
        x = d.new_zeros((n, *d.shape))
        x[self.owner] = d
        return comm.all_to_all(self.env, x, 0, 0).reshape(-1, d.shape[1])

    def forward(self, features: SparseInput,
                dist: Optional[Sequence] = None) -> KeyedTensor:
        """-> KeyedTensor [B_loc, sum(D)] in the module's column order.

        Args:
            features: the local batch, padded or jagged.
            dist: ignored (a UVM module gathers in the step).
        """
        del dist  # a UVM module gathers in the step
        if self.injected is not None:
            return self.injected
        sb = as_padded(features, self.max_feature_length)
        B_loc = sb.ids.shape[1]
        parts = [] if self.device_part is None else [
            self.device_part(sb).values]
        sb_g, host = self._uvm_batch(sb)
        if self.uvm is not None:
            vals = self.uvm.forward(sb_g, host).values
        else:
            vals = torch.zeros((sb_g.ids.shape[1], self.uvm_width),
                               device=self.env.device)
        if not torch.is_inference_mode_enabled():
            self._saved = (features, sb_g, host)
        parts.append(self._from_owner_rows(vals, B_loc))
        values = torch.cat(parts, dim=1)[:, self.perm]
        return KeyedTensor(values=values, keys=self.embedding_names,
                           length_per_key=self.length_per_key)

    @torch.no_grad()
    def update(self, features: SparseInput, d_values: torch.Tensor,
               learning_rate: float, dist: Optional[Sequence] = None
               ) -> None:
        """Fused step, in place, from the cotangent of the forward's values
        [B_loc, sum(D)]: the device columns through the device part, the
        UVM ones to the owner and through the UVM collection. Reuses the
        global batch of the forward just before it on the same batch
        object; else gathers it again.

        Args:
            features: the forward's batch.
            d_values: the cotangent of its values.
            learning_rate: the fused optimizer's.
            dist: ignored.
        """
        del dist
        d = d_values[:, self.inv_perm]
        if self.device_part is not None:
            self.device_part.update(features, d[:, :self.dev_width],
                                    learning_rate)
        saved, self._saved = self._saved, None
        if saved is not None and saved[0] is features:
            sb_g, host = saved[1:]
        else:
            sb_g, host = self._uvm_batch(
                as_padded(features, self.max_feature_length))
        d_g = self._to_owner_rows(d[:, self.dev_width:].contiguous())
        if self.uvm is not None:
            self.uvm.update(sb_g, d_g, learning_rate, host)
