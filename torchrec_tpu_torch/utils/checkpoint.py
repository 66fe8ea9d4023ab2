"""Checkpoint and resume of the port's DistributedModelParallel.

Counterpart of torchrec_tpu/utils/checkpoint.py. Two levels, as in JAX:

* `save_reshardable` / `load_reshardable`: one flat `.npz` with JAX's
  keys, portable across plans and world sizes: `dense/<fqn>` (the port's
  parameter names), `tables/<key>/<table>` (every table unsharded, the
  host-resident UVM tables included), `opt/<key>/<table>/<tag>` (the
  strategies' canonical fused optimizer state, `unshard_opt_to_tables`),
  `uvmopt/<key>/<name>` (the UVM collections' `momentum_dict`; an integer
  `.step` keeps its dtype, so that a step past 2^24 resumes exactly) and
  `step`. Loading reshards the weights and the momenta onto the current
  plan, under JAX's exactness rules: full momenta ([R, D]) reshard under
  any plan; rowwise momenta ([R]) across any row-space plans; a
  column-sharded rowwise momentum ([S, R]) moves exactly to S column
  shards, becomes its mean over the shards in row space (exact: each
  shard's accumulator is mean(g^2) over its equal-width columns), and is
  replicated into a column space it does not match, with a warning. A
  group whose checkpoint state does not fit its optimizer (the optimizer
  changed across the save) restarts fresh, with a warning naming the
  table and tag. A table's momenta follow it between host and device
  memory: the `uvmopt` entries of a table saved under FUSED_UVM_CACHING
  load into the device group that holds it now, and the canonical state
  of a device table into the UVM collection. (JAX's load feeds `uvmopt`
  to UVM modules only, so a UVM table moved to the device has no state
  and its whole group restarts.) A tower module's tables reshard and its
  fused state restarts; its interaction parameters are not in the file,
  as in JAX.
  The module keys and dense FQNs are the port's; utils/jax_bridge
  `load_jax_reshardable` reads a file JAX wrote.

* `save_state` / `restore_state`: `torch.save` of everything an exact
  same-plan resume needs, in place of JAX's orbax pair: the DMP's
  nn.Module state (dense parameters, shards, fused optimizer state), the
  dense optimizer's state_dict (a warmup's count included), the host step
  and each UVM collection's flushed host tables, momenta and steps. The
  resumed steps equal the uninterrupted run's bit for bit.

At world size n every rank calls these (the unsharding is collective);
rank 0 writes the `.npz`, and `save_state` writes one file a rank,
`<path>.rank<r>`.
"""

from __future__ import annotations

import warnings
from typing import Dict, Mapping

import numpy as np
import torch
import torch.distributed as dist

from torchrec_tpu_torch.ops.fused_update import fused_state_shapes
from torchrec_tpu_torch.parallel.dmp import DistributedModelParallel
from torchrec_tpu_torch.parallel.strategies import as_tensor
from torchrec_tpu_torch.parallel.tower_sharding import (
    ShardedEmbeddingTowerCollection,
)
from torchrec_tpu_torch.parallel.uvm_ebc import (
    UvmSplitEmbeddingBagCollection,
    canonical_to_momentum,
    momentum_to_canonical,
    table_of_entry,
)


def _barrier(dmp: DistributedModelParallel) -> None:
    if dmp.env.group is not None:
        dist.barrier(group=dmp.env.group)


def _strategies(sebc):
    """The strategies of a module's device groups (none for a tower)."""
    if isinstance(sebc, ShardedEmbeddingTowerCollection):
        return []
    if isinstance(sebc, UvmSplitEmbeddingBagCollection):
        sebc = sebc.device_part
    return [] if sebc is None else list(sebc.strategies)


def _dense_parameters(dmp: DistributedModelParallel):
    """The dense parameters by FQN, less the tower interactions'."""
    inside = {id(p) for tc in dmp._towers() for p in tc.parameters()}
    return {n: p for n, p in dmp.module.named_parameters()
            if id(p) not in inside}


@torch.no_grad()
def save_reshardable(path: str, dmp: DistributedModelParallel) -> None:
    """Write the DMP's reshardable `.npz` (see the module docstring)."""
    sd = dmp.unsharded_state_dict()
    flat: Dict[str, np.ndarray] = {}
    for fqn, t in sd["dense"].items():
        flat[f"dense/{fqn}"] = t.float().numpy()
    for key, sebc in dmp.sharded_ebcs.items():
        for name, w in sd[f"embeddings/{key}"].items():
            flat[f"tables/{key}/{name}"] = np.asarray(w, np.float32)
        for strat in _strategies(sebc):
            for tname, entry in strat.unshard_opt_to_tables().items():
                for tag, arr in entry.items():
                    flat[f"opt/{key}/{tname}/{tag}"] = arr
        for name, m in sd.get(f"uvm_momentum/{key}", {}).items():
            m = np.asarray(m)
            if not np.issubdtype(m.dtype, np.integer):
                m = m.astype(np.float32)
            flat[f"uvmopt/{key}/{name}"] = m
    flat["step"] = np.asarray(dmp.step, np.int32)
    if dmp.env.rank == 0:
        np.savez(path, **flat)
    _barrier(dmp)


def _fits(strat, per_table: Mapping[str, Mapping[str, np.ndarray]]) -> bool:
    """Whether the checkpoint holds every momentum the group's optimizer
    keeps, and a step, for each of its tables; when not, a warning names
    the first that is missing (JAX's strategies then restart the
    group)."""
    kinds = fused_state_shapes(strat.optim)
    for t in strat.meta.tables:
        entry = per_table.get(t.name, {})
        needed = [("step",)] + [
            (f"{tag}__full",) if kind == "full"
            else (f"{tag}__row", f"{tag}__cwrow")
            for tag, kind in zip(("m1", "m2"), kinds) if kind != "none"]
        for keys in needed:
            if not any(k in entry for k in keys):
                warnings.warn(
                    f"checkpoint has no {' or '.join(keys)} for table "
                    f"{t.name} ({strat.optim.name}): its group's fused "
                    "optimizer state restarts fresh", stacklevel=3)
                return False
    return True


@torch.no_grad()
def load_dense(dmp: DistributedModelParallel,
               dense: Mapping[str, np.ndarray]) -> None:
    """Copy {fqn: array} into the DMP's dense parameters (the tower
    interactions excepted); raises unless every one is matched."""
    own = _dense_parameters(dmp)
    missing = sorted(set(own) - set(dense))
    unexpected = sorted(set(dense) - set(own))
    if missing or unexpected:
        raise KeyError(f"dense params do not match: missing {missing}, "
                       f"unexpected {unexpected}")
    for name, p in own.items():
        p.copy_(as_tensor(dense[name]).reshape(p.shape))


@torch.no_grad()
def load_reshardable_arrays(dmp: DistributedModelParallel,
                            data: Mapping[str, np.ndarray]) -> None:
    """`load_reshardable` from the `.npz`'s arrays, keyed as it keys them
    (jax_bridge.load_jax_reshardable maps JAX's keys first)."""
    load_dense(dmp, {k[len("dense/"):]: v for k, v in data.items()
                     if k.startswith("dense/")})
    tables: Dict[str, Dict[str, np.ndarray]] = {}
    # {module key -> {table -> the momentum_dict entries / the canonical
    # state}} from uvmopt/<key>/<name> and opt/<key>/<table>/<tag>
    uvm_moms: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    opts: Dict[str, Dict[str, Dict[str, np.ndarray]]] = {}
    for k, v in data.items():
        # module keys are "/"-joined paths; the table name is the last part
        if k.startswith("tables/"):
            key, name = k[len("tables/"):].rsplit("/", 1)
            tables.setdefault(key, {})[name] = v
        elif k.startswith("uvmopt/"):
            key, name = k[len("uvmopt/"):].rsplit("/", 1)
            uvm_moms.setdefault(key, {}).setdefault(
                table_of_entry(name), {})[name] = v
        elif k.startswith("opt/"):
            key, tname, tag = k[len("opt/"):].rsplit("/", 2)
            opts.setdefault(key, {}).setdefault(tname, {})[tag] = v
    # a table's momenta follow it between host and device: the UVM
    # tables take their uvmopt entries, or their canonical state saved
    # from the device; the device groups their canonical state, or the
    # uvmopt entries saved from host memory
    uvm_momentum: Dict[str, Dict[str, np.ndarray]] = {}
    for key, sebc in dmp.sharded_ebcs.items():
        for t in getattr(sebc, "uvm_tables", ()):
            if t.name in uvm_moms.get(key, {}):
                got = uvm_moms[key][t.name]
            elif t.name in opts.get(key, {}):
                got = canonical_to_momentum(t.name, opts[key][t.name])
            else:
                continue
            uvm_momentum.setdefault(key, {}).update(got)
    dmp.load_tables(tables, uvm_momentum=uvm_momentum or None)
    for key, sebc in dmp.sharded_ebcs.items():
        per_table = dict(opts.get(key, {}))
        for tname, moms in uvm_moms.get(key, {}).items():
            per_table.setdefault(tname, momentum_to_canonical(tname, moms))
        if not per_table:
            continue
        for strat in _strategies(sebc):
            if _fits(strat, per_table):
                strat.shard_opt_from_tables(per_table)
    dmp.step = int(np.asarray(data["step"]))


def load_reshardable(path: str, dmp: DistributedModelParallel) -> None:
    """Load a `save_reshardable` file into the DMP under its current plan
    and world size (the dense optimizer's state is left as it is, as
    JAX's load leaves the state's)."""
    with np.load(path) as data:
        load_reshardable_arrays(dmp, {k: data[k] for k in data.files})


def _state_path(path: str, dmp: DistributedModelParallel) -> str:
    return path if dmp.env.group is None else f"{path}.rank{dmp.env.rank}"


@torch.no_grad()
def save_state(path: str, dmp: DistributedModelParallel) -> None:
    """Write what an exact same-plan resume needs (module docstring)."""
    uvm = {}
    for key, m in dmp._uvm_modules().items():
        if m.uvm is None:
            continue
        m.uvm.flush()
        uvm[key] = {name: {
            "table": c.table, "m1": c.host_momentum1,
            "m2": c.host_momentum2, "step": int(c.step)}
            for name, c in m.uvm._uvm.items()}
    torch.save({"module": dmp.state_dict(),
                "dense_opt": dmp.dense_optimizer.state_dict(),
                "step": dmp.step, "uvm": uvm}, _state_path(path, dmp))
    _barrier(dmp)


@torch.no_grad()
def restore_state(path: str, dmp: DistributedModelParallel) -> None:
    """Restore a `save_state` file into a DMP built as the saved one
    was."""
    sd = torch.load(_state_path(path, dmp), map_location="cpu",
                    weights_only=False)
    dmp.load_state_dict(sd["module"])
    dmp.dense_optimizer.load_state_dict(sd["dense_opt"])
    dmp.step = sd["step"]
    for key, per in sd["uvm"].items():
        coll = dmp.sharded_ebcs[key].uvm
        for name, st in per.items():
            c = coll._uvm[name]
            c.invalidate(flush=False)
            c.table.copy_(st["table"])
            for host, saved in ((c.host_momentum1, st["m1"]),
                                (c.host_momentum2, st["m2"])):
                if host is not None:
                    host.copy_(saved)
            c.step.fill_(st["step"])
