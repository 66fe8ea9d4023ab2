"""Carry a JAX DistributedModelParallel's weights into the port's DMP.

The JAX side hands over numpy arrays only, so this module imports no JAX:

* `dense_params`: the flax `params` tree of the DMP state (nested dicts of
  numpy arrays), walked beside the port's module tree. A flax auto-name
  maps to an attribute through the `flax_names` of the port module that
  holds it (a Perceptron's `Dense_0` is its `linear`, an MLP's
  `Perceptron_<i>` its `perceptrons.<i>`, a DLRM arch's `MLP_0` its `mlp`,
  a BERT4Rec TransformerBlock's `Dense_0` / `Dense_1` its `ff_in` /
  `ff_out`, a SwishLayerNorm's `LayerNorm_0` its `norm`, a DLRM's
  `embedding_bag_collection`, where a FeatureProcessedEmbeddingBagCollection
  keeps its `feature_processor`, its `sparse_arch.embedding_bag_collection`,
  and a SimpleDeepFMNN's too; its arches' `Dense_<i>`, `inter_arch`'s
  `Dense_0` being the layer of its DeepFM; a cross net's `cross_<i>`,
  `V_<i>`, `W_<i>`, `weight_<i>`, `bias_<i>`, `V_<i>_<e>`, `C_<i>_<e>`,
  `U_<i>_<e>` and `gate_<i>_<e>`); other names are the attribute's
  own (a PositionWeightedModule's `position_weight_<key>`), and a name the
  module does not have raises. A flax `kernel` [in...,
  out...] becomes the `nn.Linear.weight` [out, in], flattened row-major
  (DenseGeneral's [D, heads, head_dim] and [heads, head_dim, D] too); a
  LayerNorm `scale` becomes its `weight`; `bias` and other parameters (the
  positional embedding) are copied in the port parameter's shape. An
  unsharded EBC's or EC's table `<name>` is its `embedding_bags.<name>` /
  `embeddings.<name>`; `load_flax_params` loads such a tree into a module
  that no DMP wraps.
* `tables`: {table name -> [R, D]} as the JAX
  `ShardedEmbeddingBagCollection` / `ShardedEmbeddingCollection`
  `unshard_to_dense` returns it; each table goes to the port's sharded
  module that holds a table of that name (a tower collection's tables
  too; its towers' flax interaction parameters come as
  `interaction_params`). A bf16 table arrives as an
  `ml_dtypes.bfloat16` array, which torch cannot read; it is loaded
  through f32, which holds it exactly (so are bf16 leaves of `dense`).
* `opt_state` (optional): the whole fused optimizer state per table, as
  the JAX strategies' `unshard_opt_to_tables` returns it: {table name ->
  {"m1__full" [R, D] | "m1__row" [R] | "m1__cwrow" [S, R], "m2__...",
  "step"}}, with the momenta `fused_state_shapes` gives the optimizer.
  Raises unless they match the port's. `fused_optimizer_state` reads the
  port's back in the same form, which the JAX strategies'
  `shard_opt_from_tables` loads.

Tables and state move per table, whatever the plan: a JAX state of any of
the flat strategies, trained on a mesh of any size, loads into the port's
DMP under any plan and world size (each rank keeps its own block), and a
rowwise momentum saved by S column shards converts to the target's row
space as JAX converts it (`_convert_rowspace` in parallel/strategies.py).
* the dense optimizer's state: `optax_state_to_keyed` carries an
  optax state (numpy leaves, the namedtuples as optax made them) into the
  port's `KeyedOptimizer` state, {"<param fqn>/<name>": array}:
  `ScaleByAdamState` (optax.adam / adamw) gives each parameter's "step"
  (the count, as torch's float step), "exp_avg" (mu) and "exp_avg_sq"
  (nu); `TraceState` (optax.sgd with momentum) its "momentum_buffer";
  `ScaleByScheduleState` (the warmup) "__warmup/count"; `EmptyState`
  (plain sgd, the clips, scale_by_learning_rate) nothing; any other state
  raises. Moments take the parameters' port layouts, as the params do.
  `keyed_to_optax_state` reads the port's state back into an optax
  state shaped like a template.
* UVM tables (FUSED_UVM_CACHING): JAX's `dmp.state_dict(state)` holds
  them under `embeddings/<key>` with the other tables, which `tables`
  takes, and their momenta under `uvm_momentum/<key>` (the UVM
  collection's `momentum_dict`: `<table>`, `<table>.m2`, `<table>.step`),
  which `load_jax_weights`' `uvm_momentum` takes, merged over the modules;
  both enter through the port DMP's `load_tables(..., uvm_momentum=)`.
  `fused_optimizer_state` gives a UVM table's momenta in the canonical
  form too ("m1__row" / "m1__full", "m2__...", "step"), and
  `load_jax_weights`' `opt_state` takes them so.
* a reshardable checkpoint that JAX's `save_reshardable` wrote:
  `load_jax_reshardable` maps its flax dense paths and JAX module keys
  onto the port's (`dlrm/embedding_bag_collection` ->
  `dlrm/sparse_arch/embedding_bag_collection`, each module by the tables
  it holds) and loads it through utils/checkpoint.
* a quantized predict package that the JAX `PredictModule.save` wrote
  (`arrays.npz` + `manifest.json`): `load_jax_predict_package` takes its
  three arrays per table as they are and its dense params through
  `flax_dense_to_state_dict`. Its module keys are the JAX DMP's flax
  paths (`dlrm/embedding_bag_collection`); each maps to the port's
  sharded module that holds the same tables
  (`dlrm/sparse_arch/embedding_bag_collection`).

Usage, with `state` the JAX DMP state:

    dense = jax.tree.map(np.asarray, state.dense_params)
    tables = jax_sebc.unshard_to_dense(state.emb_states[key])
    opt = {}
    for strat, group in zip(jax_sebc.strategies, state.emb_states[key]):
        opt.update(strat.unshard_opt_to_tables(group.opt))
    load_jax_weights(torch_dmp, dense, tables, opt_state=opt)
    keyed = KeyedOptimizer(torch_dmp.dense_optimizer,
                           dict(torch_dmp.module.named_parameters()))
    keyed.load_state_dict(optax_state_to_keyed(
        jax.tree.map(np.asarray, state.dense_opt), torch_dmp.module))
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.inference.modules import (
    PredictModule,
    quant_modules,
    read_package,
)

from torchrec_tpu_torch.ops.fused_update import fused_state_shapes
from torchrec_tpu_torch.optim.warmup import WARMUP_KEY
from torchrec_tpu_torch.parallel.dmp import DistributedModelParallel
from torchrec_tpu_torch.parallel.strategies import as_tensor
from torchrec_tpu_torch.parallel.tower_sharding import (
    ShardedEmbeddingTowerCollection,
)
from torchrec_tpu_torch.parallel.uvm_ebc import (
    canonical_to_momentum,
    table_of_entry,
)
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

# flax leaf name -> the port parameter's name
_LEAF_NAMES = {"kernel": "weight", "scale": "weight"}


def flax_dense_to_state_dict(
    dense_params: Mapping, module: nn.Module, prefix: str = ""
) -> Dict[str, np.ndarray]:
    """Flatten a flax param tree into the parameter names of `module`, the
    port module it belongs to, in the port's layouts. Raises for a flax
    name the module does not have."""
    out: Dict[str, np.ndarray] = {}
    names = getattr(module, "flax_names", {})
    for name, value in dense_params.items():
        if isinstance(value, Mapping):
            attr = names.get(name, name)
            try:
                child = module.get_submodule(attr)
            except AttributeError:
                raise ValueError(
                    f"unexpected flax module {prefix}{name}") from None
            out.update(flax_dense_to_state_dict(value, child,
                                                f"{prefix}{attr}."))
            continue
        pname = names.get(name, _LEAF_NAMES.get(name, name))
        try:
            target = module.get_parameter(pname)
        except AttributeError:
            raise ValueError(f"unexpected flax param {prefix}{name}") from None
        arr = np.asarray(value)
        if arr.size != target.numel():
            raise ValueError(f"{prefix}{name}: JAX shape {arr.shape}, port "
                             f"{tuple(target.shape)}")
        if name == "kernel":
            arr = arr.reshape(module.in_features, module.out_features).T
        out[prefix + pname] = arr.reshape(target.shape)
    return out


@torch.no_grad()
def load_flax_params(module: nn.Module, params: Mapping,
                     exclude=frozenset()) -> None:
    """Copy a flax param tree (numpy leaves) into `module`'s parameters.
    Raises unless every parameter of the module but those whose ids are in
    `exclude` is matched."""
    flat = flax_dense_to_state_dict(params, module)
    own = {n: p for n, p in module.named_parameters()
           if id(p) not in exclude}
    missing = sorted(set(own) - set(flat))
    unexpected = sorted(set(flat) - set(own))
    if missing or unexpected:
        raise ValueError(
            f"params do not match: missing {missing}, "
            f"unexpected {unexpected}"
        )
    for name, p in own.items():
        p.copy_(as_tensor(flat[name]))


def _owners(dmp: DistributedModelParallel) -> Dict[str, str]:
    """{table -> the key of the port module that holds it}."""
    return {t.name: key for key, sebc in dmp.sharded_ebcs.items()
            for t in sebc.tables}


def _uvm_names(dmp: DistributedModelParallel) -> set:
    return {t.name for m in dmp._uvm_modules().values()
            for t in m.uvm_tables}


def _per_module(dmp: DistributedModelParallel, what: str,
                per_table: Mapping[str, np.ndarray], exclude=frozenset(),
                ) -> Dict[str, Dict[str, np.ndarray]]:
    """Split {table -> array} by the sharded module that holds each table;
    raises unless the tables match the DMP's (less `exclude`) exactly."""
    owner = {t: key for t, key in _owners(dmp).items() if t not in exclude}
    unknown = sorted(set(per_table) - set(owner))
    absent = sorted(set(owner) - set(per_table))
    if unknown or absent:
        raise ValueError(
            f"{what} do not match: unknown {unknown}, missing {absent}"
        )
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, w in per_table.items():
        out.setdefault(owner[name], {})[name] = w
    return out


@torch.no_grad()
def load_jax_weights(
    dmp: DistributedModelParallel,
    dense_params: Mapping,
    tables: Mapping[str, np.ndarray],
    opt_state: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None,
    interaction_params: Optional[Mapping[str, Any]] = None,
    uvm_momentum: Optional[Mapping[str, np.ndarray]] = None,
) -> None:
    """Load the JAX DMP's dense params, unsharded tables and (optionally)
    fused optimizer state into `dmp`; without `opt_state` the optimizer
    state restarts at zero, as after the JAX DMP's `load_tables`. UVM
    tables come with the others in `tables`; their momenta as JAX's
    `uvm_momentum/<key>` entries merged ({`<table>`, `<table>.m2`,
    `<table>.step` -> array}) in `uvm_momentum`, or in `opt_state` in the
    canonical form.
    `interaction_params`: {tower module key -> one flax param tree per
    tower}, the JAX tower collection's `interaction_params`, each loaded
    into its tower's interaction module. Raises unless every dense
    parameter, every interaction parameter and every table is matched."""
    towers = {key: m for key, m in dmp.sharded_ebcs.items()
              if isinstance(m, ShardedEmbeddingTowerCollection)}
    interaction_params = interaction_params or {}
    if set(interaction_params) != set(towers):
        raise ValueError(f"interaction params for {sorted(interaction_params)}"
                         f", the DMP's towers are {sorted(towers)}")
    load_flax_params(dmp.module, dense_params, exclude={
        id(p) for tc in towers.values() for p in tc.parameters()})
    for key, per_tower in interaction_params.items():
        inters = towers[key].interactions
        if len(per_tower) != len(inters):
            raise ValueError(f"{key}: {len(per_tower)} interaction trees for "
                             f"{len(inters)} towers")
        for inter, tree in zip(inters, per_tower):
            load_flax_params(inter, tree)
    uvm = _uvm_names(dmp)
    moms: Dict[str, Dict[str, np.ndarray]] = {}
    for name, m in dict(uvm_momentum or {}).items():
        moms.setdefault(_owners(dmp)[table_of_entry(name)], {})[name] = m
    opt_state = dict(opt_state or {})
    for name in uvm & set(opt_state):
        moms.setdefault(_owners(dmp)[name], {}).update(
            canonical_to_momentum(name, opt_state.pop(name)))
    dmp.load_tables(_per_module(dmp, "tables", tables),
                    uvm_momentum=moms or None)
    # after the tables: load_tables restarts the optimizer state
    if opt_state:
        for key, st in _per_module(dmp, "optimizer states", opt_state,
                                   exclude=uvm).items():
            dmp.sharded_ebcs[key].shard_opt_from_tables(st)


def fused_optimizer_state(
    dmp: DistributedModelParallel,
) -> Dict[str, Dict[str, np.ndarray]]:
    """{table -> {"m1__...", "m2__...", "step"}}: the port's fused
    optimizer state in the form of the JAX strategies'
    `unshard_opt_to_tables`; a UVM table's flushed host momenta
    ({"m1__row" | "m1__full", "m2__...", "step"}) included."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for sebc in dmp.sharded_ebcs.values():
        out.update(sebc.unshard_opt_to_tables())
    for m in dmp._uvm_modules().values():
        mom, steps = m.uvm_momentum_dict(), m.uvm_steps()
        for t in m.uvm_tables:
            entry = {"step": np.asarray(steps[t.name], np.int32)}
            for tag, suffix, kind in zip(("m1", "m2"), ("", ".m2"),
                                         fused_state_shapes(m.optim)):
                if kind != "none":
                    entry[f"{tag}__{kind}"] = mom[t.name + suffix]
            out[t.name] = entry
    return out


def load_jax_reshardable(npz_path: str,
                         dmp: DistributedModelParallel) -> None:
    """Load a `.npz` that JAX's `save_reshardable` wrote into `dmp` under
    its plan and world size: the flax dense paths become the port's
    parameter names (`flax_dense_to_state_dict`), each JAX module key the
    key of the port module that holds its tables, then
    utils/checkpoint.load_reshardable_arrays. Raises for a table the DMP
    does not hold."""
    from torchrec_tpu_torch.utils.checkpoint import load_reshardable_arrays

    with np.load(npz_path) as f:
        data = {k: f[k] for k in f.files}
    owner = _owners(dmp)
    tree: Dict[str, Any] = {}
    out: Dict[str, np.ndarray] = {"step": data["step"]}
    for k, v in data.items():
        if k.startswith("dense/"):
            node = tree
            parts = k[len("dense/"):].split("/")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = v
            continue
        for prefix in ("tables/", "opt/", "uvmopt/"):
            if not k.startswith(prefix):
                continue
            rest = k[len(prefix):]
            if prefix == "opt/":
                _, tname, tag = rest.rsplit("/", 2)
                tail = f"{tname}/{tag}"
            else:
                tail = rest.rsplit("/", 1)[1]
                tname = table_of_entry(tail)
            if tname not in owner:
                raise ValueError(f"{k}: the DMP holds no table {tname!r}")
            out[f"{prefix}{owner[tname]}/{tail}"] = v
    for name, arr in flax_dense_to_state_dict(tree, dmp.module).items():
        out[f"dense/{name}"] = arr
    load_reshardable_arrays(dmp, out)


def _to_flax_tree(template: Mapping, module: nn.Module,
                  flat: Mapping[str, Any], prefix: str = "") -> Dict:
    """The inverse of flax_dense_to_state_dict: a tree shaped like
    `template` (a flax param tree) with `flat`'s arrays, keyed by the
    port's parameter names, in the flax layouts."""
    out: Dict[str, Any] = {}
    names = getattr(module, "flax_names", {})
    for name, value in template.items():
        if isinstance(value, Mapping):
            attr = names.get(name, name)
            out[name] = _to_flax_tree(value, module.get_submodule(attr),
                                      flat, f"{prefix}{attr}.")
            continue
        pname = names.get(name, _LEAF_NAMES.get(name, name))
        arr = np.asarray(torch.as_tensor(flat[prefix + pname]).cpu())
        if name == "kernel":
            arr = arr.T
        out[name] = arr.reshape(np.shape(value))
    return out


def optax_state_to_keyed(opt_state: Any,
                         module: nn.Module) -> Dict[str, np.ndarray]:
    """An optax dense-optimizer state over `module`'s flax params (numpy
    leaves) -> the port's KeyedOptimizer state {key: array}. Raises for an
    optax state it does not know."""
    out: Dict[str, np.ndarray] = {}

    def walk(node):
        kind = type(node).__name__
        if kind == "ScaleByAdamState":
            mu = flax_dense_to_state_dict(node.mu, module)
            nu = flax_dense_to_state_dict(node.nu, module)
            for name in mu:
                out[f"{name}/step"] = np.asarray(node.count, np.float32)
                out[f"{name}/exp_avg"] = mu[name]
                out[f"{name}/exp_avg_sq"] = nu[name]
        elif kind == "TraceState":
            for name, t in flax_dense_to_state_dict(node.trace,
                                                    module).items():
                out[f"{name}/momentum_buffer"] = t
        elif kind == "ScaleByScheduleState":
            out[f"{WARMUP_KEY}/count"] = np.asarray(node.count, np.int32)
        elif kind == "EmptyState":
            pass
        elif isinstance(node, tuple) and not hasattr(node, "_fields"):
            for child in node:  # optax.chain's tuple of states
                walk(child)
        else:
            raise ValueError(f"optax state {kind} has no port counterpart")

    walk(opt_state)
    return out


def keyed_to_optax_state(flat: Mapping[str, Any], module: nn.Module,
                         template: Any) -> Any:
    """The port's KeyedOptimizer state -> an optax state shaped like
    `template` (the optax state of the same chain, numpy leaves), its
    leaves numpy arrays in the flax layouts."""

    def per_param(tree, name):
        return _to_flax_tree(tree, module, {
            k[:-len(name) - 1]: v for k, v in flat.items()
            if k.endswith("/" + name)})

    def build(node):
        kind = type(node).__name__
        if kind == "ScaleByAdamState":
            first = next(k for k in flat if k.endswith("/step"))
            return node._replace(
                count=np.asarray(torch.as_tensor(flat[first]).cpu(),
                                 np.int32),
                mu=per_param(node.mu, "exp_avg"),
                nu=per_param(node.nu, "exp_avg_sq"))
        if kind == "TraceState":
            return node._replace(trace=per_param(node.trace,
                                                 "momentum_buffer"))
        if kind == "ScaleByScheduleState":
            return node._replace(count=np.asarray(
                torch.as_tensor(flat[f"{WARMUP_KEY}/count"]), np.int32))
        if kind == "EmptyState":
            return node
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(build(child) for child in node)
        raise ValueError(f"optax state {kind} has no port counterpart")

    return build(template)


def load_jax_predict_package(path: str, scaffold: DistributedModelParallel,
                             device: DeviceLike = None) -> PredictModule:
    """A PredictModule on `device` (default: the current CUDA card) from a
    package that the JAX package's `PredictModule.save` wrote. `scaffold`
    is the port's DMP of the same model, for its module tree and table
    configs; build it on `device="meta"`. Raises unless every table and
    dense parameter is matched."""
    dev = resolve_device(device)
    jax_quant, flat = read_package(path)
    owner = {t.name: key for key, sebc in scaffold.sharded_ebcs.items()
             for t in sebc.tables}
    quant: Dict[str, Dict[str, tuple]] = {}
    for jax_key, tabs in jax_quant.items():
        keys = {owner.get(name) for name in tabs}
        if len(keys) != 1 or None in keys:
            raise ValueError(f"JAX module {jax_key!r}: tables {sorted(tabs)} "
                             "are not the tables of one port module")
        quant[keys.pop()] = tabs
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    dense = flax_dense_to_state_dict(tree, scaffold.module)
    return PredictModule.from_dmp(
        scaffold, quant_modules(scaffold, quant, dev), dev, dense)
