"""Inference stack: quantized predict modules.

Counterpart of torchrec_tpu/inference/modules.py. A PredictModule is the
DMP's model with each sharded EmbeddingBagCollection replaced by a
QuantEmbeddingBagCollection: a copy of the dense part, made with
`copy.deepcopy` whose memo maps each sharded module to a stand-in, so the
f32 tables are never copied and the predict module holds none.
`PredictModule.load` takes a DMP only as scaffolding (its module tree and
table configs): build it on `device="meta"` and the tables are never
allocated at all. The quantized modules take the sharded ones' place, so
the pooled values need no injected slot; `predict` runs under
`torch.inference_mode()`.

Export is the JAX package's directory format: `arrays.npz` with
`dense/<parameter fqn, "/"-joined>` and `quant/<module key>/<table>/
{data,scale,shift}`, and `manifest.json` with each table's bits and dim.
The dense keys are the port's parameter names; utils/jax_bridge.py loads a
package that the JAX package wrote.
"""

from __future__ import annotations

import abc
import copy
import json
import os
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import DataType
from torchrec_tpu_torch.ops.quant import QuantizedTable
from torchrec_tpu_torch.optim.keyed import flatten_with_fqns
from torchrec_tpu_torch.parallel.dmp import _replace_module
from torchrec_tpu_torch.parallel.quant_sharded import (
    ShardedQuantEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.sharded_ec import ShardedEmbeddingCollection
from torchrec_tpu_torch.parallel.types import ShardingEnv
from torchrec_tpu_torch.quant.embedding_modules import (
    QuantEmbeddingBagCollection,
)
from torchrec_tpu_torch.utils import tracing
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

PREDICT_SPAN = "## predict ##"  # utils/tracing.py


def _copy_with(module: nn.Module, swap: Mapping[int, nn.Module],
               device: torch.device,
               dense: Optional[Mapping[str, Any]] = None) -> nn.Module:
    """A copy of `module` on `device` with each submodule whose id is a
    key of `swap` replaced by its value, which is not copied. The rest
    keeps its values, or takes `dense` ({parameter name -> array}, every
    parameter and nothing else) when given; a module on `meta` needs
    `dense`."""
    stubs = {i: nn.Identity() for i in swap}
    out = copy.deepcopy(module, memo=dict(stubs))
    meta = any(p.is_meta for p in out.parameters())
    if meta and dense is None:
        raise ValueError("a module on the meta device needs its parameters")
    out = out.to_empty(device=device) if meta else out.to(device)
    if dense is not None:
        own = dict(out.named_parameters())
        missing = sorted(set(own) - set(dense))
        unexpected = sorted(set(dense) - set(own))
        if missing or unexpected:
            raise ValueError(f"dense parameters do not match: missing "
                             f"{missing}, unexpected {unexpected}")
        with torch.no_grad():
            for name, p in own.items():
                p.copy_(torch.as_tensor(np.asarray(dense[name])))
    for i, stub in stubs.items():
        _replace_module(out, stub, swap[i])
    return out.requires_grad_(False).eval()


class PredictModule(nn.Module):
    """Serving wrapper: the dense f32 model with int-N embedding lookups.

    module: the model, its EBCs already quantized modules; quant_ebcs:
    {DMP module key -> QuantEmbeddingBagCollection (or its sharded
    form)}, the modules inside `module`. Build one with
    `quantize_embeddings` or `load`.
    """

    def __init__(self, module: nn.Module, quant_ebcs: Mapping[str, nn.Module]):
        super().__init__()
        self.module = module
        # a plain dict: the modules are registered once, inside `module`
        self._quant_ebcs = dict(quant_ebcs)

    @property
    def device(self) -> torch.device:
        q = next(iter(self._quant_ebcs.values()))
        return next(q.buffers()).device

    def predict(self, *args):
        """The model's output on `args` (on the module's device), under
        torch.inference_mode() and the `## predict ##` span."""
        with torch.inference_mode(), tracing.span(PREDICT_SPAN):
            return self.module(*args)

    def forward(self, *args):
        return self.predict(*args)

    def batching_metadata(self) -> Dict[str, str]:
        out = {}
        for q in self._quant_ebcs.values():
            for t in q.tables:
                for f in t.feature_names:
                    out[f] = "sparse"
        return out

    def result_metadata(self) -> str:
        return "dense"

    # -- export ---------------------------------------------------------

    def _dense_params(self) -> Dict[str, torch.Tensor]:
        tree: Dict[str, Any] = {}
        for name, p in self.module.named_parameters():
            node = tree
            parts = name.split(".")
            for part in parts[:-1]:
                node = node.setdefault(part, {})
            node[parts[-1]] = p
        return flatten_with_fqns(tree)

    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        flat: Dict[str, np.ndarray] = {
            f"dense/{k}": v.detach().cpu().numpy()
            for k, v in self._dense_params().items()}
        manifest: Dict[str, Any] = {"quant": {}}
        for key, q in self._quant_ebcs.items():
            manifest["quant"][key] = {}
            for name, tab in q.quantized.items():
                for part in ("data", "scale", "shift"):
                    flat[f"quant/{key}/{name}/{part}"] = (
                        getattr(tab, part).cpu().numpy())
                manifest["quant"][key][name] = {"bits": tab.bits,
                                                "dim": tab.dim}
        np.savez(os.path.join(path, "arrays.npz"), **flat)
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump(manifest, f)

    @staticmethod
    def from_dmp(dmp, quant_ebcs: Mapping[str, QuantEmbeddingBagCollection],
                 device: DeviceLike = None,
                 dense: Optional[Mapping[str, Any]] = None
                 ) -> "PredictModule":
        """The DMP's model with each sharded module keyed in `quant_ebcs`
        replaced by its quantized module, on `device`; the dense
        parameters are the DMP's, or `dense` when given."""
        _check_quantizable(dmp)
        missing = sorted(set(dmp.sharded_ebcs) - set(quant_ebcs))
        if missing:
            raise ValueError(f"no quantized module for {missing}")
        swap = {id(dmp.sharded_ebcs[key]): q for key, q in quant_ebcs.items()}
        module = _copy_with(dmp.module, swap, resolve_device(device), dense)
        return PredictModule(module, quant_ebcs)

    @staticmethod
    def load(path: str, dmp, device: DeviceLike = None) -> "PredictModule":
        """Load a package saved by `save` onto `device` (default: the
        current CUDA card). `dmp` is scaffolding for the module tree and
        the table configs; build it on `device="meta"`."""
        dev = resolve_device(device)
        quant, dense = read_package(path)
        dense = {k.replace("/", "."): v for k, v in dense.items()}
        return PredictModule.from_dmp(
            dmp, quant_modules(dmp, quant, dev), dev, dense)


def read_package(path: str) -> Tuple[Dict[str, Dict[str, tuple]],
                                     Dict[str, np.ndarray]]:
    """A package's arrays: ({module key -> {table -> (data, scale, shift,
    bits, dim)}}, {"/"-joined dense parameter path -> array})."""
    with np.load(os.path.join(path, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    missing = sorted(f"{key}/{name}" for key, tabs in manifest["quant"].items()
                     for name in tabs
                     for part in ("data", "scale", "shift")
                     if f"quant/{key}/{name}/{part}" not in arrays)
    if missing:
        raise ValueError(f"package {path}: the manifest names tables "
                         f"without arrays: {sorted(set(missing))}")
    quant = {key: {name: (arrays[f"quant/{key}/{name}/data"],
                          arrays[f"quant/{key}/{name}/scale"],
                          arrays[f"quant/{key}/{name}/shift"],
                          int(meta["bits"]), int(meta["dim"]))
                   for name, meta in tabs.items()}
             for key, tabs in manifest["quant"].items()}
    dense = {k[len("dense/"):]: v for k, v in arrays.items()
             if k.startswith("dense/")}
    return quant, dense


def quant_modules(dmp, quant: Mapping[str, Mapping[str, tuple]],
                  device: torch.device
                  ) -> Dict[str, QuantEmbeddingBagCollection]:
    """{module key -> {table -> (data, scale, shift, bits, dim)}} ->
    quantized modules on `device`, with the DMP's table configs."""
    out = {}
    for key, tabs in quant.items():
        sebc = dmp.sharded_ebcs[key]
        quantized = {
            name: QuantizedTable(data=torch.as_tensor(d),
                                 scale=torch.as_tensor(s),
                                 shift=torch.as_tensor(h), bits=bits,
                                 dim=dim)
            for name, (d, s, h, bits, dim) in tabs.items()}
        out[key] = QuantEmbeddingBagCollection(
            sebc.tables, quantized, sebc.is_weighted,
            sebc.max_feature_length, device)
    return out


class ShardedPredictModule(PredictModule):
    """Quantized serving through `ShardedQuantEmbeddingBagCollection`s:
    each quantized EBC of `module` replaced by its table-wise sharded form
    over `env`, its tables placed by `table_ranks` ({module key -> {table
    -> rank}}), in a copy of the dense part on `env`'s device. It keeps no
    reference to the unsharded quantized tables; `save` writes the sharded
    modules' tables, at world size n this rank's."""

    def __init__(self, module: nn.Module,
                 quant_ebcs: Mapping[str, QuantEmbeddingBagCollection],
                 env: ShardingEnv,
                 table_ranks: Mapping[str, Mapping[str, int]]):
        sharded = {
            key: ShardedQuantEmbeddingBagCollection(
                env, q.tables, q.quantized, table_ranks[key],
                is_weighted=q.is_weighted,
                max_feature_length=q.max_feature_length)
            for key, q in quant_ebcs.items()}
        swap = {id(q): sharded[key] for key, q in quant_ebcs.items()}
        super().__init__(_copy_with(module, swap, env.device), sharded)
        self._env = env
        self._sharded = sharded

    @property
    def device(self) -> torch.device:
        return self._env.device


def _plan_quant_ranks(env, quant_ebcs: Mapping[str, Any], *,
                      topology=None) -> Dict[str, Dict[str, int]]:
    """The planned TABLE_WISE placement of each quantized module's tables:
    the sharding planner under the quantized sharder's sharding types, on
    `topology` (default: the env's world size on the card's spec), as the
    JAX function plans it; round-robin over the ranks where the planner
    finds no plan."""
    from torchrec_tpu_torch.parallel.sharders import (
        QuantEmbeddingBagCollectionSharder,
    )
    from torchrec_tpu_torch.planner import (
        EmbeddingShardingPlanner,
        ParameterConstraints,
        PlannerError,
        Topology,
    )

    sharder = QuantEmbeddingBagCollectionSharder()
    out: Dict[str, Dict[str, int]] = {}
    for key, q in quant_ebcs.items():
        try:
            topo = topology or Topology(world_size=env.world_size)
            constraints = {t.name: ParameterConstraints(
                sharding_types=sharder.sharding_types()) for t in q.tables}
            plan = EmbeddingShardingPlanner(
                topo, constraints=constraints).plan(
                    q.tables, module_path="m").plan["m"]
            out[key] = {name: (ps.ranks[0] if ps.ranks else 0)
                        for name, ps in plan.items()}
        except PlannerError:
            out[key] = {t.name: i % env.world_size
                        for i, t in enumerate(q.tables)}
    return out


def shard_quantized(
    pm: PredictModule,
    env: Optional[ShardingEnv] = None,
    table_ranks: Optional[Mapping[str, Mapping[str, int]]] = None,
) -> ShardedPredictModule:
    """Shard a quantized PredictModule over an inference env (default: one
    device, the predict module's; `ShardingEnv.from_local(n)` for n ranks
    of one host), each table on the rank `table_ranks` gives ({module key
    -> {table -> rank}}, JAX's form), by default the sharding planner's
    TABLE_WISE placement (`_plan_quant_ranks`, as JAX plans it; at world
    size 1 every table lands on rank 0)."""
    env = env or ShardingEnv(pm.device)
    if table_ranks is None:
        table_ranks = _plan_quant_ranks(env, pm._quant_ebcs)
    return ShardedPredictModule(pm.module, pm._quant_ebcs, env, table_ranks)


class PredictFactory(abc.ABC):
    """The serving entry contract."""

    @abc.abstractmethod
    def create_predict_module(self) -> PredictModule: ...

    def batching_metadata(self) -> Dict[str, str]:
        return {}

    def result_metadata(self) -> str:
        return "dense"


def _check_quantizable(dmp) -> None:
    """Raise for the sharded modules quantized serving does not take."""
    if dmp._fp_ebcs:
        raise NotImplementedError(
            f"quantized serving of a FeatureProcessedEmbeddingBagCollection "
            f"({sorted(dmp._fp_ebcs)}): the JAX package's PredictModule "
            "does not run the feature processor, so its predictions ignore "
            "the learned per-sample weights; the port does not copy that")
    ecs = [k for k, m in dmp.sharded_ebcs.items()
           if isinstance(m, ShardedEmbeddingCollection)]
    if ecs:
        raise NotImplementedError(
            f"quantized EmbeddingCollection inference ({ecs}): the JAX "
            "package has none either")
    uvm = [k for k, m in dmp.sharded_ebcs.items()
           if getattr(m, "uvm_tables", ())]
    if uvm:
        raise NotImplementedError(
            f"quantized serving of FUSED_UVM_CACHING tables ({uvm}): the JAX "
            "package's quantize_embeddings reads only a module's device "
            "part, so it drops the host-resident tables' columns (and an "
            "all-UVM module); the port does not copy that")


def quantize_embeddings(
    dmp,
    data_type: DataType = DataType.INT8,
    device: DeviceLike = None,
) -> PredictModule:
    """Trained DMP -> quantized PredictModule on `device` (default: the
    current CUDA card). Each table is quantized where the DMP holds it; at
    world size n every rank gathers every table first (`unshard_tables`,
    a collective) and holds the whole quantized model."""
    dev = resolve_device(device)
    _check_quantizable(dmp)
    quant_ebcs = {
        key: QuantEmbeddingBagCollection.from_float(
            sebc.tables, sebc.unshard_tables(), data_type, sebc.is_weighted,
            sebc.max_feature_length, device=dmp.env.device).to(dev)
        for key, sebc in dmp.sharded_ebcs.items()}
    return PredictModule.from_dmp(dmp, quant_ebcs, dev)


class PredictFactoryPackager:
    """Exports a PredictFactory: its predict module saved as npz +
    manifest, and a factory manifest naming the factory class (the
    loading code is expected to be importable)."""

    @classmethod
    def save_predict_factory(cls, factory: PredictFactory,
                             path: str) -> None:
        module = factory.create_predict_module()
        module.save(path)
        meta = {
            "factory_class": type(factory).__qualname__,
            "factory_module": type(factory).__module__,
            "batching_metadata": factory.batching_metadata(),
            "result_metadata": factory.result_metadata(),
        }
        with open(os.path.join(path, "factory.json"), "w") as f:
            json.dump(meta, f)

    @staticmethod
    def load_metadata(path: str) -> Dict[str, Any]:
        with open(os.path.join(path, "factory.json")) as f:
            return json.load(f)
