"""DistributedModelParallel: the model-parallel engine.

Counterpart of torchrec_tpu/parallel/dmp.py for models whose sparse part is
EmbeddingBagCollections and EmbeddingCollections. The JAX DMP swaps each
for a parameter-less stub and injects the sharded lookup's output through a
flax collection; here a ShardedEmbeddingBagCollection or
ShardedEmbeddingCollection simply replaces the authored module, wherever
the model holds it (BERT4Rec holds its EC twice), which is the torch form
of the same swap. Plans are keyed by the module's first path in
`named_modules`, joined with "/" (for the port's DLRMTrain
"dlrm/sparse_arch/embedding_bag_collection", for BERT4RecTrain
"model/ec").

The DMP takes the authored module's structure, not its values: the dense
modules are re-allocated on the env's device with `to_empty`, so build
the model on `device="meta"` and call `init(seed)` or load weights
(utils/jax_bridge.py) before the first forward.

The train step follows the JAX DMP's: the sharded lookups run outside
autograd, their values (an EBC's pooled KeyedTensor values, an EC's
per-token rows) enter the dense model as leaves, one backward gives the
dense gradients and the leaves' cotangents, the dense optimizer steps
(every dense parameter, with a zero gradient where the loss does not
reach it, as JAX differentiates them all) and each sharded module
applies its fused optimizer to the touched rows. Where
the JAX step returns a new DMPState, this one updates the DMP's
parameters, tables and optimizer state in place.

A FeatureProcessedEmbeddingBagCollection is found before the EBC it
wraps and planned under its own path (for a position-weighted DLRMTrain
"dlrm/sparse_arch/embedding_bag_collection"). It becomes a
ShardedFeatureProcessedEmbeddingBagCollection: its processor stays a dense
module, drawn by `init` and stepped by the dense optimizer, and its EBC a
weighted ShardedEmbeddingBagCollection. Served, it runs
`sharded(processor(batch))`. In the train step the processor runs
with autograd on and the sharded lookup with its pooling coefficient
differentiable in the processed weights, its table a buffer that takes no
gradient; after the dense backward the pooled values' cotangent goes back
through K1's VJP (`d_coeff`, rows gathered by K8) into the processor's
parameters, and the fused update takes this step's weights, detached, as
the JAX step passes `sb.replace(weights=w)`.

Every fused optimizer trains fp32, bf16 and fp16 tables (half tables
through K1h and K3h / K4h, rounding stochastically by default; see
ops/fused_update.py). The tables are buffers, so the dense optimizer never
sees one, and each sharded module's update takes an f32 cotangent.

At world size n (an env over a process group, one process per rank) each
rank feeds its own slice of the global batch, B_loc rows, and gets the
outputs of that slice. The JAX step differentiates the mean loss of the
global batch; here each rank differentiates the mean loss of its slice,
whose gradient is n times its share of the global one. So after the
backward the dense gradients are all_reduced as a mean over the ranks (one
call; `init(seed)` draws the same dense parameters on every rank, and the
equal steps keep them equal), and the sparse cotangents are divided by n
before the sharded updates. The returned loss is the rank's own; the mean
of the ranks' losses is JAX's. At world size n a feature processor's
lookup runs through the differentiable collectives of parallel/comm.py:
the backward of the rank's local loss reaches every rank's processed
weights, so the processor's gradient on a rank is that of the sum of the
ranks' local losses through its own weights, and the dense all_reduce's
mean makes it the global mean loss's. It is not scaled by 1/n as the
sparse cotangents are.

`input_dist(batch)` is a batch's sparse input dist, computed ahead of its
step: for each EBC and EC without a feature processor, each group's
strategy's `input_dist` (the ids' all_gather, or the hierarchical
strategies' routed views). `make_prefetched_train_step()` takes the
batch's dists and returns the next batch's, so that a batch's forward and
update share one dist: each group with a dist makes one all_gather of
the ids per step where `make_train_step` makes two, with the same
numerics (parallel/train_pipeline.SparseDistPipeline drives it).

An EmbeddingTower or EmbeddingTowerCollection becomes a
ShardedEmbeddingTowerCollection (parallel/tower_sharding.py), which
returns the towers' outputs [B, sum(d_out)] and holds their tables and
interaction modules. Its plan must put every tower's tables TABLE_WISE on
one rank. Its interaction parameters step inside its update, by SGD at the
base fused learning rate (`learning_rate`, unscheduled, as the JAX DMP
builds the collection), so the dense optimizer does not take them; the
train step feeds it the cotangent of its output, divided by n as the
other sparse cotangents.

A module the plan has no entry for (or every module, without a plan) is
planned by the sharding planner (planner/) under its sharder's sharding
types, on a Topology of the env's world size and local size and the
card's spec: an EBC, an EC and an FP-EBC's EBC each on their own, a
tower module with one dependency tag per tower, so that each tower's
tables plan TABLE_WISE on one rank. Where the planner finds no plan, the
JAX DMP's fallbacks: towers round-robin over the ranks by tag, else
DATA_PARALLEL under 64 rows and ROW_WISE above.

An EmbeddingBagCollection with FUSED_UVM_CACHING tables becomes a
UvmSplitEmbeddingBagCollection (parallel/uvm_ebc.py): a
ShardedEmbeddingBagCollection over its other tables and the UVM tables in
pinned host memory with a row cache on the device each, on one rank,
which serves the global batch; its output is in the module's column
order, so the train step needs no case of its own. Its lookups and
updates are driven from the host, so it has no input dist ahead of the
step: `make_prefetched_train_step` raises for such a plan, as JAX's does,
and the pipelines gather it in the step (SparseDistPipeline included).
An FP-EBC over UVM tables raises NotImplementedError, as in JAX; a tower
table or an EC table planned FUSED_UVM_CACHING stays on the device, as in
JAX, whose tower and EC branches do not read the compute kernel.

`unsharded_state_dict()` is the JAX DMP's `state_dict(state)`: the dense
parameters by FQN and every table unsharded by module key, gathered to
the host one table at a time, UVM tables (flushed) and their momenta
included. `nn.Module.state_dict` keeps torch's meaning: the sharded
buffers (utils/checkpoint.save_state).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
    EmbeddingCollection,
    as_padded,
)
from torchrec_tpu_torch.modules.embedding_tower import (
    EmbeddingTower,
    EmbeddingTowerCollection,
)
from torchrec_tpu_torch.modules.feature_processor import (
    FeatureProcessedEmbeddingBagCollection,
)
from torchrec_tpu_torch.modules.utils import (
    drawn_by,
    get_module_output_dimension,
    seeded_reset,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.optim.keyed import DenseOptimizerFactory
from torchrec_tpu_torch.parallel import comm
from torchrec_tpu_torch.parallel.sharded_ebc import (
    ShardedEmbeddingBagCollection,
    ShardedEmbeddingModule,
    ShardedFeatureProcessedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.sharded_ec import ShardedEmbeddingCollection
from torchrec_tpu_torch.parallel.sharders import (
    EmbeddingBagCollectionSharder,
    EmbeddingCollectionSharder,
    EmbeddingTowerCollectionSharder,
    ModuleSharder,
)
from torchrec_tpu_torch.parallel.strategies import ArrayLike
from torchrec_tpu_torch.parallel.tower_sharding import (
    ShardedEmbeddingTowerCollection,
    TowerSpec,
)
from torchrec_tpu_torch.parallel.uvm_ebc import (
    UvmSplitEmbeddingBagCollection,
    uvm_tables_of,
)
from torchrec_tpu_torch.parallel.types import (
    ParameterSharding,
    ShardingEnv,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.sparse.jagged import (
    KeyedJaggedTensor,
    KeyedTensor,
    PaddedSparseBatch,
)
from torchrec_tpu_torch.utils import tracing
from torchrec_tpu_torch.utils.device import DeviceLike

# the train step's spans (utils/tracing.py); the feature processor's open
# only where the DMP has a feature-processed EBC
TRAIN_STEP = "## train_step ##"
FP_FORWARD = "## train_feature_processor ##"
DENSE_FORWARD = "## train_dense_forward ##"
BACKWARD = "## train_backward ##"
FP_BACKWARD = "## train_fp_backward ##"
DENSE_OPTIMIZER = "## train_dense_optimizer ##"


def _replace_module(root: nn.Module, old: nn.Module, new: nn.Module) -> None:
    """Put `new` wherever a module of `root` holds `old` as a child."""
    for m in list(root.modules()):
        for name, child in list(m.named_children()):
            if child is old:
                setattr(m, name, new)


def _tower_d_in(tower: EmbeddingTower) -> int:
    """A tower's interaction input width: one pooled [D] block per (table,
    feature)."""
    return sum(t.embedding_dim * len(t.feature_names)
               for t in tower.embedding_module.tables)


def _tower_d_out(tower: EmbeddingTower) -> int:
    """A tower's interaction output width, from a run on `meta`."""
    return get_module_output_dimension(tower.interaction_module,
                                       _tower_d_in(tower))


def _default_plan(tables, env: ShardingEnv, sharder: ModuleSharder,
                  dependencies: Optional[Mapping[str, str]] = None, *,
                  topology=None) -> Dict[str, ParameterSharding]:
    """The plan of a module given none: the sharding planner under the
    sharder's sharding types, on `topology` (default: the env's world size
    and local size on the card's spec). `dependencies` maps tables to
    co-location tags (one per embedding tower). Where the planner finds no
    plan, JAX's fallbacks: whole dependency groups round-robin over the
    ranks (TABLE_WISE), else DATA_PARALLEL under 64 rows and ROW_WISE
    above."""
    from torchrec_tpu_torch.planner import (
        EmbeddingShardingPlanner,
        ParameterConstraints,
        PlannerError,
        Topology,
    )

    dependencies = dependencies or {}
    try:
        topo = topology or Topology(world_size=env.world_size,
                                    local_world_size=env.local_size)
        constraints = {
            t.name: ParameterConstraints(
                sharding_types=sharder.sharding_types(),
                dependency=dependencies.get(t.name))
            for t in tables}
        planner = EmbeddingShardingPlanner(topo, constraints=constraints)
        return planner.plan(tables, module_path="m").plan["m"]
    except PlannerError:
        if dependencies:
            tags = sorted({dependencies.get(t.name, t.name) for t in tables})
            rank_of = {tag: i % env.world_size for i, tag in enumerate(tags)}
            return {t.name: ParameterSharding(
                        ShardingType.TABLE_WISE,
                        ranks=[rank_of[dependencies.get(t.name, t.name)]])
                    for t in tables}
        return {cfg.name: ParameterSharding(
                    ShardingType.DATA_PARALLEL if cfg.num_embeddings < 64
                    else ShardingType.ROW_WISE)
                for cfg in tables}


def _detach(x: Any) -> Any:
    if isinstance(x, torch.Tensor):
        return x.detach()
    if isinstance(x, (tuple, list)):
        return type(x)(_detach(v) for v in x)
    if isinstance(x, dict):
        return {k: _detach(v) for k, v in x.items()}
    return x


def _grad(leaf: Any) -> Any:
    """The gradient of a leaf or of each leaf of a dict, in f32 (a half
    table's EC rows are half leaves); zeros where the loss does not read
    it."""
    if isinstance(leaf, dict):
        return {n: _grad(t) for n, t in leaf.items()}
    g = leaf.grad if leaf.grad is not None else torch.zeros_like(leaf)
    return g.to(torch.float32)


def _scaled(g: Any, s: float) -> Any:
    """g (a tensor or a dict of them) times s; g itself when s is 1."""
    if s == 1.0:
        return g
    if isinstance(g, dict):
        return {n: t * s for n, t in g.items()}
    return g * s


class DistributedModelParallel(nn.Module):
    """Wraps an authored model, shards its EmbeddingBagCollections,
    EmbeddingCollections, FeatureProcessedEmbeddingBagCollections and
    embedding towers per the plan, and serves and trains it on the env's
    device.

    env: where to run (default: ShardingEnv(device), and `device` defaults
    to the current CUDA card). plan: a ShardingPlan keyed by module path;
    a module it has no entry for, or every module when it is None, is
    planned by the sharding planner (the plan used is `self.plan`).
    fused_optim: the embedding tables' fused optimizer.
    fused_params: its `learning_rate` (default 0.01), an optional
    `lr_schedule` (step -> lr, evaluated on the host from the DMP's step
    counter; optim/warmup.make_warmup_schedule makes one) and
    the keys of ops/fused_update.apply_fused_update. dense_optimizer: a
    factory params -> torch.optim.Optimizer for the dense parameters
    (default: plain SGD at the fused learning rate, the update of the JAX
    DMP's default optax.sgd); optim/warmup.warmup_optimizer and
    optim/clipping.gradient_clipping wrap one, and the clip covers a
    feature processor's gradient too, which the train step adds before
    the dense step. sharders: parallel/sharders.py's ModuleSharders; each
    one's `fused_params` are merged under the explicit `fused_params`, as
    the JAX DMP merges them, and the sharding types of its module kind
    bound the planner's.
    """

    def __init__(
        self,
        module: nn.Module,
        env: Optional[ShardingEnv] = None,
        plan: Optional[ShardingPlan] = None,
        fused_optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
        fused_params: Optional[dict] = None,
        dense_optimizer: Optional[DenseOptimizerFactory] = None,
        device: DeviceLike = None,
        sharders: Optional[list] = None,
    ):
        super().__init__()
        self.env = env or ShardingEnv(device)
        # module path -> EBC, EC, FP-EBC, tower or tower collection;
        # named_modules lists a wrapper before the modules it wraps, which
        # are sharded as part of it
        found: Dict[str, nn.Module] = {}
        wrapped = set()
        for name, m in module.named_modules():
            if id(m) in wrapped:
                continue
            if isinstance(m, (EmbeddingTower, EmbeddingTowerCollection)):
                found[name] = m
                wrapped.update(id(x) for x in m.modules())
            elif isinstance(m, FeatureProcessedEmbeddingBagCollection):
                found[name] = m
                wrapped.add(id(m.embedding_bag_collection))
            elif isinstance(m, (EmbeddingBagCollection, EmbeddingCollection)):
                found[name] = m
        if not found:
            raise ValueError("no EmbeddingBagCollection or "
                             "EmbeddingCollection found in module")
        self.fused_optim = fused_optim
        # the sharders' fused_params under the explicit ones; a sharder of
        # a module kind also bounds the sharding types the planner gives
        # that kind
        self._sharders = list(sharders or ())
        merged: dict = {}
        for sh in self._sharders:
            merged.update(getattr(sh, "fused_params", None) or {})
        merged.update(fused_params or {})
        fused_params = merged
        self.learning_rate = fused_params.pop("learning_rate", 0.01)
        self.fused_lr_schedule: Optional[Callable[[int], float]] = (
            fused_params.pop("lr_schedule", None))
        self.fused_params = fused_params

        # module key -> sharded EBC or EC, as the JAX DMP's sharded_ebcs
        sharded: Dict[str, ShardedEmbeddingModule] = {}
        stubs: Dict[str, nn.Module] = {}
        # module key -> what replaced an FP-EBC
        self._fp_ebcs: Dict[
            str, ShardedFeatureProcessedEmbeddingBagCollection] = {}
        plans: Dict[str, Dict[str, ParameterSharding]] = {}
        for name, mod in found.items():
            key = name.replace(".", "/")
            module_plan = (None if plan is None
                           else plan.get_plan_for_module(key))
            if isinstance(mod, (EmbeddingTower, EmbeddingTowerCollection)):
                sharded[key], plans[key] = self._tower_module(
                    mod, module_plan, fused_optim, fused_params)
                stubs[key] = nn.Identity()
                _replace_module(module, mod, stubs[key])
                continue
            if module_plan is None:
                inner = (mod.embedding_bag_collection if isinstance(
                    mod, FeatureProcessedEmbeddingBagCollection) else mod)
                kind = "ec" if isinstance(inner, EmbeddingCollection) \
                    else "ebc"
                module_plan = _default_plan(inner.tables, self.env,
                                            self._sharder(kind))
            plans[key] = module_plan
            if isinstance(mod, FeatureProcessedEmbeddingBagCollection):
                if uvm_tables_of(module_plan, mod.embedding_bag_collection
                                 .tables):
                    raise NotImplementedError(
                        "FeatureProcessedEmbeddingBagCollection with "
                        "FUSED_UVM_CACHING tables is not supported")
                # the processor stays; the EBC is stubbed and sharded below
                fp_ebc = ShardedFeatureProcessedEmbeddingBagCollection(
                    mod.embedding_bag_collection, mod.feature_processor)
                _replace_module(module, mod, fp_ebc)
                self._fp_ebcs[key] = fp_ebc
                mod = mod.embedding_bag_collection
                sharded[key] = ShardedEmbeddingBagCollection(
                    self.env, mod.tables, module_plan, is_weighted=True,
                    max_feature_length=mod.max_feature_length,
                    optim=fused_optim, optim_kwargs=fused_params,
                )
            elif isinstance(mod, EmbeddingCollection):
                sharded[key] = ShardedEmbeddingCollection(
                    self.env, mod.tables, module_plan,
                    max_feature_length=mod.max_feature_length,
                    optim=fused_optim, optim_kwargs=fused_params,
                )
            else:
                # FUSED_UVM_CACHING tables split out to the host
                cls = (UvmSplitEmbeddingBagCollection
                       if uvm_tables_of(module_plan, mod.tables)
                       else ShardedEmbeddingBagCollection)
                sharded[key] = cls(
                    self.env, mod.tables, module_plan,
                    is_weighted=mod.is_weighted,
                    max_feature_length=mod.max_feature_length,
                    optim=fused_optim, optim_kwargs=fused_params,
                )
            # drop the unsharded tables before the dense part is allocated
            stubs[key] = nn.Identity()
            _replace_module(module, mod, stubs[key])
        module.to_empty(device=self.env.device)
        for key, stub in stubs.items():
            _replace_module(module, stub, sharded[key])
        self.module = module
        self.sharded_ebcs = sharded
        # the plan the modules were sharded by, planned entries included
        self.plan = ShardingPlan(plans)
        self.dense_optimizer = (dense_optimizer or self._default_dense_opt)(
            self._dense_parameters())
        # train steps taken: the fused lr_schedule's argument
        self.step = 0

    def _default_dense_opt(self, params) -> torch.optim.Optimizer:
        return torch.optim.SGD(params, lr=self.learning_rate)

    def _sharder(self, kind: str) -> ModuleSharder:
        """The sharder given for a module kind, else the default one."""
        return next((s for s in self._sharders
                     if getattr(s, "module_kind", None) == kind), None) or {
            "ebc": EmbeddingBagCollectionSharder,
            "ec": EmbeddingCollectionSharder,
            "tower": EmbeddingTowerCollectionSharder}[kind]()

    def _tower_module(self, mod: nn.Module,
                      module_plan: Optional[Dict[str, ParameterSharding]],
                      fused_optim: EmbOptimType, fused_params: dict):
        """(the ShardedEmbeddingTowerCollection of a tower or tower
        collection, its plan): each tower's tables TABLE_WISE on one rank,
        planned with one dependency tag per tower when `module_plan` is
        None; raises for any other placement, as the JAX DMP does. As in
        JAX, the compute kernel is not read: a table planned
        FUSED_UVM_CACHING stays on the device."""
        towers = (list(mod.towers) if isinstance(mod, EmbeddingTowerCollection)
                  else [mod])
        tables = [t for tw in towers for t in tw.embedding_module.tables]
        if module_plan is None:
            module_plan = _default_plan(
                tables, self.env, self._sharder("tower"),
                dependencies={t.name: f"tower_{i}"
                              for i, tw in enumerate(towers)
                              for t in tw.embedding_module.tables})
        specs = []
        for i, tw in enumerate(towers):
            ranks = set()
            for t in tw.embedding_module.tables:
                ps = module_plan[t.name]
                if ps.sharding_type is not ShardingType.TABLE_WISE:
                    raise ValueError(
                        f"tower table {t.name} planned {ps.sharding_type}; "
                        "tower tables must be TABLE_WISE (co-located with "
                        "their interaction module on one device)")
                ranks.add(ps.ranks[0] if ps.ranks else 0)
            if len(ranks) != 1:
                raise ValueError(
                    f"tower {i} tables placed on multiple ranks "
                    f"{sorted(ranks)}; a tower must be co-located")
            specs.append(TowerSpec(
                tables=tuple(tw.embedding_module.tables),
                interaction=tw.interaction_module, device=ranks.pop(),
                d_out=_tower_d_out(tw)))
        sharded = ShardedEmbeddingTowerCollection(
            self.env, specs, optim=fused_optim, optim_kwargs=fused_params,
            interaction_lr=self.learning_rate,
            max_feature_length=max(tw.embedding_module.max_feature_length
                                   for tw in towers))
        return sharded, module_plan

    def _towers(self) -> List[ShardedEmbeddingTowerCollection]:
        return [m for m in self.sharded_ebcs.values()
                if isinstance(m, ShardedEmbeddingTowerCollection)]

    def _dense_parameters(self) -> List[nn.Parameter]:
        """The parameters the dense optimizer steps: the module's, less
        the tower interactions', which step inside their collection."""
        inside = {id(p) for tc in self._towers()
                  for p in tc.parameters()}
        return [p for p in self.module.parameters() if id(p) not in inside]

    @torch.no_grad()
    def init(self, seed: int = 0) -> "DistributedModelParallel":
        """Draw every dense parameter and table from one generator seeded
        with `seed` on the env's device, and zero the fused optimizer
        state. Each module whose `reset_parameters` takes a generator
        draws its parameters from the distribution of its JAX
        counterpart's initializer; raises for a parameter that no module
        draws. Clearing the dense optimizer's state also restarts a warmup
        wrapper's count of updates, which lives there, as the JAX `init`
        rebuilds the optax state with its count."""
        g = torch.Generator(device=self.env.device).manual_seed(seed)
        # the towers' interactions are drawn by their collections' init
        inside = {id(m) for tc in self._towers() for m in tc.modules()}
        drawn = {id(p) for tc in self._towers() for p in tc.parameters()}
        for m in self.module.modules():
            reset = None if id(m) in inside else seeded_reset(m)
            if reset is not None:
                reset(generator=g)
                drawn.update(id(p) for p in drawn_by(m))
        missing = [n for n, p in self.module.named_parameters()
                   if id(p) not in drawn]
        if missing:
            raise NotImplementedError(
                f"init(): no module initialises {missing}; give their "
                "module a reset_parameters(generator) or load the weights"
            )
        for sebc in self.sharded_ebcs.values():
            sebc.init(g)
        self.dense_optimizer.state.clear()
        self.step = 0
        return self

    def _uvm_modules(self) -> Dict[str, UvmSplitEmbeddingBagCollection]:
        return {k: m for k, m in self.sharded_ebcs.items()
                if isinstance(m, UvmSplitEmbeddingBagCollection)}

    def load_tables(
        self, tables: Mapping[str, Mapping[str, ArrayLike]],
        uvm_momentum: Optional[Mapping[str, Mapping[str, ArrayLike]]] = None,
    ) -> None:
        """Load unsharded per-table weights: {module key -> {table ->
        [R, D] array}}. The loaded modules' fused optimizer state restarts
        at zero momenta and step 0, as the JAX DMP's does. A tower module
        takes a subset of its tables and keeps its interaction
        parameters. A module with UVM tables takes them as JAX's rebuilt
        UVM collection does (the tables given replace theirs; every cache,
        momentum and step starts fresh), then `uvm_momentum` {module key ->
        `uvm_momentum/<key>` of `unsharded_state_dict`}, where given, for
        an exact resume."""
        for key, dense in tables.items():
            sebc = self.sharded_ebcs[key]
            if isinstance(sebc, ShardedEmbeddingTowerCollection):
                sebc.load_tables(dense)
                continue
            sebc.shard_from_dense(dense)
            if (isinstance(sebc, UvmSplitEmbeddingBagCollection)
                    and uvm_momentum and key in uvm_momentum
                    and sebc.uvm is not None
                    and {t.name for t in sebc.uvm_tables} & set(dense)):
                sebc.uvm.load_momentum(uvm_momentum[key])

    def cache_stats(self) -> Dict[str, Dict[str, Dict[str, int]]]:
        """{module key -> {UVM table -> {"hits", "misses"}}} of the UVM
        modules this rank holds."""
        return {k: m.cache_stats() for k, m in self._uvm_modules().items()
                if m.uvm is not None}

    @torch.no_grad()
    def unsharded_state_dict(self) -> Dict[str, Any]:
        """The JAX DMP's `state_dict(state)`: {"dense": {fqn: tensor on the
        host}, "embeddings/<key>": {table: [R, D] numpy}, and
        "uvm_momentum/<key>": the UVM collection's `momentum_dict` where it
        keeps one}. Every table is unsharded, gathered to the host one at
        a time (a collective per table at world size n; the UVM tables
        flushed and broadcast from their rank), so that the whole layout
        never lands on a card. The tower interactions step inside their
        collection and are left out, as JAX keeps them out of its dense
        parameters."""
        inside = {id(p) for tc in self._towers() for p in tc.parameters()}
        out: Dict[str, Any] = {"dense": {
            n: p.detach().cpu().clone()
            for n, p in self.module.named_parameters() if id(p) not in inside}}
        for key, sebc in self.sharded_ebcs.items():
            out[f"embeddings/{key}"] = sebc.unshard_to_dense()
            if isinstance(sebc, UvmSplitEmbeddingBagCollection):
                mom = sebc.uvm_momentum_dict()
                if mom:
                    out[f"uvm_momentum/{key}"] = mom
        return out

    def forward(self, *args):
        """Eval forward of the wrapped model on the env's device."""
        return self.module(*args)

    def make_eval_fn(self) -> Callable:
        """(*args) -> model output, run under torch.inference_mode()."""

        def eval_fn(*args):
            with torch.inference_mode():
                return self.module(*args)

        return eval_fn

    def _fused_lr(self) -> float:
        if self.fused_lr_schedule is not None:
            return float(self.fused_lr_schedule(self.step))
        return float(self.learning_rate)

    def _dist_keys(self) -> Tuple[str, ...]:
        """The modules whose input dist can be computed ahead of the step:
        every sharded EBC and EC but a feature processor's, whose
        per-sample weights the step computes from live parameters (towers
        have none)."""
        return tuple(k for k, m in self.sharded_ebcs.items()
                     if k not in self._fp_ebcs and not isinstance(
                         m, (ShardedEmbeddingTowerCollection,
                             UvmSplitEmbeddingBagCollection)))

    @torch.no_grad()
    def input_dist(self, sparse) -> Dict[str, tuple]:
        """A batch's sparse input dist (a KeyedJaggedTensor or
        PaddedSparseBatch on the env's device): {module key -> one dist per
        group, None where the group gathers in the step}; modules with no
        dist are absent. Collectives: every rank calls it."""
        out = {}
        for key in self._dist_keys():
            sebc = self.sharded_ebcs[key]
            dist = sebc.input_dist(as_padded(sparse,
                                             sebc.max_feature_length))
            if any(d is not None for d in dist):
                out[key] = dist
        return out

    @staticmethod
    def _sparse_arg(args) -> Any:
        sparse = [a for a in args
                  if isinstance(a, (KeyedJaggedTensor, PaddedSparseBatch))]
        if len(sparse) != 1:
            raise ValueError("train_step takes exactly one sparse batch "
                             f"argument, got {len(sparse)}")
        return sparse[0]

    def make_prefetched_train_step(
            self, loss_fn: Optional[Callable] = None) -> Callable:
        """step(dists, next_sparse, *args) -> (loss, aux, next_dists): one
        optimizer step of `make_train_step`'s on `args`, its sparse modules
        fed `dists`, the batch's `input_dist` (prime with the first
        batch's), then the input dist of the next batch's sparse batch.
        Numerics equal `make_train_step`'s. Raises ValueError for a plan
        with FUSED_UVM_CACHING tables, as JAX's does (their step is driven
        from the host)."""
        if self._uvm_modules():
            raise ValueError(
                "prefetched train step does not support FUSED_UVM_CACHING "
                "tables (the step is host-orchestrated)")
        return self._prefetched_step(loss_fn)

    def _prefetched_step(self, loss_fn: Optional[Callable]) -> Callable:
        """make_prefetched_train_step's step without its UVM refusal: a
        UVM module has no dist and gathers in the step (SparseDistPipeline
        drives it)."""
        self._check_trainable()

        def step(dists, next_sparse, *args):
            loss, aux = self._train_step(args, dists, loss_fn)
            return loss, aux, self.input_dist(next_sparse)

        return step

    def _check_trainable(self) -> None:
        for sebc in self.sharded_ebcs.values():
            sebc.check_trainable()

    def make_train_step(self, loss_fn: Optional[Callable] = None) -> Callable:
        """train_step(*args) -> (loss, aux), one optimizer step.

        The wrapped module must return (loss, aux) (DLRMTrain-style) unless
        `loss_fn(model_output) -> (loss, aux)` is given; one of `args` is
        the sparse batch (KeyedJaggedTensor or PaddedSparseBatch). The step
        updates the dense parameters, the tables and the fused optimizer
        state in place, where the JAX step returns a new DMPState; loss and
        aux come back detached. Every EmbOptimType trains fp32, bf16 and
        fp16 tables; raises here, before any step, for a fused_params key
        or a route the port does not take (`w_impl="write"` and
        `mom_impl="xla"` on half tables). At world size n the dense
        gradients are averaged over the ranks and the sparse cotangents
        divided by n (see the module docstring).
        """
        self._check_trainable()

        def train_step(*args):
            return self._train_step(args, {}, loss_fn)

        return train_step

    def _train_step(self, args, dists: Mapping[str, tuple],
                    loss_fn: Optional[Callable]):
        """One optimizer step on `args`; a module with an entry in
        `dists` looks up and updates from it."""
        with tracing.span(TRAIN_STEP):
            return self._step(args, dists, loss_fn)

    def _step(self, args, dists: Mapping[str, tuple],
              loss_fn: Optional[Callable]):
        sparse = self._sparse_arg(args)
        lr = self._fused_lr()
        # the sharded lookups' values enter the dense model as leaves:
        # an EBC's pooled values, an EC's {name: per-token rows}
        leaves: Dict[str, Any] = {}
        # an FP-EBC's lookup runs inside autograd, differentiable in
        # the processed weights only; its update takes them detached
        batches = {key: sparse for key in self.sharded_ebcs}
        fp_pooled: Dict[str, torch.Tensor] = {}
        for key, fp_ebc in self._fp_ebcs.items():
            with tracing.span(FP_FORWARD):
                sebc = self.sharded_ebcs[key]
                sb = fp_ebc.feature_processor(
                    as_padded(sparse, sebc.max_feature_length))
                out = sebc(sb)
                fp_pooled[key] = out.values
                leaves[key] = out.values.detach().requires_grad_(True)
                fp_ebc.injected = dataclasses.replace(out,
                                                      values=leaves[key])
                batches[key] = dataclasses.replace(
                    sb, weights=sb.weights.detach())
        # the other sharded lookups outside autograd
        with torch.no_grad():
            for key, sebc in self.sharded_ebcs.items():
                if key in leaves:
                    continue
                out = sebc(sparse, dist=dists.get(key))
                if isinstance(sebc, ShardedEmbeddingTowerCollection):
                    leaves[key] = out.requires_grad_(True)
                    sebc.injected = leaves[key]
                elif isinstance(sebc, ShardedEmbeddingCollection):
                    leaves[key] = {n: t.detach().requires_grad_(True)
                                   for n, t in out.items()}
                    sebc.injected = leaves[key]
                else:
                    leaves[key] = out.values.requires_grad_(True)
                    sebc.injected = KeyedTensor(
                        values=leaves[key], keys=out.keys,
                        length_per_key=out.length_per_key)
        try:
            with tracing.span(DENSE_FORWARD):
                out = self.module(*args)
                loss, aux = out if loss_fn is None else loss_fn(out)
        finally:
            for m in (*self.sharded_ebcs.values(),
                      *self._fp_ebcs.values()):
                m.injected = None
        self.dense_optimizer.zero_grad(set_to_none=True)
        with tracing.span(BACKWARD):
            loss.backward()
        # the pooled cotangent back through K1's VJP in its coefficient
        # into the processor's parameters (with a group, on every rank: it
        # makes collectives)
        for key, pooled in fp_pooled.items():
            if leaves[key].grad is not None or self.env.group is not None:
                with tracing.span(FP_BACKWARD):
                    pooled.backward(_grad(leaves[key]))
        with tracing.span(DENSE_OPTIMIZER):
            # the JAX step differentiates every dense parameter, so one
            # the loss does not reach gets a zero gradient, on which
            # Adam still steps; torch's optimizers skip a None one
            params = self._dense_parameters()
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            # the gradient of the global batch's mean loss
            comm.all_reduce_mean(self.env, [p.grad for p in params])
            self.dense_optimizer.step()
        for key, sebc in self.sharded_ebcs.items():
            sebc.update(batches[key],
                        _scaled(_grad(leaves[key]),
                                1.0 / self.env.world_size), lr,
                        dist=dists.get(key))
        self.step += 1
        return loss.detach(), _detach(aux)
