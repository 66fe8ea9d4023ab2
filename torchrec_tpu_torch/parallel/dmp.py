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
numerics (parallel/train_pipeline.SparseDistPipeline drives it). Not
ported yet: the planner (a plan must be given), embedding towers and
UVM-cached tables (an FP-EBC's too).
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple

import torch
from torch import nn
from torch.profiler import record_function

from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
    EmbeddingCollection,
    as_padded,
)
from torchrec_tpu_torch.modules.feature_processor import (
    FeatureProcessedEmbeddingBagCollection,
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
from torchrec_tpu_torch.parallel.strategies import ArrayLike
from torchrec_tpu_torch.parallel.types import ShardingEnv, ShardingPlan
from torchrec_tpu_torch.sparse.jagged import (
    KeyedJaggedTensor,
    KeyedTensor,
    PaddedSparseBatch,
)
from torchrec_tpu_torch.utils.device import DeviceLike

def _replace_module(root: nn.Module, old: nn.Module, new: nn.Module) -> None:
    """Put `new` wherever a module of `root` holds `old` as a child."""
    for m in list(root.modules()):
        for name, child in list(m.named_children()):
            if child is old:
                setattr(m, name, new)


def _seeded_reset(m: nn.Module) -> Optional[Callable]:
    """m.reset_parameters when it takes a `generator`, else None."""
    reset = getattr(m, "reset_parameters", None)
    if reset is None or "generator" not in inspect.signature(
            reset).parameters:
        return None
    return reset


def _drawn_by(m: nn.Module) -> List[nn.Parameter]:
    """The parameters a module's seeded reset_parameters draws: its own and
    those of the descendants that have no seeded reset of their own (a
    Perceptron's nn.Linear)."""
    out = list(m.parameters(recurse=False))
    for child in m.children():
        if _seeded_reset(child) is None:
            out.extend(_drawn_by(child))
    return out


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
    EmbeddingCollections and FeatureProcessedEmbeddingBagCollections per
    the plan, and serves and trains it on the env's device.

    env: where to run (default: ShardingEnv(device), and `device` defaults
    to the current CUDA card). plan: ShardingPlan with an entry for every
    EBC, EC and FP-EBC. fused_optim: the embedding tables' fused optimizer.
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
    the JAX DMP merges them.
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
        # module path -> EBC, EC or FP-EBC; named_modules lists an FP-EBC
        # before the EBC it wraps, which is sharded as part of it
        found: Dict[str, nn.Module] = {}
        wrapped = set()
        for name, m in module.named_modules():
            if isinstance(m, FeatureProcessedEmbeddingBagCollection):
                found[name] = m
                wrapped.add(id(m.embedding_bag_collection))
            elif (isinstance(m, (EmbeddingBagCollection, EmbeddingCollection))
                  and id(m) not in wrapped):
                found[name] = m
        if not found:
            raise ValueError("no EmbeddingBagCollection or "
                             "EmbeddingCollection found in module")
        if plan is None:
            raise NotImplementedError(
                "the sharding planner is not ported yet: pass a ShardingPlan"
            )
        self.fused_optim = fused_optim
        # the sharders' fused_params under the explicit ones; without the
        # planner (ROADMAP queue 1 item 9), which would plan within the
        # sharding types a sharder declares, they do nothing else
        merged: dict = {}
        for sh in sharders or ():
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
        for name, mod in found.items():
            key = name.replace(".", "/")
            module_plan = plan.get_plan_for_module(key)
            if module_plan is None:
                raise ValueError(f"the plan has no entry for module {key!r}")
            if isinstance(mod, FeatureProcessedEmbeddingBagCollection):
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
                sharded[key] = ShardedEmbeddingBagCollection(
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
        self.dense_optimizer = (dense_optimizer or self._default_dense_opt)(
            list(module.parameters()))
        # train steps taken: the fused lr_schedule's argument
        self.step = 0

    def _default_dense_opt(self, params) -> torch.optim.Optimizer:
        return torch.optim.SGD(params, lr=self.learning_rate)

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
        drawn = set()
        for m in self.module.modules():
            reset = _seeded_reset(m)
            if reset is not None:
                reset(generator=g)
                drawn.update(id(p) for p in _drawn_by(m))
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

    def load_tables(
        self, tables: Mapping[str, Mapping[str, ArrayLike]]
    ) -> None:
        """Load unsharded per-table weights: {module key -> {table ->
        [R, D] array}}. The loaded modules' fused optimizer state restarts
        at zero momenta and step 0, as the JAX DMP's does."""
        for key, dense in tables.items():
            self.sharded_ebcs[key].shard_from_dense(dense)

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
        per-sample weights the step computes from live parameters."""
        return tuple(k for k in self.sharded_ebcs if k not in self._fp_ebcs)

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
        Numerics equal `make_train_step`'s."""
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
        sparse = self._sparse_arg(args)
        lr = self._fused_lr()
        # the sharded lookups' values enter the dense model as leaves:
        # an EBC's pooled values, an EC's {name: per-token rows}
        leaves: Dict[str, Any] = {}
        # an FP-EBC's lookup runs inside autograd, differentiable in
        # the processed weights only; its update takes them detached
        batches = {key: sparse for key in self.sharded_ebcs}
        fp_pooled: Dict[str, torch.Tensor] = {}
        with record_function("## train_feature_processor ##"):
            for key, fp_ebc in self._fp_ebcs.items():
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
                if isinstance(sebc, ShardedEmbeddingCollection):
                    leaves[key] = {n: t.detach().requires_grad_(True)
                                   for n, t in out.items()}
                    sebc.injected = leaves[key]
                else:
                    leaves[key] = out.values.requires_grad_(True)
                    sebc.injected = KeyedTensor(
                        values=leaves[key], keys=out.keys,
                        length_per_key=out.length_per_key)
        try:
            with record_function("## train_dense_forward ##"):
                out = self.module(*args)
                loss, aux = out if loss_fn is None else loss_fn(out)
        finally:
            for m in (*self.sharded_ebcs.values(),
                      *self._fp_ebcs.values()):
                m.injected = None
        self.dense_optimizer.zero_grad(set_to_none=True)
        with record_function("## train_backward ##"):
            loss.backward()
        with record_function("## train_fp_backward ##"):
            # the pooled cotangent back through K1's VJP in its
            # coefficient into the processor's parameters (with a group,
            # on every rank: it makes collectives)
            for key, pooled in fp_pooled.items():
                if (leaves[key].grad is not None
                        or self.env.group is not None):
                    pooled.backward(_grad(leaves[key]))
        with record_function("## train_dense_optimizer ##"):
            # the JAX step differentiates every dense parameter, so one
            # the loss does not reach gets a zero gradient, on which
            # Adam still steps; torch's optimizers skip a None one
            params = list(self.module.parameters())
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
