"""DistributedModelParallel: the model-parallel engine, serving half.

Counterpart of torchrec_tpu/parallel/dmp.py for models whose sparse part is
EmbeddingBagCollections. The JAX DMP swaps each EBC for a parameter-less
stub and injects the sharded lookup's output through a flax collection;
here the ShardedEmbeddingBagCollection simply replaces the authored
EmbeddingBagCollection submodule, which is the torch form of the same
swap. Plans are keyed by the EBC's module path joined with "/" (for the
port's DLRMTrain: "dlrm/sparse_arch/embedding_bag_collection").

The DMP takes the authored module's structure, not its values: the dense
modules are re-allocated on the env's device with `to_empty`, so build
the model on `device="meta"` and call `init(seed)` or load weights
(utils/jax_bridge.py) before the first forward.

Not ported yet: the train step and its fused optimizers (the next slice;
`fused_optim` and `fused_params` are stored for it), the planner (a plan
must be given), and embedding towers, EmbeddingCollections, UVM-cached
tables and feature processors, whose modules the port does not have.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
)
from torchrec_tpu_torch.modules.mlp import Perceptron
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel.sharded_ebc import (
    ShardedEmbeddingBagCollection,
)
from torchrec_tpu_torch.parallel.strategies import ArrayLike
from torchrec_tpu_torch.parallel.types import ShardingEnv, ShardingPlan
from torchrec_tpu_torch.utils.device import DeviceLike


def _set_submodule(root: nn.Module, path: str, new: nn.Module) -> None:
    parent, _, leaf = path.rpartition(".")
    setattr(root.get_submodule(parent) if parent else root, leaf, new)


class DistributedModelParallel(nn.Module):
    """Wraps an authored model, shards its EmbeddingBagCollections per the
    plan and serves it on the env's device.

    env: where to run (default: ShardingEnv(device), and `device` defaults
    to the current CUDA card). plan: ShardingPlan with an entry for every
    EBC. fused_optim / fused_params: the embedding optimizer of the
    training slice, stored as given until that slice reads them.
    """

    def __init__(
        self,
        module: nn.Module,
        env: Optional[ShardingEnv] = None,
        plan: Optional[ShardingPlan] = None,
        fused_optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
        fused_params: Optional[dict] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.env = env or ShardingEnv(device)
        ebcs = {name: m for name, m in module.named_modules()
                if isinstance(m, EmbeddingBagCollection)}
        if not ebcs:
            raise ValueError("no EmbeddingBagCollection found in module")
        if plan is None:
            raise NotImplementedError(
                "the sharding planner is not ported yet: pass a ShardingPlan"
            )
        covered = {id(p) for m in module.modules()
                   if isinstance(m, (Perceptron, EmbeddingBagCollection))
                   for p in m.parameters()}
        if any(id(p) not in covered for p in module.parameters()):
            raise NotImplementedError(
                "only dense modules built from Perceptron are ported; "
                "init() could not initialise the others"
            )
        self.fused_optim = fused_optim
        self.fused_params = dict(fused_params or {})

        sharded: Dict[str, ShardedEmbeddingBagCollection] = {}
        for name, ebc in ebcs.items():
            key = name.replace(".", "/")
            module_plan = plan.get_plan_for_module(key)
            if module_plan is None:
                raise ValueError(f"the plan has no entry for module {key!r}")
            sharded[key] = ShardedEmbeddingBagCollection(
                self.env, ebc.tables, module_plan,
                is_weighted=ebc.is_weighted,
                max_feature_length=ebc.max_feature_length,
            )
            # drop the unsharded tables before the dense part is allocated
            _set_submodule(module, name, nn.Identity())
        module.to_empty(device=self.env.device)
        for key, sebc in sharded.items():
            _set_submodule(module, key.replace("/", "."), sebc)
        self.module = module
        self.sharded_ebcs = sharded

    @torch.no_grad()
    def init(self, seed: int = 0) -> "DistributedModelParallel":
        """Draw every dense parameter and table from one generator seeded
        with `seed` on the env's device."""
        g = torch.Generator(device=self.env.device).manual_seed(seed)
        for m in self.module.modules():
            if isinstance(m, Perceptron):
                m.reset_parameters(g)
        for sebc in self.sharded_ebcs.values():
            sebc.init(g)
        return self

    def load_tables(
        self, tables: Mapping[str, Mapping[str, ArrayLike]]
    ) -> None:
        """Load unsharded per-table weights: {module key -> {table ->
        [R, D] array}}."""
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
