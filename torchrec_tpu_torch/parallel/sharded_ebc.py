"""ShardedEmbeddingBagCollection, and the state handling it shares with
ShardedEmbeddingCollection (parallel/sharded_ec.py).

Counterpart of torchrec_tpu/parallel/sharded_ebc.py. Groups the tables by
sharding type into one strategy each, hands each strategy its group's
features and assembles the group outputs into one KeyedTensor in the
unsharded module's feature order. Groups of different strategies run
their own forward and update, each with its own collectives. At world
size n a rank feeds its slice of the global batch, B_loc rows, and gets
the pooled values of that slice, [B_loc, sum(D)], as JAX's
`out_specs=P(None, AXIS)` gives device r its block. Where the JAX module is functional over
a tuple of group states, this one is an `nn.Module` whose strategies hold
their shards and fused optimizer state as buffers; `init`,
`shard_from_dense`, `unshard_to_dense` and `update` keep the JAX names, and
`update` changes the buffers in place.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    SparseInput,
    as_padded,
    embedding_names_by_table,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel.embedding_sharding import (
    GroupedInputDistMixin,
    group_tables,
)
from torchrec_tpu_torch.parallel.strategies import (
    ROUTE_SPAN,
    ArrayLike,
    EmbeddingGroupState,
    JaggedRoute,
    create_sharding_strategy,
)
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingEnv
from torchrec_tpu_torch.sparse.jagged import KeyedJaggedTensor, KeyedTensor
from torchrec_tpu_torch.utils import tracing

# spans (utils/tracing.py) around the forward's concatenation of the groups'
# pooled values (and the quantized EBC's copy of its output) and the
# update's stacking of each group's cotangent slices, outside the groups'
# own `## ebc_fwd_* ##` / `## ebc_update_* ##` spans
OUTPUT_SPAN = "## ebc_output ##"
COTANGENT_SPAN = "## ebc_cotangent ##"


def group_spans(kind: str, groups: Sequence) -> Tuple[str, ...]:
    """`## <kind>_<sharding type>_g<i> ##` for each group i."""
    return tuple(f"## {kind}_{g.sharding_type.value}_g{i} ##"
                 for i, g in enumerate(groups))


class ShardedEmbeddingModule(GroupedInputDistMixin, nn.Module):
    """What the sharded EBC and EC share: the table groups, one strategy
    module per group (`strategies`, holding the shards and the fused
    optimizer state as buffers) and the state in and out. Subclasses set
    `groups` and `strategies` and define `forward` and `update`.

    `injected`: while set, `forward` returns it instead of looking up; the
    DMP's train step sets it to the values it computed outside autograd
    (the torch form of the JAX DMP's injected collection).
    """

    def __init__(self, env: ShardingEnv, tables: Sequence,
                 max_feature_length: int):
        super().__init__()
        self.env = env
        self.tables = tuple(tables)
        self.max_feature_length = max_feature_length
        self.injected = None

    @property
    def states(self) -> Tuple[EmbeddingGroupState, ...]:
        return tuple(EmbeddingGroupState(weights=s.weights, opt=s.opt)
                     for s in self.strategies)

    @torch.no_grad()
    def init(
        self, generator: Optional[torch.Generator] = None
    ) -> Tuple[EmbeddingGroupState, ...]:
        """Draw every table afresh (see BaseEmbeddingShardingStrategy
        .init_weights) and zero the optimizer state. Each group's old block
        is dropped before its new one is drawn, so that a card holds one
        block of a table set, not two."""
        for s in self.strategies:
            s.weights = s.weights.new_empty((0,))
            s.weights = s.init_weights(generator)
            s.reset_opt()
        return self.states

    @torch.no_grad()
    def shard_from_dense(
        self, dense: Mapping[str, ArrayLike]
    ) -> Tuple[EmbeddingGroupState, ...]:
        """Load unsharded per-table [R, D] weights into the shards and
        zero the fused optimizer state, as the JAX module builds every
        group with a fresh `init_opt()`. The old block is dropped first,
        as in `init`."""
        for s in self.strategies:
            s.weights = s.weights.new_empty((0,))
            s.weights = s.shard_from_dense(dense)
            s.reset_opt()
        return self.states

    def unshard_to_dense(
        self, states: Optional[Sequence[EmbeddingGroupState]] = None
    ) -> Dict[str, np.ndarray]:
        """Per-table [R, D] numpy arrays from `states` (default: the
        module's own)."""
        states = self.states if states is None else states
        out: Dict[str, np.ndarray] = {}
        for s, st in zip(self.strategies, states):
            out.update(s.unshard_to_dense(st.weights))
        return out

    def unshard_tables(self) -> Dict[str, torch.Tensor]:
        """Per-table [R, D] tensors of the module's own weights, on its
        device (views of the shards where the layout allows)."""
        out: Dict[str, torch.Tensor] = {}
        for s in self.strategies:
            out.update(s.unshard_tensors(s.weights))
        return out

    def unshard_opt_to_tables(self) -> Dict[str, Dict[str, np.ndarray]]:
        """Every table's fused optimizer state: {table: {"m1__full" |
        "m1__row", "m2__...", "step"}}, the JAX strategies' canonical
        form (see BaseEmbeddingShardingStrategy.unshard_opt_to_tables)."""
        out: Dict[str, Dict[str, np.ndarray]] = {}
        for s in self.strategies:
            out.update(s.unshard_opt_to_tables())
        return out

    def shard_opt_from_tables(
        self, per_table: Mapping[str, Mapping[str, ArrayLike]]
    ) -> None:
        """Load every group's fused optimizer state from that form."""
        for s in self.strategies:
            s.shard_opt_from_tables(per_table)

    def check_trainable(self) -> None:
        for s in self.strategies:
            s.check_trainable()


class ShardedEmbeddingBagCollection(ShardedEmbeddingModule):
    """Sharded EBC: the groups' strategies and the routing between the
    sparse batch, the groups and the output order.

    max_feature_length: the most values a bag of a KeyedJaggedTensor
    input takes (its first ones), as the unsharded module it replaces pads
    such an input to that L. optim / optim_kwargs: the fused optimizer of
    every group and its fused_params. `injected` holds a KeyedTensor.

    Which route a group's lookup and update take, in this order:
      * the group's entry of `dist` where one is given (the prefetched
        step's input dist of a RW, TW or CW group);
      * the jagged route where the input is a KeyedJaggedTensor and the
        group's strategy takes one (`supports_jagged`: DATA_PARALLEL
        without a process group): the forward is K1j over the real values
        and the update forms one row gradient a real value, so no
        [F, B, L] ids and no [F, B, L, D] gradient are built; the route
        (offsets, each value's bag and row) is built once a batch, and the
        update of the batch the forward took reuses it;
      * the padded route otherwise: a PaddedSparseBatch as it comes, a
        KeyedJaggedTensor padded to max_feature_length on the device
        (once a call, for every group that takes this route), K1 over the
        [F, B, L] slots and the update over all of them.
    Both routes pool and update alike: the jagged one takes a bag's first
    max_feature_length values and their coefficients as the padded one
    does.
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
        super().__init__(env, tables, max_feature_length)
        self.is_weighted = is_weighted
        enames_per_table = embedding_names_by_table(self.tables)
        self.groups = group_tables(self.tables, enames_per_table, plan,
                                   is_weighted)
        self.strategies = nn.ModuleList(
            create_sharding_strategy(env, g, optim, optim_kwargs)
            for g in self.groups
        )
        # canonical output order: tables in declaration order
        self.embedding_names: Tuple[str, ...] = tuple(
            n for names in enames_per_table for n in names)
        dim_by_name = {n: cfg.embedding_dim
                       for cfg, names in zip(self.tables, enames_per_table)
                       for n in names}
        self.length_per_key: Tuple[int, ...] = tuple(
            dim_by_name[n] for n in self.embedding_names)
        offsets = np.concatenate([[0], np.cumsum(self.length_per_key)])
        self._out_slice = {n: (int(offsets[i]), int(offsets[i + 1]))
                           for i, n in enumerate(self.embedding_names)}
        self._fwd_spans = group_spans("ebc_fwd", self.groups)
        self._update_spans = group_spans("ebc_update", self.groups)
        # the last jagged batch and its groups' routes (_jagged_route)
        self._routes: Tuple[Optional[KeyedJaggedTensor],
                            Dict[int, JaggedRoute]] = (None, {})

    # -- compute -------------------------------------------------------------

    def _padded(self, features: Optional[SparseInput]):
        """The batch padded to max_feature_length (a jagged one converted
        on the device) under the lookup route's span."""
        if features is None:
            return None
        with tracing.span(ROUTE_SPAN):
            return as_padded(features, self.max_feature_length)

    def _group_inputs(self, features: Optional[SparseInput],
                      dist: Optional[Sequence]) -> List[Tuple[str, object]]:
        """Each group's input and its route: ("dist", its input dist),
        ("jagged", the group's index; `_jagged_route` builds its route) or
        ("padded", the group's features of the padded batch), by the rule
        in the class docstring. The batch is padded once, and only where a
        group takes the padded route."""
        jagged = isinstance(features, KeyedJaggedTensor)
        sb = None
        out = []
        for gi, strat in enumerate(self.strategies):
            if dist is not None and dist[gi] is not None:
                out.append(("dist", dist[gi]))
            elif jagged and strat.supports_jagged:
                out.append(("jagged", gi))
            else:
                if sb is None:
                    sb = self._padded(features)
                out.append(("padded", self._group_batch(sb, gi)))
        return out

    def _jagged_route(self, kjt: KeyedJaggedTensor, gi: int) -> JaggedRoute:
        """Group gi's route for the jagged batch `kjt`, built once a batch:
        `update` takes the one `forward` built for the same batch object
        (held until another batch comes), so the route's device work runs
        once a step. The group's features are the batch itself where that
        is all of it, in order, and a permutation on the device otherwise."""
        batch, routes = self._routes
        if batch is not kjt:
            batch, routes = kjt, {}
            self._routes = (batch, routes)
        if gi not in routes:
            key_index = {k: i for i, k in enumerate(kjt.keys)}
            idx = [key_index[f] for f in self.groups[gi].features]
            if idx != list(range(len(kjt.keys))):
                with tracing.span(ROUTE_SPAN):
                    kjt = kjt.permute(idx)
            routes[gi] = self.strategies[gi].jagged_route(
                kjt, self.max_feature_length)
        return routes[gi]

    def forward(self, features: Optional[SparseInput],
                dist: Optional[Sequence] = None) -> KeyedTensor:
        """-> KeyedTensor [B, sum(D)]. `dist`: the batch's `input_dist`;
        a group with one looks up from it, the others from `features`
        (which may be None when every group has a dist)."""
        if self.injected is not None:
            return self.injected
        per_name: Dict[str, torch.Tensor] = {}
        inputs = self._group_inputs(features, dist)
        for gi, (strat, group, (route, x)) in enumerate(zip(
                self.strategies, self.groups, inputs)):
            with tracing.span(self._fwd_spans[gi]):
                if route == "dist":
                    out = strat.forward_from_dist(x)
                elif route == "jagged":
                    out = strat.forward_jagged(
                        self._jagged_route(features, x))
                else:
                    out = strat(x)  # [F_g, B, D_g]
            for j, ename in enumerate(group.embedding_names):
                per_name[ename] = out[j]
        with tracing.span(OUTPUT_SPAN):
            values = torch.cat([per_name[n] for n in self.embedding_names],
                               dim=1)
        return KeyedTensor(values=values, keys=self.embedding_names,
                           length_per_key=self.length_per_key)

    @torch.no_grad()
    def update(self, features: Optional[SparseInput], d_values: torch.Tensor,
               learning_rate: float, dist: Optional[Sequence] = None
               ) -> Tuple[EmbeddingGroupState, ...]:
        """Fused optimizer step, in place, from the cotangent of the
        forward's KeyedTensor.values [B, sum(D)]: each group gets its
        features' [F_g, B, D_g] slices by embedding name, and its input by
        the forward's rule."""
        inputs = self._group_inputs(features, dist)
        for gi, (strat, group, (route, x)) in enumerate(zip(
                self.strategies, self.groups, inputs)):
            with tracing.span(COTANGENT_SPAN):
                d_pooled = torch.stack([
                    d_values[:, slice(*self._out_slice[n])]
                    for n in group.embedding_names])
            with tracing.span(self._update_spans[gi]):
                if route == "dist":
                    strat.update_from_dist(x, d_pooled, learning_rate)
                elif route == "jagged":
                    strat.update_jagged(self._jagged_route(features, x),
                                        d_pooled, learning_rate)
                else:
                    strat.update(x, d_pooled, learning_rate)
        return self.states


class ShardedFeatureProcessedEmbeddingBagCollection(nn.Module):
    """What a FeatureProcessedEmbeddingBagCollection becomes under the
    DMP: its processor, still a dense module, before the weighted
    ShardedEmbeddingBagCollection that replaced its EBC. The attribute
    names are the unsharded module's, so the parameter names stay.

    `injected`: while set, `forward` returns it; the DMP's train step
    sets it to the pooled values it computed before the dense forward.
    """

    def __init__(self, embedding_bag_collection: nn.Module,
                 feature_processor: nn.Module):
        super().__init__()
        self.embedding_bag_collection = embedding_bag_collection
        self.feature_processor = feature_processor
        self.injected = None

    def forward(self, features: SparseInput) -> KeyedTensor:
        if self.injected is not None:
            return self.injected
        sebc = self.embedding_bag_collection
        return sebc(self.feature_processor(
            as_padded(features, sebc.max_feature_length)))
