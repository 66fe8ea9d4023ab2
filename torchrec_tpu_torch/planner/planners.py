"""EmbeddingShardingPlanner.

Counterpart of torchrec_tpu/planner/planners.py. plan() = storage
reservation -> enumerator and estimators -> {proposer -> partitioner ->
perf model rating}* -> the best plan -> stats. The output is the port's
ShardingPlan, {module path: {table: ParameterSharding}}, which
DistributedModelParallel takes. Planning is deterministic, so every rank
computes the same plan and `collective_plan` is `plan`.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.parallel.types import ParameterSharding, ShardingPlan
from torchrec_tpu_torch.planner import constants
from torchrec_tpu_torch.planner.enumerators import EmbeddingEnumerator
from torchrec_tpu_torch.planner.estimators import (
    EmbeddingPerfEstimator,
    EmbeddingStorageEstimator,
)
from torchrec_tpu_torch.planner.partitioners import GreedyPerfPartitioner
from torchrec_tpu_torch.planner.proposers import (
    GreedyProposer,
    UniformProposer,
)
from torchrec_tpu_torch.planner.stats import EmbeddingStats
from torchrec_tpu_torch.planner.types import (
    ParameterConstraints,
    PlannerError,
    ShardingOption,
    StorageReservation,
    Topology,
)


class HeuristicalStorageReservation(StorageReservation):
    """Keep a share of each card's memory for the dense parameters and
    activations before placing tables."""

    def __init__(self, percentage: float = constants.STORAGE_RESERVE_PERCENT):
        self._pct = percentage

    def reserve(self, topology: Topology, tables, constraints) -> Topology:
        return Topology(
            world_size=topology.world_size,
            local_world_size=topology.local_world_size,
            hbm_cap=int(topology.hbm_cap * (1 - self._pct)),
            ddr_cap=topology.ddr_cap,
            batch_size=topology.batch_size,
            device=topology.device,
            cost_model=topology.cost_model,
        )


class NoopPerfModel:
    """A plan's rating: the largest estimated time placed on one rank."""

    def rate(self, plan: List[ShardingOption], topology: Topology) -> float:
        per_dev = [0.0] * topology.world_size
        for opt in plan:
            for s in opt.shards:
                if s.rank is not None:
                    per_dev[s.rank] += s.perf
        return max(per_dev) if per_dev else 0.0


class EmbeddingShardingPlanner:
    def __init__(
        self,
        topology: Topology,
        constraints: Optional[Dict[str, ParameterConstraints]] = None,
        enumerator=None,
        proposers=None,
        partitioner=None,
        perf_model=None,
        storage_reservation=None,
        stats=None,
    ):
        self._topology = topology
        self._constraints = constraints or {}
        self._enumerator = enumerator or EmbeddingEnumerator(topology)
        self._proposers = proposers or [GreedyProposer(), UniformProposer()]
        self._partitioner = partitioner or GreedyPerfPartitioner()
        self._perf_model = perf_model or NoopPerfModel()
        self._storage_reservation = (storage_reservation
                                     or HeuristicalStorageReservation())
        self._stats = stats or EmbeddingStats()
        self._perf_estimator = EmbeddingPerfEstimator(topology,
                                                      self._constraints)
        self._storage_estimator = EmbeddingStorageEstimator(
            topology, self._constraints)
        self.last_stats: Optional[str] = None
        # the best plan's options, with their shards' ranks, perf and
        # storage
        self.last_plan: Optional[List[ShardingOption]] = None

    def plan(
        self,
        tables: Sequence[EmbeddingBagConfig],
        module_path: str = "",
    ) -> ShardingPlan:
        topology = self._storage_reservation.reserve(
            self._topology, tables, self._constraints)
        options = self._enumerator.enumerate(tables, self._constraints)
        if not options:
            raise PlannerError("no sharding options enumerated")
        for opt in options:
            self._perf_estimator.estimate(opt)
            self._storage_estimator.estimate(opt)

        by_table: Dict[str, List[ShardingOption]] = {}
        for opt in options:
            by_table.setdefault(opt.name, []).append(opt)

        best_plan = None
        best_rating = math.inf
        last_error: Optional[Exception] = None
        for proposer in self._proposers:
            for proposal in proposer.propose(by_table):
                try:
                    partitioned = self._partitioner.partition(proposal,
                                                              topology)
                except PlannerError as e:
                    last_error = e
                    continue
                rating = self._perf_model.rate(partitioned, topology)
                if rating < best_rating:
                    best_rating = rating
                    best_plan = partitioned
        if best_plan is None:
            raise PlannerError(
                f"unable to find a feasible sharding plan: {last_error}")
        self.last_stats = self._stats.log(best_plan, topology, best_rating)
        self.last_plan = best_plan
        return self._to_sharding_plan(best_plan, module_path)

    def collective_plan(self, tables, module_path: str = "") -> ShardingPlan:
        """`plan`: every rank computes the same plan, so nothing is
        broadcast."""
        return self.plan(tables, module_path=module_path)

    def _to_sharding_plan(self, plan: List[ShardingOption],
                          module_path: str) -> ShardingPlan:
        entries: Dict[str, ParameterSharding] = {}
        for opt in plan:
            ranks = [s.rank for s in opt.shards if s.rank is not None]
            entries[opt.name] = ParameterSharding(
                sharding_type=opt.sharding_type,
                compute_kernel=opt.compute_kernel,
                ranks=ranks,
                host=opt.host,
            )
        return ShardingPlan({module_path: entries})
