"""Planner data model.

Counterpart of torchrec_tpu/planner/types.py. `Topology` describes the
ranks a plan places tables on: their count, the ranks per host, and one
card's memory and bandwidths, from a `DeviceSpec` (default: the H100 SXM
of planner/constants.py) and a `CostModel` (default: the H100 costs
measured in this repo). A ShardingOption is one candidate (table x
sharding type x compute kernel) with its shards; the pluggable stages
(Enumerator, Proposer, Partitioner, PerfModel, StorageReservation) keep
the JAX package's interfaces.

Given the same device numbers and cost functions, every stage computes
what the JAX package's does, in the same order of float operations, so a
plan and its per-shard `perf` and `storage` equal JAX's to the last bit.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Dict, List, Optional, Tuple

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.parallel.types import ComputeKernel, ShardingType
from torchrec_tpu_torch.planner import constants
from torchrec_tpu_torch.planner.constants import CostModel, DeviceSpec


class PlannerError(Exception):
    """No feasible plan (a device out of memory, nothing enumerated)."""


@dataclasses.dataclass
class Storage:
    """Device (HBM) and host (DDR) byte amounts."""

    hbm: int = 0
    ddr: int = 0

    def __add__(self, other: "Storage") -> "Storage":
        return Storage(self.hbm + other.hbm, self.ddr + other.ddr)

    def __sub__(self, other: "Storage") -> "Storage":
        return Storage(self.hbm - other.hbm, self.ddr - other.ddr)

    def fits_in(self, other: "Storage") -> bool:
        return self.hbm <= other.hbm and self.ddr <= other.ddr


@dataclasses.dataclass
class DeviceHardware:
    """One rank's free storage and the estimated time placed on it."""

    rank: int
    storage: Storage
    perf: float = 0.0  # accumulated wall-time estimate (seconds)


class Topology:
    """`world_size` ranks, `local_world_size` of them per host (default:
    one host), each one card of `device`'s spec, costed by `cost_model`.

    hbm_cap / ddr_cap: bytes per rank (default: the spec's);
    hbm_mem_bw, intra_bw (between the cards of a host) and inter_bw
    (across hosts): bytes/s (default: the spec's); batch_size: the
    per-rank batch the estimates assume.
    """

    def __init__(
        self,
        world_size: int,
        local_world_size: Optional[int] = None,
        hbm_cap: Optional[int] = None,
        ddr_cap: Optional[int] = None,
        hbm_mem_bw: Optional[float] = None,
        intra_bw: Optional[float] = None,
        inter_bw: Optional[float] = None,
        batch_size: int = constants.BATCH_SIZE_DEFAULT,
        device: DeviceSpec = constants.H100_SXM,
        cost_model: CostModel = constants.H100_COSTS,
    ):
        self.device = device
        self.cost_model = cost_model
        self.world_size = world_size
        self.local_world_size = local_world_size or world_size
        self.hbm_cap = hbm_cap if hbm_cap is not None else device.hbm_cap
        self.ddr_cap = ddr_cap if ddr_cap is not None else device.ddr_cap
        self.hbm_mem_bw = hbm_mem_bw or device.hbm_bw
        self.intra_bw = intra_bw or device.intra_bw
        self.inter_bw = inter_bw or device.inter_bw
        self.host_bw = device.host_bw
        self.batch_size = batch_size
        self.devices = [
            DeviceHardware(rank=r, storage=Storage(self.hbm_cap, self.ddr_cap))
            for r in range(world_size)
        ]

    @property
    def num_hosts(self) -> int:
        return self.world_size // self.local_world_size

    def __repr__(self) -> str:
        return (f"Topology({self.device.name} x{self.world_size}, "
                f"hbm={self.hbm_cap/1024**3:.0f}GiB)")


@dataclasses.dataclass
class Shard:
    """One physical shard: (rows, cols) at (row, col) offset."""

    size: Tuple[int, int]
    offset: Tuple[int, int]
    rank: Optional[int] = None
    storage: Storage = dataclasses.field(default_factory=Storage)
    perf: float = 0.0


@dataclasses.dataclass
class ShardingOption:
    """A candidate plan entry."""

    name: str
    table: EmbeddingBagConfig
    sharding_type: ShardingType
    compute_kernel: ComputeKernel
    shards: List[Shard]
    host: Optional[int] = None
    dependency: Optional[str] = None  # co-location group (a tower)

    @property
    def total_perf(self) -> float:
        return sum(s.perf for s in self.shards)

    @property
    def total_storage(self) -> Storage:
        out = Storage()
        for s in self.shards:
            out = out + s.storage
        return out

    @property
    def num_shards(self) -> int:
        return len(self.shards)

    @property
    def is_uniform(self) -> bool:
        """One shard per rank in rank order (ROW_WISE, DATA_PARALLEL)."""
        return self.sharding_type in (
            ShardingType.ROW_WISE,
            ShardingType.DATA_PARALLEL,
        )


@dataclasses.dataclass
class ParameterConstraints:
    """Per-table planner constraints. `dependency` is a co-location tag:
    tables that share one (an embedding tower's) land whole on one rank,
    so they enumerate TABLE_WISE only."""

    sharding_types: Optional[List[ShardingType]] = None
    compute_kernels: Optional[List[ComputeKernel]] = None
    min_partition: Optional[int] = None
    pooling_factors: Optional[List[float]] = None
    caching_ratio: Optional[float] = None
    dependency: Optional[str] = None


class Enumerator(abc.ABC):
    @abc.abstractmethod
    def enumerate(self, tables, constraints) -> List[ShardingOption]: ...


class Proposer(abc.ABC):
    @abc.abstractmethod
    def propose(
        self, options_by_table: Dict[str, List[ShardingOption]]
    ) -> List[List[ShardingOption]]: ...


class Partitioner(abc.ABC):
    @abc.abstractmethod
    def partition(
        self, proposal: List[ShardingOption], topology: Topology
    ) -> List[ShardingOption]: ...


class PerfModel(abc.ABC):
    @abc.abstractmethod
    def rate(self, plan: List[ShardingOption], topology: Topology) -> float: ...


class StorageReservation(abc.ABC):
    @abc.abstractmethod
    def reserve(self, topology: Topology, tables, constraints) -> Topology: ...
