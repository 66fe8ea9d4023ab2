"""Sharding-option enumeration.

Counterpart of torchrec_tpu/planner/enumerators.py. For each table x
allowed sharding type x compute kernel, one ShardingOption with concrete
shard sizes and offsets, in the geometry of the port's strategies
(parallel/strategies.py, parallel/hierarchical_strategies.py):

* ROW_WISE: blocks of ceil(rows / world), the last one short;
* COLUMN_WISE: the columns split evenly over all ranks (dim % world == 0,
  each piece >= min_partition);
* TABLE_WISE: one shard, its rank chosen by the partitioner;
* DATA_PARALLEL: one replica per rank;
* TABLE_ROW_WISE / TABLE_COLUMN_WISE: rows or columns over a host's local
  ranks, enumerated only on more than one host.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.parallel.types import ComputeKernel, ShardingType
from torchrec_tpu_torch.planner import constants
from torchrec_tpu_torch.planner.types import (
    Enumerator,
    ParameterConstraints,
    Shard,
    ShardingOption,
    Topology,
)

DEFAULT_SHARDING_TYPES = [
    ShardingType.DATA_PARALLEL,
    ShardingType.TABLE_WISE,
    ShardingType.ROW_WISE,
    ShardingType.COLUMN_WISE,
    ShardingType.TABLE_ROW_WISE,
    ShardingType.TABLE_COLUMN_WISE,
]
# FUSED first; the UVM-caching kernel is offered only for a table too
# large for one card (see `enumerate`)
DEFAULT_KERNELS = [ComputeKernel.FUSED, ComputeKernel.FUSED_UVM_CACHING]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class EmbeddingEnumerator(Enumerator):
    def __init__(
        self,
        topology: Topology,
        sharding_types: Optional[Sequence[ShardingType]] = None,
        compute_kernels: Optional[Sequence[ComputeKernel]] = None,
    ):
        self._topology = topology
        self._sharding_types = list(sharding_types or DEFAULT_SHARDING_TYPES)
        self._kernels = list(compute_kernels or DEFAULT_KERNELS)

    def _shards_for(
        self,
        table: EmbeddingBagConfig,
        st: ShardingType,
        min_partition: int,
    ) -> Optional[List[Shard]]:
        n = self._topology.world_size
        R, D = table.num_embeddings, table.embedding_dim
        if st is ShardingType.TABLE_WISE:
            return [Shard(size=(R, D), offset=(0, 0))]
        if st is ShardingType.DATA_PARALLEL:
            return [Shard(size=(R, D), offset=(0, 0), rank=r)
                    for r in range(n)]
        if st is ShardingType.ROW_WISE:
            block = _cdiv(R, n)
            return [Shard(size=(min(block, max(R - r * block, 0)), D),
                          offset=(r * block, 0), rank=r)
                    for r in range(n)]
        if st is ShardingType.COLUMN_WISE:
            if D % n != 0 or D // n < min_partition:
                return None
            piece = D // n
            return [Shard(size=(R, piece), offset=(0, r * piece), rank=r)
                    for r in range(n)]
        Lc = self._topology.local_world_size
        if st is ShardingType.TABLE_ROW_WISE:
            if self._topology.num_hosts < 2:
                return None
            block = _cdiv(R, Lc)
            return [Shard(size=(min(block, max(R - l * block, 0)), D),
                          offset=(l * block, 0))
                    for l in range(Lc)]
        if st is ShardingType.TABLE_COLUMN_WISE:
            if self._topology.num_hosts < 2:
                return None
            if D % Lc != 0 or D // Lc < min_partition:
                return None
            piece = D // Lc
            return [Shard(size=(R, piece), offset=(0, l * piece))
                    for l in range(Lc)]
        return None

    def enumerate(
        self,
        tables: Sequence[EmbeddingBagConfig],
        constraints: Optional[Dict[str, ParameterConstraints]] = None,
    ) -> List[ShardingOption]:
        constraints = constraints or {}
        out: List[ShardingOption] = []
        for table in tables:
            c = constraints.get(table.name)
            dependency = c.dependency if c else None
            stypes = (c.sharding_types if c and c.sharding_types
                      else self._sharding_types)
            if dependency is not None:
                # co-located (tower) tables: whole tables on one rank
                stypes = [ShardingType.TABLE_WISE]
            kernels = (c.compute_kernels if c and c.compute_kernels
                       else self._kernels)
            min_partition = (c.min_partition if c and c.min_partition
                             else constants.MIN_CW_DIM)
            # the UVM kernel is an option only for a table whose fp32
            # footprint cannot fit one card's memory
            tensor_bytes = table.num_embeddings * table.embedding_dim * 4
            needs_uvm = tensor_bytes > 0.8 * self._topology.hbm_cap
            for st in stypes:
                shards = self._shards_for(table, st, min_partition)
                if shards is None:
                    continue
                for kernel in kernels:
                    if (kernel is ComputeKernel.FUSED_UVM_CACHING
                            and not needs_uvm):
                        continue
                    out.append(ShardingOption(
                        name=table.name,
                        table=table,
                        sharding_type=st,
                        compute_kernel=kernel,
                        shards=[Shard(s.size, s.offset, s.rank)
                                for s in shards],
                        dependency=dependency,
                    ))
        return out
