"""Perf and storage estimates per shard.

Counterpart of torchrec_tpu/planner/estimators.py, with the topology's
cost model in place of JAX's accelerator constants. Wall time per shard
is input dist + compute + output dist, the collectives those of the
port's strategies (parallel/strategies.py, hierarchical_strategies.py):

  input dist:  all_gather of int32 ids within the host (every sharded type)
  compute:     FUSED: the cost model's lookup and update times; the other
               kernels: touched bytes / (HBM rate x the kernel's fraction)
  output dist: ROW_WISE a reduce_scatter of [F, B, D]; TABLE_WISE and
               COLUMN_WISE an all_to_all of pooled rows; DATA_PARALLEL an
               all_gather of the row gradients; TWRW / TWCW add the
               cross-host all_to_all

Storage per shard: the table's bytes, the rowwise optimizer state, the
input and output buffers; DATA_PARALLEL twice the table (the gradient
sync).
"""

from __future__ import annotations

from typing import Dict, Optional

from torchrec_tpu_torch.parallel.types import ComputeKernel, ShardingType
from torchrec_tpu_torch.planner import constants
from torchrec_tpu_torch.planner.types import (
    ParameterConstraints,
    ShardingOption,
    Storage,
    Topology,
)

_DTYPE_BYTES = 4  # fp32 training


def _kernel_bw(topology: Topology, kernel: ComputeKernel) -> float:
    cost = topology.cost_model
    if kernel is ComputeKernel.FUSED_UVM_CACHING:
        # the cache's hits at the device's rate, its misses over the host
        # link
        lf = constants.UVM_CACHE_LOAD_FACTOR
        hbm = topology.hbm_mem_bw * cost.fused_bw_fraction
        ddr = topology.host_bw * constants.UVM_CACHING_BW_FRACTION
        return lf * hbm + (1.0 - lf) * ddr
    frac = {
        ComputeKernel.FUSED: cost.fused_bw_fraction,
        ComputeKernel.DENSE: cost.dense_bw_fraction,
        ComputeKernel.QUANT: cost.quant_bw_fraction,
    }[kernel]
    return topology.hbm_mem_bw * frac


class EmbeddingPerfEstimator:
    def __init__(
        self,
        topology: Topology,
        constraints: Optional[Dict[str, ParameterConstraints]] = None,
    ):
        self._topology = topology
        self._constraints = constraints or {}

    def estimate(self, option: ShardingOption) -> None:
        t = self._topology
        n = t.world_size
        B = t.batch_size  # per-rank batch
        c = self._constraints.get(option.name)
        pooling = (sum(c.pooling_factors) / len(c.pooling_factors)
                   if c and c.pooling_factors
                   else constants.POOLING_FACTOR_DEFAULT)
        D = option.table.embedding_dim
        F = max(len(option.table.feature_names), 1)
        ids_bytes = F * B * n * pooling * 4  # gathered global ids, int32
        pooled_bytes = F * B * D * _DTYPE_BYTES
        bw_comm = t.intra_bw
        kernel_bw = _kernel_bw(t, option.compute_kernel)
        cost = t.cost_model

        def compute_time(rows_touched, shard_bytes, cols):
            """Lookup + update time of `rows_touched` rows of a shard of
            `shard_bytes`: the cost model's for FUSED; three passes over
            the touched bytes (forward, backward, update) otherwise."""
            if option.compute_kernel is ComputeKernel.FUSED:
                return cost.lookup_s(rows_touched) + cost.update_s(
                    rows_touched, shard_bytes)
            return 3.0 * rows_touched * cols * _DTYPE_BYTES / kernel_bw

        for shard in option.shards:
            rows, cols = shard.size
            shard_bytes = rows * cols * _DTYPE_BYTES
            st = option.sharding_type
            if st is ShardingType.DATA_PARALLEL:
                input_dist = 0.0
                compute = compute_time(F * B * pooling, shard_bytes, cols)
                # every replica's row gradients all_gathered
                output_dist = ((F * B * pooling * cols * _DTYPE_BYTES * n)
                               / bw_comm)
            elif st is ShardingType.ROW_WISE:
                input_dist = ids_bytes / bw_comm
                compute = compute_time(F * B * pooling, shard_bytes, cols)
                output_dist = pooled_bytes / bw_comm
            elif st is ShardingType.TABLE_WISE:
                input_dist = ids_bytes / bw_comm
                # the owner looks up the whole global batch
                compute = compute_time(F * B * n * pooling, shard_bytes,
                                       cols)
                output_dist = (pooled_bytes * n) / bw_comm
            elif st is ShardingType.COLUMN_WISE:
                input_dist = ids_bytes / bw_comm
                compute = compute_time(F * B * n * pooling, shard_bytes,
                                       cols)
                output_dist = pooled_bytes / bw_comm
            elif st is ShardingType.TABLE_ROW_WISE:
                Lc = t.local_world_size
                input_dist = ids_bytes / bw_comm
                compute = compute_time(F * (B * n / Lc) * pooling,
                                       shard_bytes, cols)
                output_dist = (pooled_bytes / bw_comm
                               + pooled_bytes * t.num_hosts / t.inter_bw)
            elif st is ShardingType.TABLE_COLUMN_WISE:
                input_dist = ids_bytes / bw_comm
                compute = compute_time(F * B * n * pooling, shard_bytes,
                                       cols)
                output_dist = (pooled_bytes / bw_comm
                               + pooled_bytes * t.num_hosts / t.inter_bw)
            else:
                raise NotImplementedError(st)
            # forward and backward move the same bytes; compute_time holds
            # the lookup and the update
            shard.perf = 2.0 * (input_dist + output_dist) + compute


class EmbeddingStorageEstimator:
    def __init__(
        self,
        topology: Topology,
        constraints: Optional[Dict[str, ParameterConstraints]] = None,
    ):
        self._topology = topology
        self._constraints = constraints or {}

    def estimate(self, option: ShardingOption) -> None:
        B = self._topology.batch_size
        F = max(len(option.table.feature_names), 1)
        for shard in option.shards:
            rows, cols = shard.size
            tensor = rows * cols * _DTYPE_BYTES
            optimizer = rows * _DTYPE_BYTES  # the rowwise momentum
            io_buffers = F * B * (cols + 1) * _DTYPE_BYTES * 4
            if option.sharding_type is ShardingType.DATA_PARALLEL:
                optimizer += tensor  # the replicated gradient sync
            if option.compute_kernel is ComputeKernel.FUSED_UVM_CACHING:
                # the table and its state on the host, a row cache and the
                # buffers on the device
                cache = int(tensor * constants.UVM_CACHE_LOAD_FACTOR)
                shard.storage = Storage(hbm=int(cache + io_buffers),
                                        ddr=int(tensor + optimizer))
            else:
                shard.storage = Storage(
                    hbm=int(tensor + optimizer + io_buffers), ddr=0)
