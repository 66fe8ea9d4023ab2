"""Greedy perf-balancing partitioner.

Counterpart of torchrec_tpu/planner/partitioners.py. Uniform options
(ROW_WISE, DATA_PARALLEL, COLUMN_WISE) place one shard per rank; host
options (TABLE_ROW_WISE, TABLE_COLUMN_WISE), biggest first, go onto the
least-loaded host that holds them; the rest (TABLE_WISE), grouped by
dependency tag (an embedding tower's tables travel together), biggest
group first onto the least-loaded rank that holds the whole group. Raises
PlannerError when nothing holds a shard.
"""

from __future__ import annotations

import copy
from typing import List

from torchrec_tpu_torch.parallel.types import ShardingType
from torchrec_tpu_torch.planner.types import (
    Partitioner,
    PlannerError,
    ShardingOption,
    Storage,
    Topology,
)


class GreedyPerfPartitioner(Partitioner):
    def partition(
        self, proposal: List[ShardingOption], topology: Topology
    ) -> List[ShardingOption]:
        devices = [
            type(d)(rank=d.rank, storage=Storage(d.storage.hbm, d.storage.ddr))
            for d in topology.devices
        ]

        def place(shard, rank):
            dev = devices[rank]
            if not shard.storage.fits_in(dev.storage):
                raise PlannerError(
                    f"device {rank} out of memory placing shard "
                    f"(needs {shard.storage.hbm/1024**2:.0f}MiB HBM, has "
                    f"{dev.storage.hbm/1024**2:.0f}MiB)")
            dev.storage = dev.storage - shard.storage
            dev.perf += shard.perf
            shard.rank = rank

        plan = copy.deepcopy(proposal)
        tw_options = []
        host_options = []
        for opt in plan:
            if opt.sharding_type in (ShardingType.ROW_WISE,
                                     ShardingType.DATA_PARALLEL,
                                     ShardingType.COLUMN_WISE):
                if len(opt.shards) != topology.world_size:
                    raise PlannerError(
                        f"{opt.name}: uniform option has {len(opt.shards)} "
                        f"shards for world {topology.world_size}")
                for r, shard in enumerate(opt.shards):
                    place(shard, r)
            elif opt.sharding_type in (ShardingType.TABLE_ROW_WISE,
                                       ShardingType.TABLE_COLUMN_WISE):
                host_options.append(opt)
            else:
                tw_options.append(opt)

        Lc = topology.local_world_size
        n_hosts = topology.world_size // Lc
        host_options.sort(key=lambda o: o.total_storage.hbm, reverse=True)
        for opt in host_options:
            if len(opt.shards) != Lc:
                raise PlannerError(
                    f"{opt.name}: host option has {len(opt.shards)} shards "
                    f"for local size {Lc}")
            ranked_hosts = sorted(
                range(n_hosts),
                key=lambda h: sum(devices[h * Lc + l].perf
                                  for l in range(Lc)))
            placed_host = None
            for h in ranked_hosts:
                if all(s.storage.fits_in(devices[h * Lc + l].storage)
                       for l, s in enumerate(opt.shards)):
                    for l, s in enumerate(opt.shards):
                        place(s, h * Lc + l)
                    placed_host = h
                    break
            if placed_host is None:
                raise PlannerError(
                    f"no host can hold table {opt.name} "
                    f"({opt.total_storage.hbm/1024**2:.0f}MiB HBM over "
                    f"{Lc} devices)")
            opt.host = placed_host

        groups: dict = {}
        for i, opt in enumerate(tw_options):
            groups.setdefault(opt.dependency or f"__solo_{i}", []).append(opt)
        ordered = sorted(groups.values(),
                         key=lambda g: sum(o.total_storage.hbm for o in g),
                         reverse=True)
        for group in ordered:
            shards = [s for o in group for s in o.shards]
            need_hbm = sum(s.storage.hbm for s in shards)
            need_ddr = sum(s.storage.ddr for s in shards)
            candidates = sorted(devices, key=lambda d: d.perf)
            placed = False
            for dev in candidates:
                if need_hbm <= dev.storage.hbm and need_ddr <= dev.storage.ddr:
                    for shard in shards:
                        place(shard, dev.rank)
                    placed = True
                    break
            if not placed:
                names = ",".join(o.name for o in group)
                raise PlannerError(
                    f"no device can hold table group [{names}] "
                    f"({need_hbm/1024**2:.0f}MiB HBM)")
        return plan
