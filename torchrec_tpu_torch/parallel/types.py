"""Distributed core types: the sharding vocabulary.

Counterpart of torchrec_tpu/parallel/types.py. `ShardingEnv` holds this
process's `torch.device` and, at world size n, a `torch.distributed`
process group of n ranks, one process per rank, in place of a JAX mesh of
n devices: rank r plays device r of the mesh, so every sharded layout
holds on rank r what JAX's `jax.devices()[:n]` holds on device r. Without
a group the env is one device and every collective is the identity
(parallel/comm.py).

`local_size` is the ranks per host, Lc, and the world is H = n / Lc hosts
of Lc ranks, rank h * Lc + l being local rank l of host h, as JAX's flat
mesh orders its devices. The hierarchical strategies run their
collectives over the subgroups `subgroups()` builds: the intra-host groups
[[h Lc + l for l] for h] and the cross-host groups [[h Lc + l for h] for
l], JAX's `axis_index_groups`.
"""

from __future__ import annotations

import dataclasses
import datetime
import enum
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


# how long a collective may wait for the other ranks
TIMEOUT_S = 600


class ShardingType(enum.Enum):
    DATA_PARALLEL = "data_parallel"
    TABLE_WISE = "table_wise"
    COLUMN_WISE = "column_wise"
    ROW_WISE = "row_wise"
    TABLE_ROW_WISE = "table_row_wise"
    TABLE_COLUMN_WISE = "table_column_wise"


class ComputeKernel(enum.Enum):
    DENSE = "dense"
    FUSED = "fused"
    QUANT = "quant"
    FUSED_UVM_CACHING = "fused_uvm_caching"


@dataclasses.dataclass
class ParameterSharding:
    """Per-table sharding decision. ranks: the devices that take part;
    host: host index of TABLE_ROW_WISE / TABLE_COLUMN_WISE placements."""

    sharding_type: ShardingType
    compute_kernel: ComputeKernel = ComputeKernel.FUSED
    ranks: Optional[List[int]] = None
    host: Optional[int] = None


@dataclasses.dataclass
class ShardingPlan:
    """module path -> {table name -> ParameterSharding}."""

    plan: Dict[str, Dict[str, ParameterSharding]]

    def get_plan_for_module(
        self, module_path: str
    ) -> Optional[Dict[str, ParameterSharding]]:
        return self.plan.get(module_path)


class ShardingEnv:
    """Where a sharded module runs: this process's device and, at world
    size n, the process group of its n ranks.

    `ShardingEnv(device)` is one device with no group: `device` defaults
    to the current CUDA card and raises when there is none; pass
    device="cpu" to run on the CPU. Several devices in one process are not
    taken: the port runs one process per rank (`from_distributed`,
    `from_process_group`). `local_size`, the ranks per host, defaults to
    the whole world, JAX's default, and must divide it; the flat
    strategies do not read it.
    """

    def __init__(self, device: DeviceLike = None, world_size: int = 1,
                 group: Optional[dist.ProcessGroup] = None,
                 local_size: Optional[int] = None):
        if group is None and world_size != 1:
            raise NotImplementedError(
                f"world_size={world_size} in one process: the port runs one "
                "process per rank; use ShardingEnv.from_distributed() or "
                "ShardingEnv.from_process_group()"
            )
        self.device: torch.device = resolve_device(device)
        self.group = group
        if group is None:
            self.world_size, self.rank = 1, 0
        else:
            self.world_size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
        self.local_size = int(local_size or self.world_size)
        if self.local_size < 1 or self.world_size % self.local_size:
            raise ValueError(f"world_size {self.world_size} not divisible by "
                             f"local_size {self.local_size}")
        self._subgroups = None

    @property
    def num_hosts(self) -> int:
        return self.world_size // self.local_size

    def subgroup_ranks(self) -> Tuple[List[List[int]], List[List[int]]]:
        """(intra-host groups, cross-host groups) as lists of ranks of the
        env's group, each list ascending."""
        H, Lc = self.num_hosts, self.local_size
        return ([[h * Lc + l for l in range(Lc)] for h in range(H)],
                [[h * Lc + l for h in range(H)] for l in range(Lc)])

    def subgroups(self) -> Tuple[Optional[dist.ProcessGroup],
                                 Optional[dist.ProcessGroup]]:
        """This rank's (intra-host, cross-host) process groups; (None, None)
        without a group, where every collective is the identity.

        Built once per env and shared by every strategy on it: every rank
        calls `dist.new_group` for every subgroup, in one order, including
        the groups it is not in, as torch.distributed requires, so the
        first call is a collective of the env's group. A group's ranks are
        ordered ascending, which is their order in the lists, so block j of
        a subgroup's collective is its j-th member's, as JAX orders a
        group's blocks by their position in `axis_index_groups`."""
        if self.group is None:
            return None, None
        if self._subgroups is None:
            to_global = dist.get_process_group_ranks(self.group)
            h, l = divmod(self.rank, self.local_size)
            made = []
            for lists, mine in zip(self.subgroup_ranks(), (h, l)):
                groups = [dist.new_group(
                    [to_global[r] for r in ranks],
                    timeout=datetime.timedelta(seconds=TIMEOUT_S))
                    for ranks in lists]
                made.append(groups[mine])
            self._subgroups = tuple(made)
        return self._subgroups

    @staticmethod
    def from_devices(
        devices: Optional[Sequence[DeviceLike]] = None,
    ) -> "ShardingEnv":
        """Env over `devices` (default: the current CUDA card); one device
        only, as above."""
        if devices is None:
            return ShardingEnv()
        return ShardingEnv(devices[0] if len(devices) == 1 else None,
                           world_size=len(devices))

    @staticmethod
    def from_process_group(group: dist.ProcessGroup,
                           device: DeviceLike = None,
                           local_size: Optional[int] = None) -> "ShardingEnv":
        """Env over a process group the caller made; `device` as in
        `ShardingEnv(device)`, `local_size` the ranks per host (default:
        the whole group)."""
        return ShardingEnv(device, group=group, local_size=local_size)

    @staticmethod
    def _rank_device(device: DeviceLike) -> torch.device:
        """`device`, else cuda:LOCAL_RANK (raising when there is no card);
        a card given by index becomes the current card."""
        if device is None:
            if not torch.cuda.is_available():
                resolve_device(None)  # raises, naming device='cpu'
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        device = torch.device(device)
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        return device

    @staticmethod
    def from_distributed(device: DeviceLike = None) -> "ShardingEnv":
        """Env over the default process group, started from torch's
        `env://` variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as
        torchrun sets them) when none is up: NCCL for a CUDA device, gloo
        for device="cpu". The device defaults to cuda:LOCAL_RANK and
        raises when there is no card. `local_size` is torchrun's
        LOCAL_WORLD_SIZE, the ranks on this host (JAX's
        `jax.local_device_count()`), else the whole world."""
        device = ShardingEnv._rank_device(device)
        if not dist.is_initialized():
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                init_method="env://",
                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        local = os.environ.get("LOCAL_WORLD_SIZE")
        return ShardingEnv(device, group=dist.group.WORLD,
                           local_size=int(local) if local else None)

    @staticmethod
    def from_local(world_size: int,
                   device: DeviceLike = None) -> "ShardingEnv":
        """Single-host inference env of `world_size` ranks, the form of
        JAX's `from_local` (its first `world_size` local devices) for one
        process per rank: the default process group, which must hold
        `world_size` ranks, all on this host (LOCAL_WORLD_SIZE, where set,
        equals `world_size`), with local_size = world_size. Without a
        default group, world_size 1 is this device alone. The device as in
        `from_distributed`."""
        device = ShardingEnv._rank_device(device)
        if not dist.is_initialized():
            if world_size != 1:
                raise ValueError(
                    f"from_local({world_size}): no default process group; "
                    "start one rank per device (torchrun) first")
            return ShardingEnv(device)
        n = dist.get_world_size()
        local = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        if n != world_size or local != world_size:
            raise ValueError(
                f"from_local({world_size}): the default group has {n} ranks, "
                f"{local} on this host; it must have {world_size}, all local")
        return ShardingEnv(device, group=dist.group.WORLD,
                           local_size=world_size)

    def __repr__(self) -> str:
        return (f"ShardingEnv(device={self.device}, rank={self.rank}, "
                f"world={self.world_size}, local={self.local_size})")
