"""Distributed core types: the sharding vocabulary.

Counterpart of torchrec_tpu/parallel/types.py. `ShardingEnv` holds this
process's `torch.device` and, at world size n, a `torch.distributed`
process group of n ranks, one process per rank, in place of a JAX mesh of
n devices: rank r plays device r of the mesh, so every sharded layout
holds on rank r what JAX's `jax.devices()[:n]` holds on device r. Without
a group the env is one device and every collective is the identity
(parallel/comm.py).
"""

from __future__ import annotations

import dataclasses
import datetime
import enum
import os
from typing import Dict, List, Optional, Sequence

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
    `from_process_group`). `local_size`, the ranks per host, is the whole
    world, JAX's default; the flat strategies do not read it.
    """

    def __init__(self, device: DeviceLike = None, world_size: int = 1,
                 group: Optional[dist.ProcessGroup] = None):
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
        self.local_size = self.world_size

    @property
    def num_hosts(self) -> int:
        return self.world_size // self.local_size

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
                           device: DeviceLike = None) -> "ShardingEnv":
        """Env over a process group the caller made; `device` as in
        `ShardingEnv(device)`."""
        return ShardingEnv(device, group=group)

    @staticmethod
    def from_distributed(device: DeviceLike = None) -> "ShardingEnv":
        """Env over the default process group, started from torch's
        `env://` variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as
        torchrun sets them) when none is up: NCCL for a CUDA device, gloo
        for device="cpu". The device defaults to cuda:LOCAL_RANK and
        raises when there is no card."""
        if device is None:
            if not torch.cuda.is_available():
                resolve_device(None)  # raises, naming device='cpu'
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             0)))
        device = torch.device(device)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        if not dist.is_initialized():
            dist.init_process_group(
                "nccl" if device.type == "cuda" else "gloo",
                init_method="env://",
                timeout=datetime.timedelta(seconds=TIMEOUT_S))
        return ShardingEnv(device, group=dist.group.WORLD)

    def __repr__(self) -> str:
        return (f"ShardingEnv(device={self.device}, rank={self.rank}, "
                f"world={self.world_size}, local={self.local_size})")
