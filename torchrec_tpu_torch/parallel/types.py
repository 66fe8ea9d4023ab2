"""Distributed core types: the sharding vocabulary.

Counterpart of torchrec_tpu/parallel/types.py. `ShardingEnv` holds a
`torch.device` instead of a JAX mesh. This slice runs on one device: a
world size above 1 needs the NCCL collectives of a later slice and raises.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence

import torch

from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


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
    """The devices a sharded module runs on: here one `torch.device`.

    `device` defaults to the current CUDA card and raises when there is
    none; pass device="cpu" to run on the CPU.
    """

    def __init__(self, device: DeviceLike = None, world_size: int = 1):
        if world_size != 1:
            raise NotImplementedError(
                f"world_size={world_size}: sharding over several GPUs needs "
                "the NCCL collectives of a later slice; this one runs on "
                "one device"
            )
        self.device: torch.device = resolve_device(device)
        self.world_size = 1
        self.rank = 0

    @staticmethod
    def from_devices(
        devices: Optional[Sequence[DeviceLike]] = None,
    ) -> "ShardingEnv":
        """Env over `devices` (default: the current CUDA card)."""
        if devices is None:
            return ShardingEnv()
        return ShardingEnv(devices[0] if len(devices) == 1 else None,
                           world_size=len(devices))

    def __repr__(self) -> str:
        return f"ShardingEnv(device={self.device}, world={self.world_size})"
