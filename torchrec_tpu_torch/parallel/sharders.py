"""Module sharders: what each sharded module kind takes.

Counterpart of torchrec_tpu/parallel/sharders.py. A sharder declares the
sharding types and compute kernels a module kind supports and carries the
`fused_params` handed to its fused optimizer. The DMP merges each
sharder's `fused_params` under its explicit ones and plans a module given
no plan under its kind's sharder's sharding types (the tower sharder's
TABLE_WISE with one dependency tag per tower; the quantized sharder's
TABLE_WISE in inference/modules.py). `device_type` defaults to "cuda".
"""

from __future__ import annotations

import abc
from typing import Dict, List, Optional

from torchrec_tpu_torch.parallel.types import ComputeKernel, ShardingType


class ModuleSharder(abc.ABC):
    """The capabilities of one module kind ("ebc" pooled, "ec" sequence,
    "quant_ebc", "tower") and its fused_params."""

    module_kind: str = "ebc"

    def __init__(self, fused_params: Optional[dict] = None):
        self.fused_params: Dict = dict(fused_params or {})

    @abc.abstractmethod
    def sharding_types(self, device_type: str = "cuda"
                       ) -> List[ShardingType]: ...

    def compute_kernels(self, sharding_type: ShardingType,
                        device_type: str = "cuda") -> List[ComputeKernel]:
        return [ComputeKernel.FUSED]


class EmbeddingBagCollectionSharder(ModuleSharder):
    """Pooled collections: every sharding type."""

    module_kind = "ebc"

    def sharding_types(self, device_type: str = "cuda"
                       ) -> List[ShardingType]:
        return [
            ShardingType.DATA_PARALLEL,
            ShardingType.TABLE_WISE,
            ShardingType.ROW_WISE,
            ShardingType.COLUMN_WISE,
            ShardingType.TABLE_ROW_WISE,
            ShardingType.TABLE_COLUMN_WISE,
        ]

    def compute_kernels(self, sharding_type: ShardingType,
                        device_type: str = "cuda") -> List[ComputeKernel]:
        return [ComputeKernel.FUSED, ComputeKernel.FUSED_UVM_CACHING]


class EmbeddingCollectionSharder(ModuleSharder):
    """Sequence (unpooled) collections: TABLE_WISE, ROW_WISE and
    DATA_PARALLEL."""

    module_kind = "ec"

    def sharding_types(self, device_type: str = "cuda"
                       ) -> List[ShardingType]:
        return [
            ShardingType.DATA_PARALLEL,
            ShardingType.TABLE_WISE,
            ShardingType.ROW_WISE,
        ]


class QuantEmbeddingBagCollectionSharder(ModuleSharder):
    """Int-N inference collections: TABLE_WISE only."""

    module_kind = "quant_ebc"

    def sharding_types(self, device_type: str = "cuda"
                       ) -> List[ShardingType]:
        return [ShardingType.TABLE_WISE]

    def compute_kernels(self, sharding_type: ShardingType,
                        device_type: str = "cuda") -> List[ComputeKernel]:
        return [ComputeKernel.QUANT]


class EmbeddingTowerCollectionSharder(ModuleSharder):
    """Embedding towers: whole tables beside their interaction module on
    one rank, so TABLE_WISE only."""

    module_kind = "tower"

    def sharding_types(self, device_type: str = "cuda"
                       ) -> List[ShardingType]:
        return [ShardingType.TABLE_WISE]


def get_default_sharders() -> List[ModuleSharder]:
    return [
        EmbeddingBagCollectionSharder(),
        EmbeddingCollectionSharder(),
        QuantEmbeddingBagCollectionSharder(),
        EmbeddingTowerCollectionSharder(),
    ]
