"""Embedding table configuration dataclasses.

Counterpart of torchrec_tpu/modules/embedding_configs.py: table
name/rows/dim, storage data type, pooling and feature mapping.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

import torch

from torchrec_tpu_torch.ops.embedding import PoolingMode


class DataType(enum.Enum):
    FP32 = "FP32"
    FP16 = "FP16"
    BF16 = "BF16"
    INT8 = "INT8"
    INT4 = "INT4"
    INT2 = "INT2"


DATA_TYPE_NUM_BITS = {
    DataType.FP32: 32,
    DataType.FP16: 16,
    DataType.BF16: 16,
    DataType.INT8: 8,
    DataType.INT4: 4,
    DataType.INT2: 2,
}


class PoolingType(enum.Enum):
    SUM = "SUM"
    MEAN = "MEAN"
    NONE = "NONE"


def pooling_type_to_mode(p: PoolingType) -> PoolingMode:
    return {
        PoolingType.SUM: PoolingMode.SUM,
        PoolingType.MEAN: PoolingMode.MEAN,
        PoolingType.NONE: PoolingMode.NONE,
    }[p]


def data_type_to_torch_dtype(dt: DataType) -> torch.dtype:
    """Table storage dtype for training. The INT types are quantized
    serving's (quant/embedding_modules.py), not a table dtype."""
    m = {
        DataType.FP32: torch.float32,
        DataType.FP16: torch.float16,
        DataType.BF16: torch.bfloat16,
    }
    if dt not in m:
        raise ValueError(f"{dt} is not a float table dtype")
    return m[dt]


@dataclasses.dataclass
class BaseEmbeddingConfig:
    num_embeddings: int
    embedding_dim: int
    name: str = ""
    data_type: DataType = DataType.FP32
    feature_names: List[str] = dataclasses.field(default_factory=list)
    weight_init_max: Optional[float] = None
    weight_init_min: Optional[float] = None

    def get_weight_init_max(self) -> float:
        if self.weight_init_max is not None:
            return self.weight_init_max
        return (1.0 / self.num_embeddings) ** 0.5

    def get_weight_init_min(self) -> float:
        if self.weight_init_min is not None:
            return self.weight_init_min
        return -((1.0 / self.num_embeddings) ** 0.5)


@dataclasses.dataclass
class EmbeddingBagConfig(BaseEmbeddingConfig):
    """Pooled table."""

    pooling: PoolingType = PoolingType.SUM


@dataclasses.dataclass
class EmbeddingConfig(BaseEmbeddingConfig):
    """Unpooled (sequence) table of an EmbeddingCollection."""
