"""Quantized EmbeddingBagCollection for inference.

Counterpart of torchrec_tpu/quant/embedding_modules.py. `from_float`
row-wise quantizes trained f32 tables; `forward` keeps the float EBC's
KeyedTensor contract (the same names, in the same order). Each table is
one Kq launch (ops/quant_lookup.py); MEAN divides the pooled sum by the
length afterwards, as the JAX module does. Inference only.

The packed data, scale and shift of each table are buffers of the module,
so `.to()` and `state_dict()` carry them.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
    DATA_TYPE_NUM_BITS,
    DataType,
    EmbeddingBagConfig,
    pooling_type_to_mode,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    SparseInput,
    as_padded,
    embedding_names_by_table,
)
from torchrec_tpu_torch.ops.embedding import PoolingMode
from torchrec_tpu_torch.ops.quant import QuantizedTable, quantize_rowwise
from torchrec_tpu_torch.ops.quant_lookup import quant_lookup_pooled
from torchrec_tpu_torch.parallel.strategies import ArrayLike, as_tensor
from torchrec_tpu_torch.sparse.jagged import KeyedTensor
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


def quant_bits(data_type: DataType) -> int:
    """The bits of a quantized DataType; raises for a float one."""
    bits = DATA_TYPE_NUM_BITS[data_type]
    if bits > 8:
        raise ValueError(f"{data_type} is not a quantized type")
    return bits


class QuantTableBuffers(nn.Module):
    """One quantized table as the buffers `data`, `scale` and `shift`."""

    def __init__(self, table: QuantizedTable):
        super().__init__()
        self.bits, self.dim = table.bits, table.dim
        self.register_buffer("data", table.data)
        self.register_buffer("scale", table.scale)
        self.register_buffer("shift", table.shift)

    def table(self) -> QuantizedTable:
        return QuantizedTable(data=self.data, scale=self.scale,
                              shift=self.shift, bits=self.bits, dim=self.dim)


def pool_coefficients(lengths: torch.Tensor, L: int,
                      weights: Optional[torch.Tensor]) -> torch.Tensor:
    """[F, B, L] f32 pooling coefficient: the length mask, times the
    per-sample weights when given."""
    coeff = (torch.arange(L, device=lengths.device)[None, None, :]
             < lengths[:, :, None]).to(torch.float32)
    if weights is not None:
        coeff = coeff * weights.to(torch.float32)
    return coeff


def feature_rows(t: torch.Tensor, index: List[int]) -> torch.Tensor:
    """t[index] along dim 0: a view when the indices run consecutively."""
    if index == list(range(index[0], index[0] + len(index))):
        return t[index[0]:index[0] + len(index)]
    return t[torch.as_tensor(index, device=t.device)]


class QuantEmbeddingBagCollection(nn.Module):
    """Int-N EmbeddingBagCollection (quantized tables by name).

    tables: the float EBC's configs; quantized: {table name ->
    QuantizedTable}, moved to `device` (default: the current CUDA card;
    pass device="cpu" for the CPU).
    """

    def __init__(
        self,
        tables: Sequence[EmbeddingBagConfig],
        quantized: Mapping[str, QuantizedTable],
        is_weighted: bool = False,
        max_feature_length: int = 1,
        device: DeviceLike = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.tables = tuple(tables)
        for t in self.tables:
            if pooling_type_to_mode(t.pooling) is PoolingMode.NONE:
                raise ValueError(f"table {t.name}: an EmbeddingBagCollection "
                                 "pools by SUM or MEAN")
        self.is_weighted = is_weighted
        self.max_feature_length = max_feature_length
        self._emb_names = embedding_names_by_table(self.tables)
        self.embedding_names = tuple(
            n for names in self._emb_names for n in names)
        self.quant_tables = nn.ModuleDict({
            t.name: QuantTableBuffers(quantized[t.name].to(dev))
            for t in self.tables})

    @property
    def quantized(self) -> Dict[str, QuantizedTable]:
        return {name: m.table() for name, m in self.quant_tables.items()}

    @staticmethod
    def from_float(
        tables: Sequence[EmbeddingBagConfig],
        weights: Mapping[str, ArrayLike],
        data_type: DataType = DataType.INT8,
        is_weighted: bool = False,
        max_feature_length: int = 1,
        device: DeviceLike = None,
    ) -> "QuantEmbeddingBagCollection":
        """Quantize trained f32 tables {name -> [R, D]} (numpy or torch) on
        `device`."""
        bits = quant_bits(data_type)
        dev = resolve_device(device)
        quantized = {t.name: quantize_rowwise(as_tensor(weights[t.name], dev),
                                              bits)
                     for t in tables}
        return QuantEmbeddingBagCollection(tables, quantized, is_weighted,
                                           max_feature_length, dev)

    def forward(self, features: SparseInput) -> KeyedTensor:
        sb = as_padded(features, self.max_feature_length)
        key_index = {k: i for i, k in enumerate(sb.keys)}
        B, L = sb.ids.shape[1], sb.ids.shape[2]
        coeff = pool_coefficients(
            sb.lengths, L, sb.weights if self.is_weighted else None)
        outputs: List[torch.Tensor] = []
        for cfg in self.tables:
            fidx = [key_index[f] for f in cfg.feature_names]
            n = len(fidx)
            q = self.quant_tables[cfg.name]
            ids = feature_rows(sb.ids, fidx).to(torch.int32)
            pooled = quant_lookup_pooled(
                q.data, q.scale, q.shift, ids.reshape(n * B, L).contiguous(),
                feature_rows(coeff, fidx).reshape(n * B, L).contiguous(),
                q.bits).reshape(n, B, q.dim)
            if pooling_type_to_mode(cfg.pooling) is PoolingMode.MEAN:
                lengths = feature_rows(sb.lengths, fidx)
                pooled = pooled / lengths.to(torch.float32).clamp(
                    min=1.0)[:, :, None]
            outputs.extend(pooled.unbind(0))
        return KeyedTensor.from_tensor_list(self.embedding_names, outputs)
