"""Sharded quantized EmbeddingBagCollection: TABLE_WISE int-N inference.

Counterpart of torchrec_tpu/parallel/quant_sharded.py at world size 1,
where every table lands on rank 0: the tables are row-concatenated into
one packed data / scale / shift group ([rows, D * bits / 8], [rows],
padded to ROW_TILE rows as the JAX module pads each device's rows), a
feature's ids are rebased by its table's row offset, and one Kq launch
pools every feature. MEAN folds 1 / length into the coefficient before
the sum (`quant_sharded.py:203-204`), where the unsharded module divides
the pooled sum, so the two agree bit for bit for SUM only; the port
follows each module's own order. The JAX module's all_gather over
devices is the identity here. Placement over several ranks, with its
per-rank groups and routing, comes with the next slice (ROADMAP queue 1,
item 8b).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_configs import (
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
from torchrec_tpu_torch.parallel.strategies import (
    ArrayLike,
    _pad_rows_tile,
    as_tensor,
)
from torchrec_tpu_torch.parallel.types import ShardingEnv
from torchrec_tpu_torch.quant.embedding_modules import (
    feature_rows,
    pool_coefficients,
    quant_bits,
)
from torchrec_tpu_torch.sparse.jagged import KeyedTensor


class ShardedQuantEmbeddingBagCollection(nn.Module):
    """TW-sharded int-N inference EBC on `env`'s device, world size 1.
    The packed group and each feature's row offset and MEAN flag are
    buffers."""

    def __init__(
        self,
        env: ShardingEnv,
        tables: Sequence[EmbeddingBagConfig],
        quantized: Mapping[str, QuantizedTable],
        is_weighted: bool = False,
        max_feature_length: int = 1,
    ):
        super().__init__()
        if env.world_size != 1:
            raise NotImplementedError(
                f"world_size={env.world_size}: the sharded quantized EBC's "
                "table-wise placement over ranks and its output all_gather "
                "come with the next slice (ROADMAP queue 1 item 8b)")
        self.env = env
        self.tables = tuple(tables)
        self.is_weighted = is_weighted
        self.max_feature_length = max_feature_length
        dims = {t.embedding_dim for t in tables}
        if len(dims) != 1:
            raise ValueError("tables must share embedding_dim")
        self.dim = dims.pop()
        bits = {quantized[t.name].bits for t in tables}
        if len(bits) != 1:
            raise ValueError("tables must share quantized bits")
        self.bits = bits.pop()

        self.embedding_names = tuple(
            nm for names in embedding_names_by_table(self.tables)
            for nm in names)
        self.features = [f for t in tables for f in t.feature_names]
        device = env.device
        rows = _pad_rows_tile(sum(t.num_embeddings for t in tables))
        data = torch.zeros((rows, self.dim * self.bits // 8),
                           dtype=torch.uint8, device=device)
        scale = torch.zeros((rows,), dtype=torch.float32, device=device)
        shift = torch.zeros_like(scale)
        self._offsets = {}
        rowoff, mean = [], []
        off = 0
        for t in tables:
            q = quantized[t.name]
            part = slice(off, off + t.num_embeddings)
            data[part] = q.data.to(device)
            scale[part] = q.scale.to(device)
            shift[part] = q.shift.to(device)
            self._offsets[t.name] = off
            is_mean = pooling_type_to_mode(t.pooling) is PoolingMode.MEAN
            rowoff += [off] * len(t.feature_names)
            mean += [is_mean] * len(t.feature_names)
            off += t.num_embeddings
        self.register_buffer("data", data)
        self.register_buffer("scale", scale)
        self.register_buffer("shift", shift)
        self.register_buffer("feat_rowoff", torch.tensor(
            rowoff, dtype=torch.int32, device=device), persistent=False)
        self.register_buffer("feat_mean", torch.tensor(
            mean, dtype=torch.bool, device=device), persistent=False)

    @property
    def quantized(self) -> Dict[str, QuantizedTable]:
        """Each table's rows of the packed group (views), by name."""
        out = {}
        for t in self.tables:
            part = slice(self._offsets[t.name],
                         self._offsets[t.name] + t.num_embeddings)
            out[t.name] = QuantizedTable(
                data=self.data[part], scale=self.scale[part],
                shift=self.shift[part], bits=self.bits, dim=self.dim)
        return out

    @staticmethod
    def from_float(
        env: ShardingEnv,
        tables: Sequence[EmbeddingBagConfig],
        weights: Mapping[str, ArrayLike],
        data_type: DataType = DataType.INT8,
        **kwargs,
    ) -> "ShardedQuantEmbeddingBagCollection":
        bits = quant_bits(data_type)
        quantized = {
            t.name: quantize_rowwise(as_tensor(weights[t.name], env.device),
                                     bits)
            for t in tables}
        return ShardedQuantEmbeddingBagCollection(env, tables, quantized,
                                                  **kwargs)

    def forward(self, features: SparseInput) -> KeyedTensor:
        """Replicated batch in, pooled KeyedTensor [B, sum(D)] out: one Kq
        launch over the packed group."""
        sb = as_padded(features, self.max_feature_length)
        key_index = {k: i for i, k in enumerate(sb.keys)}
        order = [key_index[f] for f in self.features]
        F, B, L = len(order), sb.ids.shape[1], sb.ids.shape[2]
        ids = (feature_rows(sb.ids, order).to(torch.int32)
               + self.feat_rowoff[:, None, None])
        lengths = feature_rows(sb.lengths, order)
        coeff = pool_coefficients(
            lengths, L, feature_rows(sb.weights, order)
            if self.is_weighted and sb.weights is not None else None)
        denom = lengths.to(torch.float32).clamp(min=1.0)[:, :, None]
        coeff = torch.where(self.feat_mean[:, None, None], coeff / denom,
                            coeff)
        pooled = quant_lookup_pooled(
            self.data, self.scale, self.shift, ids.reshape(F * B, L),
            coeff.reshape(F * B, L), self.bits).reshape(F, B, self.dim)
        values = pooled.permute(1, 0, 2).reshape(B, -1)
        return KeyedTensor(values=values, keys=self.embedding_names,
                           length_per_key=tuple(
                               self.dim for _ in self.embedding_names))
