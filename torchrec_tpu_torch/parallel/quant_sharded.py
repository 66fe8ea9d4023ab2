"""Sharded quantized EmbeddingBagCollection: TABLE_WISE int-N inference.

Counterpart of torchrec_tpu/parallel/quant_sharded.py. Each table lives
whole on one rank, `table_ranks` (round-robin by default, JAX's class
default); a rank packs only its own tables, row-concatenated into one
data / scale / shift group ([rows_max, D * bits / 8], [rows_max], the
largest rank's rows padded to ROW_TILE, as JAX's [n, rows_max, ...]
layout holds on device r), in f_max feature slots (a pad slot reads
feature 0 with its lengths 0). The batch is replicated: a request is one
Kq launch over this rank's slots, one all_gather of the pooled slots over
the ranks ([n f_max, B, D]) and the slots put in canonical feature order
(`out_pos`); without a group the all_gather is the identity. MEAN folds
1 / length into the coefficient before the sum (`quant_sharded.py:
203-204`), where the unsharded module divides the pooled sum, so the two
agree bit for bit for SUM only; the port follows each module's own order.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence

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
from torchrec_tpu_torch.parallel import comm
from torchrec_tpu_torch.parallel.sharded_ebc import OUTPUT_SPAN
from torchrec_tpu_torch.parallel.strategies import (
    ROUTE_SPAN,
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
from torchrec_tpu_torch.utils import tracing

# the span (utils/tracing.py) of the whole forward; inside it the route to
# Kq (ROUTE_SPAN), Kq (`## lookup_kernel ##`) and the output's gather and
# copy into the KeyedTensor's values (OUTPUT_SPAN) have their own
FORWARD_SPAN = "## qebc_fwd ##"


class ShardedQuantEmbeddingBagCollection(nn.Module):
    """TW-sharded int-N inference EBC on `env`'s device. table_ranks:
    {table name -> rank} (default: table i on rank i % n). This rank's
    packed group and its slots' features, row offsets and MEAN flags are
    buffers."""

    def __init__(
        self,
        env: ShardingEnv,
        tables: Sequence[EmbeddingBagConfig],
        quantized: Mapping[str, QuantizedTable],
        table_ranks: Optional[Mapping[str, int]] = None,
        is_weighted: bool = False,
        max_feature_length: int = 1,
    ):
        super().__init__()
        self.env = env
        self.tables = tuple(tables)
        self.is_weighted = is_weighted
        self.max_feature_length = max_feature_length
        n = env.world_size
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
        ranks = dict(table_ranks or {t.name: i % n
                                     for i, t in enumerate(tables)})
        per_dev: List[List[int]] = [[] for _ in range(n)]
        for ti, t in enumerate(tables):
            r = ranks[t.name]
            if not 0 <= r < n:
                raise ValueError(f"table {t.name} rank {r} outside a world "
                                 f"of {n} ranks")
            per_dev[r].append(ti)
        self.table_ranks = ranks
        self.f_max = max((sum(len(tables[ti].feature_names) for ti in tids)
                          for tids in per_dev), default=1) or 1
        rows_max = _pad_rows_tile(max(
            (sum(tables[ti].num_embeddings for ti in tids)
             for tids in per_dev), default=1) or 1)
        device = env.device
        data = torch.zeros((rows_max, self.dim * self.bits // 8),
                           dtype=torch.uint8, device=device)
        scale = torch.zeros((rows_max,), dtype=torch.float32, device=device)
        shift = torch.zeros_like(scale)
        feat_pos = {f: i for i, f in enumerate(self.features)}
        out_pos = [0] * len(self.features)
        feats, rowoff, mean = [], [], []
        self._offsets = {}
        for d, tids in enumerate(per_dev):
            slot = off = 0
            for ti in tids:
                t, mine = tables[ti], d == env.rank
                is_mean = pooling_type_to_mode(t.pooling) is PoolingMode.MEAN
                if mine:
                    q = quantized[t.name]
                    part = slice(off, off + t.num_embeddings)
                    data[part] = q.data.to(device)
                    scale[part] = q.scale.to(device)
                    shift[part] = q.shift.to(device)
                    self._offsets[t.name] = off
                for f in t.feature_names:
                    out_pos[feat_pos[f]] = d * self.f_max + slot
                    slot += 1
                    if mine:
                        feats.append(feat_pos[f])
                        rowoff.append(off)
                        mean.append(is_mean)
                off += t.num_embeddings
        pad = self.f_max - len(feats)
        # the gathered slots are the canonical features (one rank)
        self._in_order = out_pos == list(range(len(out_pos)))
        # the feature each of this rank's slots reads
        self._slot_features = [self.features[f] for f in feats + [0] * pad]
        self.register_buffer("data", data)
        self.register_buffer("scale", scale)
        self.register_buffer("shift", shift)
        for name, vals, dtype in (
                ("feat_valid", [True] * len(feats) + [False] * pad,
                 torch.bool),
                ("feat_rowoff", rowoff + [0] * pad, torch.int32),
                ("feat_mean", mean + [False] * pad, torch.bool),
                ("out_pos", out_pos, torch.int64)):
            self.register_buffer(name, torch.tensor(
                vals, dtype=dtype, device=device), persistent=False)

    @property
    def quantized(self) -> Dict[str, QuantizedTable]:
        """This rank's tables' rows of the packed group (views), by name."""
        out = {}
        for t in self.tables:
            if t.name not in self._offsets:
                continue
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
        launch over this rank's slots, one all_gather of the slots."""
        with tracing.span(FORWARD_SPAN):
            sb = as_padded(features, self.max_feature_length)
            B, L = sb.ids.shape[1], sb.ids.shape[2]
            with tracing.span(ROUTE_SPAN):
                ids, coeff = self._route(sb, B, L)
            pooled = quant_lookup_pooled(
                self.data, self.scale, self.shift, ids, coeff,
                self.bits).reshape(self.f_max, B, self.dim)
            with tracing.span(OUTPUT_SPAN):
                slots = comm.all_gather(self.env, pooled, 0)  # [n f_max, B, D]
                # the one copy of the output: [B, F, D] in canonical order
                out = slots.permute(1, 0, 2)
                if not self._in_order:
                    out = out[:, self.out_pos]
                values = out.reshape(B, -1)
        return KeyedTensor(values=values, keys=self.embedding_names,
                           length_per_key=tuple(
                               self.dim for _ in self.embedding_names))

    def _route(self, sb, B: int, L: int):
        """Kq's flat ids [f_max B, L] int32 (each slot's feature's rows,
        offset to its table) and pooling coefficients [f_max B, L]."""
        key_index = {k: i for i, k in enumerate(sb.keys)}
        order = [key_index[f] for f in self._slot_features]
        ids = (feature_rows(sb.ids, order).to(torch.int32)
               + self.feat_rowoff[:, None, None])
        lengths = feature_rows(sb.lengths, order) * self.feat_valid[
            :, None].to(sb.lengths.dtype)
        coeff = pool_coefficients(
            lengths, L, feature_rows(sb.weights, order)
            if self.is_weighted and sb.weights is not None else None)
        denom = lengths.to(torch.float32).clamp(min=1.0)[:, :, None]
        coeff = torch.where(self.feat_mean[:, None, None], coeff / denom,
                            coeff)
        return (ids.reshape(self.f_max * B, L),
                coeff.reshape(self.f_max * B, L))
