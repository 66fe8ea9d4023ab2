"""Table-batched embedding lookup, pooled and per token: the forward of
every embedding module and sharding strategy.

Counterpart of torchrec_tpu/ops/embedding.py. Tables of a group are
row-concatenated into one [total_rows, D] array and a per-feature
`row_offsets` vector rebases ids, so one call pools the whole group. Ids
come in the padded [F, B, L] layout; pooling is a sum over L weighted by a
coefficient that carries the length mask, per-sample weights and 1/len for
MEAN.

PoolingMode.NONE returns the per-token rows [..., L, D] times the mask
instead: `lookup_rows`, the row gather of sequence models.

Dispatch: a pooled lookup goes to the K1 wrapper (ops/tbe_lookup.py), K1
for an fp32 table and K1h for a bf16 / fp16 one (pooled in fp32, as the
JAX package pools them in XLA, with the coefficient rounded to the table's
dtype first as JAX's `_pool_coeff` rounds it); an unpooled one of an fp32
table to the K8 wrapper (ops/gather_rows.py). Each launches its CUDA
kernel for CUDA tensors and takes its plain version for CPU tensors, and
each is differentiable. An unpooled lookup of a bf16 / fp16 table is a
plain gather in the table's dtype, as JAX's `weights[flat_ids]` keeps it
(K8 takes f32 tables only; ROADMAP queue 1 lists its half form).
"""

from __future__ import annotations

import enum
from typing import Optional, Sequence

import torch

from torchrec_tpu_torch.ops.gather_rows import gather_rows
from torchrec_tpu_torch.ops.tbe_lookup import tbe_lookup_pooled


class PoolingMode(enum.Enum):
    SUM = "sum"
    MEAN = "mean"
    NONE = "none"


def pooled_lookup(
    weights: torch.Tensor, ids: torch.Tensor, coeff: torch.Tensor
) -> torch.Tensor:
    """Fused gather + pool: out[..., :] = sum_l coeff[..., l] * W[ids[..., l]].

    weights [R, D] f32, bf16 or fp16; ids [..., L] global row ids, clamped
    to [0, R-1] as the TPU kernel clamps them (a negative id reads row 0);
    coeff [..., L] pooling coefficients (0 where invalid), rounded to a
    half table's dtype first. Returns [..., D] in fp32.
    """
    lead = ids.shape[:-1]
    L = ids.shape[-1]
    D = weights.shape[1]
    out = tbe_lookup_pooled(
        weights,
        ids.reshape(-1, L).to(torch.int32).contiguous(),
        coeff.reshape(-1, L).to(weights.dtype).to(torch.float32).contiguous(),
    )
    return out.reshape(*lead, D)


def lookup_rows(weights: torch.Tensor, flat_ids: torch.Tensor) -> torch.Tensor:
    """Row gather W[flat_ids] -> [N, D] (the PoolingMode.NONE path), ids
    clamped to [0, R-1] as the TPU kernel clamps them. fp32 tables go to
    K8; bf16/fp16 tables gather in their own dtype."""
    if weights.dtype == torch.float32:
        return gather_rows(weights, flat_ids.to(torch.int32).contiguous())
    if weights.dtype not in (torch.bfloat16, torch.float16):
        raise TypeError(f"unsupported table dtype {weights.dtype}")
    return weights[flat_ids.clamp(0, weights.shape[0] - 1).long()]


def embedding_bag_lookup(
    weights: torch.Tensor,
    ids: torch.Tensor,
    lengths: torch.Tensor,
    pooling: PoolingMode = PoolingMode.SUM,
    per_sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-table pooled lookup.

    weights [R, D]; ids [B, L] (pad slots may hold any id); lengths [B].
    Returns [B, D] ([B, L, D] for NONE).
    """
    B, L = ids.shape
    col = torch.arange(L, device=ids.device)
    mask = (col[None, :] < lengths[:, None]).to(weights.dtype)
    if per_sample_weights is not None:
        mask = mask * per_sample_weights.to(weights.dtype)
    if pooling is PoolingMode.NONE:
        rows = lookup_rows(weights, ids.reshape(-1)).reshape(B, L, -1)
        return rows * mask[:, :, None]
    if pooling is PoolingMode.MEAN:
        denom = lengths.to(weights.dtype).clamp(min=1.0)
        mask = mask / denom[:, None]
    return pooled_lookup(weights, ids, mask)


def batched_embedding_lookup(
    weights: torch.Tensor,
    ids: torch.Tensor,
    lengths: torch.Tensor,
    row_offsets,
    pooling: PoolingMode = PoolingMode.SUM,
    per_sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Grouped multi-table pooled lookup (the TBE forward).

    weights [total_rows, D] row-concatenation of the group's tables;
    ids [F, B, L] per-feature local ids; lengths [F, B]; row_offsets [F]
    base row of each feature's table; per_sample_weights optional
    [F, B, L]. Returns [F, B, D] ([F, B, L, D] for NONE).
    """
    F, B, L = ids.shape
    offs = torch.as_tensor(row_offsets, dtype=ids.dtype, device=ids.device)
    global_ids = ids + offs[:, None, None]
    col = torch.arange(L, device=ids.device)
    mask = (col[None, None, :] < lengths[:, :, None]).to(weights.dtype)
    if per_sample_weights is not None:
        mask = mask * per_sample_weights.to(weights.dtype)
    if pooling is PoolingMode.NONE:
        rows = lookup_rows(weights, global_ids.reshape(-1)).reshape(
            F, B, L, -1)
        return rows * mask[:, :, :, None]
    if pooling is PoolingMode.MEAN:
        denom = lengths.to(weights.dtype).clamp(min=1.0)
        mask = mask / denom[:, :, None]
    return pooled_lookup(weights, global_ids, mask)


def sequence_embedding_lookup(
    weights: torch.Tensor,
    ids: torch.Tensor,
    lengths: torch.Tensor,
    row_offsets,
) -> torch.Tensor:
    """Unpooled per-token lookup of EmbeddingCollection-style modules.
    Returns [F, B, L, D]; pad tokens are zero rows."""
    return batched_embedding_lookup(
        weights, ids, lengths, row_offsets, pooling=PoolingMode.NONE
    )


def make_row_offsets(rows_per_table: Sequence[int]) -> torch.Tensor:
    """Cumulative base-row offsets for a table group."""
    offs = [0]
    for r in rows_per_table:
        offs.append(offs[-1] + int(r))
    return torch.as_tensor(offs[:-1], dtype=torch.int32)
