"""Row-wise quantized embedding storage and lookup.

Counterpart of torchrec_tpu/ops/quant.py. A table is kept as three
tensors: packed int-N data uint8 [R, D * bits / 8], and per-row scale and
shift, f32 [R] holding fp16-rounded values. Quantization is per-row
affine, q = round((w - shift) / scale) clipped to [0, 2^bits - 1], and
dequantization q * scale + shift.

`quantize_rowwise` runs once, offline, so it is plain torch on every
device; it gives the JAX function's bytes bit for bit (exact min and max,
the range rounded to fp16 to nearest even, a zero scale made 1.0,
`torch.round` rounding half to even as `jnp.round` does, value j of a byte
at bits [bits * j, bits * (j + 1))). The lookups go through Kq
(ops/quant_lookup.py): the CUDA kernel for CUDA tensors, its plain version
for CPU tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from torchrec_tpu_torch.ops.embedding import PoolingMode
from torchrec_tpu_torch.ops.quant_lookup import (
    BITS,
    quant_lookup_pooled,
    quant_lookup_rows,
)


@dataclasses.dataclass
class QuantizedTable:
    """Row-wise quantized table."""

    data: torch.Tensor  # [R, D * bits // 8] uint8 (packed)
    scale: torch.Tensor  # [R] f32 (fp16-rounded)
    shift: torch.Tensor  # [R] f32 (fp16-rounded)
    bits: int
    dim: int

    def to(self, device) -> "QuantizedTable":
        return dataclasses.replace(self, data=self.data.to(device),
                                   scale=self.scale.to(device),
                                   shift=self.shift.to(device))


def quantize_rowwise(weights: torch.Tensor, bits: int = 8) -> QuantizedTable:
    """[R, D] f32, bf16 or fp16 -> int-N row-wise quantized, on the
    weights' device. As in JAX, the row's min, max and (max - min) / qmax
    are taken in the table's dtype, so a bf16 table's scale rounds to bf16
    and then to fp16 (an f32 or fp16 table's rounds once to fp16); the
    codes are computed in f32."""
    if bits not in BITS:
        raise ValueError(f"bits must be 2/4/8, got {bits}")
    R, D = weights.shape
    per_byte = 8 // bits
    if D % per_byte:
        raise ValueError(f"dim {D} not packable at {bits} bits")
    qmax = (1 << bits) - 1
    w = weights.detach()
    lo = w.amin(dim=1)
    hi = w.amax(dim=1)
    scale = ((hi - lo) / qmax).to(torch.float16).to(torch.float32)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    shift = lo.to(torch.float16).to(torch.float32)
    w = w.to(torch.float32)
    q = torch.clamp(torch.round((w - shift[:, None]) / scale[:, None]), 0,
                    qmax).to(torch.uint8)
    if per_byte > 1:
        q = q.reshape(R, D // per_byte, per_byte)
        packed = torch.zeros((R, D // per_byte), dtype=torch.uint8,
                             device=w.device)
        for j in range(per_byte):
            packed |= q[:, :, j] << (bits * j)
        q = packed
    return QuantizedTable(data=q.contiguous(), scale=scale, shift=shift,
                          bits=bits, dim=D)


def dequantize_rows(table: QuantizedTable,
                    row_ids: torch.Tensor) -> torch.Tensor:
    """Gather and dequantize rows: [N] ids -> [N, D] f32 (Kq's unpooled
    mode)."""
    return quant_lookup_rows(table.data, table.scale, table.shift,
                             row_ids.reshape(-1).to(torch.int32).contiguous(),
                             table.bits)


def quant_embedding_bag_lookup(
    table: QuantizedTable,
    ids: torch.Tensor,
    lengths: torch.Tensor,
    pooling: PoolingMode = PoolingMode.SUM,
    per_sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Pooled lookup over a quantized table: ids [F, B, L] -> [F, B, D]
    (NONE: the rows times the mask, [F, B, L, D]). MEAN divides the
    pooled sum by max(length, 1), as the JAX function does."""
    F, B, L = ids.shape
    mask = (torch.arange(L, device=ids.device)[None, None, :]
            < lengths[:, :, None]).to(torch.float32)
    if per_sample_weights is not None:
        mask = mask * per_sample_weights.to(torch.float32)
    flat = ids.to(torch.int32).reshape(F * B, L).contiguous()
    if pooling is PoolingMode.NONE:
        rows = quant_lookup_rows(table.data, table.scale, table.shift,
                                 flat.reshape(-1), table.bits,
                                 mask.reshape(-1).contiguous())
        return rows.reshape(F, B, L, table.dim)
    pooled = quant_lookup_pooled(table.data, table.scale, table.shift, flat,
                                 mask.reshape(F * B, L).contiguous(),
                                 table.bits).reshape(F, B, table.dim)
    if pooling is PoolingMode.MEAN:
        denom = lengths.to(torch.float32).clamp(min=1.0)
        pooled = pooled / denom[:, :, None]
    return pooled


def quantized_size_bytes(rows: int, dim: int, bits: int) -> int:
    """Storage of a quantized table with its scale and shift."""
    return rows * (dim * bits // 8 + 8)
