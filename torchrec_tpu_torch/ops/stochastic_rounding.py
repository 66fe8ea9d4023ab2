"""Stochastic rounding of f32 values to bf16 / fp16 tables.

Counterpart of `stochastic_round` in torchrec_tpu/ops/fused_update.py
(:254-275): a half-precision table's row writes round stochastically, so
updates far below the table's ulp survive in expectation (FBGEMM's
`stochastic_rounding` fused_param).

`stochastic_round(x32, dtype, bits)` is JAX's bit recipe applied to random
bits the caller passes in: add the low `drop` bits of `bits` (16 for bf16,
13 for fp16) to the f32 bit pattern, clear them, convert. The convert to
fp16 rounds to nearest-even again below fp16's normal range and overflows
to inf, as JAX's `astype` does.

`sr_bits(step, rows, D, seed)` is the port's own random generator, a
counter-based hash in place of JAX's `jax.random.bits(fold_in(
PRNGKey(0x5EED), step))`: 32 bits for every (seed, step, table row,
column). The bits are keyed by row and column, not by slot position, so
the result does not depend on how the slots are sorted or duplicated, and
the CUDA kernels (csrc/fused_update.cu, `sr_bits`) draw the same bits from
the same counters: the card and the CPU round alike. It reads no global
RNG state. The hash is murmur3's 32-bit finaliser (fmix32), chained:

    key(row) = fmix32(fmix32(fmix32(seed + 0x9E3779B9) ^ step) ^ row)
    bits     = fmix32(key(row) ^ (col * 0x9E3779B9 mod 2**32))

all in 32-bit words. Each stage is a bijection of 32-bit words (an odd
multiplier is one too), so for fixed other counters the bits differ
whenever any one of seed, step, row or column changes. The row's key is
taken once per row; a column costs one multiply and one fmix32. Here the
words live in int64 tensors and every 32 x 32-bit product is taken in
16-bit halves, so nothing overflows.
"""

from __future__ import annotations

import torch

SR_SEED = 0x5EED  # the JAX package's PRNGKey(0x5EED)
_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9  # 2**32 / golden ratio, odd
# bits dropped from an f32 mantissa: bf16 keeps 7 of its 23 bits, fp16 10
DROP_BITS = {torch.bfloat16: 16, torch.float16: 13}


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for words a in int64 and a 32-bit constant c, in
    16-bit halves: each partial product stays below 2**49."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finaliser on words held in int64 tensors."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def sr_row_keys(step: torch.Tensor, rows: torch.Tensor,
                seed: int = SR_SEED) -> torch.Tensor:
    """The per-row stage of `sr_bits`: int64 words [N] from a 0-d integer
    step tensor (read on its device, never on the host) and row ids [N]."""
    s = torch.full_like(rows, (seed + _GOLDEN) & _M32, dtype=torch.int64)
    h = fmix32(fmix32(s) ^ (step.to(torch.int64) & _M32))
    return fmix32(h ^ (rows.to(torch.int64) & _M32))


def sr_bits(step: torch.Tensor, rows: torch.Tensor, D: int,
            seed: int = SR_SEED) -> torch.Tensor:
    """32 random bits for each (seed, step, rows[i], column j), as int64
    words in [0, 2**32): [N, D]."""
    cols = _mul32(torch.arange(D, dtype=torch.int64, device=rows.device),
                  _GOLDEN)
    return fmix32(sr_row_keys(step, rows, seed)[:, None] ^ cols[None, :])


def stochastic_round(x32: torch.Tensor, dtype: torch.dtype,
                     bits: torch.Tensor) -> torch.Tensor:
    """Round f32 `x32` to `dtype` (bf16 or fp16) stochastically with the
    random words `bits` (int64 in [0, 2**32), x32's shape); any other
    dtype converts to nearest. Bit for bit JAX's recipe on the same bits:
    inf stays inf and NaN stays NaN."""
    drop = DROP_BITS.get(dtype)
    if drop is None:
        return x32.to(dtype)
    u = x32.contiguous().view(torch.int32).to(torch.int64) & _M32
    u = (u + (bits & ((1 << drop) - 1))) & (_M32 ^ ((1 << drop) - 1))
    u = torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)
    return u.view(torch.float32).to(dtype)
