"""Operations and bytes of the work a step does, computed from shapes and
batches alone, whatever kernels implement it.

A byte bound counts each input byte read once and each output byte
written once: every distinct row a batch touches once, its optimizer state
once, ids, lengths, pooled outputs and cotangents once. Each feature has
a table of its own here. Operation counts are the model's multiply-adds
times two, as its layers define them.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

F32 = 4
ID = 4


def linear_flops(shapes: Sequence[Tuple[int, int]], train: bool,
                 no_input_grad: Sequence[int] = ()) -> int:
    """Per example, for linear layers (in, out): the forward product, and
    in training the weight gradient and the input gradient, except for the
    layers in `no_input_grad`, whose input takes none."""
    total = 0
    for i, (fi, fo) in enumerate(shapes):
        mult = 1
        if train:
            mult = 2 if i in no_input_grad else 3
        total += mult * 2 * fi * fo
    return total


def distinct_rows(ids: torch.Tensor, lengths: torch.Tensor) -> int:
    """Distinct (feature, row) pairs among a batch's real slots; ids [F, B,
    L], lengths [F, B]."""
    F, B, L = ids.shape
    real = torch.arange(L, device=ids.device)[None, None, :] < lengths[:, :, None]
    total = 0
    for f in range(F):
        total += int(torch.unique(ids[f][real[f]]).numel())
    return total


def sparse_input_bytes(F: int, B: int, ids: int) -> int:
    """The real ids of B examples (`ids` an example: F L where every
    feature has L, the sum of the features' lengths otherwise) and the
    lengths [F, B], int32."""
    return B * ids * ID + F * B * ID


def lookup_bytes(distinct: int, F: int, B: int, ids: int, D: int,
                 row_bytes: float = F32) -> int:
    """A pooled lookup: distinct rows read, ids and lengths read, pooled
    f32 outputs [F, B, D] written."""
    return int(distinct * D * row_bytes + sparse_input_bytes(F, B, ids)
               + F * B * D * F32)


def update_bytes(distinct: int, F: int, B: int, ids: int, D: int,
                 state_floats_per_row: int, row_bytes: float = F32) -> int:
    """A fused sparse optimizer step: each distinct row and its state
    (`state_floats_per_row` f32, e.g. 1 for rowwise Adagrad, 2D for Adam)
    read and written once, the pooled f32 cotangent [F, B, D], ids and
    lengths read once."""
    per_row = 2 * (D * row_bytes + state_floats_per_row * F32)
    return int(distinct * per_row + F * B * D * F32
               + sparse_input_bytes(F, B, ids))


def quant_lookup_bytes(distinct: int, F: int, B: int, ids: int, D: int,
                       bits: int) -> int:
    """A pooled lookup over row-wise quantized tables: each distinct row's
    packed codes and its f32 scale and shift read, ids and lengths read,
    f32 outputs written."""
    return int(distinct * (D * bits // 8 + 2 * F32)
               + sparse_input_bytes(F, B, ids) + F * B * D * F32)


def optimizer_state_floats(optim: str, D: int) -> int:
    """f32 state a row of a fused optimizer keeps."""
    return {"EXACT_SGD": 0, "SGD": 0, "ROWWISE_ADAGRAD": 1,
            "ADAGRAD": D, "ADAM": 2 * D}[optim]
