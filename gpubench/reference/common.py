"""Plain PyTorch pieces of the references: frozen copies of the models'
arithmetic and of the optimizers and the quantizer, written from their
published definitions. Nothing here imports the program or JAX.

`Precision` is the arithmetic a reference runs in: "float32" (TF32 off,
the configurations' stated precision) or "tf32", the control: every
matrix product's inputs rounded to TF32's 10-bit mantissa, to nearest,
with products summed in f32, as the tensor cores take them. The rounding
is written out so that the control is the same on every device.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

Precision = str  # "float32" | "tf32"


def fp32_matmul() -> None:
    """TF32 off for matrix products and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 -> the nearest TF32 value (1 sign, 8 exponent, 10 mantissa
    bits), ties away from zero, kept in f32."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """a @ b with TF32 inputs, and the backward's products likewise."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return (g @ tf32_round(b).transpose(-1, -2),
                tf32_round(a).transpose(-1, -2) @ g)


def mm(a: torch.Tensor, b: torch.Tensor, precision: Precision) -> torch.Tensor:
    if precision == "tf32":
        return _TF32Matmul.apply(a, b)
    return a @ b


def linear(x: torch.Tensor, w: torch.Tensor, b, precision: Precision
           ) -> torch.Tensor:
    """x [N, in] times weight [out, in] plus bias [out] (none where b is
    None)."""
    y = mm(x, w.t(), precision)
    return y if b is None else y + b


def linear_biases(model, cfg: dict) -> List[bool]:
    """Which of a reference model's `linear_shapes` have a bias: its
    `linear_biases(cfg)` where it gives one, every layer otherwise."""
    if hasattr(model, "linear_biases"):
        return list(model.linear_biases(cfg))
    return [True] * len(model.linear_shapes(cfg))


def bce_with_logits(z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy_with_logits(z, y)


def bce(p: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return F.binary_cross_entropy(p, y)


def pool(rows: torch.Tensor, local: torch.Tensor,
         lengths: torch.Tensor) -> torch.Tensor:
    """Sum pooling: rows [U, D] of one table, local ids [B, L] into them,
    lengths [B] -> [B, D] over each bag's first `length` slots."""
    L = local.shape[1]
    real = (torch.arange(L, device=local.device)[None, :]
            < lengths[:, None]).to(rows.dtype)
    return (rows[local] * real[:, :, None]).sum(dim=1)


def row_totals(local: torch.Tensor, lengths: torch.Tensor,
               d_pooled: torch.Tensor, U: int) -> torch.Tensor:
    """The gradient of each of a table's U rows from the pooled cotangent
    [B, D]: each real slot adds its bag's cotangent to its row."""
    B, L = local.shape
    real = torch.arange(L, device=local.device)[None, :] < lengths[:, None]
    g = torch.zeros((U, d_pooled.shape[1]), dtype=torch.float32,
                    device=d_pooled.device)
    slots = d_pooled[:, None, :].expand(B, L, -1)[real]
    return g.index_add_(0, local[real], slots)


def rowwise_adagrad_(w, m, g, touched, lr: float, eps: float) -> None:
    """m += mean(g^2) over the row; w -= lr g / (sqrt(m) + eps), on the
    rows a step touched."""
    r = touched.nonzero().squeeze(1)
    gr = g[r]
    m[r] += (gr * gr).mean(dim=1)
    w[r] -= lr * gr / (torch.sqrt(m[r])[:, None] + eps)


def adagrad_rows_(w, m, g, touched, lr: float, eps: float) -> None:
    """Adagrad element by element: m += g^2; w -= lr g / (sqrt(m) + eps),
    on the rows a step touched (the port's K6 places eps so)."""
    r = touched.nonzero().squeeze(1)
    gr = g[r]
    m[r] += gr * gr
    w[r] -= lr * gr / (torch.sqrt(m[r]) + eps)


def adam_rows_(w, m1, m2, g, touched, step: int, lr: float, b1: float,
               b2: float, eps: float) -> None:
    """Adam on the rows a step touched, with the bias corrections of the
    table's step count `step` (1 after the first step)."""
    r = touched.nonzero().squeeze(1)
    gr = g[r]
    m1[r] = b1 * m1[r] + (1.0 - b1) * gr
    m2[r] = b2 * m2[r] + (1.0 - b2) * gr * gr
    m1_hat = m1[r] / (1.0 - b1 ** step)
    m2_hat = m2[r] / (1.0 - b2 ** step)
    w[r] -= lr * m1_hat / (torch.sqrt(m2_hat) + eps)


def quantize_rows(w: torch.Tensor, bits: int):
    """Row-wise affine quantization of f32 rows [R, D] to `bits`: the
    row's range over 2^bits - 1 and its minimum, each rounded to fp16 (a
    zero scale made 1), codes round((w - shift) / scale), half to even,
    clipped to [0, 2^bits - 1]. Returns (codes [R, D] uint8, scale [R],
    shift [R]), scale and shift in f32."""
    qmax = (1 << bits) - 1
    lo = w.amin(dim=1)
    hi = w.amax(dim=1)
    scale = ((hi - lo) / qmax).to(torch.float16).to(torch.float32)
    scale = torch.where(scale == 0, torch.ones_like(scale), scale)
    shift = lo.to(torch.float16).to(torch.float32)
    q = torch.clamp(torch.round((w - shift[:, None]) / scale[:, None]), 0,
                    qmax)
    return q.to(torch.uint8), scale, shift


def dequantize_rows(codes, scale, shift) -> torch.Tensor:
    return codes.to(torch.float32) * scale[:, None] + shift[:, None]
