"""Fused embedding optimizers: the sparse update of the training step.

Counterpart of torchrec_tpu/ops/fused_update.py. The table never gets a
dense [R, D] gradient: the train step hands the cotangent of the pooled
output to `apply_fused_update`, which combines the gradients of duplicate
ids in static shapes (sort + run totals, sentinels in place of `unique`,
so nothing waits for the device) and updates only the touched rows, in
place, through the kernels K2-K7 (ops/fused_update_kernels.py).

Every EmbOptimType trains fp32, bf16 and fp16 tables. On fp32 tables SGD,
EXACT_SGD, ROWWISE_ADAGRAD, ADAGRAD and ADAM route as the JAX package's
Pallas route (`_apply_fused_update_pallas`) routes them, on the card and
on the CPU alike (on the CPU each kernel wrapper takes its plain version).
PARTIAL_ROWWISE_ADAM, LAMB, PARTIAL_ROWWISE_LAMB and LARS_SGD have no
Pallas kernel (the JAX package runs them in XLA on the TPU too): they are
PyTorch ops on the same run-total form, masked as JAX's XLA route masks
them.

bf16 / fp16 tables follow JAX's XLA route, which is where the JAX package
trains them (its Pallas kernels take f32 only): momenta and gradients stay
f32 and each touched row is computed in f32 from its widened values. SGD
and EXACT_SGD go to K3h and ROWWISE_ADAGRAD to K4h
(ops/fused_update_kernels.py), which round the row stochastically when
`stochastic_rounding` is on (the default; ops/stochastic_rounding.py) and
to nearest, `half(w + half(upd))`, when it is off. The other six
optimizers never round stochastically, as in JAX: they are the PyTorch ops
of `_xla_update`, mirroring JAX's formulas, with the row written as
`half(w + half(upd))`. Two differences from JAX stay, by design
(ROADMAP.md section 3): SR-off SGD rounds each row's f32 total once where
JAX's weight-decay-free fast path rounds once per duplicate token, and the
SR bits are the port's own, one draw per (row, column) where JAX draws one
per sorted slot. `w_impl="write"` and `mom_impl="xla"` are not ported for
half tables.

The fused_params keys are `eps`, `weight_decay`, `beta1`, `beta2`, `eta`,
`momentum`, `stochastic_rounding` (no effect on fp32 tables, as in JAX),
`w_impl` and `mom_impl`. The JAX package's v5e cost-model levers
(`compact`, `unique_entries`, `mom_block_fracs`, `mom_max_block_share`,
the split momentum dispatch, wave sizes) are not ported: see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Optional, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.utils import tracing


class EmbOptimType(enum.Enum):
    SGD = "sgd"
    EXACT_SGD = "exact_sgd"
    ADAGRAD = "adagrad"
    ROWWISE_ADAGRAD = "rowwise_adagrad"
    ADAM = "adam"
    PARTIAL_ROWWISE_ADAM = "partial_rowwise_adam"
    LAMB = "lamb"
    PARTIAL_ROWWISE_LAMB = "partial_rowwise_lamb"
    LARS_SGD = "lars_sgd"


FUSED_PARAM_KEYS = ("eps", "weight_decay", "beta1", "beta2", "eta",
                    "momentum", "stochastic_rounding", "w_impl", "mom_impl")
# the skip sentinel of run_total_row_grads
RUN_SENTINEL = 2**31 - 1
# the span around the sort and segment sums that total each row's gradient
ROW_TOTALS_SPAN = "## update_row_totals ##"


@dataclasses.dataclass
class FusedOptimizerState:
    """Optimizer state living with the table.

    momentum1: [R] for ROWWISE_ADAGRAD, [R, D] for ADAGRAD/ADAM, None for
    SGD; momentum2: [R, D] for ADAM's second moment, else None; step: 0-d
    int32 tensor. The update changes these tensors in place.
    """

    momentum1: Optional[torch.Tensor]
    momentum2: Optional[torch.Tensor]
    step: torch.Tensor
    optim: EmbOptimType


def fused_state_shapes(optim: EmbOptimType) -> Tuple[str, str]:
    """(momentum1, momentum2) shape kinds: 'none' | 'row' [R] | 'full'
    [R, D]."""
    if optim in (EmbOptimType.SGD, EmbOptimType.EXACT_SGD):
        return "none", "none"
    if optim is EmbOptimType.ROWWISE_ADAGRAD:
        return "row", "none"
    if optim in (EmbOptimType.ADAGRAD, EmbOptimType.LARS_SGD):
        return "full", "none"
    if optim in (EmbOptimType.ADAM, EmbOptimType.LAMB):
        return "full", "full"
    if optim in (EmbOptimType.PARTIAL_ROWWISE_ADAM,
                 EmbOptimType.PARTIAL_ROWWISE_LAMB):
        return "full", "row"
    raise ValueError(f"unknown fused optimizer: {optim}")


def init_fused_optimizer_state(
    num_rows: int, dim: int, optim: EmbOptimType,
    dtype: torch.dtype = torch.float32, device=None,
) -> FusedOptimizerState:
    def make(kind):
        if kind == "row":
            return torch.zeros((num_rows,), dtype=dtype, device=device)
        if kind == "full":
            return torch.zeros((num_rows, dim), dtype=dtype, device=device)
        return None

    k1, k2 = fused_state_shapes(optim)
    return FusedOptimizerState(
        momentum1=make(k1), momentum2=make(k2),
        step=torch.zeros((), dtype=torch.int32, device=device), optim=optim)


def _w_impl(w_impl: str) -> str:
    """Row-write form: "rmw" reads each touched row, its momenta and its
    gradient and writes the row and momenta once, in one kernel (three
    row transfers per slot for SGD, five for ADAGRAD, seven for ADAM);
    "write" gathers them into [N, D] buffers, computes the new rows into
    others and writes each with K2 (more than twice as many). So "auto" is
    "rmw"."""
    if w_impl not in ("auto", "rmw", "write"):
        raise ValueError(f"w_impl must be 'auto', 'rmw' or 'write', got "
                         f"{w_impl!r}")
    return "rmw" if w_impl == "auto" else w_impl


def _mom_stream(mom_impl: str) -> bool:
    """Rowwise momentum in the same pass as the rows ("stream": with
    w_impl "rmw" one fused kernel does the whole update, with "write" K5
    moves each touched momentum word once) or through torch index ops
    ("xla": a gather and a scatter-add). "auto" is "stream"."""
    if mom_impl not in ("auto", "stream", "xla"):
        raise ValueError(f"mom_impl must be 'auto', 'stream' or 'xla', got "
                         f"{mom_impl!r}")
    return mom_impl != "xla"


def check_trainable(dtype: torch.dtype, params: Mapping = ()) -> None:
    """Raise unless `apply_fused_update` takes this table dtype and these
    fused_params (checked before a train step changes anything); every
    optimizer is ported, for fp32, bf16 and fp16 tables of any width D,
    on the card as on the CPU."""
    if dtype != torch.float32 and dtype not in fk.HALF_TYPES:
        raise TypeError(f"tables train in fp32, bf16 or fp16, not {dtype}")
    unknown = sorted(set(params) - set(FUSED_PARAM_KEYS))
    if unknown:
        raise NotImplementedError(
            f"fused_params {unknown} are not ported; the port takes "
            f"{list(FUSED_PARAM_KEYS)} (see ROADMAP.md)")
    w_impl = _w_impl(params.get("w_impl", "auto"))
    stream = _mom_stream(params.get("mom_impl", "auto"))
    if dtype in fk.HALF_TYPES and (w_impl == "write" or not stream):
        raise NotImplementedError(
            f"{dtype} tables train through K3h / K4h's read-modify-write "
            "with the streamed momentum only: w_impl='write' and "
            "mom_impl='xla' are not ported for them (ROADMAP queue 1)")


def pooled_grad_to_row_grads(
    d_pooled: torch.Tensor,
    lengths: torch.Tensor,
    max_length: int,
    pooling_is_mean: bool = False,
    per_sample_weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Expand the pooled-output cotangent [F, B, D] to per-token row
    gradients [F, B, L, D] (chain rule of the masked pooling sum)."""
    col = torch.arange(max_length, device=lengths.device)
    mask = (col[None, None, :] < lengths[:, :, None]).to(d_pooled.dtype)
    if per_sample_weights is not None:
        mask = mask * per_sample_weights.to(d_pooled.dtype)
    if pooling_is_mean:
        denom = lengths.to(d_pooled.dtype).clamp(min=1.0)
        mask = mask / denom[:, :, None]
    return d_pooled[:, :, None, :] * mask[:, :, :, None]


def _sorted_runs(flat_ids, row_grads, valid, num_rows):
    """Sort the slots by id (invalid ones keyed num_rows, so they sort
    last); stable, as JAX's sort_key_val. Returns (sorted ids, gradients
    in that order, run-first flags)."""
    ids = torch.where(valid, flat_ids, num_rows).to(torch.int32)
    sid, order = torch.sort(ids, stable=True)
    first = torch.ones_like(sid, dtype=torch.bool)
    first[1:] = sid[1:] != sid[:-1]
    return sid, row_grads[order], first


def _run_totals(g_sorted: torch.Tensor,
                run_start: torch.Tensor) -> torch.Tensor:
    """out[k] = sum of g_sorted[i] over i with run_start[i] == k; zeros
    elsewhere. A plain segment sum (the JAX package's chunked one-hot
    matmul is a TPU device)."""
    return torch.zeros_like(g_sorted).index_add_(0, run_start, g_sorted)


def dedup_row_grads(
    flat_ids: torch.Tensor, row_grads: torch.Tensor, valid: torch.Tensor,
    num_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine the gradients of duplicate ids, in static shapes.

    flat_ids [N] row ids; row_grads [N, D]; valid [N] bool. Returns
    (uids [N] int32, sums [N, D]): each real row once, sorted ascending, at
    the front; every other slot holds the distinct sentinel num_rows + pos,
    so uids are sorted AND unique.
    """
    N = flat_ids.shape[0]
    with tracing.span(ROW_TOTALS_SPAN):
        sid, g, first = _sorted_runs(flat_ids, row_grads, valid, num_rows)
        seg = torch.cumsum(first, 0) - 1  # compact run index, nondecreasing
        sums = _run_totals(g, seg)
        uids = torch.full_like(sid, num_rows).scatter_(0, seg, sid)
        pos = torch.arange(N, dtype=torch.int32, device=sid.device)
        uids = torch.where(uids >= num_rows, num_rows + pos, uids)
    return uids, sums


def run_total_row_grads(
    flat_ids: torch.Tensor, row_grads: torch.Tensor, valid: torch.Tensor,
    num_rows: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine the gradients of duplicate ids without compacting them.

    Each real row's total gradient lands at its run's first sorted
    position; duplicate and invalid slots carry the skip sentinel
    2**31 - 1. The uids are unique among real slots but not sorted, so
    this form feeds the per-slot kernels K2 and K3 only.
    """
    with tracing.span(ROW_TOTALS_SPAN):
        sid, g, first = _sorted_runs(flat_ids, row_grads, valid, num_rows)
        # each slot's run's first position, JAX's cummax(where(first, pos,
        # 0)) (PyTorch's cummax scans a 1-D tensor in one block on the card)
        run_start = torch.searchsorted(sid, sid)
        totals = _run_totals(g, run_start)
        uids = torch.where(first & (sid < num_rows), sid, RUN_SENTINEL)
        return uids.to(torch.int32), totals


def _add_rows(t: torch.Tensor, ids: torch.Tensor, fm: torch.Tensor,
              delta: torch.Tensor) -> None:
    """t[ids[i]] += delta[i] where fm[i], in place: the masked scatter-add
    of JAX's XLA route. Masked slots (sentinels clamped to row R - 1) add
    exact zeros and the real ids are unique, so the result does not
    depend on the order of the card's atomic adds."""
    mask = fm if delta.dim() == 1 else fm[:, None]
    t.index_add_(0, ids, torch.where(mask, delta, 0.0))


def _add_half_rows(weights: torch.Tensor, ids: torch.Tensor,
                   fm: torch.Tensor, w_rows: torch.Tensor,
                   upd: torch.Tensor) -> None:
    """weights[ids[i]] = half(w_rows[i] + half(upd[i])) where fm[i], in
    place: JAX's `weights.at[uids].add(upd.astype(weights.dtype))` on a
    half table (w_rows: the rows widened to f32). Every slot writes, so
    nothing waits for the device to count the real ones: a masked slot
    writes what the first real slot writes (or, with none, row R - 1's own
    value back), so all writers of a row agree."""
    new = (w_rows + upd.to(weights.dtype).float()).to(weights.dtype)
    new = torch.where(fm[:, None], new, weights[ids])
    pos = torch.arange(ids.shape[0], device=ids.device)
    rep = torch.where(fm, pos, fm.to(torch.uint8).argmax())
    weights.index_put_((ids[rep],), new[rep])


def _pow(beta: float, t: torch.Tensor) -> torch.Tensor:
    """beta**t in f32, as JAX raises a weak-typed Python float."""
    return torch.full_like(t, beta) ** t


def _f32(*xs: float) -> float:
    """The f32 product of Python floats, rounded at each step as JAX
    multiplies an f32 scalar by weak-typed floats (a Python product would
    round once, from double)."""
    out = np.float32(xs[0])
    for x in xs[1:]:
        out = out * np.float32(x)
    return float(out)


def _xla_update(weights, opt_state, uids, g, lr, eps, weight_decay,
                beta1, beta2, eta, momentum) -> None:
    """The optimizers that run as PyTorch ops on the run-total form, whose
    real slots are each touched row's first sorted position (JAX's `fm`):
    PARTIAL_ROWWISE_ADAM, LAMB, PARTIAL_ROWWISE_LAMB and LARS_SGD on every
    table, ADAGRAD and ADAM on bf16 / fp16 ones. JAX's XLA route
    (fused_update.py:660-809) term for term: f32 rows, momenta and
    gradients; an fp32 table takes the masked scatter-add of `upd`, a half
    table `half(w + half(upd))`."""
    optim = opt_state.optim
    R = weights.shape[0]
    fm = uids < R
    ids = uids.clamp(max=R - 1).long()
    w_rows = weights[ids].float()

    def write(upd):
        if weights.dtype == torch.float32:
            _add_rows(weights, ids, fm, upd)
        else:
            _add_half_rows(weights, ids, fm, w_rows, upd)

    m1 = opt_state.momentum1
    m1_rows = m1[ids]
    if optim in (EmbOptimType.ADAGRAD, EmbOptimType.ADAM) and weight_decay:
        g = g + (weight_decay * fm.float())[:, None] * w_rows
    if optim is EmbOptimType.ADAGRAD:
        _add_rows(m1, ids, fm, g * g)
        write(-lr * g / (torch.sqrt(m1[ids]) + eps))
        return
    if optim is EmbOptimType.LARS_SGD:
        w_norm = torch.linalg.vector_norm(w_rows, dim=1)
        g_norm = torch.linalg.vector_norm(g, dim=1)
        denom = g_norm + weight_decay * w_norm
        lr_adj = torch.where((w_norm > 0) & (denom > 0),
                             _f32(lr, eta) * w_norm / (denom + eps), lr)
        new_m1 = momentum * m1_rows + lr_adj[:, None] * (
            g + weight_decay * w_rows)
        write(-new_m1)
        _add_rows(m1, ids, fm, new_m1 - m1_rows)
        return
    rowwise = optim in (EmbOptimType.PARTIAL_ROWWISE_ADAM,
                        EmbOptimType.PARTIAL_ROWWISE_LAMB)
    m2 = opt_state.momentum2
    m2_rows = m2[ids]
    g_sq = (g * g).mean(dim=1) if rowwise else g * g
    new_m1 = beta1 * m1_rows + (1.0 - beta1) * g
    new_m2 = beta2 * m2_rows + (1.0 - beta2) * g_sq
    t = (opt_state.step + 1).to(torch.float32)
    m1_hat = new_m1 / (1.0 - _pow(beta1, t))
    m2_hat = new_m2 / (1.0 - _pow(beta2, t))
    denom = torch.sqrt(m2_hat)
    denom = (denom[:, None] if rowwise else denom) + eps
    if optim is EmbOptimType.ADAM:
        upd = (-lr * fm.float())[:, None] * m1_hat / denom
    elif optim is EmbOptimType.PARTIAL_ROWWISE_ADAM:
        upd = -lr * m1_hat / denom
        if weight_decay:
            upd = upd - _f32(lr, weight_decay) * w_rows
    else:  # LAMB, PARTIAL_ROWWISE_LAMB: per-row trust ratio
        rt = m1_hat / denom
        if weight_decay:
            rt = rt + weight_decay * w_rows
        w_norm = torch.linalg.vector_norm(w_rows, dim=1)
        r_norm = torch.linalg.vector_norm(rt, dim=1)
        trust = torch.where((w_norm > 0) & (r_norm > 0),
                            w_norm / (r_norm + eps), 1.0)
        upd = -lr * trust[:, None] * rt
    write(upd)
    _add_rows(m1, ids, fm, new_m1 - m1_rows)
    _add_rows(m2, ids, fm, new_m2 - m2_rows)


def apply_fused_update(
    weights: torch.Tensor,
    opt_state: FusedOptimizerState,
    flat_ids: torch.Tensor,
    row_grads: torch.Tensor,
    valid: torch.Tensor,
    learning_rate: float,
    eps: float = 1.0e-8,
    weight_decay: float = 0.0,
    beta1: float = 0.9,
    beta2: float = 0.999,
    eta: float = 0.001,
    momentum: float = 0.9,
    stochastic_rounding: bool = True,
    mom_impl: str = "auto",
    w_impl: str = "auto",
    sr_row_base: int = 0,
) -> Tuple[torch.Tensor, FusedOptimizerState]:
    """Apply one fused sparse optimizer step to the touched rows only.

    weights [R, D] f32, bf16 or fp16; flat_ids [N] row ids into `weights`;
    row_grads [N, D] per-token gradients (before combining duplicates),
    taken in f32; valid [N] bool; learning_rate a Python float. The JAX
    function returns new arrays; this one updates `weights`, the momentum
    and the step IN PLACE and returns the same objects.

      SGD, EXACT_SGD:  w -= lr * (g + wd * w)
      ROWWISE_ADAGRAD: g += wd * w; m += mean(g^2);
                       w -= lr * g / (sqrt(m) + eps)
      ADAGRAD:         g += wd * w; m += g^2; w -= lr * g / (sqrt(m) + eps)
      ADAM:            g += wd * w; m1 = b1 m1 + (1-b1) g;
                       m2 = b2 m2 + (1-b2) g^2;
                       w -= lr * m1_hat / (sqrt(m2_hat) + eps)
      PARTIAL_ROWWISE_ADAM: ADAM with rowwise m2 (mean of g^2), wd
                       applied as w -= lr * wd * w
      LAMB, PARTIAL_ROWWISE_LAMB: Adam ratio rt (+ wd * w), per-row trust
                       w -= lr * (|w| / |rt|) * rt
      LARS_SGD:        lr_adj = lr * eta * |w| / (|g| + wd * |w|);
                       m = momentum * m + lr_adj * (g + wd * w); w -= m

    with g the total gradient of each row and m_hat = m / (1 - b**t) at
    the incremented step t. w_impl "auto"|"rmw"|"write" and mom_impl
    "auto"|"stream"|"xla" pick the kernels (see `_w_impl`,
    `_mom_stream`). `stochastic_rounding` rounds a bf16 / fp16 table's
    SGD, EXACT_SGD and ROWWISE_ADAGRAD rows stochastically (see the module
    docstring) and has no effect on fp32 tables; its bits are keyed by
    `sr_row_base` + the row, the row's index across the group (a sharded
    strategy passes rank * its rows per shard, 0 on one device).
    """
    optim = opt_state.optim
    check_trainable(weights.dtype, {"w_impl": w_impl, "mom_impl": mom_impl})
    w_impl = _w_impl(w_impl)
    lr = float(learning_rate)
    R = weights.shape[0]
    row_grads = row_grads.to(torch.float32)
    if weights.dtype in fk.HALF_TYPES:
        _half_update(weights, opt_state, flat_ids, row_grads, valid, lr,
                     eps, weight_decay, beta1, beta2, eta, momentum,
                     stochastic_rounding, sr_row_base)
    elif optim is EmbOptimType.ROWWISE_ADAGRAD:
        # the momentum step needs sorted compacted uids
        uids, g = dedup_row_grads(flat_ids, row_grads, valid, R)
        fk.fused_update_rowwise_adagrad(
            weights, opt_state.momentum1, uids, g, lr, eps=eps,
            weight_decay=weight_decay, momentum_stream=_mom_stream(mom_impl),
            w_impl=w_impl)
    elif optim in (EmbOptimType.SGD, EmbOptimType.EXACT_SGD):
        uids, g = run_total_row_grads(flat_ids, row_grads, valid, R)
        if w_impl == "write":
            w_rows = weights[uids.clamp(max=R - 1).long()]
            if weight_decay:
                g = g + weight_decay * w_rows
            fk.scatter_rows_write(weights, uids, w_rows - lr * g)
        else:
            fk.fused_update_sgd(weights, uids, g, lr,
                                weight_decay=weight_decay)
    elif optim in (EmbOptimType.ADAGRAD, EmbOptimType.ADAM):
        uids, g = run_total_row_grads(flat_ids, row_grads, valid, R)
        m1, m2 = opt_state.momentum1, opt_state.momentum2
        step = opt_state.step + 1
        if w_impl == "rmw" and optim is EmbOptimType.ADAGRAD:
            fk.fused_update_adagrad(weights, m1, uids, g, lr, eps=eps,
                                    weight_decay=weight_decay)
        elif w_impl == "rmw":
            fk.fused_update_adam(weights, m1, m2, uids, g, lr, step,
                                 eps=eps, weight_decay=weight_decay,
                                 beta1=beta1, beta2=beta2)
        else:  # gather, compute, write each tensor with K2
            safe = uids.clamp(max=R - 1).long()
            if optim is EmbOptimType.ADAGRAD:
                new = fk.adagrad_rows(weights[safe], m1[safe], g, lr, eps,
                                      weight_decay)
                dsts = (weights, m1)
            else:
                new = fk.adam_rows(
                    weights[safe], m1[safe], m2[safe], g, lr,
                    fk.adam_bias_correction(step, beta1, beta2), eps,
                    weight_decay, beta1, beta2)
                dsts = (weights, m1, m2)
            for dst, rows in zip(dsts, new):
                fk.scatter_rows_write(dst, uids, rows)
    else:
        uids, g = run_total_row_grads(flat_ids, row_grads, valid, R)
        _xla_update(weights, opt_state, uids, g, lr, eps, weight_decay,
                    beta1, beta2, eta, momentum)
    opt_state.step.add_(1)
    return weights, opt_state


def _half_update(weights, opt_state, flat_ids, row_grads, valid, lr, eps,
                 weight_decay, beta1, beta2, eta, momentum,
                 stochastic_rounding, sr_row_base=0) -> None:
    """One step on a bf16 / fp16 table, before the step's increment: K4h
    (ROWWISE_ADAGRAD) or K3h (SGD, EXACT_SGD), rounding stochastically
    with the step's bits when `stochastic_rounding`, else to nearest; the
    other optimizers through `_xla_update`, to nearest, as in JAX."""
    optim = opt_state.optim
    R = weights.shape[0]
    if optim is EmbOptimType.ROWWISE_ADAGRAD:
        uids, g = dedup_row_grads(flat_ids, row_grads, valid, R)
        fk.fused_update_rowwise_adagrad_half(
            weights, opt_state.momentum1, uids, g, lr, opt_state.step,
            eps=eps, weight_decay=weight_decay,
            stochastic_rounding=stochastic_rounding, row_base=sr_row_base)
        return
    uids, g = run_total_row_grads(flat_ids, row_grads, valid, R)
    if optim in (EmbOptimType.SGD, EmbOptimType.EXACT_SGD):
        fk.fused_update_sgd_half(weights, uids, g, lr, opt_state.step,
                                 weight_decay=weight_decay,
                                 stochastic_rounding=stochastic_rounding,
                                 row_base=sr_row_base)
    else:
        _xla_update(weights, opt_state, uids, g, lr, eps, weight_decay,
                    beta1, beta2, eta, momentum)
