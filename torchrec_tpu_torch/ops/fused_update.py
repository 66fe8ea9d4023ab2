"""Fused embedding optimizers: the sparse update of the training step.

Counterpart of torchrec_tpu/ops/fused_update.py. The table never gets a
dense [R, D] gradient: the train step hands the cotangent of the pooled
output to `apply_fused_update`, which combines the gradients of duplicate
ids in static shapes (sort + run totals, sentinels in place of `unique`,
so nothing waits for the device) and updates only the touched rows, in
place, through the kernels K2-K5 (ops/fused_update_kernels.py).

Ported: SGD, EXACT_SGD and ROWWISE_ADAGRAD on fp32 tables, routed as the
JAX package's Pallas route (`_apply_fused_update_pallas`) routes them, on
the card and on the CPU alike (on the CPU each kernel wrapper takes its
plain version). The fused_params keys are `eps`, `weight_decay`, `w_impl`
and `mom_impl`. The other optimizers and half-precision tables (which need
stochastic rounding) raise NotImplementedError: ROADMAP queue 1 item 4.
The JAX package's XLA route and its v5e cost-model levers (`compact`,
`unique_entries`, `mom_block_fracs`, `mom_max_block_share`, the split
momentum dispatch, wave sizes) are not ported: see ROADMAP.md.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Mapping, Optional, Tuple

import torch

from torchrec_tpu_torch.ops import fused_update_kernels as fk


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


PORTED_OPTIMS = (EmbOptimType.SGD, EmbOptimType.EXACT_SGD,
                 EmbOptimType.ROWWISE_ADAGRAD)
FUSED_PARAM_KEYS = ("eps", "weight_decay", "w_impl", "mom_impl")
# the skip sentinel of run_total_row_grads
RUN_SENTINEL = 2**31 - 1


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
    """Row-write form: "rmw" reads each touched row and its gradient and
    writes the row once, in one kernel (three row transfers per slot);
    "write" gathers the rows into an [N, D] buffer, computes the new rows
    into another and writes them with K2 (at least seven). So "auto" is
    "rmw"."""
    if w_impl not in ("auto", "rmw", "write"):
        raise ValueError(f"w_impl must be 'auto', 'rmw' or 'write', got "
                         f"{w_impl!r}")
    return "rmw" if w_impl == "auto" else w_impl


def _mom_stream(mom_impl: str) -> bool:
    """Rowwise momentum through K5 ("stream", one launch that moves each
    touched momentum word once) or torch index ops ("xla": a gather and a
    scatter-add). "auto" is "stream"."""
    if mom_impl not in ("auto", "stream", "xla"):
        raise ValueError(f"mom_impl must be 'auto', 'stream' or 'xla', got "
                         f"{mom_impl!r}")
    return mom_impl != "xla"


def check_trainable(optim: EmbOptimType, dtype: torch.dtype,
                    params: Mapping = ()) -> None:
    """Raise unless `apply_fused_update` takes this optimizer, table dtype
    and fused_params (checked before a train step changes anything)."""
    if optim not in PORTED_OPTIMS:
        raise NotImplementedError(
            f"fused optimizer {optim.name} is not ported yet (ROADMAP queue "
            "1 item 4); ported: SGD, EXACT_SGD, ROWWISE_ADAGRAD")
    if dtype != torch.float32:
        raise NotImplementedError(
            f"training {dtype} tables needs stochastic rounding, which is "
            "not ported yet (ROADMAP queue 1 item 4)")
    unknown = sorted(set(params) - set(FUSED_PARAM_KEYS))
    if unknown:
        raise NotImplementedError(
            f"fused_params {unknown} are not ported; the port takes "
            f"{list(FUSED_PARAM_KEYS)} (see ROADMAP.md)")
    _w_impl(params.get("w_impl", "auto"))
    _mom_stream(params.get("mom_impl", "auto"))


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
    sid, g, first = _sorted_runs(flat_ids, row_grads, valid, num_rows)
    # each slot's run's first position, JAX's cummax(where(first, pos, 0))
    # (PyTorch's cummax scans a 1-D tensor in one block on the card)
    run_start = torch.searchsorted(sid, sid)
    totals = _run_totals(g, run_start)
    uids = torch.where(first & (sid < num_rows), sid, RUN_SENTINEL)
    return uids.to(torch.int32), totals


def apply_fused_update(
    weights: torch.Tensor,
    opt_state: FusedOptimizerState,
    flat_ids: torch.Tensor,
    row_grads: torch.Tensor,
    valid: torch.Tensor,
    learning_rate: float,
    eps: float = 1.0e-8,
    weight_decay: float = 0.0,
    mom_impl: str = "auto",
    w_impl: str = "auto",
) -> Tuple[torch.Tensor, FusedOptimizerState]:
    """Apply one fused sparse optimizer step to the touched rows only.

    weights [R, D] f32; flat_ids [N] row ids into `weights`; row_grads
    [N, D] per-token gradients (before combining duplicates); valid [N]
    bool; learning_rate a Python float. The JAX function returns new
    arrays; this one updates `weights`, the momentum and the step IN PLACE
    and returns the same objects.

      SGD, EXACT_SGD:  w -= lr * (g + wd * w)
      ROWWISE_ADAGRAD: g += wd * w; m += mean(g^2);
                       w -= lr * g / (sqrt(m) + eps)

    with g the total gradient of each row. w_impl "auto"|"rmw"|"write" and
    mom_impl "auto"|"stream"|"xla" pick the kernels (see `_w_impl`,
    `_mom_stream`).
    """
    optim = opt_state.optim
    check_trainable(optim, weights.dtype,
                    {"w_impl": w_impl, "mom_impl": mom_impl})
    w_impl = _w_impl(w_impl)
    lr = float(learning_rate)
    R = weights.shape[0]
    if optim is EmbOptimType.ROWWISE_ADAGRAD:
        # the momentum step needs sorted compacted uids
        uids, g = dedup_row_grads(flat_ids, row_grads, valid, R)
        fk.fused_update_rowwise_adagrad(
            weights, opt_state.momentum1, uids, g, lr, eps=eps,
            weight_decay=weight_decay, momentum_stream=_mom_stream(mom_impl),
            w_impl=w_impl)
    else:
        uids, g = run_total_row_grads(flat_ids, row_grads, valid, R)
        if w_impl == "write":
            w_rows = weights[uids.clamp(max=R - 1).long()]
            if weight_decay:
                g = g + weight_decay * w_rows
            fk.scatter_rows_write(weights, uids, w_rows - lr * g)
        else:
            fk.fused_update_sgd(weights, uids, g, lr,
                                weight_decay=weight_decay)
    opt_state.step.add_(1)
    return weights, opt_state
