"""The comparison that decides `correct`: the numbers a cell compares,
each held against its limit (`limits/<cell>.json`).

Training: the first checked step's loss (the later steps' losses swing
with the rounding of the first update: see PERF.md); per leaf, the norm
of the first step's gradient as the optimizer gets it and the norm of the
change after the checked steps. A leaf's gap is |program norm - reference norm| over
the larger of the reference's norm of that leaf and of the median leaf
(some gradients are all but zero). Leaves whose reference gradient is
under a thousandth of the median leaf's move by round-off alone under a
normalising optimizer and are left out of the change. Scoring: the
largest gap between a served score and the reference's, over the root
mean square of the reference's scores.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

STILL_LEAF = 1e-3  # a leaf's gradient under this share of the median's


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float],
               leaves: Sequence[str]) -> Tuple[float, str]:
    med = statistics.median(ref[n] for n in leaves)
    worst, at = 0.0, ""
    for n in leaves:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med)
        if not math.isfinite(gap):
            return math.inf, n
        if gap > worst:
            worst, at = gap, n
    return worst, at


def train_numbers(prog, ref) -> Dict[str, float]:
    """prog, ref: `reference.train.Readings` of the program and the
    reference."""
    return {k: v for k, (v, _) in train_gaps(prog, ref).items()}


def train_gaps(prog, ref) -> Dict[str, Tuple[float, str]]:
    """Each training number with where it was read: the later steps'
    largest loss gap (not compared), the worst leaf."""
    if len(prog.losses) != len(ref.losses) or not ref.losses:
        loss = (math.inf, "")
    else:
        gaps = [abs(p - r) / abs(r) for p, r in zip(prog.losses, ref.losses)]
        loss = (gaps[0], f"later steps {max(gaps[1:], default=0.0)!r}")
    leaves = sorted(ref.grad)
    med = statistics.median(ref.grad.values())
    moving = [n for n in leaves if ref.grad[n] >= STILL_LEAF * med]
    return {"loss_gap": loss,
            "grad_gap": worst_leaf(prog.grad, ref.grad, leaves),
            "change_gap": worst_leaf(prog.change, ref.change, moving)}


def score_gap(got: Sequence[torch.Tensor],
              ref: Sequence[torch.Tensor]) -> float:
    """The largest |served - reference| over the reference's RMS."""
    if len(got) != len(ref) or not ref:
        return math.inf
    diff = max(float((g.to(r.device) - r).abs().max())
               for g, r in zip(got, ref))
    rms = math.sqrt(sum(float((r * r).sum()) for r in ref)
                    / sum(r.numel() for r in ref))
    gap = diff / rms
    return gap if math.isfinite(gap) else math.inf


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Tuple[bool, List[Tuple[str, float, float]]]:
    """(every number within its limit, [(name, number, limit)])."""
    missing = sorted(set(limits) - set(numbers))
    if missing:
        raise KeyError(f"numbers not computed: {missing}")
    rows = [(n, numbers[n], limits[n]) for n in sorted(limits)]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
