"""Evaluation metrics: AUROC and accuracy for DLRM, HR@k and NDCG@k for
BERT4Rec.

Counterpart of torchrec_tpu/utils/metrics.py, with the same arithmetic
in numpy (float64 ranks, ties given their mid-rank), so that every value
equals JAX's. The inputs may be torch tensors (on any device) or numpy
arrays; the results are Python floats.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype in (torch.bfloat16, torch.float16)
                else x).numpy()
    return np.asarray(x)


def auroc(scores, labels) -> float:
    """Rank-based AUROC (the Mann-Whitney U statistic); tied scores share
    their mid-rank. NaN when one class is absent."""
    scores = np.asarray(_np(scores), np.float64).ravel()
    labels = _np(labels).ravel()
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty_like(order, dtype=np.float64)
    ranks[order] = np.arange(1, labels.size + 1)
    # each run of equal scores takes its mid-rank
    sorted_scores = scores[order]
    starts = np.flatnonzero(np.r_[True, sorted_scores[1:] != sorted_scores[:-1]])
    ends = np.r_[starts[1:], sorted_scores.size] - 1
    for i, j in zip(starts, ends):
        if j > i:
            ranks[order[i:j + 1]] = (i + 1 + j + 1) / 2.0
    u = ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))


def accuracy(scores, labels, threshold: float = 0.5) -> float:
    scores = _np(scores).ravel()
    labels = _np(labels).ravel()
    return float(((scores > threshold) == (labels > 0.5)).mean())


def hr_at_k(rankings, targets, k: int) -> float:
    """Hit rate: the fraction of rows whose target item is among the k
    best scores. rankings: [B, V] scores over items; targets: [B] ids."""
    rankings, targets = _np(rankings), _np(targets)
    topk = np.argpartition(-rankings, min(k, rankings.shape[1] - 1),
                           axis=1)[:, :k]
    return float((topk == targets[:, None]).any(axis=1).mean())


def ndcg_at_k(rankings, targets, k: int) -> float:
    """NDCG with one relevant item per row."""
    rankings, targets = _np(rankings), _np(targets)
    order = np.argsort(-rankings, axis=1)[:, :k]
    hit = order == targets[:, None]
    pos = hit.argmax(axis=1)
    gains = np.where(hit.any(axis=1), 1.0 / np.log2(pos + 2), 0.0)
    return float(gains.mean())
