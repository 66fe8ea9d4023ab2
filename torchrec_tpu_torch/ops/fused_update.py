"""Fused embedding optimizers.

Counterpart of torchrec_tpu/ops/fused_update.py. The serving slice only
needs the optimizer vocabulary, which DistributedModelParallel accepts and
stores;
the update path itself (`apply_fused_update` and the row-update kernels
K2-K5) belongs to the training slice and is not ported yet.
"""

from __future__ import annotations

import enum


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
