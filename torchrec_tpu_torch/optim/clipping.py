"""Gradient clipping before the inner optimizer's step.

Counterpart of torchrec_tpu/optim/clipping.py (ref
torchrec/optim/clipping.py:163-199, GradientClippingOptimizer), with
optax's semantics, which are not `torch.nn.utils.clip_grad_norm_`'s:

* NORM (`optax.clip_by_global_norm`): the global norm is the square root
  of the sum of every gradient's squared elements; below `max_gradient`
  the gradients stay as they are, otherwise each becomes
  (g / norm) * max_gradient, with no epsilon. At norm == max_gradient the
  division and product run, as optax's do.
* VALUE (`optax.clip`): every element clamped to [-max, max].

The clip covers every parameter of the optimizer that has a gradient:
the DMP's dense parameters, a feature processor's included (the DMP adds
its gradient before the dense step). The norm is computed and applied on
the device, without a host sync; `last_norm` holds the last step's norm
(a 0-d tensor, or None before the first NORM step).
"""

from __future__ import annotations

import enum
from typing import Callable, Iterable, Optional

import torch
from torch import nn

from torchrec_tpu_torch.optim.keyed import (DenseOptimizerFactory,
                                            OptimizerWrapper)


class GradientClipping(enum.Enum):
    NONE = "none"
    NORM = "norm"
    VALUE = "value"


class GradientClippingOptimizer(OptimizerWrapper):
    """Clip the gradients, then take the inner optimizer's step."""

    def __init__(self, inner: torch.optim.Optimizer,
                 clipping: GradientClipping = GradientClipping.NONE,
                 max_gradient: float = 0.1):
        super().__init__(inner)
        self.clipping = clipping
        self.max_gradient = max_gradient
        self.last_norm: Optional[torch.Tensor] = None

    @torch.no_grad()
    def clip_(self) -> None:
        grads = [p.grad for g in self.param_groups for p in g["params"]
                 if p.grad is not None]
        if not grads or self.clipping is GradientClipping.NONE:
            return
        if self.clipping is GradientClipping.VALUE:
            for grad in grads:
                grad.clamp_(-self.max_gradient, self.max_gradient)
            return
        norm = torch.sqrt(sum(grad.square().sum() for grad in grads))
        keep = norm < self.max_gradient
        for grad in grads:
            grad.copy_(torch.where(keep, grad,
                                   (grad / norm) * self.max_gradient))
        self.last_norm = norm

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        if closure is not None:
            raise NotImplementedError("clipping takes no closure")
        self.clip_()
        return self.inner.step()


def gradient_clipping(inner_factory: DenseOptimizerFactory,
                      clipping: GradientClipping = GradientClipping.NONE,
                      max_gradient: float = 0.1) -> DenseOptimizerFactory:
    """A dense-optimizer factory: the inner factory's optimizer with its
    gradients clipped before each step (ref clipping.py:169)."""
    if not isinstance(clipping, GradientClipping):
        raise ValueError(clipping)

    def factory(params: Iterable[nn.Parameter]) -> torch.optim.Optimizer:
        inner = inner_factory(params)
        if clipping is GradientClipping.NONE:
            return inner
        return GradientClippingOptimizer(inner, clipping, max_gradient)

    return factory
