"""Learning-rate warmup and decay policies over staged iteration ranges.

Counterpart of torchrec_tpu/optim/warmup.py (ref torchrec/optim/warmup.py
:21-147), with the same semantics:

* the multiplier is a function of the global iteration count, not of the
  progress within the stage;
* stage s applies while count <= s.max_iters; after the last stage an
  implicit NONE stage holds the base lr;
* `decay_iters` defaults to 1 for STEP and to max_iters otherwise; STEP
  decays by value ** (count // decay_iters), POLY by
  (1 - count / decay_iters) ** value, INVSQRT by 1 / sqrt(count), and
  INVSQRT at count 0 gives 1.0 (the reference divides by zero).

`make_warmup_schedule(stages, base_lr)` is a plain callable count ->
float that computes in float32 as the jnp version does (the Python
constants rounded to float32 where JAX takes them as weak types), so that
it serves unchanged as the DMP's fused `lr_schedule`. `schedule(count)`
is the lr of update number `count`, counted from 0.

`warmup_optimizer(inner_factory, stages, base_lr)` is a dense-optimizer
factory. optax's `chain(inner, scale_by_schedule)` multiplies the inner
update by schedule(count); here each step runs the inner optimizer with
every group's lr times schedule(count) and restores the lr after. That is
the same update up to rounding for SGD, Adam and AdamW, whose update is
linear in lr (weight decay included), so only those are accepted. The
count of updates lives in the optimizer's `state` under "__warmup", where
the DMP's `init` clears it with the inner moments.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Iterable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.optim.keyed import (DenseOptimizerFactory,
                                            OptimizerWrapper)

WARMUP_KEY = "__warmup"
# the optimizers whose update is linear in lr
LR_LINEAR = (torch.optim.SGD, torch.optim.Adam, torch.optim.AdamW)
_INT32_MAX = np.iinfo(np.int32).max


class WarmupPolicy(enum.Enum):
    NONE = "none"
    LINEAR = "linear"
    CONSTANT = "constant"
    POLY = "poly"
    STEP = "step"
    INVSQRT = "inv_sqrt"


@dataclasses.dataclass
class WarmupStage:
    """One stage: its policy, the last iteration it applies to, its value
    and lr scale, and (POLY, STEP) its decay_iters; <= 0 means the
    default."""

    policy: WarmupPolicy = WarmupPolicy.LINEAR
    max_iters: int = 1
    value: float = 1.0
    lr_scale: float = 1.0
    decay_iters: int = -1


def _normalize_stages(stages: Sequence[WarmupStage]) -> List[WarmupStage]:
    """Check that max_iters increases and fill in the decay_iters defaults
    (ref `_lr_stages`, warmup.py:43-60)."""
    out: List[WarmupStage] = []
    start_iter = 0
    for stage in stages:
        if stage.max_iters <= start_iter:
            raise ValueError(
                f"max_iters of stage {stage} must exceed the previous "
                f"max_iters {start_iter}"
            )
        start_iter = stage.max_iters
        decay = stage.decay_iters
        if decay <= 0:
            decay = 1 if stage.policy is WarmupPolicy.STEP else stage.max_iters
        out.append(dataclasses.replace(stage, decay_iters=decay))
    return out


def _pow(base: np.float32, exp: np.float32) -> np.float32:
    """float32 pow, correctly rounded as XLA's on the CPU is (numpy's
    float32 pow is off by an ulp now and then): taken in float64."""
    return np.float32(np.power(np.float64(base), np.float64(exp)))


def _stage_multiplier(stage: WarmupStage, it: np.float32) -> np.float32:
    """The stage's multiplier at global iteration `it`, in float32 (ref
    `_get_multiplier`, warmup.py:63-75)."""
    f32 = np.float32
    p = stage.policy
    if p is WarmupPolicy.NONE:
        m = f32(1.0)
    elif p is WarmupPolicy.LINEAR:
        m = f32(stage.value) + f32(1.0 - stage.value) * it / f32(
            stage.max_iters)
    elif p is WarmupPolicy.CONSTANT:
        m = f32(stage.value)
    elif p is WarmupPolicy.POLY:
        m = _pow(f32(1.0) - it / f32(stage.decay_iters), f32(stage.value))
    elif p is WarmupPolicy.STEP:
        m = _pow(f32(stage.value), np.floor(it / f32(stage.decay_iters)))
    elif p is WarmupPolicy.INVSQRT:
        m = f32(1.0) / np.sqrt(np.maximum(it, f32(1.0)))
    else:
        raise ValueError(p)
    return f32(m) * f32(stage.lr_scale)


def make_warmup_schedule(stages: Sequence[WarmupStage],
                         base_lr: float = 1.0) -> Callable[[int], float]:
    """schedule(count) -> the lr of update `count` (an int or a 0-d
    tensor), a float holding a float32 value."""
    stages = _normalize_stages(stages)
    lr = np.float32(base_lr)

    def schedule(count) -> float:
        it = np.float32(int(count))
        for stage in stages:
            if it <= np.float32(stage.max_iters):
                with np.errstate(invalid="ignore", divide="ignore"):
                    return float(lr * _stage_multiplier(stage, it))
        return float(lr)  # the implicit trailing NONE stage

    return schedule


class WarmupOptimizer(OptimizerWrapper):
    """The inner optimizer's update times schedule(count) (ref
    WarmupOptimizer, warmup.py:78). `inner` must be SGD, Adam or AdamW
    with float learning rates, possibly inside other wrappers."""

    def __init__(self, inner: torch.optim.Optimizer,
                 stages: Sequence[WarmupStage], base_lr: float = 1.0):
        super().__init__(inner)
        base = self.base_optimizer()
        if not isinstance(base, LR_LINEAR):
            raise NotImplementedError(
                f"warmup scales the lr of SGD, Adam or AdamW, whose update "
                f"is linear in lr; got {type(base).__name__}")
        if any(isinstance(g["lr"], torch.Tensor) for g in self.param_groups):
            raise NotImplementedError("warmup takes float learning rates")
        self.schedule = make_warmup_schedule(stages, base_lr)
        self.init_state()

    def init_state(self) -> None:
        super().init_state()
        st = self.state[WARMUP_KEY]
        if "count" not in st:
            st["count"] = torch.zeros((), dtype=torch.int32)

    @property
    def count(self) -> int:
        """Updates taken since the state was created or cleared."""
        self.init_state()
        return int(self.state[WARMUP_KEY]["count"])

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        self.init_state()
        count = self.state[WARMUP_KEY]["count"]
        scale = self.schedule(count)
        lrs = [g["lr"] for g in self.param_groups]
        for g, lr in zip(self.param_groups, lrs):
            g["lr"] = lr * scale
        try:
            loss = self.inner.step(closure)
        finally:
            for g, lr in zip(self.param_groups, lrs):
                g["lr"] = lr
        if int(count) < _INT32_MAX:  # optax's safe_int32_increment
            count += 1
        return loss


def warmup_optimizer(inner_factory: DenseOptimizerFactory,
                     stages: Sequence[WarmupStage],
                     base_lr: float = 1.0) -> DenseOptimizerFactory:
    """A dense-optimizer factory: the inner factory's optimizer under the
    staged schedule."""

    def factory(params: Iterable[nn.Parameter]) -> WarmupOptimizer:
        return WarmupOptimizer(inner_factory(params), stages, base_lr)

    return factory
