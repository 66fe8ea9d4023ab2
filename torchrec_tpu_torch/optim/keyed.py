"""FQN-keyed optimizer state, for checkpoints that survive resharding.

Counterpart of torchrec_tpu/optim/keyed.py. There the optimizer is an
optax transform and its state a pytree beside the params; here it is a
`torch.optim.Optimizer`, whose state is a dict keyed by the parameter
tensors. `KeyedOptimizer` keys that state by the parameters' module paths
instead:

* `flatten_with_fqns` / `unflatten_from_fqns` turn nested dicts, lists and
  tuples into a flat {"a/b/c": leaf} dict and back, with the keys of the
  JAX package's `_path_str` (dict keys and sequence indices joined by
  "/"); the load is strict.
* `KeyedOptimizer(optimizer, params)`: `state_dict()` is {"<param
  fqn>/<state name>": tensor} (Adam's "m.dense_arch.0.weight/exp_avg")
  plus the wrappers' own state under its string key ("__warmup/count");
  `load_state_dict(flat)` copies into that state in place and raises
  KeyError for a missing or an extra key.
* `CombinedOptimizer([(name, KeyedOptimizer | sharded module)])`: the
  dense state under "name/..." and each sharded module's packed momentum
  under "{name}/momentum/{sharding_type}"; its `step()` does nothing,
  because the DMP's train step takes the dense and the fused steps.

torch creates an optimizer's state at its first step; optax creates it at
`init`. `init_optimizer_state` creates the zero state that SGD, Adam and
AdamW would create (a step then does what it would have done from
nothing, as optax's does from `init`), so that a fresh optimizer already
has every key a strict load expects. `OptimizerWrapper` is the base of
the warmup and clipping wrappers: it shares its inner optimizer's
param_groups and state, so that clearing `state` (as the DMP's `init`
does) resets the inner moments and the wrappers' counters together.
"""

from __future__ import annotations

from typing import (Any, Callable, Dict, Iterable, List, Mapping, Optional,
                    Sequence, Tuple)

import numpy as np
import torch
from torch import nn

DenseOptimizerFactory = Callable[[Iterable[nn.Parameter]],
                                 torch.optim.Optimizer]


def flatten_with_fqns(tree: Any) -> Dict[str, Any]:
    """Nested dicts, lists and tuples -> {fqn: leaf}; None is no leaf, as in
    a JAX pytree."""
    out: Dict[str, Any] = {}

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, Mapping):
            items = node.items()
        elif isinstance(node, (list, tuple)):
            items = enumerate(node)
        else:
            out[prefix] = node
            return
        for k, v in items:
            walk(v, f"{prefix}/{k}" if prefix else str(k))

    walk(tree, "")
    return out


def unflatten_from_fqns(template: Any, flat: Mapping[str, Any],
                        strict: bool = True) -> Any:
    """Rebuild a tree shaped like `template` from {fqn: leaf}. Strict: every
    template leaf must be present and no extra key may remain; not strict,
    a missing leaf keeps the template's."""
    paths = flatten_with_fqns(template)
    if strict:
        missing = [p for p in paths if p not in flat]
        extra = [k for k in flat if k not in paths]
        if missing:
            raise KeyError(f"missing optimizer state keys: {missing[:5]}")
        if extra:
            raise KeyError(f"unexpected optimizer state keys: {extra[:5]}")

    def build(node, prefix):
        if node is None:
            return None
        if isinstance(node, Mapping):
            return type(node)((k, build(v, f"{prefix}/{k}" if prefix
                                        else str(k)))
                              for k, v in node.items())
        if isinstance(node, (list, tuple)):
            vals = [build(v, f"{prefix}/{i}" if prefix else str(i))
                    for i, v in enumerate(node)]
            return type(node)(vals)
        return flat.get(prefix, node)

    return build(template, "")


def _init_torch_state(opt: torch.optim.Optimizer) -> None:
    """The zero state SGD, Adam and AdamW create at their first step, for
    every parameter that has none; other optimizers are left as they are
    (Adagrad, for one, creates its state in its constructor)."""
    for group in opt.param_groups:
        for p in group["params"]:
            st = opt.state[p]
            if st:
                continue
            if isinstance(opt, torch.optim.SGD):
                if group["momentum"] == 0:
                    continue
                if group["dampening"] != 0:
                    raise NotImplementedError(
                        "SGD with dampening takes its first momentum from "
                        "the gradient: its state cannot start at zero")
                st["momentum_buffer"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
            elif isinstance(opt, (torch.optim.Adam, torch.optim.AdamW)):
                # as Adam._init_group makes it: a host f32 step unless the
                # optimizer is capturable or fused
                on_device = group["capturable"] or group["fused"]
                st["step"] = torch.zeros(
                    (), dtype=torch.float32,
                    device=p.device if on_device else "cpu")
                for name in ("exp_avg", "exp_avg_sq") + (
                        ("max_exp_avg_sq",) if group["amsgrad"] else ()):
                    st[name] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)


def init_optimizer_state(opt: torch.optim.Optimizer) -> None:
    """Create the state `opt` would create at its first step, where it has
    none yet; an OptimizerWrapper also creates its own."""
    if isinstance(opt, OptimizerWrapper):
        opt.init_state()
    else:
        _init_torch_state(opt)


class OptimizerWrapper(torch.optim.Optimizer):
    """An optimizer around `inner` that shares its param_groups and state;
    subclasses change `step`. Own state goes under a string key of the
    shared `state` (torch's state_dict keeps such keys as they are)."""

    def __init__(self, inner: torch.optim.Optimizer):
        # the inner optimizer's group dicts themselves, not copies
        super().__init__(inner.param_groups, inner.defaults)
        self.inner = inner
        self.state = inner.state

    def init_state(self) -> None:
        init_optimizer_state(self.inner)

    def base_optimizer(self) -> torch.optim.Optimizer:
        """The innermost optimizer, below every wrapper."""
        opt = self.inner
        while isinstance(opt, OptimizerWrapper):
            opt = opt.inner
        return opt

    @torch.no_grad()
    def step(self, closure: Optional[Callable] = None):
        return self.inner.step(closure)

    def load_state_dict(self, state_dict: Dict[str, Any]) -> None:
        # torch's load replaces state and param_groups: share them again
        self.inner.load_state_dict(state_dict)
        self.param_groups = self.inner.param_groups
        self.state = self.inner.state


class KeyedOptimizer:
    """A torch optimizer and the named parameters it steps, with its state
    keyed by parameter FQN (ref torchrec/optim/keyed.py:30-227).

    params: {fqn: parameter}, every parameter the optimizer holds."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 params: Mapping[str, nn.Parameter]):
        self.optimizer = optimizer
        self.params = dict(params)
        self._fqn = {id(p): name for name, p in self.params.items()}
        held = {id(p) for g in optimizer.param_groups for p in g["params"]}
        if held != set(self._fqn):
            raise ValueError("params must name exactly the parameters the "
                             "optimizer holds")
        self.init_state()

    def init_state(self) -> None:
        """Materialise the state before the first step (ref `init_state`,
        keyed.py:206-227; optax state is materialised at init)."""
        init_optimizer_state(self.optimizer)

    def step(self, closure: Optional[Callable] = None):
        return self.optimizer.step(closure)

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.optimizer.zero_grad(set_to_none=set_to_none)

    def _tree(self) -> Dict[str, Dict[str, Any]]:
        self.init_state()
        return {(self._fqn[id(k)] if isinstance(k, torch.Tensor) else k): v
                for k, v in self.optimizer.state.items()}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """{"<fqn>/<state name>": tensor}, the tensors themselves."""
        return {k: v for k, v in flatten_with_fqns(self._tree()).items()
                if isinstance(v, torch.Tensor)}

    @torch.no_grad()
    def load_state_dict(self, flat: Mapping[str, Any]) -> None:
        """Copy `flat` (tensors or arrays) into the state in place, each
        onto its tensor's device and dtype. Raises KeyError for a missing
        or an unexpected key before anything is copied."""
        current = self.state_dict()
        missing = [k for k in current if k not in flat]
        if missing:
            raise KeyError(f"missing optimizer state keys: {missing[:5]}")
        extra = [k for k in flat if k not in current]
        if extra:
            raise KeyError(f"unexpected optimizer state keys: {extra[:5]}")
        for k, t in current.items():
            v = flat[k]
            t.copy_(v if isinstance(v, torch.Tensor)
                    else torch.from_numpy(np.array(v)))


class KeyedOptimizerWrapper(KeyedOptimizer):
    """Build from named parameters and a factory params -> optimizer (ref
    keyed.py:328)."""

    def __init__(self, params: Mapping[str, nn.Parameter],
                 optim_factory: DenseOptimizerFactory):
        params = dict(params)
        super().__init__(optim_factory(list(params.values())), params)


class CombinedOptimizer:
    """The dense KeyedOptimizer and the fused embedding optimizers under one
    facade (ref keyed.py:236-325). Entries are (name, KeyedOptimizer) or
    (name, sharded module): the sharded module's fused step happens inside
    its update, so it contributes only its momenta to the state_dict."""

    def __init__(self, optims: Sequence[Tuple[str, Any]]):
        self._optims = list(optims)

    @property
    def optimizers(self) -> List[Tuple[str, Any]]:
        return self._optims

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """"{name}/{key}" for each KeyedOptimizer's state and
        "{name}/momentum/{sharding_type}" for each sharded module group's
        packed first momentum (none for EXACT_SGD), as the JAX
        CombinedOptimizer names them."""
        out: Dict[str, torch.Tensor] = {}
        for name, opt in self._optims:
            if isinstance(opt, KeyedOptimizer):
                for k, v in opt.state_dict().items():
                    out[f"{name}/{k}"] = v
            elif hasattr(opt, "strategies"):
                for strat in opt.strategies:
                    if strat.momentum1 is not None:
                        out[f"{name}/momentum/"
                            f"{strat.meta.sharding_type.value}"] = (
                                strat.momentum1)
        return out

    def step(self) -> None:
        """Nothing: the DMP's train step takes the dense step and each
        fused one (ref keyed.py:283-285, fused.py:15-31)."""
        return None
