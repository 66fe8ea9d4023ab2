"""The port's tracing: profiler spans and the launch-counter registry.

A span is a `torch.profiler` user annotation named `## <name> ##`, so it
shares the kineto clock with the device trace, and a trace reader matches
device operations to spans by their launch times. `span(name)` returns a
`record_function` while a torch profiler collects and one shared no-op
context otherwise: untraced, a span costs a flag check, with no call into
the dispatcher. Callers build each name once (a module constant, or in
`__init__`), not on every call.

`ModuleSpan` runs a part of the dense model under its span and, while a
profiler collects with grad enabled, brackets the part's backward in a
`## <name>.bwd ##` span: one identity autograd node on the part's output
opens it, and identity nodes on each of the part's inputs that needs grad
close it, the last of them to run. A part none of whose inputs needs grad
(the first layers of a model) closes it when the gradients of all its
parameters are computed. Autograd runs the nodes of one device on one
thread, newest first, so the span holds the part's backward operations
and launches. With no profiler, or under `no_grad` / `inference_mode`, no
node is added: the autograd graph is exactly the untraced one.

`count(name, n)` adds to the process's one registry of kernel launches
and collective calls (`tbe_lookup`, `fused_update_adam`, `comm.all_gather`,
...); `counts()` returns a copy of it, and readers take differences of
two copies.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()


def span(name: str):
    """A `record_function(name)` while a torch profiler collects; the one
    shared no-op context otherwise."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _NULL


class _BackwardSpan:
    """One part's `.bwd` span in one backward pass: opened by the output's
    identity node, closed by the last input node to run, or by the hook on
    the part's parameters where no input needs grad."""

    def __init__(self, name: str):
        self.name = name
        self.inputs = 0  # identity nodes on the part's inputs
        self.left = 0
        self.rf: Optional[_profiler.record_function] = None
        self.hook = None

    def open(self) -> None:
        self._end()
        self.left = self.inputs
        self.rf = _profiler.record_function(self.name)
        self.rf.__enter__()

    def input_done(self) -> None:
        self.left -= 1
        if self.left <= 0:
            self._end()

    def _end(self) -> None:
        if self.rf is not None:
            self.rf.__exit__(None, None, None)
            self.rf = None

    def close(self, *_) -> None:
        """The parameters' hook: end the span and remove the hook, which
        lives on leaf tensors and would otherwise outlast the step."""
        self._end()
        if self.hook is not None:
            self.hook.remove()
            self.hook = None


class _Mark(torch.autograd.Function):
    """The identity; its backward calls `hit` (a span's open or one of its
    inputs' close)."""

    @staticmethod
    def forward(ctx, x, hit):
        ctx.hit = hit
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        ctx.hit()
        return g, None


def _close_on(x: Any, state: _BackwardSpan) -> Any:
    """x, or a list / tuple of tensors, with a closing identity node on
    each tensor that needs grad."""
    if isinstance(x, (list, tuple)):
        return type(x)(_close_on(t, state) for t in x)
    if isinstance(x, torch.Tensor) and x.requires_grad:
        state.inputs += 1
        return _Mark.apply(x, state.input_done)
    return x


class ModuleSpan:
    """`## <name> ##` around a part of the dense model and, while traced
    with grad enabled, `## <name>.bwd ##` around its backward (see the
    module docstring). Build it once; on each forward call it with the
    part and its arguments, where `part(*args)` returns a tensor."""

    def __init__(self, name: str):
        self.name = f"## {name} ##"
        self.bwd = f"## {name}.bwd ##"

    def __call__(self, part: Callable, *args):
        if not _profiler._is_profiler_enabled:
            return part(*args)
        with _profiler.record_function(self.name):
            if not torch.is_grad_enabled():
                return part(*args)
            state = _BackwardSpan(self.bwd)
            out = part(*(_close_on(a, state) for a in args))
            if not out.requires_grad:
                return out
            if not state.inputs:
                params = ([p for p in part.parameters() if p.requires_grad]
                          if isinstance(part, nn.Module) else [])
                if not params:
                    return out
                state.hook = torch.autograd.graph.register_multi_grad_hook(
                    params, state.close)
            return _Mark.apply(out, state.open)


_COUNTS: Dict[str, int] = {}
_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` (a kernel's launches, a collective's
    calls)."""
    with _LOCK:
        _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> Dict[str, int]:
    """A copy of every counter counted so far in this process."""
    with _LOCK:
        return dict(_COUNTS)
