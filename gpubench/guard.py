"""The check that no run loads JAX or the JAX package.

Modules are compared by their top-level name, the part before the first
dot, as a whole word: `torchrec_tpu_torch` begins with `torchrec_tpu` and
is allowed."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "torchrec_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among module names (default: those
    loaded in this process)."""
    names = list(sys.modules) if names is None else names
    return sorted({n.split(".", 1)[0] for n in names} & FORBIDDEN)
