"""Module-construction helpers (ref torchrec/modules/utils.py:14-120).

Counterpart of torchrec_tpu/modules/utils.py, with the same six names and
torch's semantics: a module factory is instantiated, the output width is
probed by running the module, xavier initialisation is applied to a
tensor in place, and one module is deep-copied (and re-initialised) into
nested `nn.ModuleList`s. `get_module_output_dimension` runs the module on
the `meta` device with its parameters and buffers swapped for meta
tensors, so it allocates nothing and computes nothing, as the JAX version
(`jax.eval_shape`) probes shapes only.
"""

from __future__ import annotations

import copy
import inspect
from typing import Any, Callable, List, Optional, Sequence, Set, Tuple, Union

import torch
from torch import nn


def extract_module_or_tensor_callable(
    module_or_callable: Union[Callable[[], nn.Module], nn.Module, Callable],
) -> Union[nn.Module, Callable]:
    """ref modules/utils.py:14-37. A module instance as it is; a module
    class instantiated with no arguments; another callable over tensors
    as it is."""
    if isinstance(module_or_callable, nn.Module):
        return module_or_callable
    if isinstance(module_or_callable, type):
        inst = module_or_callable()
        if not isinstance(inst, nn.Module):
            raise ValueError("the class provided is not an nn.Module class")
        return inst
    if callable(module_or_callable):
        return module_or_callable
    raise ValueError(
        "module_or_callable must be an nn.Module, a Module factory, or a "
        "callable over tensors"
    )


def get_module_output_dimension(
    module: Union[nn.Module, Callable], in_features: int
) -> int:
    """ref modules/utils.py:38-46: the last dim of the module's output for
    a [1, in_features] float32 input, probed on the meta device."""
    x = torch.empty(1, in_features, device="meta")
    if isinstance(module, nn.Module):
        meta = {name: torch.empty_like(t, device="meta")
                for name, t in (*module.named_parameters(),
                                *module.named_buffers())}
        out = torch.func.functional_call(module, meta, (x,))
    else:
        out = module(x)
    return int(out.shape[-1])


def check_module_output_dimension(
    module: Union[Sequence[Any], nn.Module, Callable],
    in_features: int,
    out_features: int,
) -> bool:
    """ref modules/utils.py:47-68: whether the module, or every module of a
    list, tuple or ModuleList, maps [*, in_features] to
    [*, out_features]."""
    if isinstance(module, (list, tuple, nn.ModuleList)):
        return all(
            check_module_output_dimension(m, in_features, out_features)
            for m in module
        )
    return get_module_output_dimension(module, in_features) == out_features


def xavier_uniform_init() -> Callable[..., torch.Tensor]:
    """ref modules/utils.py:69-74: the initializer init(weight,
    generator=None) that draws a weight in place from U(-a, a), a =
    sqrt(6 / (fan_in + fan_out)), the bound of flax's xavier_uniform."""

    def init(weight: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        with torch.no_grad():
            return nn.init.xavier_uniform_(weight, generator=generator)

    return init


def _reset(module: nn.Module) -> None:
    reset = getattr(module, "reset_parameters", None)
    if reset is not None:
        reset()


def construct_modulelist_from_single_module(
    module: nn.Module, sizes: Tuple[int, ...]
) -> nn.ModuleList:
    """ref modules/utils.py:75-98: `module` deep-copied into nested
    ModuleLists of `sizes`, each copy re-initialised (reset_parameters of
    every submodule that has one)."""
    if not sizes:
        return nn.ModuleList()
    if len(sizes) == 1:
        return nn.ModuleList(copy.deepcopy(module).apply(_reset)
                             for _ in range(sizes[0]))
    return nn.ModuleList(
        construct_modulelist_from_single_module(module, sizes[1:])
        for _ in range(sizes[0])
    )


def convert_list_of_modules_to_modulelist(
    modules: Sequence[nn.Module], sizes: Tuple[int, ...]
) -> nn.ModuleList:
    """ref modules/utils.py:99-120: a flat sequence of modules reshaped
    into nested ModuleLists of `sizes`."""
    total = 1
    for s in sizes:
        total *= s
    if len(modules) != total:
        raise ValueError(
            f"the numbers of modules ({len(modules)}) do not match "
            f"the sizes {sizes}"
        )
    if len(sizes) == 1:
        return nn.ModuleList(modules)
    inner = total // sizes[0]
    return nn.ModuleList(
        convert_list_of_modules_to_modulelist(
            modules[i * inner:(i + 1) * inner], sizes[1:]
        )
        for i in range(sizes[0])
    )


def seeded_reset(m: nn.Module) -> Optional[Callable]:
    """m.reset_parameters when it takes a `generator`, else None."""
    reset = getattr(m, "reset_parameters", None)
    if reset is None or "generator" not in inspect.signature(
            reset).parameters:
        return None
    return reset


def drawn_by(m: nn.Module) -> List[nn.Parameter]:
    """The parameters a module's seeded reset_parameters draws: its own and
    those of the descendants that have no seeded reset of their own (a
    Perceptron's nn.Linear)."""
    out = list(m.parameters(recurse=False))
    for child in m.children():
        if seeded_reset(child) is None:
            out.extend(drawn_by(child))
    return out


def reset_seeded(module: nn.Module,
                 generator: Optional[torch.Generator]) -> Set[int]:
    """Call the seeded reset_parameters of `module` and of each of its
    descendants, in `modules()` order, with `generator`; the ids of the
    parameters they drew."""
    drawn: Set[int] = set()
    for m in module.modules():
        reset = seeded_reset(m)
        if reset is not None:
            reset(generator=generator)
            drawn.update(id(p) for p in drawn_by(m))
    return drawn
