"""Carry a JAX DistributedModelParallel's weights into the port's DMP.

The JAX side hands over numpy arrays only, so this module imports no JAX:

* `dense_params`: the flax `params` tree of the DMP state (nested dicts of
  numpy arrays). A flax Dense `kernel` [in, out] becomes the port's
  `nn.Linear.weight` [out, in]; its `bias` is copied as is. Flax's
  auto-names map to the port's attributes: `MLP_0` -> `mlp`,
  `Perceptron_<i>` -> `perceptrons.<i>`, `Dense_0` -> `linear`.
* `tables`: {table name -> [R, D]} as the JAX
  `ShardedEmbeddingBagCollection.unshard_to_dense` returns it; each table
  goes to the port's sharded EBC that holds a table of that name.
* `opt_state` (optional): the whole fused optimizer state per table, as
  the JAX strategies' `unshard_opt_to_tables` returns it: {table name ->
  {"m1__full" [R, D] | "m1__row" [R], "m2__full" | "m2__row", "step"}},
  with the momenta `fused_state_shapes` gives the optimizer. Raises
  unless they match the port's. `fused_optimizer_state` reads the port's
  back in the same form, which the JAX strategies'
  `shard_opt_from_tables` loads.

Usage, with `state` the JAX DMP state:

    dense = jax.tree.map(np.asarray, state.dense_params)
    tables = jax_sebc.unshard_to_dense(state.emb_states[key])
    opt = {}
    for strat, group in zip(jax_sebc.strategies, state.emb_states[key]):
        opt.update(strat.unshard_opt_to_tables(group.opt))
    load_jax_weights(torch_dmp, dense, tables, opt_state=opt)
"""

from __future__ import annotations

import re
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from torchrec_tpu_torch.parallel.dmp import DistributedModelParallel


def _torch_segment(segment: str) -> str:
    if segment == "MLP_0":
        return "mlp"
    if segment == "Dense_0":
        return "linear"
    m = re.fullmatch(r"Perceptron_(\d+)", segment)
    return f"perceptrons.{m.group(1)}" if m else segment


def flax_dense_to_state_dict(
    dense_params: Mapping, prefix: str = ""
) -> Dict[str, np.ndarray]:
    """Flatten a flax Dense param tree into port parameter names."""
    out: Dict[str, np.ndarray] = {}
    for name, value in dense_params.items():
        if isinstance(value, Mapping):
            path = prefix + _torch_segment(name) + "."
            out.update(flax_dense_to_state_dict(value, path))
        elif name == "kernel":
            out[prefix + "weight"] = np.asarray(value).T
        elif name == "bias":
            out[prefix + "bias"] = np.asarray(value)
        else:
            raise ValueError(f"unexpected flax param {prefix}{name}")
    return out


def _per_module(dmp: DistributedModelParallel, what: str,
                per_table: Mapping[str, np.ndarray],
                ) -> Dict[str, Dict[str, np.ndarray]]:
    """Split {table -> array} by the sharded EBC that holds each table;
    raises unless the tables match the DMP's exactly."""
    owner = {t.name: key for key, sebc in dmp.sharded_ebcs.items()
             for t in sebc.tables}
    unknown = sorted(set(per_table) - set(owner))
    absent = sorted(set(owner) - set(per_table))
    if unknown or absent:
        raise ValueError(
            f"{what} do not match: unknown {unknown}, missing {absent}"
        )
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for name, w in per_table.items():
        out.setdefault(owner[name], {})[name] = w
    return out


@torch.no_grad()
def load_jax_weights(
    dmp: DistributedModelParallel,
    dense_params: Mapping,
    tables: Mapping[str, np.ndarray],
    opt_state: Optional[Mapping[str, Mapping[str, np.ndarray]]] = None,
) -> None:
    """Load the JAX DMP's dense params, unsharded tables and (optionally)
    fused optimizer state into `dmp`. Raises unless every dense parameter
    and every table is matched."""
    flat = flax_dense_to_state_dict(dense_params)
    params = dict(dmp.module.named_parameters())
    missing = sorted(set(params) - set(flat))
    unexpected = sorted(set(flat) - set(params))
    if missing or unexpected:
        raise ValueError(
            f"dense params do not match: missing {missing}, "
            f"unexpected {unexpected}"
        )
    for name, p in params.items():
        src = torch.tensor(flat[name])
        if src.shape != p.shape:
            raise ValueError(
                f"{name}: JAX shape {tuple(src.shape)}, port {tuple(p.shape)}"
            )
        p.copy_(src)
    dmp.load_tables(_per_module(dmp, "tables", tables))
    if opt_state is not None:
        for key, st in _per_module(dmp, "optimizer states",
                                   opt_state).items():
            dmp.sharded_ebcs[key].shard_opt_from_tables(st)


def fused_optimizer_state(
    dmp: DistributedModelParallel,
) -> Dict[str, Dict[str, np.ndarray]]:
    """{table -> {"m1__...", "m2__...", "step"}}: the port's fused
    optimizer state in the form of the JAX strategies'
    `unshard_opt_to_tables`."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for sebc in dmp.sharded_ebcs.values():
        out.update(sebc.unshard_opt_to_tables())
    return out
