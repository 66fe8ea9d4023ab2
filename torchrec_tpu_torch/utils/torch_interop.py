"""Interop with reference TorchRec checkpoints (torch state_dicts).

Counterpart of torchrec_tpu/utils/torch_interop.py. A user migrating from
the reference holds `state_dict()`s whose tables live under module-FQN
keys like `model.sparse_arch.embedding_bag_collection.embedding_bags.
<table>.weight` (an EmbeddingBagCollection's `nn.ModuleDict` of
`nn.EmbeddingBag`s; an EmbeddingCollection's `embeddings.<table>.weight`).

`import_torch_state_dict` loads those tables into the port's
DistributedModelParallel, with JAX's matching rules: tables by name; a
table two modules hold goes to the module whose key shares the longest
path suffix with the torch module path, and a tie raises; a row-count
mismatch loads the overlapping prefix and is recorded in `partial_rows`;
a dim mismatch raises under `strict` (else it is skipped). The tables go
through `DMP.load_tables`, so the checkpoint's layout never needs to
match the plan. `import_dlrm_dense` maps the reference DLRM's MLP layers
onto the port's DLRM; both are `nn.Linear`, so the weights copy as they
are, without the transpose JAX's flax kernels need. `export_torch_state_dict`
writes the DMP's tables, the host-resident UVM tables included, under
reference FQNs, through `DMP.unsharded_state_dict`.

The input may be a `.pt` path, a module or a mapping.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional

import numpy as np
import torch
from torch import nn

from torchrec_tpu_torch.parallel.dmp import DistributedModelParallel
from torchrec_tpu_torch.parallel.sharded_ec import ShardedEmbeddingCollection

logger = logging.getLogger(__name__)

# <prefix>.embedding_bags.<table>.weight  (EBC)
# <prefix>.embeddings.<table>.weight      (EC)
_TABLE_KEY_RE = re.compile(
    r"^(?P<prefix>.*?)(?:^|\.)(?:embedding_bags|embeddings)"
    r"\.(?P<table>[^.]+)\.weight$"
)


def _to_numpy(v: Any) -> np.ndarray:
    """A tensor (bf16 / fp16 included) or array-like -> float32 numpy."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _ndim(v: Any) -> int:
    nd = getattr(v, "ndim", None)
    return int(nd) if nd is not None else np.asarray(v).ndim


def _load_mapping(sd: Any) -> Mapping[str, Any]:
    """A mapping, an nn.Module's state_dict, or a torch `.pt` file's."""
    if isinstance(sd, str) or hasattr(sd, "__fspath__"):
        obj = torch.load(sd, map_location="cpu", weights_only=True)
        if not isinstance(obj, Mapping):
            raise TypeError(f"torch.load({sd!r}) returned "
                            f"{type(obj).__name__}, expected a state_dict "
                            "mapping")
        return obj
    if isinstance(sd, nn.Module):
        return sd.state_dict()
    return sd


def _path_score(torch_prefix: str, module_key: str) -> int:
    """The common path suffix, in segments, of a torch module prefix
    (dots) and a DMP module key (slashes)."""
    a = [s for s in torch_prefix.replace("/", ".").split(".") if s]
    b = [s for s in module_key.split("/") if s]
    n = 0
    while n < min(len(a), len(b)) and a[-1 - n] == b[-1 - n]:
        n += 1
    return n


@dataclass
class ImportReport:
    """What an import did."""

    loaded: Dict[str, List[str]] = field(default_factory=dict)
    #: torch keys that matched no table (dense params, buffers, ...)
    skipped_keys: List[str] = field(default_factory=list)
    #: tables whose rows only partly overlapped the model's
    partial_rows: List[str] = field(default_factory=list)

    @property
    def num_tables(self) -> int:
        return sum(len(v) for v in self.loaded.values())


def extract_tables(sd: Any) -> Dict[str, Dict[str, np.ndarray]]:
    """{torch module prefix -> {table -> [rows, dim] float32}} of a
    reference state_dict."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for k, v in _load_mapping(sd).items():
        m = _TABLE_KEY_RE.match(k)
        if m is None or _ndim(v) != 2:
            continue
        out.setdefault(m.group("prefix").rstrip("."), {})[
            m.group("table")] = _to_numpy(v)
    return out


def import_torch_state_dict(dmp: DistributedModelParallel, sd: Any,
                            strict: bool = True) -> ImportReport:
    """Load a reference checkpoint's tables into the DMP (matching rules in
    the module docstring); dense entries are left alone and listed in
    `skipped_keys`. The loaded modules' fused optimizer state restarts, as
    after any `load_tables`."""
    mapping = _load_mapping(sd)
    by_prefix = extract_tables(mapping)
    if not by_prefix:
        raise ValueError(
            "no embedding tables found in the state dict (expected keys "
            "matching '...embedding_bags.<table>.weight' or "
            "'...embeddings.<table>.weight')")
    table_keys = {f"{p}.{t}" if p else t for p, ts in by_prefix.items()
                  for t in ts}
    # the current tables, also the base of a module's load
    current = {k.split("/", 1)[1]: dict(v)
               for k, v in dmp.unsharded_state_dict().items()
               if k.startswith("embeddings/")}
    owners: Dict[str, List[str]] = {}
    for mk, tabs in current.items():
        for t in tabs:
            owners.setdefault(t, []).append(mk)
    report = ImportReport()
    to_load: Dict[str, Dict[str, np.ndarray]] = {}
    for prefix, tabs in by_prefix.items():
        for tname, arr in tabs.items():
            cands = owners.get(tname, [])
            if not cands:
                report.skipped_keys.append(
                    f"{prefix + '.' if prefix else ''}{tname}.weight "
                    "(no such table here)")
                continue
            mk = cands[0]
            if len(cands) > 1:
                scored = sorted(((_path_score(prefix, c), c) for c in cands),
                                reverse=True)
                if scored[0][0] == scored[1][0]:
                    raise ValueError(
                        f"table {tname!r} is ambiguous between modules "
                        f"{[c for _, c in scored]} and the torch path "
                        f"{prefix!r} does not disambiguate")
                mk = scored[0][1]
            cur = current[mk][tname]
            if arr.shape[1] != cur.shape[1]:
                msg = (f"table {tname!r}: checkpoint dim {arr.shape[1]} != "
                       f"model dim {cur.shape[1]}")
                if strict:
                    raise ValueError(msg)
                logger.warning("%s: skipped", msg)
                report.skipped_keys.append(f"{tname}.weight ({msg})")
                continue
            if arr.shape[0] != cur.shape[0]:
                rows = min(arr.shape[0], cur.shape[0])
                merged = np.array(cur, np.float32, copy=True)
                merged[:rows] = arr[:rows]
                arr = merged
                report.partial_rows.append(tname)
            to_load.setdefault(mk, dict(current[mk]))[tname] = arr
            report.loaded.setdefault(mk, []).append(tname)
    for k, v in mapping.items():
        if _TABLE_KEY_RE.match(k) is None or _ndim(v) != 2:
            report.skipped_keys.append(k)
    if strict and not to_load:
        raise ValueError(
            f"no checkpoint table matched this model (checkpoint tables: "
            f"{sorted(table_keys)[:8]}...)")
    if to_load:
        dmp.load_tables(to_load)
    return report


# the reference DLRM's dense FQNs: DenseArch holds an MLP at .model,
# OverArch a Sequential(MLP, Linear) at .model; MLP layers are
# Perceptron._linear
_DLRM_DENSE_RE = re.compile(
    r"(?:^|\.)dense_arch\.model\._mlp\.(?P<i>\d+)\._linear"
    r"\.(?P<p>weight|bias)$")
_DLRM_OVER_MLP_RE = re.compile(
    r"(?:^|\.)over_arch\.model\.0\._mlp\.(?P<i>\d+)\._linear"
    r"\.(?P<p>weight|bias)$")
_DLRM_OVER_HEAD_RE = re.compile(
    r"(?:^|\.)over_arch\.model\.1\.(?P<p>weight|bias)$")


@torch.no_grad()
def import_dlrm_dense(dmp: DistributedModelParallel, sd: Any) -> List[str]:
    """Load a reference DLRM checkpoint's dense layers into the port's
    DLRM inside the DMP:

    * `dense_arch.model._mlp.<i>._linear` -> `dense_arch.mlp.perceptrons.<i>.linear`
    * `over_arch.model.0._mlp.<i>._linear` -> `over_arch.mlp.perceptrons.<i>.linear`
    * `over_arch.model.1` (the last Linear) -> `over_arch.head.linear`

    Both sides are `nn.Linear` ([out, in]), so nothing is transposed. The
    dense optimizer's state is left as it is. Returns the matched torch
    keys; raises for a shape mismatch or when nothing matches."""
    mapping = _load_mapping(sd)
    root = next((name for name, m in dmp.module.named_modules()
                 if hasattr(m, "dense_arch") and hasattr(m, "over_arch")),
                None)
    if root is None:
        raise ValueError("the model has no module holding dense_arch and "
                         "over_arch: import_dlrm_dense maps the DLRM only")
    params = dict(dmp.module.named_parameters())
    base = root + "." if root else ""
    matched: List[str] = []
    for k, v in mapping.items():
        for rex, target in (
                (_DLRM_DENSE_RE, "dense_arch.mlp.perceptrons.{i}.linear"),
                (_DLRM_OVER_MLP_RE, "over_arch.mlp.perceptrons.{i}.linear"),
                (_DLRM_OVER_HEAD_RE, "over_arch.head.linear")):
            m = rex.search(k)
            if m is None:
                continue
            name = base + target.format(**m.groupdict()) + "." + m.group("p")
            if name not in params:
                raise KeyError(f"dense param {name} not found in the model")
            arr = torch.as_tensor(_to_numpy(v))
            p = params[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"dense param {name}: checkpoint shape "
                                 f"{tuple(arr.shape)} != model shape "
                                 f"{tuple(p.shape)}")
            p.copy_(arr.to(p.dtype))
            matched.append(k)
            break
    if not matched:
        raise ValueError(
            "no reference DLRM dense params found (expected keys like "
            "'...dense_arch.model._mlp.0._linear.weight')")
    return matched


def export_torch_state_dict(dmp: DistributedModelParallel,
                            kind_attr: Optional[Dict[str, str]] = None,
                            as_torch: bool = True) -> Dict[str, Any]:
    """The trained tables (UVM tables included) under reference FQNs,
    `<module key with dots>.embedding_bags.<table>.weight` (pooled
    modules) or `.embeddings.<table>.weight` (sequence ECs); `kind_attr`
    overrides the container attribute per module key."""
    out: Dict[str, Any] = {}
    for k, tabs in dmp.unsharded_state_dict().items():
        if not k.startswith("embeddings/"):
            continue
        mk = k.split("/", 1)[1]
        attr = (kind_attr or {}).get(
            mk, "embeddings" if isinstance(dmp.sharded_ebcs[mk],
                                           ShardedEmbeddingCollection)
            else "embedding_bags")
        for tname, arr in tabs.items():
            arr = np.asarray(arr, np.float32)
            out[f"{mk.replace('/', '.')}.{attr}.{tname}.weight"] = (
                torch.from_numpy(arr.copy()) if as_torch else arr)
    return out
