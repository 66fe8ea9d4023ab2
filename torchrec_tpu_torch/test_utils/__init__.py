"""Shared test helpers.

Counterpart of torchrec_tpu/test_utils/__init__.py: seeding, synthetic
sparse batches and tables for golden-parity tests, and a structure-aware
allclose. `random_padded_batch` and `random_dense_tables` draw from
`np.random.RandomState(seed)` in JAX's order, so they give JAX's values
for a seed; the batch is a port PaddedSparseBatch on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
import logging
import random
from typing import Any, Dict, Sequence

import numpy as np
import torch

from torchrec_tpu_torch.modules.embedding_configs import EmbeddingBagConfig
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, PaddedSparseBatch

logger = logging.getLogger(__name__)


def seed_and_log(fn):
    """Seed Python's, numpy's and torch's generators with one logged seed
    before each call of `fn`."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        seed = random.randint(0, 2**31)
        logger.info("Using random seed %d", seed)
        random.seed(seed)
        np.random.seed(seed % (2**32))
        torch.manual_seed(seed)
        return fn(*args, **kwargs)

    return wrapped


def random_padded_batch(
    tables: Sequence[EmbeddingBagConfig],
    batch_size: int,
    max_length: int,
    seed: int = 0,
    weighted: bool = False,
) -> PaddedSparseBatch:
    """A synthetic [F, B, L] sparse batch over the tables' features:
    lengths uniform in [0, L], ids uniform over each table's rows, f32
    weights in [0, 1) when `weighted`."""
    rng = np.random.RandomState(seed)
    feats = [f for t in tables for f in t.feature_names]
    rows = {f: t.num_embeddings for t in tables for f in t.feature_names}
    B, L = batch_size, max_length
    lengths = rng.randint(0, L + 1, size=(len(feats) * B,)).astype(np.int32)
    values = []
    for fi, f in enumerate(feats):
        for b in range(B):
            n = lengths[fi * B + b]
            values.extend(rng.randint(0, rows[f], size=(n,)).tolist())
    weights = rng.rand(len(values)).astype(np.float32) if weighted else None
    kjt = KeyedJaggedTensor.from_lengths(
        feats,
        torch.from_numpy(np.asarray(values, np.int32)),
        torch.from_numpy(lengths),
        weights=None if weights is None else torch.from_numpy(weights),
    )
    return kjt.to_padded(L)


def random_dense_tables(
    tables: Sequence[EmbeddingBagConfig], seed: int = 0
) -> Dict[str, np.ndarray]:
    """Unsharded per-table f32 weights, standard normal."""
    rng = np.random.RandomState(seed)
    return {
        t.name: rng.randn(t.num_embeddings, t.embedding_dim).astype(
            np.float32
        )
        for t in tables
    }


def _leaves(tree: Any, path: str = ""):
    """(path, leaf) pairs of a tree of dicts, tuples, lists and
    dataclasses, in order; None is an empty subtree, as in JAX."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name), f"{path}.{f.name}")
    else:
        yield path, tree


def _structure(tree: Any):
    """The tree's shape without its leaves."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _structure(tree[k])) for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__, tuple(_structure(v) for v in tree))
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__, tuple(
            (f.name, _structure(getattr(tree, f.name)))
            for f in dataclasses.fields(tree)))
    return "*"


def _np(x: Any) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.numpy()
    return np.asarray(x)


def assert_allclose_pytree(got, want, rtol=1e-5, atol=1e-6):
    """Structure-aware allclose for parameter / optimizer trees of tensors
    or arrays: raises ValueError where the structures differ, as
    `jax.tree.map` does, and AssertionError at the first leaf that is not
    close."""
    if _structure(got) != _structure(want):
        raise ValueError(
            f"tree structures differ: {_structure(got)} vs "
            f"{_structure(want)}")
    for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=rtol, atol=atol,
                                   err_msg=f"at {path or 'the root'}")
