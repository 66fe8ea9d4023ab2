"""The port's linter and test utilities against the JAX package's.

The linter reads source as text: on every .py file of the JAX package,
and on tests/test_code_quality.py's bad classes, it gives JAX's issues,
and on the port it finds none. `random_padded_batch` and
`random_dense_tables` give JAX's values for a seed;
`assert_allclose_pytree` raises where JAX's raises.
"""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.linter import module_linter as jlint
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingBagConfig as JConfig,
)
from torchrec_tpu import test_utils as jtu
from torchrec_tpu_torch import test_utils as tu
from torchrec_tpu_torch.linter import module_linter as lint
from torchrec_tpu_torch.modules import EmbeddingBagConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_FILES = sorted((ROOT / "torchrec_tpu").rglob("*.py"))

BAD = {
    "no_doc": ("import flax.linen as nn\n"
               "class NoDoc(nn.Module):\n"
               "    def __call__(self, x):\n"
               "        return x\n"),
    "undocumented_args": ("import flax.linen as nn\n"
                          "class HasDoc(nn.Module):\n"
                          "    '''does things.'''\n"
                          "    def __call__(self, alpha_x, beta_y):\n"
                          "        return alpha_x + beta_y\n"),
    "torch_forward": ("from torch import nn\n"
                      "class T(nn.Module):\n"
                      "    '''a module.'''\n"
                      "    def forward(self, a_in, b_in, c_in):\n"
                      "        return a_in\n"
                      "class _Private(nn.Module):\n"
                      "    def forward(self, a, b):\n"
                      "        return a\n"),
    "many_fields": ("class P(PredictModule):\n"
                    "    '''many.'''\n"
                    + "".join(f"    f{i}: int = 0\n" for i in range(9))
                    + "    def update(self, x):\n        return x\n"),
    "clean": ("from torch import nn\n"
              "class C(nn.Module):\n"
              "    '''Args: x and y.'''\n"
              "    def forward(self, x, y):\n"
              "        return x\n"),
}
BAD_COUNTS = {"no_doc": 1, "undocumented_args": 1, "torch_forward": 1,
              "many_fields": 1, "clean": 0}


def test_linter_gives_jax_issues_on_the_jax_package():
    """Every .py file of torchrec_tpu/, read as text, one comparison of
    the whole list (the JAX package lints clean, so both are empty)."""
    got = [i for p in JAX_FILES for i in lint.linter_one_file(str(p))]
    want = [i for p in JAX_FILES for i in jlint.linter_one_file(str(p))]
    assert got == want
    assert len(JAX_FILES) > 60


@pytest.mark.parametrize("name", sorted(BAD))
def test_linter_gives_jax_issues_on_bad_files(tmp_path, name):
    path = tmp_path / f"{name}.py"
    path.write_text(BAD[name])
    got = lint.linter_one_file(str(path))
    assert got == jlint.linter_one_file(str(path))
    assert len(got) == BAD_COUNTS[name], got


def test_port_lints_clean():
    issues = [i for p in sorted((ROOT / "torchrec_tpu_torch").rglob("*.py"))
              for i in lint.linter_one_file(str(p))]
    assert not issues, "\n".join(issues)


def _tables(cls):
    return [cls(num_embeddings=n, embedding_dim=d, name=f"t{i}",
                feature_names=[f"f{i}", f"g{i}"][: 1 + i % 2])
            for i, (n, d) in enumerate(((30, 4), (7, 8), (100, 2)))]


@pytest.mark.parametrize("weighted", [False, True])
def test_random_padded_batch_is_jax(weighted):
    got = tu.random_padded_batch(_tables(EmbeddingBagConfig), 6, 3, seed=9,
                                 weighted=weighted)
    want = jtu.random_padded_batch(_tables(JConfig), 6, 3, seed=9,
                                   weighted=weighted)
    assert got.keys == tuple(want.keys)
    for a in ("ids", "lengths", "weights"):
        g, w = getattr(got, a), getattr(want, a)
        if w is None:
            assert g is None
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        assert g.numpy().dtype == np.asarray(w).dtype


def test_random_dense_tables_is_jax():
    got = tu.random_dense_tables(_tables(EmbeddingBagConfig), seed=2)
    want = jtu.random_dense_tables(_tables(JConfig), seed=2)
    assert list(got) == list(want)
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])


def _trees(lib):
    """(got, want) pairs and whether each comparison must raise, in the
    tensors of `lib` (torch for the port, jnp for JAX)."""
    t = torch.tensor if lib == "torch" else jnp.asarray
    base = {"a": t([1.0, 2.0]), "b": (t([3.0]), [t([4.0, 5.0])]),
            "c": None}
    return [
        (base, {"a": t([1.0, 2.0]), "b": (t([3.0]), [t([4.0, 5.0])]),
                "c": None}, None),
        (base, {"a": t([1.0, 2.0 + 1e-7]), "b": (t([3.0]),
                                                  [t([4.0, 5.0])]),
                "c": None}, None),
        (base, {"a": t([1.0, 2.1]), "b": (t([3.0]), [t([4.0, 5.0])]),
                "c": None}, AssertionError),
        (base, {"a": t([1.0, 2.0]), "b": (t([3.0]), [t([4.0, 5.0])])},
         ValueError),
        (base, {"a": t([1.0, 2.0]), "b": (t([3.0]), (t([4.0, 5.0]),)),
                "c": None}, ValueError),
        (base, {"a": t([1.0, 2.0]), "b": (t([3.0]), [t([4.0, 5.0]),
                                                     t([1.0])]),
                "c": None}, ValueError),
        (t([1.0, 2.0]), t([1.0, 2.0, 3.0]), AssertionError),
    ]


@pytest.mark.parametrize("case", range(7))
def test_assert_allclose_pytree_raises_where_jax_raises(case):
    results = []
    for lib, fn in (("torch", tu.assert_allclose_pytree),
                    ("jax", jtu.assert_allclose_pytree)):
        got, want, err = _trees(lib)[case]
        if err is None:
            fn(got, want)
        else:
            with pytest.raises(err):
                fn(got, want)
        results.append(err)
    assert results[0] == results[1]
