"""The port's sparse batch, lookup ops and K1 wrapper against the JAX
package, on the CPU.

Inputs are made from a seed with numpy and handed to both sides. K1 is
held against the Pallas kernel run in interpret mode (as tests/test_pallas.py
runs it); on CPU tensors the port's wrapper takes its plain PyTorch
version. Tolerances: one id per bag is a copy and must match bit for bit;
longer bags differ only in summation order (rtol=atol=1e-6 in fp32); bf16
tables round their coefficients to bf16 on both sides (rtol=1e-2).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import embedding as jemb
from torchrec_tpu.ops import pallas_embedding as pe
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.ops import embedding as temb
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.sparse import KeyedJaggedTensor as TKJT
from torchrec_tpu_torch.sparse import KeyedTensor as TKT
from torchrec_tpu_torch.utils import tracing

R, D = 200, 32


def _k1_inputs(L, kind, seed=0):
    rng = np.random.RandomState(seed)
    NB = 40
    w = rng.randn(R, D).astype(np.float32)
    # ids past both ends must clamp to [0, R-1]
    ids = rng.randint(-5, R + 20, size=(NB, L)).astype(np.int32)
    lengths = rng.randint(0, L + 1, size=(NB,))
    valid = np.arange(L)[None, :] < lengths[:, None]
    if kind == "mean":
        coeff = valid / np.maximum(lengths, 1)[:, None]
    else:  # per-sample weights
        coeff = valid * rng.rand(NB, L)
    # padded slots carry coefficient 0
    return w, ids, coeff.astype(np.float32)


@pytest.mark.parametrize("kind", ["mean", "psw"])
@pytest.mark.parametrize("L", [1, 3, 8])
def test_k1_matches_pallas_interpret(L, kind):
    w, ids, coeff = _k1_inputs(L, kind)
    ref = np.asarray(pe.tbe_lookup_pooled(
        jnp.asarray(w), jnp.asarray(ids), jnp.asarray(coeff), interpret=True))
    launches = tracing.counts()
    out = tl.tbe_lookup_pooled(torch.as_tensor(w), torch.as_tensor(ids),
                               torch.as_tensor(coeff)).numpy()
    assert tracing.counts() == launches  # CPU tensors take the plain version
    if L == 1:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize(
    "bad",
    ["w_dtype", "ids_dtype", "coeff_shape", "noncontig", "ids_1d"],
)
def test_k1_wrapper_rejects_bad_inputs(bad):
    w = torch.zeros(10, 8)
    ids = torch.zeros(4, 2, dtype=torch.int32)
    coeff = torch.ones(4, 2)
    if bad == "w_dtype":
        w = w.double()
    elif bad == "ids_dtype":
        ids = ids.long()
    elif bad == "coeff_shape":
        coeff = torch.ones(4, 3)
    elif bad == "noncontig":
        w = torch.zeros(8, 10).t()
    elif bad == "ids_1d":
        ids, coeff = ids.reshape(-1), coeff.reshape(-1)
    with pytest.raises((TypeError, ValueError)):
        tl.tbe_lookup_pooled(w, ids, coeff)


def _lookup_inputs(dtype, weighted, F=None, seed=1):
    rng = np.random.RandomState(seed)
    B, L = 24, 3
    lead = (B,) if F is None else (F, B)
    w = rng.randn(R, D).astype(np.float32)
    ids = rng.randint(0, R, size=lead + (L,)).astype(np.int32)
    lengths = rng.randint(0, L + 1, size=lead).astype(np.int32)
    psw = rng.rand(*lead, L).astype(np.float32) if weighted else None
    jw = jnp.asarray(w, dtype=jnp.bfloat16 if dtype == "bf16" else None)
    tw = torch.as_tensor(w)
    if dtype == "bf16":
        tw = tw.to(torch.bfloat16)
    return jw, tw, ids, lengths, psw


def _tol(dtype):
    return dict(rtol=1e-2, atol=1e-2) if dtype == "bf16" else dict(
        rtol=1e-6, atol=1e-6)


def _opt(x, fn):
    return None if x is None else fn(x)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pooling", ["SUM", "MEAN"])
def test_embedding_bag_lookup_matches_jax(pooling, weighted, dtype):
    jw, tw, ids, lengths, psw = _lookup_inputs(dtype, weighted)
    ref = jemb.embedding_bag_lookup(
        jw, jnp.asarray(ids), jnp.asarray(lengths),
        jemb.PoolingMode[pooling], _opt(psw, jnp.asarray))
    with torch.no_grad():
        out = temb.embedding_bag_lookup(
            tw, torch.as_tensor(ids), torch.as_tensor(lengths),
            temb.PoolingMode[pooling], _opt(psw, torch.as_tensor))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               **_tol(dtype))


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("pooling", ["SUM", "MEAN"])
def test_batched_embedding_lookup_matches_jax(pooling, weighted, dtype):
    F = 3
    jw, tw, ids, lengths, psw = _lookup_inputs(dtype, weighted, F=F)
    ids = ids % 60  # three tables of 60, 70 and 70 rows in one array
    rows = [60, 70, 70]
    ref = jemb.batched_embedding_lookup(
        jw, jnp.asarray(ids), jnp.asarray(lengths),
        jemb.make_row_offsets(rows), jemb.PoolingMode[pooling],
        _opt(psw, jnp.asarray))
    offs = temb.make_row_offsets(rows)
    np.testing.assert_array_equal(offs.numpy(),
                                  np.asarray(jemb.make_row_offsets(rows)))
    with torch.no_grad():
        out = temb.batched_embedding_lookup(
            tw, torch.as_tensor(ids), torch.as_tensor(lengths), offs,
            temb.PoolingMode[pooling], _opt(psw, torch.as_tensor))
    assert out.shape == (F, ids.shape[1], D)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref, np.float32),
                               **_tol(dtype))


def _kjt_inputs(seed, weighted, empty=False):
    rng = np.random.RandomState(seed)
    keys = ["a", "b", "c"]
    B = 7
    lengths = (np.zeros(len(keys) * B, np.int32) if empty
               else rng.randint(0, 5, size=len(keys) * B).astype(np.int32))
    values = rng.randint(0, 1000, size=int(lengths.sum())).astype(np.int32)
    weights = (rng.rand(values.shape[0]).astype(np.float32)
               if weighted else None)
    return keys, values, lengths, weights


@pytest.mark.parametrize("case", ["plain", "weighted", "empty"])
@pytest.mark.parametrize("L", [1, 3])
def test_kjt_to_padded_matches_jax(case, L):
    keys, values, lengths, weights = _kjt_inputs(
        L, case == "weighted", empty=case == "empty")
    j = JKJT.from_lengths(keys, jnp.asarray(values), jnp.asarray(lengths),
                          _opt(weights, jnp.asarray)).to_padded(L)
    t = TKJT.from_lengths(keys, values, lengths, weights).to_padded(L)
    assert t.keys == j.keys
    assert t.ids.dtype == torch.int32 and t.lengths.dtype == torch.int32
    np.testing.assert_array_equal(t.ids.numpy(), np.asarray(j.ids))
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    if weights is not None:
        np.testing.assert_array_equal(t.weights.numpy(),
                                      np.asarray(j.weights))
    np.testing.assert_array_equal(t.mask().numpy(), np.asarray(j.mask()))


def test_kjt_views_match_jax():
    keys, values, lengths, weights = _kjt_inputs(5, True)
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    j = JKJT.from_offsets(keys, jnp.asarray(values), jnp.asarray(offsets),
                          jnp.asarray(weights))
    t = TKJT.from_offsets(keys, values, offsets, weights)
    np.testing.assert_array_equal(t.lengths.numpy(), np.asarray(j.lengths))
    np.testing.assert_array_equal(t.offsets.numpy(), np.asarray(j.offsets))
    np.testing.assert_array_equal(t.length_per_key().numpy(),
                                  np.asarray(j.length_per_key()))
    for k in keys:
        jt, tt = j[k], t.to_dict()[k]
        np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))
        np.testing.assert_array_equal(tt.lengths.numpy(),
                                      np.asarray(jt.lengths))
        np.testing.assert_array_equal(tt.weights.numpy(),
                                      np.asarray(jt.weights))
        for a, b in zip(tt.to_dense(), jt.to_dense()):
            np.testing.assert_array_equal(a.numpy(), b)


def test_keyed_tensor_views():
    a, b = torch.arange(6.0).reshape(2, 3), torch.arange(4.0).reshape(2, 2)
    kt = TKT.from_tensor_list(["a", "b"], [a, b])
    assert kt.length_per_key == (3, 2)
    assert torch.equal(kt["b"], b)
    assert torch.equal(kt.to_dict()["a"], a)
