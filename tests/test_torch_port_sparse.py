"""The port's sparse batch (torchrec_tpu_torch/sparse/jagged.py) against
the JAX package's, on the CPU.

The same numpy inputs go to both; every output is an integer array or a
gather of the inputs, so each must match bit for bit, dtype included. The
cases are those of tests/test_jagged.py, with zero lengths, all-empty
batches and truncation added, and the hypothesis strategy of
tests/test_property_sparse.py (few examples: each one traces JAX ops).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from test_property_sparse import kjt_data
from torchrec_tpu import sparse as js
from torchrec_tpu.sparse.jagged import jagged_permute_indices as j_permute
from torchrec_tpu_torch import sparse as ts

FEW = settings(max_examples=6, deadline=None,
               suppress_health_check=[HealthCheck.too_slow])


def _same(port, ref):
    """Bit for bit, dtype included (numpy / torch / jax)."""
    ref = np.asarray(ref)
    got = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    assert got.dtype == ref.dtype, (got.dtype, ref.dtype)
    np.testing.assert_array_equal(got, ref)


def _kjts(keys, lengths, values, weights=None, stride=None):
    """(JAX KJT, port KJT) of the same numpy arrays."""
    lengths = np.asarray(lengths, np.int32).reshape(-1)
    values = np.asarray(values)
    j = js.KeyedJaggedTensor.from_lengths(
        keys, jnp.asarray(values), jnp.asarray(lengths),
        None if weights is None else jnp.asarray(weights), stride=stride)
    t = ts.KeyedJaggedTensor.from_lengths(keys, values, lengths, weights,
                                          stride=stride)
    return j, t


def _same_kjt(t, j):
    assert t.keys == j.keys and t.stride == j.stride
    _same(t.values, j.values)
    _same(t.lengths, j.lengths)
    assert (t.weights is None) == (j.weights is None)
    if j.weights is not None:
        _same(t.weights, j.weights)


def _example():
    # f1 rows: [1, 2], [], [3]; f2 rows: [4], [5, 6], [7, 8, 9]
    return (["f1", "f2"], [2, 0, 1, 1, 2, 3],
            np.arange(1, 10, dtype=np.int32))


@pytest.mark.parametrize("lengths,total", [
    ([2, 0, 3], 7),  # test_jagged's case: two padding slots
    ([2, 0, 3], 3),  # total below the real sum
    ([0, 0, 0], 4),  # all empty
    ([], 3),  # no segments
    ([1, 4, 0, 2], 7),  # exactly the real total
])
def test_jagged_segment_ids_match_jax(lengths, total):
    lengths = np.asarray(lengths, np.int32)
    _same(ts.jagged_segment_ids(torch.as_tensor(lengths), total),
          js.jagged_segment_ids(jnp.asarray(lengths), total))


@pytest.mark.parametrize("lengths,perm,total", [
    ([2, 1, 3], [2, 0, 1], 8),  # test_jagged's static total
    ([2, 0, 3, 0], [3, 1, 2, 0], 5),  # zero-length segments
    ([0, 0], [1, 0], 3),  # all empty
    ([1, 2, 3], [2, 2, 0], 9),  # a repeated segment
    ([3, 1], [1, 0], 2),  # total below the real sum
])
def test_jagged_permute_indices_match_jax(lengths, perm, total):
    lengths = np.asarray(lengths, np.int32)
    perm = np.asarray(perm, np.int32)
    _same(ts.jagged_permute_indices(torch.as_tensor(lengths),
                                    torch.as_tensor(perm), total),
          j_permute(jnp.asarray(lengths), jnp.asarray(perm), total))


@pytest.mark.parametrize("shape,lengths,weighted", [
    ((4, 3), [1, 3, 0, 2], False),  # test_jagged's round trip
    ((4, 3, 2), [3, 0, 0, 1], True),  # rows [B, L, D], per-slot weights
    ((3, 2), [0, 0, 0], True),  # all empty
    ((2, 3), [5, 1], False),  # a length beyond L keeps its whole row
])
def test_from_dense_lengths_matches_jax(shape, lengths, weighted):
    rng = np.random.RandomState(len(shape))
    dense = rng.randn(*shape).astype(np.float32)
    lengths = np.asarray(lengths, np.int32)
    w = rng.rand(*shape[:2]).astype(np.float32) if weighted else None
    j = js.JaggedTensor.from_dense_lengths(
        jnp.asarray(dense), jnp.asarray(lengths),
        None if w is None else jnp.asarray(w))
    t = ts.JaggedTensor.from_dense_lengths(
        torch.as_tensor(dense), torch.as_tensor(lengths),
        None if w is None else torch.as_tensor(w))
    _same(t.values, j.values)
    _same(t.lengths, j.lengths)
    assert t.lengths_or_none() is t.lengths
    assert t.weights_or_none() is t.weights
    if weighted:
        _same(t.weights, j.weights)
    for a, b in zip(t.to_dense(), j.to_dense()):
        _same(a, b)


@pytest.mark.parametrize("case", ["rows", "weighted", "empty_row", "none"])
def test_from_dense_matches_jax(case):
    rows = {"rows": [[1, 2], [3], [4, 5, 6]],
            "weighted": [[7], [8, 9]],
            "empty_row": [[1], [], [2, 3]],
            "none": []}[case]
    rows = [np.asarray(r, np.int32) for r in rows]
    w = None
    if case == "weighted":
        w = [np.asarray([0.5], np.float32), np.asarray([1.5, 2.5], np.float32)]
    j = js.JaggedTensor.from_dense(rows, w)
    t = ts.JaggedTensor.from_dense(rows, w)
    _same(t.values, j.values)
    _same(t.lengths, j.lengths)
    assert (t.weights is None) == (j.weights is None)
    if w is not None:
        _same(t.weights, j.weights)


@pytest.mark.parametrize("values,lengths,L,pad", [
    ([1.0, 2.0, 3.0, 4.0, 5.0], [2, 0, 3], 3, -1.0),  # test_jagged's case
    ([1.0, 2.0, 3.0, 4.0, 5.0], [2, 0, 3], 2, 0.0),  # truncated
    ([9.0, 9.0], [0, 0], 3, 7.0),  # all empty, slack values only
    ([[1, 2], [3, 4], [5, 6]], [1, 2], 3, 0.0),  # [N, D] rows
    ([4, 5, 6], [3], 4, -1.0),  # int values: padding cast to int32
])
def test_to_padded_dense_matches_jax(values, lengths, L, pad):
    dtype = np.int32 if isinstance(values[0], (int, list)) else np.float32
    values = np.asarray(values, dtype)
    lengths = np.asarray(lengths, np.int32)
    j = js.JaggedTensor(values=jnp.asarray(values),
                        lengths=jnp.asarray(lengths))
    t = ts.JaggedTensor(values=torch.as_tensor(values),
                        lengths=torch.as_tensor(lengths))
    _same(t.to_padded_dense(L, pad), j.to_padded_dense(L, pad))


def test_empty_matches_jax():
    for dtype, jdtype in ((torch.int32, jnp.int32),
                          (torch.float32, jnp.float32)):
        t, j = ts.JaggedTensor.empty(dtype), js.JaggedTensor.empty(jdtype)
        _same(t.values, j.values)
        _same(t.lengths, j.lengths)
    t, j = ts.KeyedJaggedTensor.empty(), js.KeyedJaggedTensor.empty()
    _same_kjt(t, j)
    assert t.num_keys == j.num_keys == 0


def test_kjt_views_match_jax():
    j, t = _kjts(*_example())
    assert t.num_keys == j.num_keys == 2
    _same(t.lengths_matrix(), j.lengths_matrix())
    assert t.sync() is t


@pytest.mark.parametrize("perm", [[1, 0], [0, 1], [1], [1, 1, 0]])
@pytest.mark.parametrize("weighted", [False, True])
def test_kjt_permute_matches_jax(perm, weighted):
    keys, lengths, values = _example()
    w = np.linspace(0.1, 0.9, 9).astype(np.float32) if weighted else None
    j, t = _kjts(keys, lengths, values, w)
    _same_kjt(t.permute(perm), j.permute(perm))


def test_kjt_permute_keeps_static_slack_and_empty_batches():
    # 3 slack slots past the real total of 9; then an all-empty batch
    keys, lengths, values = _example()
    values = np.concatenate([values, np.asarray([0, 0, 0], np.int32)])
    j, t = _kjts(keys, lengths, values)
    _same_kjt(t.permute([1, 0]), j.permute([1, 0]))
    j, t = _kjts(["a", "b"], [0, 0, 0, 0], np.zeros(0, np.int32))
    _same_kjt(t.permute([1, 0]), j.permute([1, 0]))


@pytest.mark.parametrize("segments", [[1, 1], [2], [0, 2], [2, 0]])
def test_kjt_split_and_concat_match_jax(segments):
    keys, lengths, values = _example()
    w = np.linspace(0.1, 0.9, 9).astype(np.float32)
    j, t = _kjts(keys, lengths, values, w)
    tparts, jparts = t.split(segments), j.split(segments)
    assert len(tparts) == len(jparts)
    for a, b in zip(tparts, jparts):
        _same_kjt(a, b)
    _same_kjt(ts.KeyedJaggedTensor.concat(tparts),
              js.KeyedJaggedTensor.concat(jparts))


def test_kjt_concat_fills_missing_weights_with_zeros():
    j1, t1 = _kjts(["a"], [1, 2], np.asarray([1, 2, 3], np.int32))
    j2, t2 = _kjts(["b"], [2, 0], np.asarray([4, 5], np.int32),
                   np.asarray([0.5, 1.5], np.float32))
    out = ts.KeyedJaggedTensor.concat([t1, t2])
    _same_kjt(out, js.KeyedJaggedTensor.concat([j1, j2]))
    _same(out.weights, np.asarray([0, 0, 0, 0.5, 1.5], np.float32))
    _, t3 = _kjts(["c"], [1], np.asarray([6], np.int32))
    with pytest.raises(ValueError, match="strides"):
        ts.KeyedJaggedTensor.concat([t1, t3])


@pytest.mark.parametrize("L", [3, 2, 4])  # round trip, truncated, slack
@pytest.mark.parametrize("weighted", [False, True])
def test_padded_batch_matches_jax(L, weighted):
    keys, lengths, values = _example()
    w = np.linspace(0.1, 0.9, 9).astype(np.float32) if weighted else None
    j, t = _kjts(keys, lengths, values, w)
    jsb, tsb = j.to_padded(L), t.to_padded(L)
    assert (tsb.num_keys, tsb.batch_size, tsb.max_length) == \
        (jsb.num_keys, jsb.batch_size, jsb.max_length) == (2, 3, L)
    _same_kjt(tsb.to_kjt(), jsb.to_kjt())


def test_all_empty_padded_batch_to_kjt_matches_jax():
    j, t = _kjts(["a", "b"], [0, 0, 0, 0], np.zeros(0, np.int32),
                 np.zeros(0, np.float32))
    _same_kjt(t.to_padded(3).to_kjt(), j.to_padded(3).to_kjt())


def test_keyed_tensor_regroup_matches_jax():
    rng = np.random.RandomState(0)
    a, b, c = (rng.randn(2, n).astype(np.float32) for n in (1, 3, 2))
    j1 = js.KeyedTensor.from_tensor_list(["a", "b"], [jnp.asarray(a),
                                                      jnp.asarray(b)])
    j2 = js.KeyedTensor.from_tensor_list(["c"], [jnp.asarray(c)], dim=1)
    t1 = ts.KeyedTensor.from_tensor_list(["a", "b"], [torch.as_tensor(a),
                                                      torch.as_tensor(b)])
    t2 = ts.KeyedTensor.from_tensor_list(["c"], [torch.as_tensor(c)], dim=1)
    groups = [["a", "c"], ["b"], ["c", "b", "a"]]
    for got, ref in zip(ts.KeyedTensor.regroup([t1, t2], groups),
                        js.KeyedTensor.regroup([j1, j2], groups)):
        _same(got, ref)
    with pytest.raises(AssertionError):
        js.KeyedTensor.from_tensor_list(["c"], [jnp.asarray(c)], dim=0)
    with pytest.raises(ValueError, match="dim"):
        ts.KeyedTensor.from_tensor_list(["c"], [torch.as_tensor(c)], dim=0)


# -- hypothesis: random jagged structure, zero lengths and empty keys ------


def _drawn(data):
    keys, lengths, values, weights = data
    return _kjts(keys, lengths, values, weights)


@FEW
@given(kjt_data(), st.randoms(use_true_random=False))
def test_permute_matches_jax_on_drawn_batches(data, rnd):
    j, t = _drawn(data)
    perm = list(range(len(data[0])))
    rnd.shuffle(perm)
    _same_kjt(t.permute(perm), j.permute(perm))


@FEW
@given(kjt_data(), st.data())
def test_split_concat_matches_jax_on_drawn_batches(data, dd):
    j, t = _drawn(data)
    segs, left = [], len(data[0])
    while left > 0:
        segs.append(dd.draw(st.integers(1, left)))
        left -= segs[-1]
    tparts, jparts = t.split(segs), j.split(segs)
    for a, b in zip(tparts, jparts):
        _same_kjt(a, b)
    _same_kjt(ts.KeyedJaggedTensor.concat(tparts),
              js.KeyedJaggedTensor.concat(jparts))


@FEW
@given(kjt_data(max_len=4), st.integers(1, 5))
def test_padded_round_trip_matches_jax_on_drawn_batches(data, L):
    """to_padded (truncating where L is short), to_kjt, and the first
    feature's from_dense_lengths / to_padded_dense."""
    j, t = _drawn(data)
    jsb, tsb = j.to_padded(L), t.to_padded(L)
    _same_kjt(tsb.to_kjt(), jsb.to_kjt())
    jt = js.JaggedTensor.from_dense_lengths(jsb.ids[0], jsb.lengths[0])
    tt = ts.JaggedTensor.from_dense_lengths(tsb.ids[0], tsb.lengths[0])
    _same(tt.values, jt.values)
    _same(tt.to_padded_dense(L, -1), jt.to_padded_dense(L, -1))
    lengths = np.asarray(data[1], np.int32).reshape(-1)
    total = int(lengths.sum()) + 2
    _same(ts.jagged_segment_ids(torch.as_tensor(lengths), total),
          js.jagged_segment_ids(jnp.asarray(lengths), total))
