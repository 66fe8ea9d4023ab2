"""The generators repeat by seed, and seeds past 32 bits make streams of
their own; an int `ids_per_feature` draws as it always has, a list gives
each feature its own number of ids; a layer without a bias draws the
rest as before."""

import hashlib

import pytest
import torch

from gpubench import inputs, work

CARDS = (1460, 3, 10_131_227)


@pytest.mark.parametrize("seed", [0, 2**31 + 11, 2**40 + 3])
def test_batches_repeat_by_seed(seed):
    a = inputs.make_batch(CARDS, 64, 2, 1.05, seed, 4, "cpu")
    b = inputs.make_batch(CARDS, 64, 2, 1.05, seed, 4, "cpu")
    for k in a:
        assert torch.equal(a[k], b[k]), k
    c = inputs.make_batch(CARDS, 64, 2, 1.05, seed + 1, 4, "cpu")
    assert not torch.equal(a["ids"], c["ids"])
    d = inputs.make_batch(CARDS, 64, 2, 1.05, seed, 5, "cpu")
    assert not torch.equal(a["ids"], d["ids"])


def test_batch_ranges():
    b = inputs.make_batch(CARDS, 4096, 1, 1.05, 9, 0, "cpu")
    assert b["ids"].dtype == torch.int32 and b["ids"].shape == (3, 4096, 1)
    for f, n in enumerate(CARDS):
        assert 0 <= int(b["ids"][f].min()) and int(b["ids"][f].max()) < n
    # Zipf: the hottest row of the big table is its order's first
    hot = int(inputs.row_orders(CARDS, 9, "cpu")[2][0])
    assert int((b["ids"][2] == hot).sum()) > 100
    assert set(b["labels"].unique().tolist()) <= {0.0, 1.0}
    u = inputs.make_batch(CARDS, 4096, 1, None, 9, 0, "cpu")
    assert int((u["ids"][2] == hot).sum()) < 5


def test_hot_rows_are_scattered_over_the_table():
    """The ten hottest rows of a table are not its first rows, lie far
    apart, and differ by seed; the orders are permutations."""
    n = CARDS[2]
    orders = inputs.row_orders(CARDS, 2**33 + 1, "cpu")
    for o, rows in zip(orders, CARDS):
        assert torch.equal(torch.sort(o).values, torch.arange(rows))
    hot = orders[2][:10]
    assert int(hot.min()) > 10 and int(hot.max()) - int(hot.min()) > n // 10
    assert not torch.equal(hot, inputs.row_orders(CARDS, 2**33 + 2,
                                                  "cpu")[2][:10])
    pool = inputs.make_pool(CARDS, {"batch": 64, "ids_per_feature": 1,
                                    "zipf_a": 1.05, "pool": 2},
                            2**33 + 1, "cpu")
    assert torch.equal(pool[1]["ids"], inputs.make_batch(
        CARDS, 64, 1, 1.05, 2**33 + 1, 1, "cpu", orders)["ids"])


def test_seeds_past_32_bits_differ():
    assert inputs.sub_seed(2**32 + 1) != inputs.sub_seed(1)
    assert inputs.sub_seed(5, 1, 2) != inputs.sub_seed(5, 2, 1)


def test_weights_repeat_and_are_drawn_alone():
    w = inputs.make_table(2**35, 3, 1000, 8, "cpu")
    assert torch.equal(w, inputs.make_table(2**35, 3, 1000, 8, "cpu"))
    assert float(w.abs().max()) <= (1 / 1000) ** 0.5
    lin = inputs.make_linears(7, [(3, 4), (4, 2)], "cpu")
    assert torch.equal(lin[1][0], inputs.make_linear(7, 1, 4, 2, "cpu")[0])


def _digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.contiguous().numpy().tobytes()).hexdigest()[:16]


# sha256 prefixes of a small seeded batch's tensors before `ids_per_feature`
# took a list: an int draws the same batch as before, bit for bit
PINNED = {
    1.05: {"ids": "0ab04b8f535714c6", "lengths": "5ad3049edfad1871",
           "dense": "e236cf92722ac800", "labels": "8969ee21f87f8c84"},
    None: {"ids": "8eb97053d0042992", "lengths": "5ad3049edfad1871",
           "dense": "47e7226d89fed097", "labels": "59863c2ebbca5d03"},
}
PINNED_POOL = [
    {"ids": "cfff377b3c69f554", "lengths": "a7d3fa431bba41f5",
     "dense": "8018fc36d239cd3f", "labels": "0570a3973799fa5c"},
    {"ids": "1e3e787316177662", "lengths": "a7d3fa431bba41f5",
     "dense": "69507d436038d328", "labels": "79ea107298d0c57a"},
]


@pytest.mark.parametrize("zipf_a", [1.05, None])
def test_int_ids_per_feature_draws_as_before(zipf_a):
    b = inputs.make_batch(CARDS, 64, 2, zipf_a, 2**33 + 7, 3, "cpu")
    assert {k: _digest(v) for k, v in b.items()} == PINNED[zipf_a]


def test_int_ids_per_feature_pool_draws_as_before():
    pool = inputs.make_pool(CARDS, {"batch": 32, "ids_per_feature": 1,
                                    "zipf_a": 1.05, "pool": 2},
                            2**31 + 5, "cpu")
    assert [{k: _digest(v) for k, v in b.items()} for b in pool] == \
        PINNED_POOL


@pytest.mark.parametrize("zipf_a", [1.05, None])
def test_per_feature_ids(zipf_a):
    """A list of lengths: lengths[f] = L_f in every example, the slots past
    it 0, the real slots those of the int draw at the largest L; distinct
    rows and bytes count the real slots alone."""
    per = [3, 1, 6]
    seed, B = 2**33 + 9, 64
    b = inputs.make_batch(CARDS, B, per, zipf_a, seed, 2, "cpu")
    full = inputs.make_batch(CARDS, B, 6, zipf_a, seed, 2, "cpu")
    assert b["ids"].shape == (3, B, 6) and b["ids"].dtype == torch.int32
    assert b["lengths"].dtype == torch.int32
    for f, n in enumerate(per):
        assert bool((b["lengths"][f] == n).all())
        assert bool((b["ids"][f, :, n:] == 0).all())
        assert torch.equal(b["ids"][f, :, :n], full["ids"][f, :, :n])
    for k in ("dense", "labels"):
        assert torch.equal(b[k], full[k])
    real = sum(int(torch.unique(b["ids"][f, :, :n]).numel())
               for f, n in enumerate(per))
    assert work.distinct_rows(b["ids"], b["lengths"]) == real
    assert inputs.ids_per_example(3, per) == 10
    assert inputs.ids_per_example(3, 2) == 6
    # ids a batch: sum of L_f over B examples, and the lengths [F, B]
    assert work.sparse_input_bytes(3, B, 10) == 10 * B * 4 + 3 * B * 4
    assert work.lookup_bytes(real, 3, B, 10, 8) == (
        real * 8 * 4 + 10 * B * 4 + 3 * B * 4 + 3 * B * 8 * 4)


def test_per_feature_ids_need_one_length_a_feature():
    with pytest.raises(ValueError):
        inputs.make_batch(CARDS, 8, [1, 2], 1.05, 1, 0, "cpu")
    assert inputs.feature_lengths(2, [4, 1]) == [4, 1]
    assert inputs.feature_lengths(3, 2) == [2, 2, 2]


def test_linears_without_a_bias_keep_their_streams():
    """A layer without a bias draws its weight as before, and the other
    layers' draws do not move."""
    shapes = [(3, 4), (4, 5), (5, 2)]
    both = inputs.make_linears(7, shapes, "cpu")
    some = inputs.make_linears(7, shapes, "cpu", [True, False, True])
    assert some[1][1] is None
    for (w, b), (w2, b2) in zip(both, some):
        assert torch.equal(w, w2)
        assert b2 is None or torch.equal(b, b2)
