"""The generators repeat by seed, and seeds past 32 bits make streams of
their own."""

import pytest
import torch

from gpubench import inputs

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
