"""The narrow-row layout of K1 and the row kernel, on the CPU.

K1 / K1h (csrc/tbe_lookup.cu) and the row kernel of K2, K3 and K4's scaled
RMW (csrc/fused_update.cu, `row_update_kernel`) give a row of D columns
`lanes_per_row(D)` lanes (ops/lane_groups.py), so a warp holds several
narrow rows. The kernels run on the card only; here:

* the geometry helper's lanes and rows a warp for D = 1..160, and the row
  kernel's slots a warp;
* numpy emulations of both kernels' index maps (which lane of which warp
  reads and writes which bag or slot and which columns), driven by the
  wrappers' own geometry: every (bag or slot, column) is covered exactly
  once and no column >= D is touched, at every lane group and slot count;
* the plain versions the wrappers take on CPU tensors (K1 and K3, with K2)
  at D = 10 and 64 against the Pallas kernels run in interpret mode, on
  inputs made from a seed with numpy.

Tolerances as test_torch_port_ops.py and test_torch_port_fused_update.py
hold the same functions: K1 bit for bit at one id a bag, rtol = atol =
1e-6 for longer bags (summation order); K2 bit for bit; K3 rtol 1e-5 /
atol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import fused_update as jfu
from torchrec_tpu.ops import pallas_embedding as pe
from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.ops.lane_groups import lanes_per_row, rows_per_warp

WARPS_PER_BLOCK = 8  # kWarpsPerBlock of both sources
R, LR = 300, 0.1


# -- the geometry ------------------------------------------------------------


def _expected_lanes(D):
    """The table in ops/lane_groups.py's docstring, spelled out."""
    for top, lanes in ((4, 1), (8, 2), (16, 4), (32, 8), (64, 16)):
        if D <= top:
            return lanes
    return 32


@pytest.mark.parametrize("D", range(1, 161))
def test_lanes_and_rows_per_warp(D):
    G, P = lanes_per_row(D), rows_per_warp(D)
    quads = -(-D // 4)
    assert G == _expected_lanes(D) and G * P == 32
    assert G & (G - 1) == 0  # a power of two
    if G < 32:  # the smallest that covers the row's quads
        assert G >= quads and (G == 1 or G // 2 < quads)
    else:
        assert quads > 16


@pytest.mark.parametrize("D", [0, -3])
def test_lanes_per_row_refuses_an_empty_row(D):
    with pytest.raises(ValueError):
        lanes_per_row(D)


@pytest.mark.parametrize("D", range(1, 161))
def test_row_slots_per_warp(D):
    """A multiple of the warp's lane groups, at most 32; 32 on the
    one-row-a-warp path."""
    G, slots = fk.row_geometry(D)
    assert G == lanes_per_row(D) and slots == fk.row_slots_per_warp(D)
    assert 1 <= slots <= 32 and slots % (32 // G) == 0
    if G == 32:
        assert slots == 32


# -- the index maps ----------------------------------------------------------


def _k1_cover(D, NB, G, vec):
    """How often the K1 launch for [NB, D] writes each (bag, column), from
    the kernels' index arithmetic: the narrow kernel's lane groups below 32
    lanes (the same lanes on its vector and masked paths), the
    one-warp-a-bag kernel's column chunks at 32 (quads on the vector path,
    `vec`, floats otherwise)."""
    hits = np.zeros((NB, 64 * 4 + D), np.int64)  # room for stray columns
    if G < 32:
        P = 32 // G
        quads = -(-D // 4)
        warps = -(-NB // P)
        grid = -(-warps // WARPS_PER_BLOCK)
        for block in range(grid):
            for warp_in in range(WARPS_PER_BLOCK):
                first = (block * WARPS_PER_BLOCK + warp_in) * P
                if first >= NB:
                    continue
                for lane in range(32):
                    bag, sub = first + lane // G, lane % G
                    if bag >= NB or sub >= quads:
                        continue
                    for c in range(4 * sub, 4 * sub + 4):
                        if c < D:  # vector quads are whole at D % 4 == 0
                            hits[bag, c] += 1
        return hits
    cols = D // 4 if vec else D
    for y in range(-(-cols // 32)):
        for bag in range(NB):
            for lane in range(32):
                col = y * 32 + lane
                if col < cols:
                    for c in (range(4 * col, 4 * col + 4) if vec else (col,)):
                        hits[bag, c] += 1
    return hits


@pytest.mark.parametrize("D", [1, 2, 3, 4, 5, 8, 10, 12, 16, 17, 32, 33, 63,
                               64, 65, 100, 128, 130])
def test_k1_index_map_covers_each_output_once(D):
    NB = 37  # not a multiple of any lane group's bags a warp
    for vec in ((True, False) if D % 4 == 0 else (False,)):
        hits = _k1_cover(D, NB, lanes_per_row(D), vec)
        np.testing.assert_array_equal(hits[:, :D], 1)
        assert not hits[:, D:].any()


def _rows_cover(D, N, G, slots):
    """How often the row kernel's launch over N slots of width D moves each
    (slot, column), from its index arithmetic: a warp takes `slots` slots;
    group p of its 32 / G walks slots p, p + 32 / G, ... below n, lane `sub`
    of the group quads sub, sub + G, ... Also checks that every lane reads
    its slot's id from a lane of the warp (j < 32)."""
    P = 32 // G
    quads = -(-D // 4)
    hits = np.zeros((N, 4 * quads + 4), np.int64)
    warps = -(-N // slots)
    for warp in range(warps):
        base = warp * slots
        n = min(N - base, slots)
        for step in range(0, n, P):
            for lane in range(32):
                j = step + lane // G
                assert j < 32
                if j >= n:  # lanes from n on hold the sentinel -1
                    continue
                for q in range(lane % G, quads, G):
                    for c in range(4 * q, 4 * q + 4):
                        if c < D:  # masked past D; whole at D % 4 == 0
                            hits[base + j, c] += 1
    return hits


@pytest.mark.parametrize("D", [1, 2, 3, 4, 5, 8, 10, 12, 16, 17, 32, 33, 63,
                               64, 65, 128, 130, 600])
def test_row_kernel_index_map_covers_each_slot_once(D):
    G = lanes_per_row(D)
    counts = [32] if G == 32 else [s for s in (1, 2, 4, 8, 16, 32)
                                   if s % (32 // G) == 0]
    assert fk.row_geometry(D)[1] in counts
    for N in (1, 31, 101):
        for slots in counts:
            hits = _rows_cover(D, N, G, slots)
            np.testing.assert_array_equal(hits[:, :D], 1)
            assert not hits[:, D:].any()


# -- the plain versions against the Pallas kernels ---------------------------


def _k1_inputs(D, L, kind, seed):
    rng = np.random.RandomState(seed)
    NB = 37
    w = rng.randn(R, D).astype(np.float32)
    ids = rng.randint(-5, R + 20, size=(NB, L)).astype(np.int32)
    lengths = rng.randint(0, L + 1, size=(NB,))
    valid = np.arange(L)[None, :] < lengths[:, None]
    if kind == "mean":
        coeff = valid / np.maximum(lengths, 1)[:, None]
    else:  # per-sample weights
        coeff = valid * rng.rand(NB, L)
    return w, ids, coeff.astype(np.float32)


@pytest.mark.parametrize("kind", ["mean", "psw"])
@pytest.mark.parametrize("L", [1, 4])
@pytest.mark.parametrize("D", [10, 64])
def test_k1_plain_matches_pallas_at_narrow_widths(D, L, kind):
    w, ids, coeff = _k1_inputs(D, L, kind, seed=D + L)
    ref = np.asarray(pe.tbe_lookup_pooled(
        jnp.asarray(w), jnp.asarray(ids), jnp.asarray(coeff), interpret=True))
    launches = tl.LAUNCHES
    out = tl.tbe_lookup_pooled(torch.as_tensor(w), torch.as_tensor(ids),
                               torch.as_tensor(coeff)).numpy()
    assert tl.LAUNCHES == launches  # CPU tensors take the plain version
    if L == 1:
        np.testing.assert_array_equal(out, ref)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-6, atol=1e-6)


def _run_totals(D, seed):
    """Duplicate-rich ids with invalid slots, combined by JAX into run
    totals (real ids unique, 2**31 - 1 sentinels between them)."""
    rng = np.random.RandomState(seed)
    n = 101
    ids = rng.randint(0, R, size=n).astype(np.int32)
    ids[: n // 4] = rng.randint(0, 20, size=n // 4)
    grads = rng.randn(n, D).astype(np.float32)
    valid = rng.rand(n) > 0.2
    uids, totals = jfu.run_total_row_grads(
        jnp.asarray(ids), jnp.asarray(grads), jnp.asarray(valid), R)
    return np.array(uids), np.array(totals)


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("D", [10, 64])
def test_k3_plain_matches_pallas_at_narrow_widths(D, wd):
    uids, totals = _run_totals(D, seed=D)
    assert (uids == 2**31 - 1).any()
    w = np.random.RandomState(D + 1).randn(R, D).astype(np.float32)
    ref = np.asarray(pe.fused_update_sgd(
        jnp.asarray(w), jnp.asarray(uids), jnp.asarray(totals), LR,
        weight_decay=wd, interpret=True))
    before = dict(fk.LAUNCHES)
    W = torch.as_tensor(w.copy())
    out = fk.fused_update_sgd(W, torch.as_tensor(uids),
                              torch.as_tensor(totals), LR, weight_decay=wd)
    assert out is W and fk.LAUNCHES == before  # in place, plain version
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("D", [10, 64])
def test_k2_plain_matches_pallas_at_narrow_widths(D):
    uids, totals = _run_totals(D, seed=D + 2)
    w = np.random.RandomState(D + 3).randn(R, D).astype(np.float32)
    ref = np.asarray(pe.scatter_rows_write(
        jnp.asarray(w), jnp.asarray(uids), jnp.asarray(totals),
        interpret=True))
    W = torch.as_tensor(w.copy())
    fk.scatter_rows_write(W, torch.as_tensor(uids), torch.as_tensor(totals))
    np.testing.assert_array_equal(W.numpy(), ref)
