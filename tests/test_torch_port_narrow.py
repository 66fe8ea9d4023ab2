"""The narrow-row layout of the kernels, on the CPU.

K1 / K1h (csrc/tbe_lookup.cu), the row kernel of K2, K3 and K4's scaled
RMW, the fused rowwise kernel of K4 / K4h and the moment kernel of K6 /
K7 (csrc/fused_update.cu: `row_update_kernel`,
`rowwise_adagrad_narrow_kernel`, `moment_update_kernel`) give a row of D
columns `lanes_per_row(D)` lanes (ops/lane_groups.py), so a warp holds
several narrow rows. The kernels run on the card only; here:

* the geometry helpers' lanes and rows a warp for D = 1..160, and each
  kernel's slots a warp (the fused kernel's at the slot counts of the
  D=10 DeepFM, the Criteo Kaggle DLRM and BERT4Rec);
* numpy emulations of the kernels' index maps (which lane of which warp
  reads and writes which bag or slot and which columns), driven by the
  wrappers' own geometry: every (bag or real slot, column) is covered
  exactly once, no sentinel slot and no column >= D is touched, at every
  lane group and slot count (the fused kernel's momentum word once a real
  slot; K3h's stores, the row kernel on a half table, with the stochastic
  rounding bits of each element keyed as the plain version keys them and
  its 4-byte words at an even D aligned pairs of columns below D);
* a torch emulation of the fused kernel's g^2 sum inside a lane group (a
  row's quads padded to G lanes, halved pairwise from G / 2) against
  `row_mean_sq` (the warp's 32 lanes), bit for bit at D = 1..64;
* the plain versions the wrappers take on CPU tensors (K1 and K3, with
  K2, the fused K4, K6 and K7) at D = 10 and 64 against the Pallas
  kernels run in interpret mode, the plain K4h at D = 10 and the plain
  K3h at D = 10 and 64 against `apply_fused_update`'s XLA route, on
  inputs made from a seed with numpy.

Tolerances as test_torch_port_ops.py, test_torch_port_fused_update.py and
test_torch_port_low_precision.py hold the same functions: K1 bit for bit
at one id a bag, rtol = atol = 1e-6 for longer bags (summation order); K2
bit for bit; K3, K4, K6 and K7 rows rtol 1e-5 / atol 1e-6 (XLA contracts
a multiply and an add), momenta rtol 1e-6 (atol 1e-7 for full momenta,
whose elements reach zero); K4h and K3h rows within one ulp of the half
type (bit for bit where a row is hit once; untouched rows equal), K4h's
momentum rtol 1e-4 / atol 1e-9 (the XLA route sums g^2 in another
order).
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.ops import fused_update as jfu
from torchrec_tpu.ops import pallas_embedding as pe
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.ops.lane_groups import lanes_per_row, rows_per_warp
from torchrec_tpu_torch.ops.stochastic_rounding import (
    _GOLDEN,
    _mul32,
    fmix32,
    sr_bits,
    sr_row_keys,
)
from torchrec_tpu_torch.utils import tracing

WARPS_PER_BLOCK = 8  # kWarpsPerBlock of both sources
R, LR = 300, 0.1
# the update's slot count of the D=10 DeepFM and the Criteo Kaggle DLRM (26
# features x B=8192) and of BERT4Rec's train step (B=32 x 64 tokens)
KAGGLE_N, B4R_N = 212_992, 2048


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


def _k3h_launch(D, N=101, R_=R):
    """The arguments fused_update_sgd_half hands trt_fused_update_sgd_half
    for fake CUDA tensors [R_, D] bf16, N slots, with the launch stood in
    for by a recorder (no card here)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    seen = {}

    class Lib:
        def trt_fused_update_sgd_half(self, *args):
            seen["args"] = args
            return 0

    def launch(name, dev, call):
        seen["name"], seen["err"] = name, call(Lib(), 0)

    saved = fk._launch
    fk._launch = launch
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # data_ptr of a fake tensor
            with FakeTensorMode():
                dev = "cuda"
                fk.fused_update_sgd_half(
                    torch.zeros(R_, D, dtype=torch.bfloat16, device=dev),
                    torch.zeros(N, dtype=torch.int32, device=dev),
                    torch.zeros(N, D, device=dev), LR,
                    torch.zeros((), dtype=torch.int32, device=dev))
    finally:
        fk._launch = saved
    assert seen["name"] == "fused_update_sgd_half" and seen["err"] == 0
    return seen["args"]


def _k3h_access(D, G):
    """The access launch_rows takes for aligned rows: whole quads at
    D % 4 == 0, 4-byte pairs on narrow rows at an even D, else masked
    (a table view that starts mid-row takes masked at any D)."""
    if D % 4 == 0:
        return "vector"
    return "pairs" if G < 32 and D % 2 == 0 else "masked"


def _k3h_stores(D, uids, G, slots, access, row_base):
    """The K3h launch's row stores, from its index arithmetic: the row
    kernel's walk (group p of P = 32 / G takes slots p, p + P, ... below
    n; lane `sub` of the group quads sub, sub + G, ..., one at most below
    G = 32), each quad stored as one 8-byte word (vector), two 4-byte
    words, the second only below D (pairs), or one element a store below
    D (masked). Yields (slot, first element's offset in the table, the
    stored columns, each element's (row key, column) for sr_bits)."""
    P = 32 // G
    quads = -(-D // 4)
    for base, ids in _warp_ids(uids, slots):
        n = min(len(uids) - base, slots)
        for at in range(0, n, P):
            for lane in range(32):
                j = at + lane // G
                assert j < 32
                u = ids[j]
                if not 0 <= u < R:  # sentinels, and -1 from n on
                    continue
                for q in range(lane % G, quads, G):
                    c = 4 * q
                    if access == "vector":
                        words = [(c, c + 1, c + 2, c + 3)]
                    elif access == "pairs":
                        words = [(c, c + 1)] + (
                            [(c + 2, c + 3)] if c + 2 < D else [])
                    else:
                        words = [(e,) for e in range(c, c + 4) if e < D]
                    for cols in words:
                        yield (base + j, u * D + cols[0], cols,
                               [(row_base + u, e) for e in cols])
                    if G < 32:
                        break


@pytest.mark.parametrize("D", [1, 2, 3, 4, 5, 8, 10, 12, 16, 17, 32, 33, 63,
                               64, 65, 128, 130, 600])
def test_k3h_index_map_and_rounding_keys(D):
    """K3h on a half table, the row kernel's walk with its stores through
    table_store: at the geometry the wrapper hands the launch and at every
    slot count of the lane group, every (real slot, column) is written
    once and nothing else; each element's stochastic-rounding bits, keyed
    by (row_base + row, column) as the kernel keys them, equal the plain
    version's (sr_bits over the real slots' rows); on the pair path every
    4-byte word holds columns (c, c + 1) of one row, c even, at a 4-byte
    aligned offset, and a quad's second word is stored only below D."""
    args = _k3h_launch(D)
    G, slots = args[7], args[8]
    assert (G, slots) == fk.row_geometry(D) == (lanes_per_row(D),
                                                fk.row_slots_per_warp(D))
    counts = [32] if G == 32 else [s for s in (1, 2, 4, 8, 16, 32)
                                   if s % (32 // G) == 0]
    assert slots in counts
    step = torch.tensor(6, dtype=torch.int32)
    for uids in _slot_patterns(D):
        real = (uids >= 0) & (uids < R)
        for row_base in (0, 3 * R):
            plain = sr_bits(step, torch.as_tensor(uids[real]).long()
                            + row_base, D).numpy()
            for access in sorted({_k3h_access(D, G), "masked"}):
                for s_ in counts:
                    hits = np.zeros((len(uids), D + 8), np.int64)
                    keys = np.full((len(uids), D, 2), -1, np.int64)
                    for slot, off, cols, kc in _k3h_stores(
                            D, uids, G, s_, access, row_base):
                        if access == "pairs":
                            assert len(cols) == 2 and cols[0] % 2 == 0
                            assert (2 * off) % 4 == 0 and cols[1] < D
                        for c, k in zip(cols, kc):
                            hits[slot, c] += 1
                            if c < D:
                                keys[slot, c] = k
                    np.testing.assert_array_equal(hits[real, :D], 1)
                    assert not hits[~real].any() and not hits[:, D:].any()
                    rk = torch.as_tensor(keys[real, :, 0])
                    col = torch.as_tensor(keys[real, :, 1])
                    bits = fmix32(sr_row_keys(step, rk.reshape(-1))
                                  .reshape(rk.shape)
                                  ^ _mul32(col, _GOLDEN)).numpy()
                    np.testing.assert_array_equal(bits, plain)


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
    launches = tracing.counts()
    out = tl.tbe_lookup_pooled(torch.as_tensor(w), torch.as_tensor(ids),
                               torch.as_tensor(coeff)).numpy()
    assert tracing.counts() == launches  # CPU tensors take the plain version
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
    before = tracing.counts()
    W = torch.as_tensor(w.copy())
    out = fk.fused_update_sgd(W, torch.as_tensor(uids),
                              torch.as_tensor(totals), LR, weight_decay=wd)
    assert out is W and tracing.counts() == before  # in place, plain version
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


# -- the fused rowwise kernel and the moment kernel --------------------------


@pytest.mark.parametrize("D", range(1, 161))
def test_fused_and_moment_geometry(D):
    """Slots a warp a multiple of the warp's lane groups, at most 32, at
    every slot count of a launch; at a warp a row (D > 64) the geometry the
    kernels took before lane groups: `fused_slots_per_warp(N)` for the
    fused kernel, 32 for the moment kernel."""
    G, P = lanes_per_row(D), rows_per_warp(D)
    for N in (1, B4R_N, KAGGLE_N, 2**31 - 1):
        lanes, slots = fk.fused_geometry(D, N)
        assert lanes == G and 1 <= slots <= 32 and slots % P == 0
        if G == 32:
            assert slots == fk.fused_slots_per_warp(N)
    lanes, slots = fk.moment_geometry(D)
    assert lanes == G and 1 <= slots <= 32 and slots % P == 0
    if G == 32:
        assert slots == 32


def test_fused_and_moment_geometry_at_the_paths_shapes():
    """The geometry at the shapes of the paths that run it, checked by the
    sweep on the card (PERF.md): the fused kernel one slot a lane group
    at BERT4Rec's 2,048 slots and four at the D=10 DeepFM's and the
    Criteo Kaggle DLRM's 212,992 (and at 65,536, a shape no path trains);
    the moment kernel one step a lane group at D=10, two at D=64; D=128
    as before lane groups."""
    got = {(D, N): fk.fused_geometry(D, N)
           for D in (10, 64, 128) for N in (B4R_N, 65_536, KAGGLE_N)}
    assert got == {(10, B4R_N): (4, 8), (10, 65_536): (4, 32),
                   (10, KAGGLE_N): (4, 32), (64, B4R_N): (16, 2),
                   (64, 65_536): (16, 8), (64, KAGGLE_N): (16, 8),
                   (128, B4R_N): (32, 1), (128, 65_536): (32, 2),
                   (128, KAGGLE_N): (32, 2)}
    assert [fk.moment_geometry(D) for D in (3, 8, 10, 32, 64, 128)] == [
        (1, 32), (2, 16), (4, 8), (8, 8), (16, 4), (32, 32)]


def _nth_set_bit(mask, r):
    """csrc/fused_update.cu's nth_set_bit: r when the set bits are a
    prefix, else the position of the set bit of rank r (from 0) in a
    32-bit mask, by halving the window."""
    if mask & (mask + 1) == 0:
        return r
    pos = 0
    for half in (16, 8, 4, 2, 1):
        low = bin(mask & ((1 << half) - 1)).count("1")
        if r >= low:
            r, mask, pos = r - low, mask >> half, pos + half
    return pos


def _warp_ids(uids, slots):
    """(first slot, each lane's id: -1 from the warp's slot count on) of
    every warp of a launch over the slots of `uids`."""
    N = len(uids)
    for base in range(0, N, slots):
        n = min(N - base, slots)
        yield base, [int(uids[base + lane]) if lane < n else -1
                     for lane in range(32)]


def _ballot(ids):
    return sum(1 << lane for lane, i in enumerate(ids) if 0 <= i < R)


def _cover_quad(hits, slot, q, D):
    for c in range(4 * q, 4 * q + 4):
        if c < D:  # masked past D; whole at D % 4 == 0
            hits[slot, c] += 1


def _fused_cover(D, uids, G, slots):
    """How often the fused rowwise kernel's launch moves each (slot,
    column) and writes each slot's momentum word, from its index
    arithmetic: group p of P = 32 / G takes the real slots of rank p,
    p + P, ... (nth_set_bit), every group running the warp's
    ceil(count / P) steps; lane `sub` of a group holds quads sub, sub + G,
    ..., the group's first lane the momentum word. At D > 64 (G = 32)
    that is the warp walking the ballot's real slots in order, lane l
    holding quads l, l + 32, ..."""
    quads = -(-D // 4)
    hits = np.zeros((len(uids), 4 * max(quads, G) + 4), np.int64)
    mom = np.zeros(len(uids), np.int64)
    P = 32 // G
    for base, ids in _warp_ids(uids, slots):
        todo = _ballot(ids)
        count = bin(todo).count("1")
        for step in range(-(-count // P)):
            for lane in range(32):
                rank = lane // G + step * P
                if rank >= count:  # no row this step: the butterfly only
                    continue
                j = _nth_set_bit(todo, rank)
                assert j < slots and 0 <= ids[j] < R
                if lane % G == 0:
                    mom[base + j] += 1
                for q in range(lane % G, quads, G):
                    _cover_quad(hits, base + j, q, D)
    return hits, mom


def _moment_cover(D, uids, G, slots):
    """How often the moment kernel's launch moves each (slot, column):
    group p of P = 32 / G (one group of 32 lanes at D > 64) walks slots
    p, p + P, ... of the warp's, every group running the same steps; lane
    `sub` of a group holds quads sub, sub + G, ..."""
    quads = -(-D // 4)
    hits = np.zeros((len(uids), 4 * max(quads, G) + 4), np.int64)
    for base, ids in _warp_ids(uids, slots):
        n = min(len(uids) - base, slots)
        for step in range(0, n, 32 // G):
            for lane in range(32):
                j = step + lane // G
                assert j < 32
                if not 0 <= ids[j] < R:  # sentinels, and -1 from n on
                    continue
                for q in range(lane % G, quads, G):
                    _cover_quad(hits, base + j, q, D)
    return hits


def _slot_patterns(D):
    """Slots as the kernels get them: the dedup output (real ids sorted
    and first, sentinels R + pos) and the run totals (sentinels 2**31 - 1
    between the real ids), both from tfu on duplicate-rich ids with
    invalid slots, at 1, 31 and 101 slots; and one with real ids and both
    sentinels in random order."""
    rng = np.random.RandomState(D)
    out = []
    for n in (1, 31, 101):
        ids = rng.randint(0, R, size=n).astype(np.int32)
        ids[: n // 4] = rng.randint(0, 20, size=n // 4)
        args = (torch.as_tensor(ids), torch.zeros((n, 1)),
                torch.as_tensor(rng.rand(n) > 0.2), R)
        out += [tfu.dedup_row_grads(*args)[0].numpy(),
                tfu.run_total_row_grads(*args)[0].numpy()]
    mixed = rng.permutation(R)[:70].astype(np.int64)
    mixed = np.concatenate([mixed, R + np.arange(20), [2**31 - 1] * 11])
    return out + [rng.permutation(mixed).astype(np.int32)]


@pytest.mark.parametrize("kernel", ["fused", "moment"])
@pytest.mark.parametrize("D", [1, 2, 3, 4, 5, 8, 10, 12, 16, 17, 32, 33, 63,
                               64, 65, 128, 130, 600])
def test_update_kernel_index_map_covers_each_real_slot_once(kernel, D):
    G, P = lanes_per_row(D), rows_per_warp(D)
    counts = [s for s in (1, 2, 4, 8, 16, 32) if s % P == 0]
    if kernel == "fused":
        assert fk.fused_geometry(D, KAGGLE_N)[1] in counts
    else:
        assert fk.moment_geometry(D)[1] in counts
    for uids in _slot_patterns(D):
        real = (uids >= 0) & (uids < R)
        for slots in counts:
            if kernel == "fused":
                hits, mom = _fused_cover(D, uids, G, slots)
                np.testing.assert_array_equal(mom, real.astype(np.int64))
                covers = [hits]
            else:
                covers = [_moment_cover(D, uids, G, slots)]
            for hits in covers:
                np.testing.assert_array_equal(hits[real, :D], 1)
                assert not hits[~real].any() and not hits[:, D:].any()


def _group_mean_sq(g):
    """The narrow fused kernel's g^2 mean in torch ops: lane `sub` of a
    row's G = lanes_per_row(D) lanes holds ((x*x + y*y) + z*z) + w*w of
    quad `sub` (+0.0 past the row's quads), the xor butterfly inside the
    group halves the partials pairwise from G / 2 (lane l adds lane
    l + h's), and the total is divided by D once."""
    N, D = g.shape
    G = lanes_per_row(D)
    sq = torch.nn.functional.pad(g * g, (0, 4 * G - D)).view(N, G, 4)
    part = ((sq[..., 0] + sq[..., 1]) + sq[..., 2]) + sq[..., 3]
    h = G // 2
    while h:
        part = part[:, :h] + part[:, h:2 * h]
        h //= 2
    total = part[:, 0]
    return total / torch.full_like(total, D)


@pytest.mark.parametrize("D", range(1, 65))
def test_group_butterfly_equals_row_mean_sq(D):
    """The group's total is the warp's: lanes past the row's quads hold
    +0.0 and partials are never -0.0, so the warp's butterfly steps over
    offsets >= G add +0.0 and change nothing. Random rows over 12 orders
    of magnitude, and rows with 0, -0.0, f32 subnormals, values whose
    square overflows, inf and NaN; bit for bit (NaN where NaN)."""
    rng = np.random.RandomState(D + 40)
    g = (rng.randn(64, D) * np.exp(rng.randn(64, 1) * 3)).astype(np.float32)
    special = np.array([0.0, -0.0, 1e-40, -3e-39, 2e19, -3e38, np.inf,
                        -np.inf, np.nan, 1.0], np.float32)
    edge = rng.choice(special, size=(48, D)).astype(np.float32)
    edge[:8] = special[rng.randint(0, 4, size=(8, D))]  # zeros, subnormals
    edge[8:16] = np.delete(special, 8)[rng.randint(0, 9, size=(8, D))]
    edge[8:16, 0] = [np.inf, 2e19, -np.inf, -3e38] * 2  # no NaN: inf sums
    x = torch.as_tensor(np.concatenate([g, edge]))
    got, ref = _group_mean_sq(x), fk.row_mean_sq(x)
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan].view(torch.int32),
                       ref[~nan].view(torch.int32))
    assert nan.any() and torch.isinf(ref[72:80]).all()
    assert (ref[64:72] < 1e-30).all()


def _dedup(D, seed):
    ids, grads, valid = _raw(D, seed)
    uids, sums = jfu.dedup_row_grads(
        jnp.asarray(ids), jnp.asarray(grads), jnp.asarray(valid), R)
    return np.array(uids), np.array(sums)


def _raw(D, seed):
    """Duplicate-rich ids with invalid slots and their gradients."""
    rng = np.random.RandomState(seed)
    n = 101
    ids = rng.randint(0, R, size=n).astype(np.int32)
    ids[: n // 4] = rng.randint(0, 20, size=n // 4)
    return ids, rng.randn(n, D).astype(np.float32), rng.rand(n) > 0.2


def _untouched(outs, before, uids):
    rest = np.setdiff1d(np.arange(R), uids[(uids >= 0) & (uids < R)])
    for out, b in zip(outs, before):
        np.testing.assert_array_equal(out.numpy()[rest], b[rest])


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("D", [10, 64])
def test_k4_plain_matches_pallas_at_narrow_widths(D, wd):
    uids, sums = _dedup(D, seed=D + 4)
    w = np.random.RandomState(D + 5).randn(R, D).astype(np.float32)
    m = np.random.RandomState(D + 6).rand(R).astype(np.float32)
    ref_w, ref_m = pe.fused_update_rowwise_adagrad(
        jnp.asarray(w), jnp.asarray(m), jnp.asarray(uids), jnp.asarray(sums),
        LR, weight_decay=wd, momentum_stream=True, interpret=True)
    before = tracing.counts()
    W, M = torch.as_tensor(w.copy()), torch.as_tensor(m.copy())
    out = fk.fused_update_rowwise_adagrad(
        W, M, torch.as_tensor(uids), torch.as_tensor(sums), LR,
        weight_decay=wd, momentum_stream=True)
    assert out[0] is W and out[1] is M and tracing.counts() == before
    np.testing.assert_allclose(W.numpy(), np.asarray(ref_w), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(M.numpy(), np.asarray(ref_m), rtol=1e-6)
    _untouched((W, M), (w, m), uids)


@pytest.mark.parametrize("k", ["K6", "K7"])
@pytest.mark.parametrize("D", [10, 64])
def test_moment_plain_matches_pallas_at_narrow_widths(D, k):
    uids, totals = _run_totals(D, seed=D + 7)
    assert (uids == 2**31 - 1).any()
    rng = np.random.RandomState(D + 8)
    w = rng.randn(R, D).astype(np.float32)
    moms = [(rng.rand(R, D) * 0.01).astype(np.float32)
            for _ in range(1 if k == "K6" else 2)]
    step = 6  # the incremented step: bias corrections far from 1
    j = [jnp.asarray(a) for a in (w, *moms, uids, totals)]
    if k == "K6":
        ref = pe.fused_update_adagrad(*j, LR, interpret=True)
    else:
        ref = pe.fused_update_adam(*j, LR, jnp.asarray(step, jnp.int32),
                                   interpret=True)
    before = tracing.counts()
    state = [torch.as_tensor(a.copy()) for a in (w, *moms)]
    args = (torch.as_tensor(uids), torch.as_tensor(totals), LR)
    if k == "K6":
        out = fk.fused_update_adagrad(*state, *args)
    else:
        out = fk.fused_update_adam(*state, *args,
                                   torch.tensor(step, dtype=torch.int32))
    assert all(o is s for o, s in zip(out, state))
    assert tracing.counts() == before
    np.testing.assert_allclose(state[0].numpy(), np.asarray(ref[0]),
                               rtol=1e-5, atol=1e-6)
    for got, r in zip(state[1:], ref[1:]):
        np.testing.assert_allclose(got.numpy(), np.asarray(r), rtol=1e-6,
                                   atol=1e-7)
    _untouched(state, (w, *moms), uids)


@pytest.mark.parametrize("name", ["bf16", "fp16"])
def test_k4h_plain_matches_jax_xla_route_at_d10(name):
    """K4h's plain version on the port's dedup output against JAX's
    `apply_fused_update` on a half table under ROWWISE_ADAGRAD (its XLA
    route), stochastic rounding off: the same f32 update, rounded to
    nearest as `w + upd.astype(dtype)`."""
    D = 10
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "fp16": (torch.float16, jnp.float16)}[name]
    ids, grads, valid = _raw(D, seed=9)
    rng = np.random.RandomState(10)
    w = (rng.randn(R, D) * 0.5).astype(np.float32)
    m = (rng.rand(R) * 0.01).astype(np.float32)
    state = jfu.init_fused_optimizer_state(
        R, D, jfu.EmbOptimType.ROWWISE_ADAGRAD)
    state = state.replace(momentum1=jnp.asarray(m),
                          step=jnp.asarray(5, jnp.int32))
    jw, jstate = jfu.apply_fused_update(
        jnp.asarray(w, jdt), state, jnp.asarray(ids), jnp.asarray(grads),
        jnp.asarray(valid), LR, weight_decay=0.01, stochastic_rounding=False)
    uids, sums = tfu.dedup_row_grads(torch.as_tensor(ids),
                                     torch.as_tensor(grads),
                                     torch.as_tensor(valid), R)
    W, M = torch.as_tensor(w).to(tdt), torch.as_tensor(m.copy())
    before = tracing.counts()
    fk.fused_update_rowwise_adagrad_half(
        W, M, uids, sums, LR, torch.tensor(5, dtype=torch.int32),
        weight_decay=0.01, stochastic_rounding=False)
    assert tracing.counts() == before and W.dtype == tdt
    got = W.float().numpy()
    ref = np.array(jnp.asarray(jw, jnp.float32))
    hits = np.bincount(ids[valid], minlength=R)
    start = torch.as_tensor(w).to(tdt).float().numpy()
    assert not np.array_equal(got[hits > 0], start[hits > 0])  # it moved
    np.testing.assert_array_equal(got[hits == 0], start[hits == 0])
    np.testing.assert_array_equal(got[hits == 1], ref[hits == 1])
    t = torch.as_tensor(ref).to(tdt)
    ulp = (torch.nextafter(t, torch.full_like(t, float("inf"))).float()
           - t.float()).numpy()
    assert (np.abs(got - ref) <= ulp).all()
    np.testing.assert_allclose(M.numpy(), np.asarray(jstate.momentum1),
                               rtol=1e-4, atol=1e-9)


def _ulp(x, dtype):
    """One ulp of the half type `dtype` at each element of f32 x."""
    t = torch.as_tensor(x).to(dtype)
    return (torch.nextafter(t, torch.full_like(t, float("inf"))).float()
            - t.float()).numpy()


@pytest.mark.parametrize("wd", [0.0, 0.01])
@pytest.mark.parametrize("name", ["bf16", "fp16"])
@pytest.mark.parametrize("D", [10, 64])
def test_k3h_plain_matches_jax_xla_route(D, name, wd):
    """K3h's plain version on the port's run totals against JAX's
    `apply_fused_update` on a half table under EXACT_SGD (its XLA route),
    stochastic rounding off: the same f32 update, rounded to nearest as
    `w + upd.astype(dtype)`. Rows hit once bit for bit, untouched rows
    equal; at weight decay 0.01 (JAX's run-total route) every row within
    one ulp of the half type. At weight decay 0 JAX adds each duplicate
    token's rounded step on its own (the port rounds the row's total once:
    test_torch_port_low_precision.py's trap 2), so there, as at 0.01,
    every row is held within one ulp, at the larger of the result and the
    update, of JAX's route on the widened table in f32 (the widths
    tests' tolerance: half(w + half(upd)) rounds the update first)."""
    tdt, jdt = {"bf16": (torch.bfloat16, jnp.bfloat16),
                "fp16": (torch.float16, jnp.float16)}[name]
    ids, grads, valid = _raw(D, seed=D + 11)
    w = (np.random.RandomState(D + 12).randn(R, D) * 0.5).astype(np.float32)
    start = torch.as_tensor(w).to(tdt).float().numpy()  # the table, exactly
    state = jfu.init_fused_optimizer_state(R, D, jfu.EmbOptimType.EXACT_SGD)
    state = state.replace(step=jnp.asarray(5, jnp.int32))
    ref = {}
    for tag, table in (("half", jnp.asarray(w, jdt)),
                       ("f32", jnp.asarray(start))):
        jw, _ = jfu.apply_fused_update(
            table, state, jnp.asarray(ids), jnp.asarray(grads),
            jnp.asarray(valid), LR, weight_decay=wd,
            stochastic_rounding=False)
        ref[tag] = np.array(jnp.asarray(jw, jnp.float32))
    uids, totals = tfu.run_total_row_grads(torch.as_tensor(ids),
                                           torch.as_tensor(grads),
                                           torch.as_tensor(valid), R)
    W = torch.as_tensor(w).to(tdt)
    before = tracing.counts()
    out = fk.fused_update_sgd_half(
        W, uids, totals, LR, torch.tensor(5, dtype=torch.int32),
        weight_decay=wd, stochastic_rounding=False)
    assert out is W and tracing.counts() == before and W.dtype == tdt
    got = W.float().numpy()
    hits = np.bincount(ids[valid], minlength=R)
    assert (hits > 1).any()  # duplicate tokens, summed into run totals
    assert not np.array_equal(got[hits > 0], start[hits > 0])  # it moved
    np.testing.assert_array_equal(got[hits == 0], start[hits == 0])
    np.testing.assert_array_equal(got[hits == 1], ref["half"][hits == 1])
    if wd:
        assert (np.abs(got - ref["half"]) <= _ulp(ref["half"], tdt)).all()
    x32 = ref["f32"]
    big = np.maximum(np.abs(x32), np.abs(x32 - start))
    assert (np.abs(got - x32) <= _ulp(big, tdt)).all()
