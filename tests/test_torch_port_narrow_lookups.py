"""The narrow-row layout of the lookups K8, the routed gather and Kq, on
the CPU.

K8 and the routed gather (csrc/gather_rows.cu) and Kq (csrc/quant_lookup.cu)
give a row of D columns `lanes_per_row(D)` lanes (ops/lane_groups.py), so
at D <= 64 a warp copies or pools several rows, tokens or bags, one per
lane group, each lane a quad of 4 columns; wider rows keep a warp each.
The kernels run on the card only; here:

* the lane group each wrapper hands its C entry point for D = 1..160,
  captured on a stand-in library with fake CUDA tensors;
* numpy emulations of the kernels' index maps, driven by that geometry and
  by the access each launcher picks from D and the pointers' alignment
  (`pick_access` in csrc/gather_rows.cu, `launch_narrow` and `launch` in
  csrc/quant_lookup.cu, spelled out below): every (row, token or bag,
  column) is written exactly once and no column >= D; every load is
  aligned to its width and lies inside its row (no byte past a packed
  row); a zero-coefficient slot of a pooled bag is not read; a masked
  token reads no row; the route-only mode writes each token's route once;
* the plain versions the wrappers take on CPU tensors at D = 10 and 64
  against the JAX package: K8 against the Pallas gather in interpret mode
  and the routed gather against JAX's `_route`, the Pallas gather and the
  mask multiply (bit for bit; rows by value, as test_torch_port_gather.py
  holds them), Kq at 8 and 4 bits against `dequantize_rows` and
  `quant_embedding_bag_lookup` (bit for bit at one slot, rtol = atol =
  1e-6 at L=5, where only the order of the sums differs).
"""

import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.modules.embedding_configs import (
    EmbeddingConfig as JSeqConfig,
)
from torchrec_tpu.ops import pallas_embedding as pe
from torchrec_tpu.ops import quant as jq
from torchrec_tpu.ops.embedding import PoolingMode as JMode
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.parallel.sharded_ec import (
    ShardedEmbeddingCollection as JSEC,
)
from torchrec_tpu_torch.ops import gather_rows as gr
from torchrec_tpu_torch.ops import quant as tq
from torchrec_tpu_torch.ops import quant_lookup as ql
from torchrec_tpu_torch.ops.embedding import PoolingMode
from torchrec_tpu_torch.ops.lane_groups import lanes_per_row
from torchrec_tpu_torch.utils import tracing

# chip_smoke.py's NARROW_WIDTHS: every lane group at its ends and inside
WIDTHS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16, 17, 18, 32, 33, 34, 63, 64, 128)
THREADS = 256  # kThreads of gather_rows.cu
TURNS = 4  # kTurns of gather_rows.cu: the rows a lane group of K8 copies
WARPS_PER_BLOCK = 8  # kWarpsPerBlock of quant_lookup.cu
BASE = 1 << 12  # an address aligned to every access


def _kq_bits(D):
    """The bit counts that pack a row of D columns."""
    return [b for b in (8, 4, 2) if D * b % 8 == 0 and (b != 2 or D % 4 == 0)]


KQ_CASES = [(D, b) for D in WIDTHS for b in _kq_bits(D)]


# -- the geometry the wrappers hand the launch ---------------------------------


class _Library:
    """A stand-in for a built library: every entry point records its
    arguments and returns 0 (no error); `bind` gives them the real
    ctypes argtypes."""

    def __init__(self, bind):
        self.calls = []
        self.entries = {}
        bind(self)

    def __getattr__(self, name):
        if not name.startswith("trt_"):
            raise AttributeError(name)
        calls = self.calls

        class Entry:
            argtypes = None

            def __call__(self, *args):
                calls.append((name, args))
                return 0

        return self.entries.setdefault(name, Entry())


@pytest.fixture
def stand_in(monkeypatch):
    """Fake CUDA tensors reach the stand-in libraries of K8 and Kq: the
    streams and devices of torch.cuda stood in, as no card is here."""

    class Stream:
        cuda_stream = 0

    libs = {}
    for mod in (gr, ql):
        libs[mod] = _Library(mod._bind)
        monkeypatch.setattr(mod.LIBRARY, "load",
                            lambda lib=libs[mod]: lib)
    monkeypatch.setattr(gr, "_routed_fn", None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    return libs


def _launch(libs, call):
    """Run `call` on fake CUDA tensors; the (entry point, arguments) pairs
    it handed the stand-in libraries."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # data_ptr of a fake tensor
        with FakeTensorMode():
            call("cuda")
    calls = [c for lib in libs.values() for c in lib.calls]
    for lib in libs.values():
        for name, args in lib.calls:
            assert len(args) == len(lib.entries[name].argtypes)
        lib.calls.clear()
    return calls


@pytest.mark.parametrize("D", range(1, 161))
def test_lookups_hand_their_lane_group_to_the_launch(D, stand_in):
    """K8, the routed gather, its route-only mode and Kq (pooled and
    unpooled, at each bit count that packs D) pass G = lanes_per_row(D)
    (the route-only mode 1) with as many arguments as their ctypes
    signatures: the geometry comes from D alone."""
    G = lanes_per_row(D)

    def k8(dev):
        gr.gather_rows_forward(torch.zeros(9, D, device=dev),
                               torch.zeros(5, dtype=torch.int32, device=dev))

    def routed(dev):
        ids = torch.zeros(2, 3, 4, dtype=torch.int32, device=dev)
        args = (ids, torch.zeros(2, 3, dtype=torch.int32, device=dev),
                torch.ones(2, dtype=torch.int32, device=dev),
                torch.zeros(2, dtype=torch.int32, device=dev), 0)
        gr.routed_gather_rows(torch.zeros(9, D, device=dev), *args)
        gr.route_tokens(*args)

    (name, args), = _launch(stand_in, k8)
    assert name == "trt_gather_rows_f32" and args[3:7] == (9, D, 5, G)
    (n1, a1), (n2, a2) = _launch(stand_in, routed)
    assert n1 == n2 == "trt_routed_gather_rows_f32"
    assert a1[8:15] == (9, D, 2, 3, 4, 0, G)
    assert a2[5] is None and a2[8:15] == (0, 0, 2, 3, 4, 0, 1)
    for bits in _kq_bits(D):
        def kq(dev, bits=bits):
            data = torch.zeros(9, D * bits // 8, dtype=torch.uint8,
                               device=dev)
            s = torch.ones(9, device=dev)
            ids = torch.zeros(5, 3, dtype=torch.int32, device=dev)
            ql.quant_lookup_pooled(data, s, s, ids,
                                   torch.ones(5, 3, device=dev), bits)
            ql.quant_lookup_rows(data, s, s, ids.reshape(-1), bits)

        (p, pa), (u, ua) = _launch(stand_in, kq)
        assert p == "trt_quant_lookup_pooled" and u == "trt_quant_lookup_rows"
        assert pa[6:12] == (9, D, 5, 3, bits, G)
        assert ua[6:11] == (9, D, 15, bits, G)


# -- the index maps ---------------------------------------------------------


def _pick_access(D, *addrs):
    """gather_rows.cu's `pick_access`: whole quads as float4s, float2
    pairs, or elements."""
    a = 0
    for x in addrs:
        a |= x
    if D % 4 == 0 and a % 16 == 0:
        return "quad"
    if D % 2 == 0 and a % 8 == 0:
        return "pair"
    return "elem"


def _quad_loads(acc, c, D):
    """(first column, columns) of each float load of quad c .. c + 3 of a
    row under `acc` (load_quad / store_quad): past D nothing."""
    if acc == "quad":
        return [(c, 4)]
    if acc == "pair":
        return [(c, 2)] + ([(c + 2, 2)] if c + 2 < D else [])
    return [(k, 1) for k in range(c, min(c + 4, D))]


def _check_f32_load(addr, col, width, D):
    """A float load of `width` floats at `addr`: aligned to its size and
    inside its row."""
    assert addr % (4 * width) == 0, (addr, width)
    assert 0 <= col and col + width <= D


def _k8_lanes(D, N, G, acc):
    """(row, (first column, columns)) of every lane's moves in K8's launch
    for N rows of width D: at G < 32 lane l of warp w moves quad l % G of
    rows w * P * TURNS + l / G + k * P, k < TURNS (P = 32 / G), under
    `acc`; at G = 32 lane l of the warp of row n moves float4 l, l + 32,
    ... (acc "quad") or float l, l + 32, ... (otherwise)."""
    if G < 32:
        P = 32 // G
        warps = -(-N // (P * TURNS))
    else:
        warps = N
    out = []
    for t in range(-(-warps * 32 // THREADS) * THREADS):
        if G < 32:
            lane, c = t & 31, 4 * (t % G)
            base = (t >> 5) * P * TURNS + lane // G
            if c >= D:
                continue
            for n in range(base, base + TURNS * P, P):
                if n < N:
                    out += [(n, m) for m in _quad_loads(acc, c, D)]
        else:
            n, lane = t >> 5, t & 31
            if n >= N:
                continue
            if acc == "quad":
                out += [(n, (4 * q, 4)) for q in range(lane, D // 4, 32)]
            else:
                out += [(n, (c, 1)) for c in range(lane, D, 32)]
    return out


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("D", WIDTHS)
def test_k8_index_map_covers_each_row_once(D, offset):
    """Each (row, column) of the output written once and read once from
    its row of W, every load and store aligned to its width: the table one
    element into its storage in the offset case."""
    N, G = 37, lanes_per_row(D)
    w_base, out_base = BASE + 4 * offset, BASE
    acc = _pick_access(D, w_base, out_base)
    hits = np.zeros((N, D + 8), np.int64)
    for n, (col, width) in _k8_lanes(D, N, G, acc):
        _check_f32_load(w_base + 4 * (7 * D + col), col, width, D)
        _check_f32_load(out_base + 4 * (n * D + col), col, width, D)
        hits[n, col:col + width] += 1
    np.testing.assert_array_equal(hits[:, :D], 1)
    assert not hits[:, D:].any()


def _route_numpy(ids, lengths, sr, off, rank):
    """The route with Python's floor division and modulo."""
    owner = np.floor_divide(ids, sr[:, None, None])
    local = np.mod(ids, sr[:, None, None]) + off[:, None, None]
    col = np.arange(ids.shape[2])
    return local, (owner == rank) & (col[None, None, :] < lengths[:, :, None])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("D", WIDTHS + (0,))
def test_routed_gather_index_map(D, offset):
    """The routed gather at width D (D = 0: its route-only mode, one thread
    a token): each token's local row and owned flag written once, by the
    first lane of its group; each (token, column) of the output written
    once, an owned token's from its row, a masked token's as zeros with no
    read of W."""
    rng = np.random.RandomState(D + offset)
    F, B, L, R = 3, 5, 7, 40
    ids = rng.randint(-30, 90, size=(F, B, L))
    lengths = rng.randint(0, L + 1, size=(F, B))
    sr, off = np.array([20, 9, 30]), np.array([0, 20, 29])
    local, owned = _route_numpy(ids, lengths, sr, off, 1)
    assert owned.any() and (~owned).any()
    N = F * B * L
    G = lanes_per_row(D) if D else 1
    acc = _pick_access(D, BASE + 4 * offset, BASE) if D else "elem"
    route_hits = np.zeros(N, np.int64)
    hits = np.zeros((N, D + 8), np.int64)
    reads = np.zeros(N, np.int64)
    for t in range(-(-N * G // THREADS) * THREADS):
        n = t // G
        if n >= N:
            continue
        if t % G == 0:
            route_hits[n] += 1
        c = 4 * (t % G)
        if not D or c >= D:  # route-only, or a lane past the row
            continue
        for col, width in _quad_loads(acc, c, D):
            if owned.reshape(-1)[n]:
                row = min(max(local.reshape(-1)[n], 0), R - 1)
                _check_f32_load(BASE + 4 * offset + 4 * (row * D + col),
                                col, width, D)
                reads[n] += width
            hits[n, col:col + width] += 1
    np.testing.assert_array_equal(route_hits, 1)
    if D:
        np.testing.assert_array_equal(hits[:, :D], 1)
        assert not hits[:, D:].any()
        np.testing.assert_array_equal(reads, owned.reshape(-1) * D)


def _kq_access(D, bits, data_addr):
    """quant_lookup.cu's `launch_narrow`: one word of the quad's bits,
    2-column pieces, or bytes."""
    if bits == 2:
        return "quad"
    if bits == 4:
        return "quad" if D % 4 == 0 and data_addr % 2 == 0 else "pair"
    if D % 4 == 0 and data_addr % 4 == 0:
        return "quad"
    return "pair" if D % 2 == 0 and data_addr % 2 == 0 else "elem"


def _kq_quad_bytes(acc, bits, c, D):
    """(first byte, bytes) of each load of quad c .. c + 3 of a packed row
    (load_packed_quad)."""
    first = c * bits // 8
    if acc == "quad":
        return [(first, 4 * bits // 8)]
    if acc == "pair":
        piece = 2 * bits // 8
        return [(first, piece)] + ([(first + piece, piece)]
                                   if c + 2 < D else [])
    return [(first + k, 1) for k in range(min(4, D - c))]


def _kq_lanes(D, bits, NB, L, coeff, acc):
    """Kq's launch for NB bags of L slots: (bag, slot, (first byte, bytes))
    of every packed load, and (bag, first column, columns) of every store.
    At G < 32 (quant_lookup_narrow_kernel) warp w takes bags w * 32 / G ..,
    lane l bag w * 32 / G + l / G and quad l % G, and reads a slot's row
    unless its coefficient is 0; at G = 32 (quant_lookup_kernel) a warp
    takes a bag and 32 words (D % 4 == 0 and aligned data: quads) or 32
    columns of it."""
    G = lanes_per_row(D)
    loads, stores = [], []
    if G < 32:
        P = 32 // G
        warps = -(-NB // P)
        for w in range(-(-warps // WARPS_PER_BLOCK) * WARPS_PER_BLOCK):
            first = w * P
            if first >= NB:
                continue
            for lane in range(32):
                bag, c = first + lane // G, 4 * (lane % G)
                if bag >= NB or c >= D:
                    continue
                for slot in range(L):
                    if coeff[bag, slot] != 0:
                        loads += [(bag, slot, b)
                                  for b in _kq_quad_bytes(acc, bits, c, D)]
                stores.append((bag, c, min(4, D - c)))
        return loads, stores
    vec = acc == "quad"
    cols = D // 4 if vec else D
    for bag in range(NB):
        for col in range(cols):
            for slot in range(L):
                if coeff[bag, slot] != 0:
                    if vec:
                        loads.append((bag, slot, (col * bits // 2,
                                                  bits // 2)))
                    else:
                        loads.append((bag, slot, (col * bits // 8, 1)))
            stores.append((bag, 4 * col, 4) if vec else (bag, col, 1))
    return loads, stores


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("D,bits", KQ_CASES)
def test_kq_index_map_covers_each_bag_once(D, bits, offset):
    """Each (bag, column) of the output written once; each live slot's
    packed row read whole, each byte once, and nothing past it, every load
    aligned to its width (the packed rows one byte into their storage in
    the offset case); a slot whose coefficient is 0 not read."""
    rng = np.random.RandomState(D * bits + offset)
    NB, L = 13, 5
    coeff = rng.rand(NB, L) * (rng.rand(NB, L) > 0.3)
    row_bytes = D * bits // 8
    data_addr = BASE + offset
    acc = _kq_access(D, bits, data_addr)
    if lanes_per_row(D) == 32:  # the warp kernel's vector path
        acc = "quad" if D % 4 == 0 and data_addr % (bits // 2) == 0 \
            else "elem"
    loads, stores = _kq_lanes(D, bits, NB, L, coeff, acc)
    read = np.zeros((NB, L, row_bytes + 8), np.int64)
    for bag, slot, (first, size) in loads:
        row = 11  # any row: the addresses are the row's base plus these
        assert (data_addr + row * row_bytes + first) % size == 0
        assert first + size <= row_bytes
        read[bag, slot, first:first + size] += 1
    if lanes_per_row(D) < 32 or acc == "quad":
        want = (coeff != 0)[:, :, None] * np.ones(row_bytes, np.int64)
    else:  # the warp kernel's byte path: a byte per column it holds
        want = (coeff != 0)[:, :, None] * np.full(row_bytes, 8 // bits)
    np.testing.assert_array_equal(read[:, :, :row_bytes], want)
    assert not read[:, :, row_bytes:].any()
    hits = np.zeros((NB, D + 8), np.int64)
    for bag, c, n in stores:
        hits[bag, c:c + n] += 1
    np.testing.assert_array_equal(hits[:, :D], 1)
    assert not hits[:, D:].any()


# -- the plain versions against JAX at D = 10 and 64 --------------------------


@pytest.mark.parametrize("D", [10, 64])
def test_k8_plain_matches_pallas_at_narrow_widths(D):
    rng = np.random.RandomState(D)
    R = 50
    w = rng.randn(R, D).astype(np.float32)
    ids = rng.randint(-R - 3, R + 7, size=301).astype(np.int32)
    launches = tracing.counts()
    out = gr.gather_rows_forward(torch.from_numpy(w), torch.from_numpy(ids))
    assert tracing.counts() == launches  # CPU tensors take the plain version
    ref = np.asarray(pe.gather_rows(jnp.asarray(w), jnp.asarray(ids), 64,
                                    True))
    np.testing.assert_array_equal(out.numpy(), ref)


@pytest.mark.parametrize("my", [0, 1])
@pytest.mark.parametrize("D", [10, 64])
def test_routed_gather_plain_matches_jax_at_narrow_widths(D, my):
    """JAX's `_route` on a two-device row-wise sequence strategy, the
    Pallas gather (interpret mode) and the mask multiply against the plain
    routed gather: rows by value (JAX leaves -0.0 under a masked negative
    entry, the port +0.0), the route bit for bit."""
    tables = (JSeqConfig(num_embeddings=37, embedding_dim=D, name="t0",
                         feature_names=["a", "b"]),
              JSeqConfig(num_embeddings=20, embedding_dim=D, name="t1",
                         feature_names=["c"]))
    jsec = JSEC(JEnv.from_devices(jax.devices()[:2]), tables,
                {t.name: JPS(JST.ROW_WISE) for t in tables})
    strat = jsec.strategies[0]
    rng = np.random.RandomState(D + my)
    w = rng.randn(strat.rows_loc, D).astype(np.float32)
    ids = rng.randint(-45, 60, size=(3, 4, 6)).astype(np.int32)
    lengths = rng.randint(0, 7, size=(3, 4)).astype(np.int32)
    local, owned = strat._route(jnp.asarray(ids), jnp.asarray(lengths), my,
                                ids.shape[2])
    rows = pe.gather_rows(jnp.asarray(w), local.reshape(-1), 16, True)
    ref = np.asarray(rows.reshape(*ids.shape, D)
                     * owned.astype(jnp.float32)[..., None])
    assert np.asarray(owned).any() and not np.asarray(owned).all()
    args = (torch.from_numpy(ids), torch.from_numpy(lengths),
            torch.as_tensor(strat.feat_shard_rows, dtype=torch.int32),
            torch.as_tensor(strat.feat_local_off, dtype=torch.int32), my)
    out = gr.routed_gather_rows(torch.from_numpy(w), *args)
    np.testing.assert_array_equal(out.numpy(), ref)
    t_local, t_owned = gr.route_tokens(*args)
    np.testing.assert_array_equal(t_local.numpy(), np.asarray(local))
    np.testing.assert_array_equal(t_owned.numpy(), np.asarray(owned))


def _quant_pair(D, bits, seed):
    rng = np.random.RandomState(seed)
    w = rng.randn(70, D).astype(np.float32)
    w[3] = 0.25  # a constant row: scale 1.0
    return (jq.quantize_rowwise(jnp.asarray(w), bits),
            tq.quantize_rowwise(torch.from_numpy(w), bits))


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("D", [10, 64])
def test_kq_plain_dequantize_matches_jax_at_narrow_widths(D, bits):
    j, t = _quant_pair(D, bits, D + bits)
    ids = np.concatenate([np.arange(70), [69, 70, 75]]).astype(np.int32)
    launches = tracing.counts()
    got = tq.dequantize_rows(t, torch.from_numpy(ids))
    assert tracing.counts() == launches
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jq.dequantize_rows(j, jnp.asarray(ids))))


@pytest.mark.parametrize("L,weighted", [(1, False), (1, True), (5, True)])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("D", [10, 64])
def test_kq_plain_pooled_matches_jax_at_narrow_widths(D, bits, L, weighted):
    """SUM over bags of L slots (zero lengths among them): bit for bit at
    one slot, rtol = atol = 1e-6 at L=5 (JAX's einsum sums in its own
    order); MEAN at L=5 too."""
    j, t = _quant_pair(D, bits, 2 * D + bits)
    rng = np.random.RandomState(D + L)
    ids = rng.randint(0, 70, size=(3, 9, L)).astype(np.int32)
    lengths = rng.randint(0, L + 1, size=(3, 9)).astype(np.int32)
    psw = rng.rand(3, 9, L).astype(np.float32) if weighted else None
    for mode, tmode in ((JMode.SUM, PoolingMode.SUM),
                        (JMode.MEAN, PoolingMode.MEAN)):
        want = np.asarray(jq.quant_embedding_bag_lookup(
            j, jnp.asarray(ids), jnp.asarray(lengths), mode,
            None if psw is None else jnp.asarray(psw)))
        got = tq.quant_embedding_bag_lookup(
            t, torch.from_numpy(ids), torch.from_numpy(lengths), tmode,
            None if psw is None else torch.from_numpy(psw)).numpy()
        if L == 1 and mode is JMode.SUM:
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
