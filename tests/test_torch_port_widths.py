"""Tables of any width in the port against the JAX package, on the CPU.

The JAX package trains a table of any width D: its dispatch sends only D %
128 == 0 to Pallas and every other width to its XLA route. The port's CUDA
update kernels take any D as well (a masked path when D % 4 != 0 or a row
is not aligned, a two-pass path for the fused rowwise kernel past 512
columns); on the CPU the wrappers take their plain versions, which these
tests hold against JAX at widths the card's vector path does not take.
Inputs are made from a seed with numpy and handed to both sides.

Tolerances, as the files they come from hold the same functions:
`apply_fused_update` on fp32 tables as test_torch_port_fused_update.py
(rows rtol 1e-5 / atol 1e-6 and the rowwise momentum rtol 1e-6 for SGD,
EXACT_SGD and ROWWISE_ADAGRAD; NEW_OPTIMS' for the other six, momenta as
their rows); on bf16 / fp16 tables with stochastic rounding off, rows
within one ulp of the table's dtype at the larger of the result's and the
update's magnitude (half(w + half(upd)) rounds the update first; the
rowwise scale sums g^2 in another order than JAX's), single-slot rows of
SGD and EXACT_SGD bit for bit (test_half_update_sr_off_matches_jax holds
every optimizer so at D=16), with it on, every touched element
one of the two half neighbours of JAX's f32 update
(test_half_update_sr_on_lands_on_jax_neighbours), momenta as the fp32
cases. `row_mean_sq` bit for bit with a numpy model of the kernels' lane
order, and within rtol 1e-6 of `jnp.mean`. The D=10 DeepFM's DMP as
test_torch_port_deepfm.py holds the DeepFM DMP: probabilities, losses,
dense parameters, tables and full momenta rtol 1e-4 / atol 1e-5, the
rowwise momenta atol 1e-9; bf16 rows within one ulp; untouched rows equal.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_fused_update import NEW_OPTIMS
from torchrec_tpu.models.deepfm import SimpleDeepFMNN as JSimpleDeepFMNN
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.modules.embedding_configs import DataType as JDataType
from torchrec_tpu.ops import fused_update as jfu
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.models import SimpleDeepFMNN
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
)
from torchrec_tpu_torch.modules.embedding_configs import DataType
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils import tracing
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    fused_optimizer_state,
    load_jax_weights,
)

R, N, LR, WD, START = 50, 64, 0.1, 0.01, 4
HALF = {"bf16": (torch.bfloat16, jnp.bfloat16),
        "fp16": (torch.float16, jnp.float16)}


def _ulp(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """The table dtype's ulp at each value of x (representable in it)."""
    t = torch.tensor(x).to(dtype)
    return (torch.nextafter(t, torch.full_like(t, float("inf"))).float()
            - t.float()).numpy()


def _neighbours(x32: np.ndarray, dtype: torch.dtype):
    """The largest value of `dtype` <= x32 and the smallest >= x32."""
    t = torch.tensor(x32).to(dtype)
    tf = t.float().numpy()
    down = torch.nextafter(t, torch.full_like(t, -float("inf"))).float()
    up = torch.nextafter(t, torch.full_like(t, float("inf"))).float()
    return (np.where(tf <= x32, tf, down.numpy()),
            np.where(tf >= x32, tf, up.numpy()))


# -- apply_fused_update at any width -----------------------------------------

# (optimizer, table dtype, D, stochastic rounding): every optimizer on fp32
# tables at widths the card's vector path does not take (D % 4 != 0, and a
# masked second chunk at 130); the half kernels' optimizers at D = 10 and
# past the fused rowwise kernel's 512 register columns
WIDTH_CASES = (
    [(o.name, "fp32", D, False) for o in tfu.EmbOptimType
     for D in (1, 3, 10, 130)]
    + [(o, h, D, sr) for o in ("SGD", "EXACT_SGD", "ROWWISE_ADAGRAD")
       for h in HALF for D in (10, 1030) for sr in (False, True)])


def _inputs(optim: str, dim: int, seed: int):
    """Table, duplicate-rich ids with invalid slots, per-token gradients
    and the optimizer state at step START (momenta in [0, 0.1))."""
    rng = np.random.RandomState(seed)
    w = (rng.randn(R, dim) * 0.5).astype(np.float32)
    ids = rng.randint(0, R, size=N).astype(np.int32)
    ids[: N // 4] = rng.randint(0, 5, size=N // 4)  # hot rows repeat
    grads = (rng.randn(N, dim) * 0.1).astype(np.float32)
    valid = rng.rand(N) > 0.15
    moms = {}
    for tag, kind in zip(("momentum1", "momentum2"), tfu.fused_state_shapes(
            tfu.EmbOptimType[optim])):
        shape = {"row": (R,), "full": (R, dim)}.get(kind)
        if shape is not None:
            moms[tag] = (rng.rand(*shape) * 0.1).astype(np.float32)
    return w, ids, grads, valid, moms


@functools.lru_cache(maxsize=None)
def _jax_f32_update(optim: str, dtype: str, dim: int):
    """JAX's f32 update of the half table of `_inputs(optim, dim, dim)`,
    kept for the case with stochastic rounding on and the one with it off
    (an f32 table ignores the flag)."""
    w, ids, grads, valid, moms = _inputs(optim, dim, seed=dim)
    w = torch.tensor(w).to(HALF[dtype][0]).float().numpy()
    return _jax_update(optim, w, ids, grads, valid, moms, jnp.float32,
                       weight_decay=WD)


def _jax_update(optim, w, ids, grads, valid, moms, jdt, **kw):
    state = jfu.init_fused_optimizer_state(R, w.shape[1],
                                           jfu.EmbOptimType[optim])
    state = state.replace(step=jnp.asarray(START, jnp.int32),
                          **{k: jnp.asarray(v) for k, v in moms.items()})
    new_w, new = jfu.apply_fused_update(
        jnp.asarray(w, jdt), state, jnp.asarray(ids), jnp.asarray(grads),
        jnp.asarray(valid), LR, **kw)
    return (np.asarray(jnp.asarray(new_w, jnp.float32)),
            {k: np.asarray(getattr(new, k)) for k in moms})


@pytest.mark.parametrize("optim,dtype,dim,sr", WIDTH_CASES)
def test_apply_fused_update_at_any_width_matches_jax(optim, dtype, dim, sr):
    w, ids, grads, valid, moms = _inputs(optim, dim, seed=dim)
    tdt = torch.float32 if dtype == "fp32" else HALF[dtype][0]
    if dtype != "fp32":
        w = torch.tensor(w).to(tdt).float().numpy()  # the table's values
    if dtype == "fp32":
        ref_w, ref_moms = _jax_update(optim, w, ids, grads, valid, moms,
                                      jnp.float32, weight_decay=WD)
    elif sr:  # JAX's f32 update of the same table
        ref_w, ref_moms = _jax_f32_update(optim, dtype, dim)
    else:
        ref_w, ref_moms = _jax_update(optim, w, ids, grads, valid, moms,
                                      HALF[dtype][1], weight_decay=WD,
                                      stochastic_rounding=False)

    state = tfu.init_fused_optimizer_state(R, dim, tfu.EmbOptimType[optim])
    state.step.fill_(START)
    for k, v in moms.items():
        setattr(state, k, torch.tensor(v))
    W = torch.tensor(w).to(tdt)
    launches = tracing.counts()
    out_w, out = tfu.apply_fused_update(
        W, state, torch.tensor(ids), torch.tensor(grads),
        torch.tensor(valid), LR, weight_decay=WD, stochastic_rounding=sr)
    # CPU tensors take the plain versions
    assert tracing.counts() == launches
    assert out_w is W and W.dtype == tdt and int(out.step) == START + 1
    got = W.float().numpy()
    hits = np.bincount(ids[valid], minlength=R)
    assert not np.array_equal(got[hits > 0], w[hits > 0])  # it moved
    np.testing.assert_array_equal(got[hits == 0], w[hits == 0])
    if dtype == "fp32":
        rtol, atol = NEW_OPTIMS.get(optim, (1e-5, 1e-6))
        np.testing.assert_allclose(got, ref_w, rtol=rtol, atol=atol)
    elif sr:
        lo, hi = _neighbours(ref_w, tdt)
        on = (got == lo) | (got == hi)
        assert on[hits > 0].all()
        touched = hits > 0
        assert (got[touched] == lo[touched]).any()
        assert (got[touched] == hi[touched]).any()
    else:
        # half(w + half(upd)) rounds upd first: where the rowwise scale's
        # g^2 sum (row_mean_sq's order, JAX's jnp.mean) moves upd's last
        # f32 bit, half(upd) may differ by an ulp of upd, which exceeds an
        # ulp of the result where |upd| > |w + upd|
        x32, _ = _jax_f32_update(optim, dtype, dim)
        mag = np.maximum(np.abs(ref_w), np.abs(x32 - w))
        assert (np.abs(got - ref_w) <= _ulp(mag, tdt)).all()
        if optim != "ROWWISE_ADAGRAD":  # the same f32 arithmetic
            np.testing.assert_array_equal(got[hits == 1], ref_w[hits == 1])
    for k, ref in ref_moms.items():
        m = getattr(out, k).numpy()
        assert not np.array_equal(m, moms[k])  # it moved
        if optim in NEW_OPTIMS:  # the momenta as their rows
            rtol, atol = NEW_OPTIMS[optim]
        else:  # the rowwise momentum
            rtol, atol = 1e-6, 0.0
        np.testing.assert_allclose(m, ref, rtol=rtol, atol=atol, err_msg=k)
        np.testing.assert_array_equal(m[hits == 0], moms[k][hits == 0])


@pytest.mark.parametrize("dim", [10, 1030])
def test_rowwise_routes_agree_at_any_width(dim):
    """test_k4_routes_agree_on_momentum at widths off the vector path and
    past 512 columns: the four rowwise routes (K5 or torch index ops x
    scaled RMW or K2) leave the same momentum bit for bit, the same rows
    bit for bit between the two row writes, and rows within an ulp of the
    scale between the two momentum routes (lr * inv against -lr / (...))."""
    w, ids, grads, valid, _ = _inputs("ROWWISE_ADAGRAD", dim, seed=dim + 1)
    m = np.random.RandomState(dim).rand(R).astype(np.float32)
    uids, sums = tfu.dedup_row_grads(torch.tensor(ids), torch.tensor(grads),
                                     torch.tensor(valid), R)
    out = {}
    for stream in (True, False):
        for w_impl in ("rmw", "write"):
            W, M = torch.tensor(w), torch.tensor(m)
            fk.fused_update_rowwise_adagrad(
                W, M, uids, sums, LR, weight_decay=WD,
                momentum_stream=stream, w_impl=w_impl)
            out[stream, w_impl] = (W.numpy(), M.numpy())
    ref_w, ref_m = out[True, "rmw"]
    assert not np.array_equal(ref_m, m)
    for (stream, w_impl), (got_w, got_m) in out.items():
        np.testing.assert_array_equal(got_m, ref_m)
        np.testing.assert_array_equal(got_w, out[stream, "rmw"][0])
        np.testing.assert_allclose(got_w, ref_w, rtol=1e-6, atol=1e-7)


# -- no width refused on the card ---------------------------------------------

# (kernel, D): the f32 row kernels and both half kernels at a width that is
# not a multiple of 4, the fused rowwise kernels past 512 columns, K1 and
# K1h at narrow widths (lane groups of 1, 4 and 16 lanes)
CUDA_WIDTH_CASES = [(k, 3) for k in ("K2", "K3", "scaled", "K4", "K6", "K7",
                                     "K3h", "K4h")] + [("K4", 1030),
                                                       ("K4h", 1030)] + [
    (k, d) for k in ("K1", "K1h") for d in (3, 10, 64)]


@pytest.mark.parametrize("kernel,dim", CUDA_WIDTH_CASES)
def test_update_kernels_take_any_width_on_a_cuda_tensor(kernel, dim):
    """A CUDA tensor of any width goes to the launch: with no card and no
    nvcc here the wrapper raises from the kernel's build, never a refusal
    of the width (ValueError for D % 4 != 0, NotImplementedError for K4h
    past 512 columns, as before), and takes no plain version. K1 and K1h
    pick their lane group from D before the build, as the row kernels do.
    The tensors are fake CUDA tensors (metadata only), which a CPU build
    can make."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    launches = tracing.counts()
    with FakeTensorMode():
        dev = "cuda"
        f32 = torch.zeros(8, dim, device=dev)
        half = torch.zeros(8, dim, dtype=torch.bfloat16, device=dev)
        uids = torch.zeros(2, dtype=torch.int32, device=dev)
        bags = torch.zeros(5, 2, dtype=torch.int32, device=dev)
        coeff = torch.ones(5, 2, device=dev)
        g = torch.zeros(2, dim, device=dev)
        m_row = torch.zeros(8, device=dev)
        step = torch.zeros((), dtype=torch.int32, device=dev)
        call = {
            "K2": lambda: fk.scatter_rows_write(f32, uids, g),
            "K3": lambda: fk.fused_update_sgd(f32, uids, g, LR),
            "scaled": lambda: fk.scaled_row_update(
                f32, uids, g, torch.zeros(2, device=dev)),
            "K4": lambda: fk.fused_update_rowwise_adagrad(
                f32, m_row, uids, g, LR, momentum_stream=True),
            "K6": lambda: fk.fused_update_adagrad(
                f32, torch.zeros_like(f32), uids, g, LR),
            "K7": lambda: fk.fused_update_adam(
                f32, torch.zeros_like(f32), torch.zeros_like(f32), uids, g,
                LR, step),
            "K3h": lambda: fk.fused_update_sgd_half(half, uids, g, LR, step),
            "K4h": lambda: fk.fused_update_rowwise_adagrad_half(
                half, m_row, uids, g, LR, step),
            "K1": lambda: tl.tbe_lookup_pooled(f32, bags, coeff),
            "K1h": lambda: tl.tbe_lookup_pooled(half, bags, coeff),
        }[kernel]
        with pytest.raises(RuntimeError) as raised:
            call()
    assert not isinstance(raised.value, NotImplementedError)
    assert tracing.counts() == launches


class _Entry:
    """A stand-in for one C entry point: records its arguments and returns
    0 (no error)."""

    def __init__(self, calls: list):
        self.calls = calls

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _Library:
    """A stand-in for the built library: every entry point an _Entry,
    which fk._bind gives its ctypes argtypes as it gives the real ones."""

    def __init__(self):
        self.calls: list = []
        self.entries: dict = {}

    def __getattr__(self, name):
        if name.startswith("trt_"):
            return self.entries.setdefault(name, _Entry(self.calls))
        raise AttributeError(name)


@pytest.mark.parametrize("dim", range(1, 161))
def test_k3h_hands_its_geometry_to_the_launch(dim, monkeypatch):
    """On a CUDA tensor of any width, `fused_update_sgd_half` hands
    `trt_fused_update_sgd_half` the row kernel's (lanes per row, slots per
    warp) at that width, `row_geometry(D)`, with as many arguments as the
    entry point's ctypes signature: no width is refused before the launch.
    The launch is made on a stand-in library (no card and no nvcc here),
    with fake CUDA tensors."""
    import warnings

    from torch._subclasses.fake_tensor import FakeTensorMode

    from torchrec_tpu_torch.ops.lane_groups import lanes_per_row

    lib = _Library()
    fk._bind(lib)
    launched = []

    def launch(name, device, call):
        launched.append(name)
        assert call(lib, 0) == 0

    monkeypatch.setattr(fk, "_launch", launch)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # data_ptr of a fake tensor
        with FakeTensorMode():
            dev = "cuda"
            half = torch.zeros(8, dim, dtype=torch.float16, device=dev)
            out = fk.fused_update_sgd_half(
                half, torch.zeros(3, dtype=torch.int32, device=dev),
                torch.zeros(3, dim, device=dev), LR,
                torch.zeros((), dtype=torch.int32, device=dev),
                weight_decay=WD, stochastic_rounding=False, row_base=24)
            assert out is half
    assert launched == ["fused_update_sgd_half"] and len(lib.calls) == 1
    args = lib.calls[0]
    entry = lib.entries["trt_fused_update_sgd_half"]
    assert len(args) == len(entry.argtypes)
    # (w, uids, g, step, R, D, N, group, slots, lr, wd, half, sr, seed,
    # row_base, stream)
    R_, D, N, group, slots = args[4:9]
    assert (R_, D, N) == (8, dim, 3)
    assert (group, slots) == fk.row_geometry(dim)
    assert group == lanes_per_row(dim) and slots % (32 // group) == 0
    assert args[11:13] == (fk.HALF_TYPES[torch.float16], 0)
    assert args[14] == 24


# -- row_mean_sq at any width -------------------------------------------------


def _masked_quad_mean_sq(g: np.ndarray) -> np.ndarray:
    """The fused rowwise kernel's g_sq in numpy float32 on its masked path:
    lane l takes quad c * 32 + l of each 128-column chunk c (columns 4q ..
    4q + 3, read as 0 past D) and adds ((x*x + y*y) + z*z) + w*w to its
    partial, the chunks in order; a xor butterfly over 16, 8, 4, 2, 1
    combines the 32 lanes; the total is divided by D once."""
    rows, dim = g.shape
    part = np.zeros((rows, 32), np.float32)
    quads = -(-dim // 4)
    for q in range(quads):
        x, y, z, w = (g[:, 4 * q + i] if 4 * q + i < dim
                      else np.zeros(rows, np.float32) for i in range(4))
        part[:, q % 32] += ((x * x + y * y) + z * z) + w * w
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, np.arange(32) ^ off]
    assert (part == part[:, :1]).all()  # every lane holds the same total
    return part[:, 0] / np.float32(dim)


@pytest.mark.parametrize("dim", [3, 10, 130, 1030])
def test_row_mean_sq_at_any_width(dim):
    rng = np.random.RandomState(dim)
    g = (rng.randn(40, dim) * np.exp(rng.randn(40, 1) * 3)).astype(np.float32)
    out = fk.row_mean_sq(torch.tensor(g))
    assert out.dtype == torch.float32 and out.shape == (40,)
    np.testing.assert_array_equal(out.numpy(), _masked_quad_mean_sq(g))
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jnp.mean(jnp.asarray(g) ** 2, 1)),
                               rtol=1e-6)


# -- SimpleDeepFMNN at D=10 through the DMP -----------------------------------

KD_ROWS = (1000, 257, 31, 3)
KD_KEYS = [f"f{i}" for i in range(len(KD_ROWS))]
KD_D, KD_DENSE_IN, KD_HIDDEN, KD_DEEP, KD_B = 10, 5, 16, 12, 64
JAX_KEY = "m/embedding_bag_collection"  # the flax field path
PORT_KEY = "m/sparse_arch/embedding_bag_collection"
KD_FUSED_LR, KD_DENSE_LR, KD_STEPS, KD_START = 0.1, 0.05, 3, 5
MODEL = dict(rtol=1e-4, atol=1e-5)
KD_EPS = 1e-7  # the BCE's clip of the probabilities


class _JTrain(fnn.Module):
    """SimpleDeepFMNN + a BCE on its probabilities clipped to [KD_EPS,
    1 - KD_EPS], as test_torch_port_deepfm.py trains it."""

    m: JSimpleDeepFMNN

    def __call__(self, dense, sparse, labels):
        p = self.m(dense, sparse)[:, 0]
        pc = jnp.clip(p, KD_EPS, 1.0 - KD_EPS)
        loss = -jnp.mean(labels * jnp.log(pc)
                         + (1.0 - labels) * jnp.log1p(-pc))
        return loss, (loss, p)


class _Train(torch.nn.Module):
    def __init__(self, m):
        super().__init__()
        self.m = m

    def forward(self, dense, sparse, labels):
        p = self.m(dense, sparse)[:, 0]
        pc = p.clamp(KD_EPS, 1.0 - KD_EPS)
        loss = -torch.mean(labels * torch.log(pc)
                           + (1.0 - labels) * torch.log1p(-pc))
        return loss, (loss, p)


def _kd_tables(cls, dtype):
    return [cls(num_embeddings=r, embedding_dim=KD_D, name=f"t{i}",
                feature_names=[KD_KEYS[i]], data_type=dtype)
            for i, r in enumerate(KD_ROWS)]


def _kd_request(seed):
    rng = np.random.RandomState(seed)
    ids = np.concatenate([rng.randint(0, r, size=KD_B)
                          for r in KD_ROWS]).astype(np.int32)
    lengths = np.ones(len(KD_ROWS) * KD_B, np.int32)
    dense = rng.randn(KD_B, KD_DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=KD_B).astype(np.float32)
    return ids, lengths, dense, labels


def _jsb(ids, lengths):
    return JKJT.from_lengths(KD_KEYS, jnp.asarray(ids),
                             jnp.asarray(lengths)).to_padded(1)


def _kjt(ids, lengths):
    return KeyedJaggedTensor.from_lengths(KD_KEYS, ids, lengths)


def _kd_bridged(optim, half):
    """A JAX DeepFM DMP at step KD_START with seeded fused momenta and the
    port's DMP loaded from it (weights, tables, fused state). bf16 tables
    when `half`, stochastic rounding off."""
    jdt, tdt = (JDataType.BF16, DataType.BF16) if half else (
        JDataType.FP32, DataType.FP32)
    fused = {"learning_rate": KD_FUSED_LR, "stochastic_rounding": False}
    jmodel = _JTrain(m=JSimpleDeepFMNN(
        num_dense_features=KD_DENSE_IN,
        embedding_bag_collection=JEBC(tables=tuple(
            _kd_tables(JConfig, jdt)), max_feature_length=1),
        hidden_layer_size=KD_HIDDEN, deep_fm_dimension=KD_DEEP))
    jdmp = JDMP(jmodel, env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({JAX_KEY: {f"t{i}": JPS(JST.ROW_WISE)
                                      for i in range(len(KD_ROWS))}}),
                fused_optim=jfu.EmbOptimType[optim], fused_params=fused,
                dense_optimizer=optax.sgd(KD_DENSE_LR))
    ids, lengths, dense, labels = _kd_request(0)
    state = jdmp.init(jax.random.PRNGKey(0), jnp.asarray(dense),
                      _jsb(ids, lengths), jnp.asarray(labels))
    rng = np.random.RandomState(1)
    per_table = {}
    for i, rows in enumerate(KD_ROWS):
        entry = {"step": np.asarray(KD_START, np.int32)}
        for tag, kind in zip(("m1", "m2"), jfu.fused_state_shapes(
                jfu.EmbOptimType[optim])):
            shape = {"row": (rows,), "full": (rows, KD_D)}.get(kind)
            if shape is not None:
                entry[f"{tag}__{kind}"] = (rng.rand(*shape) * 0.01).astype(
                    np.float32)
        per_table[f"t{i}"] = entry
    state = state.replace(emb_states={JAX_KEY: tuple(
        g.replace(opt=s.shard_opt_from_tables(per_table, g.opt))
        for s, g in zip(jdmp.sharded_ebcs[JAX_KEY].strategies,
                        state.emb_states[JAX_KEY]))})
    model = _Train(SimpleDeepFMNN(
        KD_DENSE_IN, EmbeddingBagCollection(
            _kd_tables(EmbeddingBagConfig, tdt), max_feature_length=1,
            device="meta"), KD_HIDDEN, KD_DEEP, device="meta"))
    dmp = DistributedModelParallel(
        model, device="cpu",
        plan=ShardingPlan({PORT_KEY: {f"t{i}": ParameterSharding(
            ShardingType.ROW_WISE) for i in range(len(KD_ROWS))}}),
        fused_optim=tfu.EmbOptimType[optim], fused_params=fused,
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=KD_DENSE_LR))
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
            state.emb_states[JAX_KEY]), opt_state=per_table)
    return jdmp, state, dmp, per_table


def _f32(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("optim,half", [
    ("ROWWISE_ADAGRAD", False), ("ADAM", False), ("ROWWISE_ADAGRAD", True)],
    ids=["ROWWISE_ADAGRAD", "ADAM", "ROWWISE_ADAGRAD-bf16"])
def test_deepfm_at_d10_serves_and_trains_as_jax(optim, half):
    jdmp, state, dmp, start_opt = _kd_bridged(optim, half)
    ids, lengths, dense, labels = _kd_request(2)
    _, (_, jp) = jdmp.make_eval_fn()(state, jnp.asarray(dense),
                                     _jsb(ids, lengths), jnp.asarray(labels))
    _, (_, p) = dmp.make_eval_fn()(torch.as_tensor(dense),
                                   _kjt(ids, lengths),
                                   torch.as_tensor(labels))
    assert p.shape == (KD_B,) and ((p >= 0) & (p <= 1)).all()
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), **MODEL)

    jstep, step = jdmp.make_train_step(), dmp.make_train_step()
    start = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    touched = {f"t{i}": np.zeros(r, bool) for i, r in enumerate(KD_ROWS)}
    launches = tracing.counts()
    for s in range(KD_STEPS):
        ids, lengths, dense, labels = _kd_request(20 + s)
        for i in range(len(KD_ROWS)):
            touched[f"t{i}"][ids[i * KD_B:(i + 1) * KD_B]] = True
        state, jloss, _ = jstep(state, jnp.asarray(dense),
                                _jsb(ids, lengths), jnp.asarray(labels))
        loss, _ = step(torch.as_tensor(dense), _kjt(ids, lengths),
                       torch.as_tensor(labels))
        np.testing.assert_allclose(float(loss), float(jloss), **MODEL)
    assert tracing.counts() == launches

    jdense = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params), dmp.module)
    for name, prm in dmp.module.named_parameters():
        np.testing.assert_allclose(prm.detach().numpy(), jdense[name],
                                   err_msg=name, **MODEL)
    jtables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    tables = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    for name in jtables:
        got, ref = _f32(tables[name]), _f32(jtables[name])
        assert got.shape == (touched[name].size, KD_D)
        if half:
            assert (np.abs(got - ref) <= _ulp(ref, torch.bfloat16)).all()
        else:
            np.testing.assert_allclose(got, ref, err_msg=name, **MODEL)
        untouched = ~touched[name]
        np.testing.assert_array_equal(got[untouched],
                                      _f32(start[name])[untouched])
        assert not np.array_equal(got[~untouched],
                                  _f32(start[name])[~untouched])
    jopt = {}
    for s_, g in zip(jdmp.sharded_ebcs[JAX_KEY].strategies,
                     state.emb_states[JAX_KEY]):
        jopt.update(s_.unshard_opt_to_tables(g.opt))
    opt = fused_optimizer_state(dmp)
    for name in jopt:
        assert int(opt[name]["step"]) == KD_START + KD_STEPS
        for tag in sorted(set(jopt[name]) - {"step"}):
            got, ref = opt[name][tag], np.asarray(jopt[name][tag])
            atol = 1e-9 if tag.endswith("__row") else MODEL["atol"]
            np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol,
                                       err_msg=f"{name} {tag}")
            untouched = ~touched[name]
            np.testing.assert_array_equal(got[untouched],
                                          start_opt[name][tag][untouched])
