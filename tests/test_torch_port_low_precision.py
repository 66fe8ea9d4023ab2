"""Half-precision (bf16 / fp16) tables in the port against the JAX package,
on the CPU.

The JAX package trains such tables on its XLA route (its Pallas kernels
take f32 only): `stochastic_round` on JAX's own random bits, `_sr_set` for
SGD / EXACT_SGD / ROWWISE_ADAGRAD with stochastic rounding on, and
`w + upd.astype(dtype)` for the rest. Inputs are made from a seed with
numpy and handed to both sides; on CPU tensors the half kernels K1h, K3h
and K4h take their plain versions.

Tolerances: with stochastic rounding off, the port's rows are within one
ulp of the table's dtype of JAX's (the f32 update is rounded in another
order in places: rowwise Adagrad's scale and g^2 sum, Adam's powers,
norms), and bit for bit where a row was hit by a single slot. With it on,
the two sides draw different random bits, so a touched element must be
one of the two half-precision neighbours of JAX's f32 value `w + upd`.
Momenta stay f32 and are held as the fp32 tests hold them (rtol 1e-4;
atol 1e-5, rowwise 1e-9).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_dlrm import (
    D as DLRM_D,
    DENSE_ARCH,
    DENSE_IN,
    JAX_KEY,
    OVER_ARCH,
    PORT_KEY,
    ROWS as DLRM_ROWS,
    _request,
)
from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
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
from torchrec_tpu_torch.models import DLRM, DLRMTrain
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    EmbeddingConfig,
)
from torchrec_tpu_torch.modules.embedding_configs import DataType
from torchrec_tpu_torch.ops import embedding as temb
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.ops import stochastic_rounding as tsr
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardedEmbeddingBagCollection,
    ShardedEmbeddingCollection,
    ShardingEnv,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils import tracing
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    load_jax_weights,
)

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16),
          "fp16": (torch.float16, jnp.float16)}
OPTIMS = [o.name for o in tfu.EmbOptimType]
SR_OPTIMS = ("SGD", "EXACT_SGD", "ROWWISE_ADAGRAD")
R, D, N = 64, 16, 96
LR, START_STEP = 0.1, 5


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ulp(x: np.ndarray, dtype: torch.dtype) -> np.ndarray:
    """The table dtype's ulp at each value of x (representable in it)."""
    t = torch.tensor(x).to(dtype)
    up = torch.nextafter(t, torch.full_like(t, float("inf")))
    return (up.float() - t.float()).numpy()


def _neighbours(x32: np.ndarray, dtype: torch.dtype):
    """The largest value of `dtype` <= x32 and the smallest >= x32."""
    t = torch.tensor(x32).to(dtype)  # nearest
    tf = t.float().numpy()
    down = torch.nextafter(t, torch.full_like(t, -float("inf"))).float()
    up = torch.nextafter(t, torch.full_like(t, float("inf"))).float()
    lo = np.where(tf <= x32, tf, down.numpy())
    hi = np.where(tf >= x32, tf, up.numpy())
    return lo, hi


# -- the bit recipe and the generator ------------------------------------------

EDGES = np.array([
    0.0, -0.0, 1.0, -1.0, 1.0 + 1e-3, -1.0 - 3e-3, 3.14159, 1e-3,
    # fp16: largest normal 65504, the overflow edge 65520, past it
    65504.0, 65519.0, 65520.0, -65530.0, 7e4,
    # fp16: the smallest normal 2**-14, subnormals, below half the
    # smallest subnormal 2**-24
    6.1035156e-05, 6.0e-05, 1e-6, 5.96e-08, 2.98e-08, 1e-8, -3e-8,
    # f32 subnormal, f32 extremes, infinities
    1e-45, 3.4e38, -3.4e38, np.inf, -np.inf,
], np.float32)


@pytest.mark.parametrize("name", ["bf16", "fp16"])
def test_stochastic_round_is_jax_recipe_on_jax_bits(name):
    tdt, jdt = DTYPES[name]
    rng = np.random.RandomState(0)
    # values between grid points at every scale, and the edges
    x = np.concatenate([
        EDGES, (rng.randn(2000) * 10.0 ** rng.randint(-9, 5, 2000)).astype(
            np.float32)])
    key = jax.random.fold_in(jax.random.PRNGKey(0x5EED), 7)
    bits = np.asarray(jax.random.bits(key, x.shape, jnp.uint32))
    ref = _f32(jfu.stochastic_round(jnp.asarray(x), jdt, key))
    out = tsr.stochastic_round(torch.from_numpy(x), tdt,
                               torch.from_numpy(bits.astype(np.int64)))
    assert out.dtype == tdt
    np.testing.assert_array_equal(_f32(out).view(np.uint32),
                                  ref.view(np.uint32))
    # NaN stays NaN (its payload is the converter's own on either side)
    nan = tsr.stochastic_round(torch.tensor([np.nan]), tdt,
                               torch.tensor([12345]))
    assert torch.isnan(nan).all()


def _fmix32(h: int) -> int:
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    return h ^ (h >> 16)


def _bits_python(seed, step, row, col) -> int:
    """sr_bits in Python integers, as the CUDA kernels compute it in
    32-bit words."""
    g = 0x9E3779B9
    key = _fmix32(_fmix32(_fmix32((seed + g) & 0xFFFFFFFF)
                          ^ (step & 0xFFFFFFFF)) ^ row)
    return _fmix32(key ^ ((col * g) & 0xFFFFFFFF))


def test_sr_bits_is_the_documented_hash():
    rows = torch.tensor([0, 1, 7, 2_600_063, 2**31 - 2])
    for seed, step in ((tsr.SR_SEED, 0), (tsr.SR_SEED, 5), (1, -1),
                       (0, 2**31 - 1)):
        out = tsr.sr_bits(torch.tensor(step, dtype=torch.int32), rows, 6,
                          seed)
        assert out.dtype == torch.int64 and out.shape == (5, 6)
        want = [[_bits_python(seed, step, int(r), c) for c in range(6)]
                for r in rows]
        assert out.tolist() == want


def test_sr_bits_depend_on_every_counter_and_nothing_else():
    step = torch.tensor(3, dtype=torch.int32)
    rows = torch.arange(50)
    base = tsr.sr_bits(step, rows, 128)
    # deterministic, and keyed by the row, not its position
    assert torch.equal(base, tsr.sr_bits(step, rows, 128))
    perm = torch.randperm(50, generator=torch.Generator().manual_seed(0))
    assert torch.equal(base[perm], tsr.sr_bits(step, rows[perm], 128))
    assert torch.equal(base[:, :64], tsr.sr_bits(step, rows, 64))
    # any one counter changed changes every word
    for other in (tsr.sr_bits(step + 1, rows, 128),
                  tsr.sr_bits(step, rows + 1, 128),
                  tsr.sr_bits(step, rows, 128, seed=tsr.SR_SEED + 1)):
        assert not (other == base).any()
    assert not (base[:, 1:] == base[:, :-1]).any()
    # the 16 and 13 low bits SR uses are spread evenly
    for drop in (16, 13):
        low = (base & ((1 << drop) - 1)).double() / (1 << drop)
        assert abs(low.mean().item() - 0.5) < 0.01


@pytest.mark.parametrize("name", ["bf16", "fp16"])
def test_stochastic_round_unbiased_on_sr_bits(name):
    """JAX's test_stochastic_round_primitive_unbiased at its tolerance,
    on the port's bits."""
    tdt, _ = DTYPES[name]
    x = torch.full((200, 128), 1.0 + 1e-3)  # between grid points
    bits = tsr.sr_bits(torch.tensor(0, dtype=torch.int32),
                       torch.arange(200), 128)
    out = tsr.stochastic_round(x, tdt, bits).float()
    assert abs(out.mean().item() - (1.0 + 1e-3)) < 5e-4
    lo, hi = _neighbours(np.float32(1.0 + 1e-3), tdt)
    assert sorted(np.unique(out.numpy()).tolist()) == [float(lo), float(hi)]


# -- apply_fused_update on half tables against JAX -----------------------------


def _update_inputs(optim, seed=0, n=N):
    rng = np.random.RandomState(seed)
    w = (rng.randn(R, D) * 0.5).astype(np.float32)
    # duplicates are common (n ids over R rows); some slots invalid
    ids = rng.randint(0, R, size=n).astype(np.int32)
    grads = (rng.randn(n, D) * 0.1).astype(np.float32)
    valid = rng.rand(n) > 0.15
    opt = {"step": np.int32(START_STEP)}
    for tag, kind in zip(("m1", "m2"),
                         tfu.fused_state_shapes(tfu.EmbOptimType[optim])):
        shape = {"row": (R,), "full": (R, D)}.get(kind)
        if shape is not None:
            opt[tag] = (rng.rand(*shape) * 0.01).astype(np.float32)
    return w, ids, grads, valid, opt


def _jax_update(optim, w, ids, grads, valid, opt, jdt, **kw):
    state = jfu.init_fused_optimizer_state(R, D, jfu.EmbOptimType[optim])
    state = state.replace(
        momentum1=None if "m1" not in opt else jnp.asarray(opt["m1"]),
        momentum2=None if "m2" not in opt else jnp.asarray(opt["m2"]),
        step=jnp.asarray(opt["step"]))
    new_w, new = jfu.apply_fused_update(
        jnp.asarray(w, jdt), state, jnp.asarray(ids), jnp.asarray(grads),
        jnp.asarray(valid), LR, **kw)
    moms = {t: np.asarray(m) for t, m in (("m1", new.momentum1),
                                          ("m2", new.momentum2))
            if m is not None}
    return _f32(new_w), moms, int(new.step)


def _port_update(optim, w, ids, grads, valid, opt, tdt, **kw):
    state = tfu.init_fused_optimizer_state(R, D, tfu.EmbOptimType[optim])
    for tag in ("m1", "m2"):
        if tag in opt:
            setattr(state, f"momentum{tag[1]}", torch.tensor(opt[tag]))
    state.step.fill_(int(opt["step"]))
    weights = torch.tensor(w).to(tdt)
    launches = tracing.counts()
    tfu.apply_fused_update(weights, state, torch.tensor(ids),
                           torch.tensor(grads), torch.tensor(valid), LR, **kw)
    # CPU tensors take the plain versions
    assert tracing.counts() == launches
    assert weights.dtype == tdt
    moms = {t: getattr(state, f"momentum{t[1]}").numpy()
            for t in ("m1", "m2") if getattr(state, f"momentum{t[1]}")
            is not None}
    return _f32(weights), moms, int(state.step)


def _hits(ids, valid):
    """Slots per row among the valid ones."""
    return np.bincount(ids[valid], minlength=R)


def _check_moms(moms, jmoms, opt):
    assert moms.keys() == jmoms.keys()
    for tag, m in moms.items():
        assert m.dtype == np.float32
        assert not np.array_equal(m, opt[tag])  # it moved
        atol = 1e-9 if m.ndim == 1 else 1e-5
        np.testing.assert_allclose(m, jmoms[tag], rtol=1e-4, atol=atol,
                                   err_msg=tag)


# SGD and EXACT_SGD at weight decay 0 are JAX's per-token fast path, the
# one deliberate difference (test_sr_off_sgd_rounds_run_totals_once_trap2)
_SR_OFF_CASES = [(o, n, wd) for o in OPTIMS for n in DTYPES
                 for wd in (0.0, 0.01)
                 if not (wd == 0.0 and o in ("SGD", "EXACT_SGD"))]


@pytest.mark.parametrize("optim,name,wd", _SR_OFF_CASES)
def test_half_update_sr_off_matches_jax(optim, name, wd):
    tdt, jdt = DTYPES[name]
    w, ids, grads, valid, opt = _update_inputs(optim)
    kw = dict(weight_decay=wd, stochastic_rounding=False)
    jw, jmoms, jstep = _jax_update(optim, w, ids, grads, valid, opt, jdt,
                                   **kw)
    pw, moms, step = _port_update(optim, w, ids, grads, valid, opt, tdt,
                                  **kw)
    assert step == jstep == START_STEP + 1
    hits = _hits(ids, valid)
    start = _f32(torch.tensor(w).to(tdt))
    assert not np.array_equal(pw[hits > 0], start[hits > 0])  # it moved
    np.testing.assert_array_equal(pw[hits == 0], start[hits == 0])
    np.testing.assert_array_equal(jw[hits == 0], start[hits == 0])
    np.testing.assert_array_equal(pw[hits == 1], jw[hits == 1])
    assert (np.abs(pw - jw) <= _ulp(jw, tdt)).all()
    _check_moms(moms, jmoms, opt)


@pytest.mark.parametrize("optim", SR_OPTIMS)
@pytest.mark.parametrize("name", ["bf16", "fp16"])
def test_half_update_sr_on_lands_on_jax_neighbours(optim, name):
    """Every touched element is one of the two half-precision neighbours
    of JAX's f32 w + upd (JAX's update of the same, widened, table in
    f32), untouched rows are unchanged, and the momentum is JAX's."""
    tdt, jdt = DTYPES[name]
    w, ids, grads, valid, opt = _update_inputs(optim, seed=1)
    w = _f32(torch.tensor(w).to(tdt))  # the table's values, exactly
    x32, jmoms, _ = _jax_update(optim, w, ids, grads, valid, opt,
                                jnp.float32, weight_decay=0.01)
    pw, moms, _ = _port_update(optim, w, ids, grads, valid, opt, tdt,
                               weight_decay=0.01)
    hits = _hits(ids, valid) > 0
    lo, hi = _neighbours(x32, tdt)
    on = (pw == lo) | (pw == hi)
    assert on[hits].all()
    np.testing.assert_array_equal(pw[~hits], w[~hits])
    # both neighbours are taken, where they differ
    assert (pw[hits] == lo[hits]).any() and (pw[hits] == hi[hits]).any()
    _check_moms(moms, jmoms, opt)


@pytest.mark.parametrize("name", ["bf16", "fp16"])
def test_stochastic_rounding_preserves_tiny_updates(name):
    """test_low_precision.py's drift test on the port: 300 SGD steps of
    lr * g = 1e-4 on ones, far below the ulp at 1.0. With SR the mean
    drift is about 0.03; rounding to nearest loses every step."""
    tdt, _ = DTYPES[name]
    R2, D2, steps, lr, gval = 8, 8, 300, 0.01, 0.01
    ids = torch.arange(R2, dtype=torch.int32)
    grads = torch.full((R2, D2), gval)
    valid = torch.ones(R2, dtype=torch.bool)

    def run(sr):
        w = torch.ones((R2, D2), dtype=tdt)
        opt = tfu.init_fused_optimizer_state(R2, D2, tfu.EmbOptimType.SGD)
        for _ in range(steps):
            tfu.apply_fused_update(w, opt, ids, grads, valid, lr,
                                   stochastic_rounding=sr)
        assert int(opt.step) == steps
        return w.float().numpy()

    expected = steps * lr * gval
    assert abs(1.0 - run(False).mean()) < 1e-6
    assert 0.5 * expected < 1.0 - run(True).mean() < 1.5 * expected


def test_sr_off_sgd_rounds_run_totals_once_trap2():
    """The deliberate difference: with SR off and no weight decay, JAX's
    SGD adds each duplicate token's rounded step on its own; the port
    rounds the row's f32 total once, which is what JAX gives as soon as a
    weight decay sends it through run totals. bf16 ones, ids [1, 1],
    g 0.0015, lr 1.0: a token's step is under half an ulp of 1.0, the
    total's is not."""
    w = jnp.ones((4, 4), jnp.bfloat16)
    ids = np.array([1, 1], np.int32)
    grads = np.full((2, 4), 0.0015, np.float32)
    valid = np.ones(2, bool)

    def jax_row(wd):
        new, _ = jfu.apply_fused_update(
            w, jfu.init_fused_optimizer_state(4, 4, jfu.EmbOptimType.EXACT_SGD),
            jnp.asarray(ids), jnp.asarray(grads), jnp.asarray(valid), 1.0,
            weight_decay=wd, stochastic_rounding=False)
        return _f32(new)

    port = torch.ones((4, 4), dtype=torch.bfloat16)
    tfu.apply_fused_update(
        port, tfu.init_fused_optimizer_state(4, 4,
                                             tfu.EmbOptimType.EXACT_SGD),
        torch.tensor(ids), torch.tensor(grads), torch.tensor(valid), 1.0,
        stochastic_rounding=False)
    assert (jax_row(0.0)[1] == 1.0).all()
    assert (jax_row(1e-9)[1] == 0.99609375).all()
    assert (_f32(port)[1] == 0.99609375).all()
    assert (_f32(port)[[0, 2, 3]] == 1.0).all()


# -- the sharded modules and the DMP -------------------------------------------

KEYS = [f"f{i}" for i in range(len(DLRM_ROWS))]
STEPS, FUSED_LR, DENSE_LR = 3, 0.1, 0.05


def _jax_bf16_dmp(optim, sr):
    tables = tuple(JConfig(num_embeddings=r, embedding_dim=DLRM_D,
                           name=f"t{i}", feature_names=[f"f{i}"],
                           data_type=JDataType.BF16)
                   for i, r in enumerate(DLRM_ROWS))
    model = JDLRMTrain(dlrm=JDLRM(
        embedding_bag_collection=JEBC(tables=tables, max_feature_length=1),
        dense_in_features=DENSE_IN, dense_arch_layer_sizes=DENSE_ARCH,
        over_arch_layer_sizes=OVER_ARCH))
    return JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({JAX_KEY: {t.name: JPS(JST.ROW_WISE)
                                      for t in tables}}),
                fused_optim=jfu.EmbOptimType[optim],
                fused_params={"learning_rate": FUSED_LR,
                              "stochastic_rounding": sr},
                dense_optimizer=optax.sgd(DENSE_LR))


def _port_bf16_dmp(optim, sr):
    tables = [EmbeddingBagConfig(num_embeddings=r, embedding_dim=DLRM_D,
                                 name=f"t{i}", feature_names=[f"f{i}"],
                                 data_type=DataType.BF16)
              for i, r in enumerate(DLRM_ROWS)]
    model = DLRMTrain(DLRM(
        EmbeddingBagCollection(tables, max_feature_length=1, device="meta"),
        DENSE_IN, DENSE_ARCH, OVER_ARCH, device="meta"))
    return DistributedModelParallel(
        model, plan=ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
            ShardingType.ROW_WISE) for t in tables}}), device="cpu",
        fused_optim=tfu.EmbOptimType[optim],
        fused_params={"learning_rate": FUSED_LR, "stochastic_rounding": sr},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR))


def _jax_batch(ids, lengths):
    return JKJT.from_lengths(KEYS, jnp.asarray(ids),
                             jnp.asarray(lengths)).to_padded(1)


def _bridged(optim, sr):
    """A JAX bf16 DMP's state and the port's bf16 DMP loaded from it, the
    optimizer state at step START_STEP with seeded momenta on both (from
    zero momenta the first rowwise Adagrad step is lr * g / rms(g), which
    turns last-bit differences of a small gradient into steps of order
    lr)."""
    ids, lengths, dense, labels = _request(1, seed=0)
    jdmp = _jax_bf16_dmp(optim, sr)
    state = jdmp.init(jax.random.PRNGKey(0), jnp.asarray(dense),
                      _jax_batch(ids, lengths), jnp.asarray(labels))
    rng = np.random.RandomState(7)
    per_table = {}
    for i, rows in enumerate(DLRM_ROWS):
        per_table[f"t{i}"] = {"step": np.int32(START_STEP)}
        if optim == "ROWWISE_ADAGRAD":
            per_table[f"t{i}"]["m1__row"] = (rng.rand(rows) * 0.01).astype(
                np.float32)
    jstrat = jdmp.sharded_ebcs[JAX_KEY].strategies[0]
    group = state.emb_states[JAX_KEY][0]
    state = state.replace(emb_states={**state.emb_states, JAX_KEY: (
        group.replace(opt=jstrat.shard_opt_from_tables(per_table,
                                                       group.opt)),)})
    jtables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    dmp = _port_bf16_dmp(optim, sr)
    load_jax_weights(dmp, jax.tree.map(np.asarray, state.dense_params),
                     jtables, opt_state=per_table)
    return jdmp, state, dmp


def test_shard_from_dense_takes_ml_dtypes_bf16():
    """A bf16 table from JAX's unshard_to_dense (numpy's ml_dtypes.bfloat16,
    which torch.tensor refuses) loads into the port's serving DMP bit for
    bit, and comes back as f32 holding the same values."""
    jdmp, state, dmp = _bridged("EXACT_SGD", True)
    jtables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    assert all(t.dtype.name == "bfloat16" for t in jtables.values())
    port_w = dmp.sharded_ebcs[PORT_KEY].states[0].weights
    assert port_w.dtype == torch.bfloat16
    jax_w = state.emb_states[JAX_KEY][0].weights
    np.testing.assert_array_equal(_f32(port_w).view(np.uint32),
                                  _f32(jax_w).view(np.uint32))
    back = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    for name, t in jtables.items():
        assert back[name].dtype == np.float32
        np.testing.assert_array_equal(back[name], _f32(t))


@pytest.mark.parametrize("optim", ["EXACT_SGD", "ROWWISE_ADAGRAD"])
@pytest.mark.parametrize("sr", [False, True], ids=["sr_off", "sr_on"])
def test_bf16_dmp_serves_and_trains_as_jax(optim, sr):
    jdmp, state, dmp = _bridged(optim, sr)
    batches = [_request(1, seed=20 + s) for s in range(STEPS + 1)]
    ids, lengths, dense, labels = batches[0]
    _, (_, jlogits, _) = jdmp.make_eval_fn()(
        state, jnp.asarray(dense), _jax_batch(ids, lengths),
        jnp.asarray(labels))
    _, (_, logits, _) = dmp.make_eval_fn()(
        torch.as_tensor(dense), KeyedJaggedTensor.from_lengths(
            KEYS, ids, lengths), torch.as_tensor(labels))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-6)

    jstep, step = jdmp.make_train_step(), dmp.make_train_step()
    strat = dmp.sharded_ebcs[PORT_KEY].strategies[0]
    start = _f32(strat.weights).copy()
    for ids, lengths, dense, labels in batches[1:]:
        state, jloss, _ = jstep(state, jnp.asarray(dense),
                                _jax_batch(ids, lengths),
                                jnp.asarray(labels))
        loss, _ = step(torch.as_tensor(dense), KeyedJaggedTensor.from_lengths(
            KEYS, ids, lengths), torch.as_tensor(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   atol=1e-5)
    assert strat.weights.dtype == torch.bfloat16
    assert int(strat.step) == START_STEP + STEPS
    # the dense optimizer holds no table
    assert all(p.dtype == torch.float32
               for g in dmp.dense_optimizer.param_groups for p in g["params"])
    pw = _f32(strat.weights)
    jw = _f32(state.emb_states[JAX_KEY][0].weights)
    assert (pw != start).any()
    if sr:  # each step's draws differ: one ulp of the row's scale a step
        mag = np.maximum(np.maximum(np.abs(start), np.abs(pw)), np.abs(jw))
        assert (np.abs(pw - jw) <= STEPS * _ulp(mag, torch.bfloat16)).all()
    else:
        assert (np.abs(pw - jw) <= _ulp(jw, torch.bfloat16)).all()
    if optim == "ROWWISE_ADAGRAD":
        m = strat.momentum1.numpy()
        jm = np.asarray(state.emb_states[JAX_KEY][0].opt.momentum1)
        np.testing.assert_allclose(m, jm, rtol=1e-4, atol=1e-9)
    jdense = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params), dmp.module)
    for name, p in dmp.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jdense[name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)


# test_low_precision.py's cases on the port, against the port's own fp32
# path at that file's tolerances (ROW_WISE only: TABLE_WISE is not ported)
LP_B, LP_L, LP_D, LP_R, LP_LR = 16, 2, 16, 64, 0.1


def _lp_tables(dt, cls=EmbeddingBagConfig):
    return [cls(num_embeddings=LP_R, embedding_dim=LP_D, name="t0",
                feature_names=["f0"], data_type=dt),
            cls(num_embeddings=40, embedding_dim=LP_D, name="t1",
                feature_names=["f1"], data_type=dt)]


def _lp_batch(seed=0, feats=("f0", "f1")):
    rng = np.random.RandomState(seed)
    rows = {"f0": LP_R, "f1": 40}
    lengths = rng.randint(0, LP_L + 1, size=(2 * LP_B,)).astype(np.int32)
    vals = []
    for fi, f in enumerate(("f0", "f1")):
        for b in range(LP_B):
            vals.extend(rng.randint(0, rows[f], size=(
                lengths[fi * LP_B + b],)).tolist())
    n0 = int(lengths[:LP_B].sum())
    if feats == ("f0",):
        vals, lengths = vals[:n0], lengths[:LP_B]
    return KeyedJaggedTensor.from_lengths(
        list(feats), np.asarray(vals, np.int32), lengths)


def _lp_plan(tables):
    return {t.name: ParameterSharding(ShardingType.ROW_WISE) for t in tables}


@pytest.mark.parametrize("name", ["bf16", "fp16"])
def test_low_precision_matches_fp32_loosely(name):
    tdt, _ = DTYPES[name]
    rng = np.random.RandomState(0)
    dense = {"t0": rng.randn(LP_R, LP_D).astype(np.float32),
             "t1": rng.randn(40, LP_D).astype(np.float32)}
    kjt = _lp_batch()
    outs, ebcs = {}, {}
    for dt in (DataType.FP32, DataType[name.upper()]):
        tables = _lp_tables(dt)
        ebc = ShardedEmbeddingBagCollection(
            ShardingEnv("cpu"), tables, _lp_plan(tables),
            max_feature_length=LP_L,
            optim=tfu.EmbOptimType.ROWWISE_ADAGRAD)
        ebc.shard_from_dense(dense)
        assert ebc.states[0].weights.dtype == (
            torch.float32 if dt is DataType.FP32 else tdt)
        launches = tracing.counts()
        kt = ebc(kjt)
        assert tracing.counts() == launches
        assert kt.values.dtype == torch.float32  # fp32 accumulation
        outs[dt], ebcs[dt] = kt.values.numpy(), ebc
    half = DataType[name.upper()]
    np.testing.assert_allclose(outs[half], outs[DataType.FP32], rtol=2e-2,
                               atol=2e-2)
    # one update step stays close to the fp32 path
    d_vals = torch.as_tensor(rng.randn(*outs[DataType.FP32].shape).astype(
        np.float32))
    got = {}
    for dt, ebc in ebcs.items():
        ebc.update(kjt, d_vals, LP_LR)
        got[dt] = ebc.unshard_to_dense()
    for t in dense:
        assert not np.array_equal(np.asarray(got[half][t], np.float32),
                                  dense[t])
        np.testing.assert_allclose(np.asarray(got[half][t], np.float32),
                                   got[DataType.FP32][t], rtol=3e-2,
                                   atol=3e-2)


def _lp_ec(dt, optim=tfu.EmbOptimType.ROWWISE_ADAGRAD):
    tables = [EmbeddingConfig(num_embeddings=50, embedding_dim=LP_D,
                              name="s0", feature_names=["f0"],
                              data_type=dt)]
    return ShardedEmbeddingCollection(ShardingEnv("cpu"), tables,
                                      _lp_plan(tables),
                                      max_feature_length=LP_L, optim=optim)


def test_sequence_collection_bf16():
    """The sharded EC with a bf16 table: per-token rows come back finite,
    in bf16, close to the fp32 path."""
    dense = {"s0": np.random.RandomState(0).randn(50, LP_D).astype(
        np.float32)}
    kjt = _lp_batch(2, feats=("f0",))
    outs = {}
    for dt in (DataType.FP32, DataType.BF16):
        ec = _lp_ec(dt)
        ec.shard_from_dense(dense)
        rows = ec(kjt)["f0"]
        assert rows.dtype == (torch.bfloat16 if dt is DataType.BF16
                              else torch.float32)
        outs[dt] = rows.float().numpy()
        assert np.isfinite(outs[dt]).all()
    np.testing.assert_allclose(outs[DataType.BF16], outs[DataType.FP32],
                               rtol=2e-2, atol=2e-2)


def test_bf16_sequence_collection_trains():
    """One fused ROWWISE_ADAGRAD step of the bf16 sharded EC (the route,
    then K4h's plain version) stays close to the fp32 path's, with the same
    momentum, and leaves untouched rows alone."""
    rng = np.random.RandomState(1)
    dense = {"s0": rng.randn(50, LP_D).astype(np.float32)}
    kjt = _lp_batch(3, feats=("f0",))
    d = torch.as_tensor(rng.randn(LP_B, LP_L, LP_D).astype(np.float32))
    got, moms = {}, {}
    for dt in (DataType.FP32, DataType.BF16):
        ec = _lp_ec(dt)
        ec.shard_from_dense(dense)
        ec.update(kjt, {"f0": d.to(ec.strategies[0].weights.dtype)}, LP_LR)
        got[dt] = ec.unshard_to_dense()["s0"]
        moms[dt] = ec.strategies[0].momentum1.numpy()
        assert int(ec.strategies[0].step) == 1
    ids = kjt.values.numpy()
    assert (ids >= 50).any()  # out-of-range ids are owned by no shard
    touched = np.zeros(50, bool)
    touched[ids[ids < 50]] = True
    bf = np.asarray(got[DataType.BF16], np.float32)
    start = _f32(torch.tensor(dense["s0"]).to(torch.bfloat16))
    assert (bf[touched] != start[touched]).any()
    np.testing.assert_array_equal(bf[~touched], start[~touched])
    np.testing.assert_allclose(bf, got[DataType.FP32], rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(moms[DataType.BF16], moms[DataType.FP32],
                               rtol=2e-2, atol=1e-6)


# -- the half kernels' plain versions ------------------------------------------


def _k1_inputs(L, seed=0):
    rng = np.random.RandomState(seed)
    NB, RR, DD = 40, 200, 32
    w = rng.randn(RR, DD).astype(np.float32)
    # ids past the end clamp to R - 1 on both sides (a negative id, which
    # no strategy passes, reads row 0 here as in K1 and wraps in JAX's
    # XLA gather)
    ids = rng.randint(0, RR + 20, size=(NB, L)).astype(np.int32)
    lengths = rng.randint(0, L + 1, size=(NB,))
    valid = np.arange(L)[None, :] < lengths[:, None]
    mean = valid / np.maximum(lengths, 1)[:, None]
    psw = valid * rng.rand(NB, L)
    coeff = np.where(np.arange(NB)[:, None] % 2 == 0, mean, psw)
    return w, ids, coeff.astype(np.float32)


@pytest.mark.parametrize("name", ["bf16", "fp16"])
@pytest.mark.parametrize("L", [1, 3, 20])
def test_k1h_matches_jax_half_pooling(L, name):
    """K1h's plain version against the JAX package's half-table pooling
    (XLA gather, f32 einsum), the coefficient rounded to the table's dtype
    on both sides; ids past both ends clamp. One id per bag is a copy;
    longer bags differ in summation order only."""
    from torchrec_tpu.ops import embedding as jemb

    tdt, jdt = DTYPES[name]
    w, ids, coeff = _k1_inputs(L)
    ref = np.asarray(jemb.pooled_lookup(
        jnp.asarray(w, jdt), jnp.asarray(ids),
        jnp.asarray(coeff).astype(jdt)))
    launches = tracing.counts()
    out = tl.tbe_lookup_pooled(
        torch.tensor(w).to(tdt), torch.tensor(ids),
        torch.tensor(coeff).to(tdt).float())
    assert tracing.counts() == launches
    assert out.dtype == torch.float32
    if L == 1:
        np.testing.assert_array_equal(out.numpy(), ref)
    else:
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["bf16", "fp16"])
def test_k1h_gradients_match_jax(name):
    """K1's VJP on a half table through pooled_lookup: d_coeff from the
    half rows widened, rounded to the table's dtype by the coefficient's
    rounding, as in JAX; d_W summed in f32 and returned in the table's
    dtype, where JAX sums the rounded per-token cotangents in the table's
    dtype (bf16's tolerance for both)."""
    from torchrec_tpu.ops import embedding as jemb

    tdt, jdt = DTYPES[name]
    w, ids, coeff = _k1_inputs(3, seed=2)
    d_out = np.random.RandomState(3).randn(ids.shape[0], w.shape[1]).astype(
        np.float32)
    _, vjp = jax.vjp(lambda ww, cc: jemb.pooled_lookup(ww, jnp.asarray(ids),
                                                       cc),
                     jnp.asarray(w, jdt), jnp.asarray(coeff))
    jdw, jdc = vjp(jnp.asarray(d_out))
    tw = torch.tensor(w).to(tdt).requires_grad_(True)
    tc = torch.tensor(coeff).requires_grad_(True)
    out = temb.pooled_lookup(tw, torch.tensor(ids), tc)
    out.backward(torch.tensor(d_out))
    assert tw.grad.dtype == tdt and tc.grad.dtype == torch.float32
    for got, ref in ((tw.grad, jdw), (tc.grad, jdc)):
        np.testing.assert_allclose(_f32(got), _f32(ref), rtol=1e-2,
                                   atol=1e-2)


@pytest.mark.parametrize("kernel", ["K3h", "K4h"])
@pytest.mark.parametrize("name", ["bf16", "fp16"])
def test_half_kernels_round_their_f32_forms(kernel, name):
    """K3h / K4h compute K3's / the fused K4's f32 update on the widened
    rows: with SR each touched element is one of the two half neighbours
    of the f32 kernel's result on an f32 copy of the table (the momentum
    bit for bit the f32 kernel's); to nearest, half(w + half(upd)), it is
    within half an ulp of upd's and of the result's magnitude of it; and
    untouched rows and sentinel slots are left alone."""
    tdt, _ = DTYPES[name]
    rng = np.random.RandomState(5)
    Rk, Dk, Nk = 40, 12, 30
    w = torch.tensor(rng.randn(Rk, Dk).astype(np.float32)).to(tdt)
    flat = torch.tensor(rng.randint(0, Rk, Nk).astype(np.int32))
    grads = torch.tensor(rng.randn(Nk, Dk).astype(np.float32))
    valid = torch.tensor(rng.rand(Nk) > 0.2)
    m0 = torch.tensor(rng.rand(Rk).astype(np.float32) * 0.01)
    step = torch.tensor(9, dtype=torch.int32)
    if kernel == "K3h":
        uids, g = tfu.run_total_row_grads(flat, grads, valid, Rk)
    else:
        uids, g = tfu.dedup_row_grads(flat, grads, valid, Rk)
    touched = torch.zeros(Rk, dtype=torch.bool)
    touched[uids[uids < Rk].long()] = True

    def half(sr):
        wh, m = w.clone(), m0.clone()
        if kernel == "K3h":
            fk.fused_update_sgd_half(wh, uids, g, LR, step, 0.01, sr)
        else:
            fk.fused_update_rowwise_adagrad_half(wh, m, uids, g, LR, step,
                                                 weight_decay=0.01,
                                                 stochastic_rounding=sr)
        return wh, m

    w32, m32 = w.float(), m0.clone()
    if kernel == "K3h":
        fk.fused_update_sgd(w32, uids, g, LR, weight_decay=0.01)
    else:
        fk.fused_update_rowwise_adagrad(w32, m32, uids, g, LR,
                                        weight_decay=0.01,
                                        momentum_stream=True)
    lo, hi = _neighbours(w32.numpy(), tdt)
    sr_w, sr_m = half(True)
    got = _f32(sr_w)
    assert ((got == lo) | (got == hi))[touched.numpy()].all()
    assert torch.equal(sr_w[~touched], w[~touched])
    assert torch.equal(half(True)[0], sr_w)  # the same bits again
    nearest, m = half(False)
    assert torch.equal(sr_m, m32) and torch.equal(m, m32)
    assert torch.equal(nearest[~touched], w[~touched])
    # rounding upd, then the sum: half an ulp of each off the f32 result
    t = touched.numpy()
    near, x32, w0 = _f32(nearest)[t], w32.numpy()[t], _f32(w)[t]
    mag = np.maximum(np.maximum(np.abs(x32 - w0), np.abs(x32)),
                     np.abs(near))
    assert (np.abs(near - x32) <= _ulp(mag, tdt)).all()
    assert (near != w0).any()


@pytest.mark.parametrize("kernel", ["K1h", "K3h", "K4h"])
def test_half_kernels_raise_on_a_cuda_tensor_without_a_card(kernel):
    """CUDA tensors launch the kernel or raise: with no card and no nvcc
    the wrapper raises and does not take the plain version. The tensors
    are fake CUDA tensors (metadata only), which a CPU build can make."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    launches = tracing.counts()
    with FakeTensorMode():
        w = torch.zeros(8, 4, dtype=torch.bfloat16, device="cuda")
        step = torch.zeros((), dtype=torch.int32, device="cuda")
        uids = torch.zeros(2, dtype=torch.int32, device="cuda")
        g = torch.zeros(2, 4, device="cuda")
        with pytest.raises((RuntimeError, AssertionError)):
            if kernel == "K1h":
                tl.tbe_lookup_pooled_forward(
                    w, torch.zeros(2, 1, dtype=torch.int32, device="cuda"),
                    torch.ones(2, 1, device="cuda"))
            elif kernel == "K3h":
                fk.fused_update_sgd_half(w, uids, g, 0.1, step)
            else:
                fk.fused_update_rowwise_adagrad_half(
                    w, torch.zeros(8, device="cuda"), uids, g, 0.1, step)
    assert tracing.counts() == launches
