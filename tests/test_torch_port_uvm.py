"""The port's host-resident (FUSED_UVM_CACHING) tables against the JAX
package, on the CPU.

- UvmCachedEmbedding (ops/uvm_cache.py) against JAX's on the same seeded
  table and id sequences under eviction pressure (500 rows, a 96-row
  cache, 32 x 2 ids a batch), for every EmbOptimType: the slots of every
  id, the directory (row of each slot, dirty marks) and the hits and
  misses after every call equal JAX's exactly; after `flush` the host
  table, momenta and step equal JAX's within the fused update's
  tolerances (tests/test_torch_port_fused_update.py's, the two packages'
  CPU routes summing in other orders), and bit for bit the port's own
  uncached `apply_fused_update` on the whole table.
- UvmEmbeddingBagCollection against JAX's (a SUM and a MEAN table, with
  and without per-sample weights): pooled values, tables, momenta and
  cache stats over 5 batches; the shared-table update combined in one
  step (tests/test_advice_fixes_r2.py's case); the overflow, the
  out-of-range id and the reserved-suffix raises.
- The DMP over the mixed (t0 ROW_WISE, t1 FUSED_UVM_CACHING) and the
  all-UVM plans of test_advice_fixes_r2, from the JAX DMP's initial state
  bridged: eval and 3 steps under ROWWISE_ADAGRAD and EXACT_SGD (logits,
  losses, tables, momenta and cache stats; rtol 1e-5 for the dense math,
  the UVM momenta rtol 1e-5); the exact momentum resume through
  `load_tables(uvm_momentum=)`; the pipelines; and the same DMPs on two
  gloo ranks (tests/torch_port_uvm_cases.py) against JAX's DMP over two
  CPU devices, whose UVM module serves the global batch as the port's
  owner rank does.
- The refusals: the FP-EBC over UVM tables (as JAX), the prefetched step
  (as JAX), and quantized serving, where JAX's `quantize_embeddings`
  reads only the device part (pinned here with its smallest input).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_uvm_cases as cases
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.uvm_cache import UvmCachedEmbedding as JUvm
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.parallel.types import ComputeKernel as JCK
from torchrec_tpu.parallel.uvm_ebc import (
    UvmEmbeddingBagCollection as JUvmEBC,
)
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.modules import EmbeddingBagConfig, PoolingType
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    apply_fused_update,
    init_fused_optimizer_state,
)
from torchrec_tpu_torch.ops.uvm_cache import UvmCachedEmbedding
from torchrec_tpu_torch.parallel import ShardingEnv
from torchrec_tpu_torch.parallel.uvm_ebc import (
    UvmEmbeddingBagCollection,
    UvmSplitEmbeddingBagCollection,
)
from torchrec_tpu_torch.sparse import PaddedSparseBatch

R, D, B, L, C = 500, 16, 32, 2, 96
LR = 0.1
# optimizer -> (rtol, atol) of the rows and momenta against JAX
TOLS = {"SGD": (1e-5, 1e-6), "EXACT_SGD": (1e-5, 1e-6),
        "ROWWISE_ADAGRAD": (1e-5, 1e-6), "ADAGRAD": (1e-5, 1e-6),
        "ADAM": (1e-4, 1e-6), "PARTIAL_ROWWISE_ADAM": (1e-5, 1e-6),
        "LAMB": (1e-4, 1e-6), "PARTIAL_ROWWISE_LAMB": (1e-4, 1e-6),
        "LARS_SGD": (1e-4, 1e-6)}


def _batches(n, seed):
    """tests/test_uvm_cache.py's `_batches`: (ids [B, L], lengths [B],
    d_pooled [B, D])."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        ids = rng.randint(0, R, size=(B, L)).astype(np.int32)
        lengths = rng.randint(0, L + 1, size=(B,)).astype(np.int32)
        d_pooled = rng.randn(B, D).astype(np.float32)
        out.append((ids, lengths, d_pooled))
    return out


@pytest.mark.parametrize("optim", [o.name for o in EmbOptimType])
def test_uvm_cache_matches_jax_under_eviction_pressure(optim):
    table = np.random.RandomState(7).randn(R, D).astype(np.float32)
    juvm = JUvm(table.copy(), cache_rows=C, optim=JOptim[optim])
    uvm = UvmCachedEmbedding(table.copy(), cache_rows=C,
                             optim=EmbOptimType[optim], device="cpu")
    w = torch.as_tensor(table.copy())
    opt = init_fused_optimizer_state(R, D, EmbOptimType[optim])
    for ids, lengths, d in _batches(6, seed=3):
        jslots = juvm.prepare(ids)
        slots = uvm.prepare(torch.as_tensor(ids))
        np.testing.assert_array_equal(slots, jslots)
        assert (uvm.hits, uvm.misses) == (juvm.hits, juvm.misses)
        np.testing.assert_array_equal(uvm.row_in_slot, juvm.row_in_slot)
        mask = np.arange(L)[None, :] < lengths[:, None]
        grads = np.repeat(d[:, None, :], L, axis=1).reshape(-1, D)
        juvm.update(jnp.asarray(jslots.reshape(-1)), jnp.asarray(grads),
                    jnp.asarray(mask.reshape(-1)), LR)
        uvm.update(slots.reshape(-1), torch.as_tensor(grads),
                   mask.reshape(-1), LR)
        np.testing.assert_array_equal(uvm.dirty, juvm.dirty)
        apply_fused_update(w, opt, torch.as_tensor(ids.reshape(-1)),
                           torch.as_tensor(grads),
                           torch.as_tensor(mask.reshape(-1)), LR)
    assert uvm.misses > C  # rows were evicted and staged again
    juvm.flush()
    uvm.flush()
    # the cache moves rows exactly: the uncached update, bit for bit
    np.testing.assert_array_equal(uvm.table.numpy(), w.numpy())
    rtol, atol = TOLS[optim]
    np.testing.assert_allclose(uvm.table.numpy(), juvm.table, rtol=rtol,
                               atol=atol)
    for host, jhost, ref in ((uvm.host_momentum1, juvm.host_momentum1,
                              opt.momentum1),
                             (uvm.host_momentum2, juvm.host_momentum2,
                              opt.momentum2)):
        assert (host is None) == (jhost is None) == (ref is None)
        if host is not None:
            np.testing.assert_array_equal(host.numpy(), ref.numpy())
            np.testing.assert_allclose(host.numpy(), jhost, rtol=rtol,
                                       atol=atol)
    assert int(uvm.step) == int(juvm.step) == 6


def test_uvm_cache_raises():
    uvm = UvmCachedEmbedding(np.zeros((R, D), np.float32), cache_rows=4,
                             device="cpu")
    with pytest.raises(ValueError, match="cache_rows"):
        uvm.prepare(np.arange(10, dtype=np.int32))
    with pytest.raises(ValueError, match="outside"):
        uvm.prepare(np.asarray([R], np.int32))
    with pytest.raises(ValueError, match="outside"):
        uvm.prepare(np.asarray([-1], np.int32))
    t = EmbeddingBagConfig(num_embeddings=10, embedding_dim=8,
                           name="clicks.step", feature_names=["f0"])
    with pytest.raises(ValueError, match="reserved"):
        UvmEmbeddingBagCollection([t], {"clicks.step": np.zeros(
            (10, 8), np.float32)}, device="cpu")
    # JAX raises alike (tests/test_uvm_cache.py)
    with pytest.raises(ValueError):
        JUvm(np.zeros((R, D), np.float32), cache_rows=4).prepare(
            np.arange(10, dtype=np.int32))


def _ebc_batch(seed, weighted):
    """tests/test_uvm_cache.py's make_batch (features f0 over 300 rows, f1
    over 120, B 16, L 2), optionally with per-sample weights."""
    r = np.random.RandomState(seed)
    Bb, Lb = 16, 2
    rows = {"f0": 300, "f1": 120}
    lengths = r.randint(0, Lb + 1, size=(2 * Bb,)).astype(np.int32)
    vals = []
    for fi, f in enumerate(("f0", "f1")):
        for b in range(Bb):
            vals.extend(r.randint(0, rows[f],
                                  size=(lengths[fi * Bb + b],)).tolist())
    vals = np.asarray(vals, np.int32)
    w = (r.rand(vals.size).astype(np.float32) + 0.5) if weighted else None
    jsb = JKJT.from_lengths(["f0", "f1"], jnp.asarray(vals),
                            jnp.asarray(lengths),
                            weights=None if w is None else jnp.asarray(w)
                            ).to_padded(Lb)
    sb = PaddedSparseBatch(
        ids=torch.as_tensor(np.asarray(jsb.ids)),
        lengths=torch.as_tensor(np.asarray(jsb.lengths)),
        keys=("f0", "f1"),
        weights=None if w is None else torch.as_tensor(
            np.asarray(jsb.weights)))
    return jsb, sb


@pytest.mark.parametrize("weighted", [False, True])
def test_uvm_ebc_matches_jax(weighted):
    rng = np.random.RandomState(0)
    specs = (("u0", 300, "f0", "SUM"), ("u1", 120, "f1", "MEAN"))
    jtables = tuple(JConfig(num_embeddings=r, embedding_dim=16, name=n,
                            feature_names=[f], pooling=JPooling[p])
                    for n, r, f, p in specs)
    tables = [EmbeddingBagConfig(num_embeddings=r, embedding_dim=16, name=n,
                                 feature_names=[f], pooling=PoolingType[p])
              for n, r, f, p in specs]
    weights = {n: rng.randn(r, 16).astype(np.float32) for n, r, _, _ in specs}
    jebc = JUvmEBC(jtables, weights, cache_load_factor=0.3,
                   min_cache_rows=64)
    ebc = UvmEmbeddingBagCollection(tables, weights, cache_load_factor=0.3,
                                    min_cache_rows=64, device="cpu")
    for i in range(5):
        jsb, sb = _ebc_batch(i, weighted)
        want = np.asarray(jebc.forward(jsb).values)
        got = ebc.forward(sb).values.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
        d = np.random.RandomState(100 + i).randn(*want.shape).astype(
            np.float32)
        jebc.update(jsb, jnp.asarray(d), 0.1)
        ebc.update(sb, torch.as_tensor(d), 0.1)
        assert ebc.cache_stats() == jebc.cache_stats()
    for got, want in ((ebc.state_dict(), jebc.state_dict()),
                      (ebc.momentum_dict(), jebc.momentum_dict())):
        assert sorted(got) == sorted(want)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=1e-5,
                                       atol=1e-6, err_msg=name)
    assert ebc.cache_stats()["u0"]["misses"] > 0


def test_uvm_shared_table_update_is_combined():
    """tests/test_advice_fixes_r2.py's case: id 5 under both features of
    one table gets one combined ROWWISE_ADAGRAD step, the port's
    apply_fused_update over both features' (id, gradient) lists bit for
    bit, and JAX's collection's within rtol 1e-5."""
    Rs, Ds, Bs = 32, 8, 4
    t = EmbeddingBagConfig(num_embeddings=Rs, embedding_dim=Ds, name="t",
                           feature_names=["fa", "fb"])
    jt = JConfig(num_embeddings=Rs, embedding_dim=Ds, name="t",
                 feature_names=["fa", "fb"])
    rng = np.random.RandomState(0)
    w0 = rng.randn(Rs, Ds).astype(np.float32)
    kwargs = {"stochastic_rounding": False}
    ebc = UvmEmbeddingBagCollection([t], {"t": w0}, optim_kwargs=kwargs,
                                    device="cpu")
    jebc = JUvmEBC((jt,), {"t": w0}, optim_kwargs=kwargs)
    ids = np.zeros((2, Bs, 1), np.int32)
    ids[0, :, 0] = [5, 1, 2, 3]
    ids[1, :, 0] = [5, 7, 8, 9]
    lengths = np.ones((2, Bs), np.int32)
    d = rng.randn(Bs, 2 * Ds).astype(np.float32)
    ebc.update(PaddedSparseBatch(ids=torch.as_tensor(ids),
                                 lengths=torch.as_tensor(lengths),
                                 keys=("fa", "fb")), torch.as_tensor(d), 0.1)
    jebc.update(JKJT.from_lengths(["fa", "fb"], jnp.asarray(ids.reshape(-1)),
                                  jnp.asarray(lengths.reshape(-1))
                                  ).to_padded(1), jnp.asarray(d), 0.1)
    w = torch.as_tensor(w0.copy())
    opt = init_fused_optimizer_state(Rs, Ds, EmbOptimType.ROWWISE_ADAGRAD)
    apply_fused_update(w, opt, torch.as_tensor(ids.reshape(-1)),
                       torch.as_tensor(np.concatenate([d[:, :Ds], d[:, Ds:]])),
                       torch.ones(2 * Bs, dtype=torch.bool), 0.1, **kwargs)
    got = ebc.state_dict()["t"]
    np.testing.assert_array_equal(got, w.numpy())
    np.testing.assert_allclose(got, jebc.state_dict()["t"], rtol=1e-5,
                               atol=1e-6)


# -- the DMP -------------------------------------------------------------------


class _JModel:
    """tests/test_advice_fixes_r2.py's `_M` (built lazily: flax)."""

    @staticmethod
    def make(tables):
        import flax.linen as nn

        class M(nn.Module):
            ebc: nn.Module

            @nn.compact
            def __call__(self, sb, labels):
                logits = nn.Dense(1)(self.ebc(sb).values)[:, 0]
                y = labels.astype(logits.dtype)
                loss = jnp.mean(jnp.maximum(logits, 0) - logits * y
                                + jnp.log1p(jnp.exp(-jnp.abs(logits))))
                return loss, (loss, logits)

        return M(ebc=JEBC(tables=tables, max_feature_length=cases.UVM_L))


def _jax_uvm_dmp(all_uvm, optim, n=1):
    tables = tuple(JConfig(num_embeddings=r, embedding_dim=cases.UVM_D,
                           name=f"t{i}", feature_names=[f"f{i}"])
                   for i, r in enumerate(cases.UVM_ROWS))

    def uvm():
        return JPS(JST.TABLE_WISE, compute_kernel=JCK.FUSED_UVM_CACHING,
                   ranks=[0])

    plan = {"t0": uvm() if all_uvm else JPS(JST.ROW_WISE), "t1": uvm()}
    return JDMP(_JModel.make(tables),
                env=JEnv.from_devices(jax.devices()[:n]),
                plan=JPlan({"ebc": plan}), fused_optim=JOptim[optim],
                fused_params={"learning_rate": cases.UVM_FUSED_LR},
                dense_optimizer=optax.sgd(cases.UVM_DENSE_LR))


def _jargs(seed):
    vals, lengths, labels = cases.uvm_batch(seed)
    sb = JKJT.from_lengths(["f0", "f1"], jnp.asarray(vals),
                           jnp.asarray(lengths)).to_padded(cases.UVM_L)
    return sb, jnp.asarray(labels)


def _jax_init(all_uvm, optim, n=1, seed=1):
    jdmp = _jax_uvm_dmp(all_uvm, optim, n)
    state = jdmp.init(jax.random.PRNGKey(seed), *_jargs(0))
    return jdmp, state


def _init_arrays(jdmp, state, prefix):
    """The JAX DMP's initial dense params and tables, flat."""
    from torchrec_tpu.optim.keyed import flatten_with_fqns

    out = {f"{prefix}/dense/{k}": np.asarray(v) for k, v in
           flatten_with_fqns(jax.tree.map(np.asarray,
                                          state.dense_params)).items()}
    for name, w in jdmp.state_dict(state)["embeddings/ebc"].items():
        out[f"{prefix}/tables/{name}"] = np.asarray(w)
    return out


def _jax_run(jdmp, state, steps=cases.UVM_STEPS):
    """JAX's eval and steps: (eval logits, [(loss, logits)], state)."""
    _, (_, elogits) = jdmp.make_eval_fn()(state, *_jargs(100))
    step = jdmp.make_train_step(donate=False)
    outs = []
    for s in range(steps):
        state, loss, (_, logits) = step(state, *_jargs(s))
        outs.append((float(loss), np.asarray(logits)))
    return np.asarray(elogits), outs, state


def _hold_state(jdmp, state, got: dict, prefix: str):
    """`got` (cases.record_state's keys) against the JAX DMP's state."""
    want = jdmp.state_dict(state)
    for name, w in want["embeddings/ebc"].items():
        np.testing.assert_allclose(got[f"{prefix}/embeddings/ebc/{name}"],
                                   np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=name)
    for name, m in want.get("uvm_momentum/ebc", {}).items():
        np.testing.assert_allclose(got[f"{prefix}/uvm_momentum/ebc/{name}"],
                                   np.asarray(m), rtol=1e-5, atol=1e-9,
                                   err_msg=name)
    assert sorted(k[len(prefix) + 18:] for k in got
                  if k.startswith(prefix + "/uvm_momentum/ebc/")) == sorted(
        want.get("uvm_momentum/ebc", {}))
    for name, st in jdmp._uvm_mods["ebc"].cache_stats().items():
        np.testing.assert_array_equal(got[f"{prefix}/stats/{name}"],
                                      [st["hits"], st["misses"]])


@pytest.mark.parametrize("optim", cases.UVM_OPTIMS)
@pytest.mark.parametrize("plan", cases.UVM_PLANS)
def test_uvm_dmp_matches_jax(plan, optim):
    jdmp, state = _jax_init(plan == "all_uvm", optim)
    prefix = f"uvm/{plan}/{optim}"
    init = _init_arrays(jdmp, state, prefix)
    out: dict = {}
    cases.run_uvm_case(ShardingEnv("cpu"), plan, optim, init, out)
    elogits, steps, state = _jax_run(jdmp, state)
    np.testing.assert_allclose(out[prefix + "/eval_logits"], elogits,
                               rtol=1e-5, atol=1e-6)
    for s, (loss, logits) in enumerate(steps):
        np.testing.assert_allclose(out[f"{prefix}/loss{s}"], loss, rtol=1e-5)
        np.testing.assert_allclose(out[f"{prefix}/logits{s}"], logits,
                                   rtol=1e-5, atol=1e-6)
    _hold_state(jdmp, state, out, prefix)
    dmp = cases.uvm_dmp(ShardingEnv("cpu"), plan == "all_uvm", optim)
    sebc = dmp.sharded_ebcs["ebc"]
    assert isinstance(sebc, UvmSplitEmbeddingBagCollection)
    assert (sebc.device_part is None) == (plan == "all_uvm")


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """The uvm/ and gather/ cases on two gloo ranks, after the JAX DMPs'
    initial states are written for them."""
    d = tmp_path_factory.mktemp("uvm_gloo")
    init = {}
    for plan in cases.UVM_PLANS:
        for optim in cases.UVM_OPTIMS:
            jdmp, state = _jax_init(plan == "all_uvm", optim, n=2)
            init.update(_init_arrays(jdmp, state, f"uvm/{plan}/{optim}"))
    np.savez(d / "uvm_init.npz", **init)
    return cases.spawn("uvm", 2, d)


@pytest.mark.parametrize("optim", cases.UVM_OPTIMS)
@pytest.mark.parametrize("plan", cases.UVM_PLANS)
def test_uvm_dmp_at_world_size_2_matches_jax(gloo_ranks, plan, optim):
    """Rank r's logits are JAX's rows of its slice, the mean of the ranks'
    losses JAX's loss; rank 0 holds the UVM tables, whose hits and misses
    (over the global batch) equal JAX's; every rank's state dict is JAX's.
    A step makes one ids all_gather and two all_to_alls for the UVM
    tables (the update reuses the forward's ids), besides the ROW_WISE
    group's calls."""
    assert not any(bool(o["jax_imported"]) for o in gloo_ranks)
    jdmp, state = _jax_init(plan == "all_uvm", optim, n=2)
    elogits, steps, state = _jax_run(jdmp, state)
    prefix = f"uvm/{plan}/{optim}"
    r0, r1 = gloo_ranks[0], gloo_ranks[1]
    np.testing.assert_allclose(
        np.concatenate([r0[prefix + "/eval_logits"],
                        r1[prefix + "/eval_logits"]]), elogits,
        rtol=1e-5, atol=1e-6)
    for s, (loss, logits) in enumerate(steps):
        np.testing.assert_allclose(
            (r0[f"{prefix}/loss{s}"] + r1[f"{prefix}/loss{s}"]) / 2, loss,
            rtol=1e-5)
        np.testing.assert_allclose(
            np.concatenate([r0[f"{prefix}/logits{s}"],
                            r1[f"{prefix}/logits{s}"]]), logits,
            rtol=1e-5, atol=1e-6)
    _hold_state(jdmp, state, r0, prefix)
    assert not any(k.startswith(prefix + "/stats/") for k in r1)
    for k, v in r0.items():
        if k.startswith(prefix + "/embeddings/"):
            np.testing.assert_array_equal(r1[k], v)
    calls = {k.rsplit("/", 1)[1]: int(v) for k, v in r0.items()
             if k.startswith(prefix + "/step0/calls/") and int(v)}
    want = {"all_gather": 1, "all_to_all": 2, "all_reduce_mean": 1}
    if plan == "mixed":  # the ROW_WISE group's: ids twice, the cotangent
        want = {"all_gather": 4, "all_to_all": 2, "reduce_scatter": 1,
                "all_reduce_mean": 1}
    assert calls == want


def test_uvm_dmp_momentum_resume_is_exact():
    """test_uvm_cache.py's exact resume, all-UVM under ROWWISE_ADAGRAD and
    ADAM (both moments and the bias-correction step): the state dict after
    3 steps loaded through load_tables(uvm_momentum=) into a fresh DMP,
    whose 2 more steps equal the uninterrupted run's bit for bit."""
    from torchrec_tpu_torch.utils.checkpoint import load_dense

    for optim in ("ROWWISE_ADAGRAD", "ADAM"):
        env = ShardingEnv("cpu")
        dmp = cases.uvm_dmp(env, True, optim).init(0)
        step = dmp.make_train_step()
        for i in range(3):
            step(*cases.port_args(i))
        snap = dmp.unsharded_state_dict()
        assert np.abs(snap["uvm_momentum/ebc"]["t0"]).max() > 0
        if optim == "ADAM":
            assert {"t0.m2", "t0.step"} <= set(snap["uvm_momentum/ebc"])
        for i in range(3, 5):
            step(*cases.port_args(i))
        golden = dmp.unsharded_state_dict()["embeddings/ebc"]
        dmp2 = cases.uvm_dmp(env, True, optim).init(5)
        load_dense(dmp2, {k: v.numpy() for k, v in snap["dense"].items()})
        dmp2.load_tables({"ebc": snap["embeddings/ebc"]},
                         uvm_momentum={"ebc": snap["uvm_momentum/ebc"]})
        step2 = dmp2.make_train_step()
        for i in range(3, 5):
            step2(*cases.port_args(i))
        got = dmp2.unsharded_state_dict()["embeddings/ebc"]
        for name in golden:
            np.testing.assert_array_equal(got[name], golden[name])


def test_uvm_dmp_through_the_pipelines():
    """tests/test_uvm_cache.py's pipeline case: TrainPipeline's losses
    equal the direct loop's, SparseDistPipeline's too (the UVM module
    gathers in the step), EvalPipeline the eval function's; the prefetched
    step raises for a UVM plan, as JAX's does."""
    from torchrec_tpu_torch.parallel.train_pipeline import (
        EvalPipeline,
        SparseDistPipeline,
        TrainPipeline,
    )

    batches = [cases.port_args(i) for i in range(5)]

    def run(make):
        dmp = cases.uvm_dmp(ShardingEnv("cpu"), False, "ROWWISE_ADAGRAD")
        dmp.init(0)
        pipe = make(dmp)
        it, losses = iter(batches), []
        while True:
            try:
                losses.append(float(pipe.progress(it)[0]))
            except StopIteration:
                return losses, dmp

    direct, dmp = run(lambda d: TrainPipeline(d.make_train_step(),
                                              device="cpu"))
    step = cases.uvm_dmp(ShardingEnv("cpu"), False, "ROWWISE_ADAGRAD")
    step.init(0)
    loop = [float(step.make_train_step()(*b)[0]) for b in batches]
    assert direct == loop
    sparse, _ = run(lambda d: SparseDistPipeline(d, device="cpu"))
    assert sparse == loop
    ev = EvalPipeline(dmp.make_eval_fn(), device="cpu")
    it = iter(batches[:2])
    for b in batches[:2]:
        np.testing.assert_array_equal(ev.progress(it)[1][1].numpy(),
                                      dmp.make_eval_fn()(*b)[1][1].numpy())
    with pytest.raises(ValueError, match="FUSED_UVM_CACHING"):
        dmp.make_prefetched_train_step()


def test_uvm_refusals_and_jax_quantize():
    """An FP-EBC over UVM tables raises NotImplementedError, as in JAX.
    Quantized serving of a UVM plan raises NotImplementedError naming
    FUSED_UVM_CACHING; JAX's quantize_embeddings reads the device part
    only: the mixed module's quantized EBC holds t0 alone (t1's 16
    columns are gone) and the all-UVM module (device part None) raises
    AttributeError."""
    from torchrec_tpu.inference.modules import (
        quantize_embeddings as jquantize,
    )
    from torchrec_tpu_torch.inference import (
        PredictModule,
        quantize_embeddings,
    )

    from test_torch_port_feature_processor import _port_dmp as fp_dmp
    from torchrec_tpu_torch.parallel import ComputeKernel

    # a feature processor over UVM tables raises, as JAX's DMP does
    with pytest.raises(NotImplementedError, match="FUSED_UVM_CACHING"):
        fp_dmp("EXACT_SGD", ComputeKernel.FUSED_UVM_CACHING)
    dmp = cases.uvm_dmp(ShardingEnv("cpu"), False, "EXACT_SGD").init(0)
    with pytest.raises(NotImplementedError, match="FUSED_UVM_CACHING"):
        quantize_embeddings(dmp, device="cpu")
    with pytest.raises(NotImplementedError, match="FUSED_UVM_CACHING"):
        PredictModule.from_dmp(dmp, {}, "cpu")
    jdmp, state = _jax_init(False, "EXACT_SGD")
    pm = jquantize(jdmp, state)
    assert [t.name for t in pm._quant_ebcs["ebc"].tables] == ["t0"]
    jdmp, state = _jax_init(True, "EXACT_SGD")
    with pytest.raises(AttributeError):
        jquantize(jdmp, state)
