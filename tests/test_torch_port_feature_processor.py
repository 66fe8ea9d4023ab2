"""The port's SwishLayerNorm, feature processors and the DMP's
feature-processor branch against the JAX package, on the CPU.

Inputs are made from a seed with numpy and handed to both sides; weights
and optimizer state go from JAX to the port through utils/jax_bridge.py.

Tolerances: SwishLayerNorm rtol = atol = 1e-6 (flax's variance is
E[x^2] - E[x]^2, torch's two-pass); the position weights are gathers and
a mask product, bit for bit; the unsharded FP-EBC's pooled values and
gradients rtol 1e-5 / atol 1e-6 (sums in another order). The
position-weighted DLRM (3 tables x 50 rows x D=8, L=4, B=16, dense 4 ->
8, over 8-1) is held as tests/test_torch_port_train.py holds the DLRM:
logits, loss, dense parameters, position weights and tables rtol 1e-4 /
atol 1e-5, rowwise momenta rtol 1e-4 / atol 1e-9. The golden step of
tests/test_position_weighted.py keeps its own tolerances.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from test_torch_port_bert4rec import B as EC_B
from test_torch_port_bert4rec import D as EC_D
from test_torch_port_bert4rec import L as EC_L
from test_torch_port_bert4rec import _ec_batch, _ec_tables
from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.modules import EmbeddingCollection as JEC
from torchrec_tpu.modules import FeatureProcessedEmbeddingBagCollection as JFP
from torchrec_tpu.modules import PositionWeightedModule as JPW
from torchrec_tpu.modules.activation import SwishLayerNorm as JSwish
from torchrec_tpu.modules.embedding_configs import EmbeddingConfig as JSeqConf
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.models import DLRM, DLRMTrain
from torchrec_tpu_torch.models.bert4rec import Dense
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    EmbeddingCollection,
    EmbeddingConfig,
    FeatureProcessedEmbeddingBagCollection,
    PositionWeightedModule,
    SwishLayerNorm,
)
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel import (
    ComputeKernel,
    DistributedModelParallel,
    ParameterSharding,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.parallel.sharded_ebc import (
    ShardedFeatureProcessedEmbeddingBagCollection,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, PaddedSparseBatch
from torchrec_tpu_torch.utils import tracing
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    fused_optimizer_state,
    load_flax_params,
    load_jax_weights,
)

TIGHT = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)
ROWS, D, L, B, NT = 50, 8, 4, 16, 3
DENSE_IN, DENSE_ARCH, OVER_ARCH = 4, (8,), (8, 1)
KEYS = [f"f{i}" for i in range(NT)]
# max_len below L (f1), above it (f2), and a key missing (f0)
MAX_LENGTHS = {"f1": 2, "f2": 6}
JAX_KEY = "dlrm/embedding_bag_collection"
PORT_KEY = "dlrm/sparse_arch/embedding_bag_collection"
FUSED_LR, DENSE_LR, STEPS, START_STEP = 0.1, 0.05, 3, 5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jsb(keys, values, lengths, L_=L):
    return JKJT.from_lengths(keys, jnp.asarray(values),
                             jnp.asarray(lengths)).to_padded(L_)


def _batch(seed, zero_rows=False):
    """(values, lengths) of NT features x B rows, lengths 0..L."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, L + 1, size=NT * B).astype(np.int32)
    if zero_rows:
        lengths[:B] = 0  # a feature with no ids at all
    values = rng.randint(0, ROWS, size=int(lengths.sum())).astype(np.int32)
    return values, lengths


# -- SwishLayerNorm ----------------------------------------------------------


@pytest.mark.parametrize("shape", [(7, 16), (3, 5, 32)])
def test_swish_layer_norm_matches_flax(shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    jmod = JSwish()
    params = _np(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    ln = params["params"]["LayerNorm_0"]
    assert np.all(ln["scale"] == 1) and not ln["bias"].any()
    ln["scale"] = rng.rand(shape[-1]).astype(np.float32) + 0.5
    ln["bias"] = rng.randn(shape[-1]).astype(np.float32)
    ref = np.asarray(jmod.apply(params, jnp.asarray(x)))

    mod = SwishLayerNorm(shape[-1], device="cpu")
    assert mod.norm.eps == 1e-6
    assert mod.norm.weight.eq(1).all() and not mod.norm.bias.any()
    load_flax_params(mod, params["params"])
    with torch.no_grad():
        out = mod(torch.as_tensor(x))
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-6, atol=1e-6)


# -- PositionWeightedModule ---------------------------------------------------


@pytest.mark.parametrize("seed,zero_rows", [(0, False), (1, True)])
def test_position_weighted_module_matches_jax(seed, zero_rows):
    """max_len < L, max_len > L, a key missing from max_feature_lengths
    (it uses L) and zero lengths: weights bit for bit, shapes as JAX's."""
    values, lengths = _batch(seed, zero_rows)
    sb = _jsb(KEYS, values, lengths)
    jmod = JPW(max_feature_lengths=tuple(MAX_LENGTHS.items()))
    params = _np(jmod.init(jax.random.PRNGKey(0), sb))["params"]
    rng = np.random.RandomState(seed + 10)
    params = {k: rng.rand(*v.shape).astype(np.float32) + 0.5
              for k, v in params.items()}
    ref = jmod.apply({"params": params}, sb)

    mod = PositionWeightedModule(MAX_LENGTHS, device="cpu").build(KEYS, L)
    shapes = {n: tuple(p.shape) for n, p in mod.named_parameters()}
    assert shapes == {k: v.shape for k, v in params.items()}
    assert shapes["position_weight_f2"] == (6,)
    assert all(p.eq(1).all() for p in mod.parameters())
    load_flax_params(mod, params)
    with torch.no_grad():
        out = mod(KeyedJaggedTensor.from_lengths(KEYS, values,
                                                 lengths).to_padded(L))
    assert out.weights.dtype == torch.float32
    np.testing.assert_array_equal(out.weights.numpy(),
                                  np.asarray(ref.weights))
    np.testing.assert_array_equal(out.ids.numpy(), np.asarray(ref.ids))


def test_position_weights_are_built_by_the_fp_ebc():
    """A processor without parameters is built for the EBC's features and
    max_feature_length; test_position_weighted's standalone module gives
    its masked ones."""
    mod = PositionWeightedModule({"f0": 2}, device="cpu")
    assert not list(mod.parameters())
    with pytest.raises(RuntimeError, match="build"):
        mod(PaddedSparseBatch(torch.zeros(1, 1, 1, dtype=torch.int32),
                              torch.zeros(1, 1, dtype=torch.int32), ("f0",)))
    FeatureProcessedEmbeddingBagCollection(_ebc("cpu"), mod)
    assert mod.feature_names == tuple(KEYS) and mod.max_length == L
    assert tuple(mod.position_weight_f0.shape) == (L,)
    values, lengths = _batch(2)
    sb = KeyedJaggedTensor.from_lengths(KEYS, values, lengths).to_padded(L)
    with torch.no_grad():
        out = mod(sb)
    np.testing.assert_array_equal(out.weights.numpy(),
                                  sb.mask().float().numpy())
    with pytest.raises(ValueError, match="exist"):
        mod.build(KEYS, L)


# -- the unsharded FP-EBC ----------------------------------------------------


def _tables(cls=EmbeddingBagConfig):
    return [cls(num_embeddings=ROWS, embedding_dim=D, name=f"t{i}",
                feature_names=[f"f{i}"]) for i in range(NT)]


def _ebc(device):
    return EmbeddingBagCollection(_tables(), is_weighted=True,
                                  max_feature_length=L, device=device)


def _jfp():
    return JFP(embedding_bag_collection=JEBC(tables=tuple(_tables(JConfig)),
                                             is_weighted=True,
                                             max_feature_length=L),
               feature_processor=JPW(
                   max_feature_lengths=tuple(MAX_LENGTHS.items())))


def _random_pw(params, seed):
    rng = np.random.RandomState(seed)
    return {k: rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            for k, v in params.items()}


def test_unsharded_fp_ebc_and_its_gradients_match_jax():
    values, lengths = _batch(3, zero_rows=True)
    sb = _jsb(KEYS, values, lengths)
    jfp = _jfp()
    params = _np(jfp.init(jax.random.PRNGKey(1), sb))["params"]
    params["feature_processor"] = _random_pw(params["feature_processor"], 4)
    cot = np.random.RandomState(5).randn(B, NT * D).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, params)

    def loss(p):
        return (jfp.apply({"params": p}, sb).values * cot).sum()

    jloss, jgrad = jax.value_and_grad(loss)(jparams)
    ref = jfp.apply({"params": jparams}, sb)

    fp = FeatureProcessedEmbeddingBagCollection(
        _ebc("cpu"), PositionWeightedModule(MAX_LENGTHS, device="cpu"))
    assert fp.is_weighted and fp.tables == fp.embedding_bag_collection.tables
    load_flax_params(fp, params)
    launches = tracing.counts()
    out = fp(KeyedJaggedTensor.from_lengths(KEYS, values, lengths))
    assert out.keys == ref.keys and out.length_per_key == ref.length_per_key
    np.testing.assert_allclose(out.values.detach().numpy(),
                               np.asarray(ref.values), **TIGHT)
    (out.values * torch.as_tensor(cot)).sum().backward()
    assert tracing.counts() == launches  # CPU: plain versions
    np.testing.assert_allclose(
        float((out.values.detach() * torch.as_tensor(cot)).sum()),
        float(jloss), **TIGHT)
    for name, g in jgrad["feature_processor"].items():
        np.testing.assert_allclose(
            fp.feature_processor.get_parameter(name).grad.numpy(),
            np.asarray(g), err_msg=name, **TIGHT)
    for name, g in jgrad["embedding_bag_collection"].items():
        np.testing.assert_allclose(
            fp.embedding_bag_collection.embedding_bags[name].grad.numpy(),
            np.asarray(g), err_msg=name, **TIGHT)


# -- the position-weighted DLRM through the DMPs -----------------------------


def _dlrm_request(seed):
    values, lengths = _batch(seed, zero_rows=seed % 2 == 0)
    rng = np.random.RandomState(seed + 100)
    dense = rng.randn(B, DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=B).astype(np.float32)
    return values, lengths, dense, labels


def _jax_dmp(optim):
    model = JDLRMTrain(dlrm=JDLRM(
        embedding_bag_collection=_jfp(), dense_in_features=DENSE_IN,
        dense_arch_layer_sizes=DENSE_ARCH, over_arch_layer_sizes=OVER_ARCH))
    return JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({JAX_KEY: {f"t{i}": JPS(JST.ROW_WISE)
                                      for i in range(NT)}}),
                fused_optim=JOptim[optim],
                fused_params={"learning_rate": FUSED_LR},
                dense_optimizer=optax.sgd(DENSE_LR))


def _port_model(device="meta", pw=None):
    fp = FeatureProcessedEmbeddingBagCollection(
        _ebc(device), pw or PositionWeightedModule(MAX_LENGTHS, device=device))
    return DLRMTrain(DLRM(fp, DENSE_IN, DENSE_ARCH, OVER_ARCH,
                          device=device))


def _port_dmp(optim, plan_kernel=ComputeKernel.FUSED):
    return DistributedModelParallel(
        _port_model(), device="cpu",
        plan=ShardingPlan({PORT_KEY: {f"t{i}": ParameterSharding(
            ShardingType.ROW_WISE, compute_kernel=plan_kernel)
            for i in range(NT)}}),
        fused_optim=EmbOptimType[optim],
        fused_params={"learning_rate": FUSED_LR},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR))


def _jax_opt_tables(jdmp, state):
    out = {}
    for strat, g in zip(jdmp.sharded_ebcs[JAX_KEY].strategies,
                        state.emb_states[JAX_KEY]):
        out.update(strat.unshard_opt_to_tables(g.opt))
    return out


def _bridged(optim, seed=0):
    """A JAX DMP state with random position weights (and, for the rowwise
    optimizer, seeded momenta at step 5), and the port DMP loaded from
    it."""
    values, lengths, dense, labels = _dlrm_request(seed)
    jdmp = _jax_dmp(optim)
    state = jdmp.init(jax.random.PRNGKey(seed), jnp.asarray(dense),
                      _jsb(KEYS, values, lengths), jnp.asarray(labels))
    dense_params = _np(state.dense_params)
    fp = dense_params["dlrm"]["embedding_bag_collection"]["feature_processor"]
    dense_params["dlrm"]["embedding_bag_collection"]["feature_processor"] = \
        _random_pw(fp, seed + 1)
    dense_params = jax.tree.map(jnp.asarray, dense_params)
    state = state.replace(dense_params=dense_params,
                          dense_opt=jdmp.dense_optimizer.init(dense_params))
    if optim == "ROWWISE_ADAGRAD":
        rng = np.random.RandomState(seed + 2)
        per_table = {f"t{i}": {
            "m1__row": (rng.rand(ROWS) * 0.01).astype(np.float32),
            "step": np.asarray(START_STEP, np.int32)} for i in range(NT)}
        groups = tuple(
            g.replace(opt=strat.shard_opt_from_tables(per_table, g.opt))
            for strat, g in zip(jdmp.sharded_ebcs[JAX_KEY].strategies,
                                state.emb_states[JAX_KEY]))
        state = state.replace(emb_states={JAX_KEY: groups})
    dmp = _port_dmp(optim)
    load_jax_weights(
        dmp, _np(state.dense_params),
        jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(state.emb_states[JAX_KEY]),
        opt_state=_jax_opt_tables(jdmp, state))
    return jdmp, state, dmp


def _port_pw(dmp):
    fp = dmp.module.dlrm.sparse_arch.embedding_bag_collection
    return {n: p.detach().numpy().copy()
            for n, p in fp.feature_processor.named_parameters()}


def test_dmp_swaps_the_inner_ebc_and_keeps_the_processor_dense():
    dmp = _port_dmp("EXACT_SGD").init(0)
    fp = dmp.module.dlrm.sparse_arch.embedding_bag_collection
    assert isinstance(fp, ShardedFeatureProcessedEmbeddingBagCollection)
    assert not any(isinstance(m, FeatureProcessedEmbeddingBagCollection)
                   for m in dmp.modules())
    assert list(dmp.sharded_ebcs) == [PORT_KEY]
    sebc = dmp.sharded_ebcs[PORT_KEY]
    assert fp.embedding_bag_collection is sebc and sebc.is_weighted
    assert sebc.max_feature_length == L
    assert not any(isinstance(m, EmbeddingBagCollection)
                   for m in dmp.modules())
    pw = list(fp.feature_processor.parameters())
    opt_params = {id(p) for g in dmp.dense_optimizer.param_groups
                  for p in g["params"]}
    assert pw and all(id(p) in opt_params for p in pw)
    assert all(p.eq(1).all() for p in pw)  # init(seed) draws ones
    assert not any(b.requires_grad for b in sebc.buffers())
    # a processor over UVM-cached tables raises, as in JAX
    with pytest.raises(NotImplementedError):
        _port_dmp("EXACT_SGD", ComputeKernel.FUSED_UVM_CACHING)


def test_dmp_eval_matches_jax():
    jdmp, state, dmp = _bridged("ROWWISE_ADAGRAD", seed=6)
    values, lengths, dense, labels = _dlrm_request(7)
    jloss, (_, jlogits, _) = jdmp.make_eval_fn()(
        state, jnp.asarray(dense), _jsb(KEYS, values, lengths),
        jnp.asarray(labels))
    loss, (_, logits, _) = dmp.make_eval_fn()(
        torch.as_tensor(dense), KeyedJaggedTensor.from_lengths(
            KEYS, values, lengths), torch.as_tensor(labels))
    assert logits.shape == (B,)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **MODEL)
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL)


@pytest.mark.parametrize("optim", ["EXACT_SGD", "ROWWISE_ADAGRAD"])
def test_dmp_train_steps_match_jax(optim, monkeypatch):
    """Three steps: loss, position weights, dense parameters, tables and
    momenta. Each step gathers the rows of K1's d_coeff once (K8) and
    builds no dense table gradient."""
    jdmp, state, dmp = _bridged(optim, seed=8)
    pw0 = _port_pw(dmp)
    calls = {"gather": 0, "scatter": 0}
    gather, scatter = tl.gather_rows_forward, tl.scatter_add_rows

    def counted_gather(*a):
        calls["gather"] += 1
        return gather(*a)

    def counted_scatter(*a):
        calls["scatter"] += 1
        return scatter(*a)

    monkeypatch.setattr(tl, "gather_rows_forward", counted_gather)
    monkeypatch.setattr(tl, "scatter_add_rows", counted_scatter)
    jstep, step = jdmp.make_train_step(), dmp.make_train_step()
    for s in range(STEPS):
        values, lengths, dense, labels = _dlrm_request(20 + s)
        state, jloss, _ = jstep(state, jnp.asarray(dense),
                                _jsb(KEYS, values, lengths),
                                jnp.asarray(labels))
        loss, _ = step(torch.as_tensor(dense), KeyedJaggedTensor.from_lengths(
            KEYS, values, lengths), torch.as_tensor(labels))
        assert not loss.requires_grad
        np.testing.assert_allclose(float(loss), float(jloss), **MODEL)
    assert calls == {"gather": STEPS, "scatter": 0}

    jdense = flax_dense_to_state_dict(_np(state.dense_params), dmp.module)
    assert any("position_weight" in n for n in jdense)
    for name, p in dmp.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jdense[name],
                                   err_msg=name, **MODEL)
    # the position weights move by 1e-5 to 3e-4 in three steps: their
    # steps are held apart from the weights
    jfp = _np(state.dense_params)["dlrm"][
        "embedding_bag_collection"]["feature_processor"]
    for name, w in _port_pw(dmp).items():
        assert np.abs(w - pw0[name]).max() > 5e-6, name
        np.testing.assert_allclose(w - pw0[name], jfp[name] - pw0[name],
                                   rtol=1e-4, atol=1e-9, err_msg=name)
    jtables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    tables = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    for name in jtables:
        np.testing.assert_allclose(tables[name], np.asarray(jtables[name]),
                                   err_msg=name, **MODEL)
    jopt, opt = _jax_opt_tables(jdmp, state), fused_optimizer_state(dmp)
    for name in jopt:
        assert opt[name].keys() == jopt[name].keys()
        for tag, ref in jopt[name].items():
            np.testing.assert_allclose(opt[name][tag], np.asarray(ref),
                                       rtol=1e-4, atol=1e-9,
                                       err_msg=f"{name} {tag}")


class _FpModel(nn.Module):
    """tests/test_position_weighted.py's FpModel: an FP-EBC and a linear
    head under a BCE loss."""

    flax_names = {"Dense_0": "head"}

    def __init__(self, fpebc, dim, device="meta"):
        super().__init__()
        self.fpebc = fpebc
        self.head = Dense(dim, 1, device)

    def forward(self, sb, labels):
        logits = self.head(self.fpebc(sb).values)[:, 0]
        loss = torch.mean(torch.clamp(logits, min=0) - logits * labels
                          + torch.log1p(torch.exp(-torch.abs(logits))))
        return loss, (loss, logits)


def test_dmp_reproduces_the_position_weighted_golden_step():
    """tests/test_position_weighted.py:139-235: one EXACT_SGD step of the
    port's DMP equals the unsharded JAX autodiff SGD step."""
    import test_position_weighted as tpw

    lr_emb, lr_dense, Lg, Dg = 0.1, 0.05, tpw.L, tpw.D
    sb, labels = tpw._batch(0)
    jmodel = tpw.FpModel(fpebc=JFP(
        embedding_bag_collection=JEBC(
            tables=(JConfig(num_embeddings=tpw.ROWS, embedding_dim=Dg,
                            name="t0", feature_names=["f0"]),),
            is_weighted=True, max_feature_length=Lg),
        feature_processor=JPW(max_feature_lengths=(("f0", Lg),))))
    params = jmodel.init(jax.random.PRNGKey(0), sb, labels)["params"]
    pw0 = jnp.asarray(np.linspace(0.5, 1.5, Lg, dtype=np.float32))
    params["fpebc"]["feature_processor"]["position_weight_f0"] = pw0
    (g_loss, (_, g_logits)), grads = jax.value_and_grad(
        lambda p: jmodel.apply({"params": p}, sb, labels), has_aux=True
    )(params)

    fpebc = FeatureProcessedEmbeddingBagCollection(
        EmbeddingBagCollection(
            [EmbeddingBagConfig(num_embeddings=tpw.ROWS, embedding_dim=Dg,
                                name="t0", feature_names=["f0"])],
            is_weighted=True, max_feature_length=Lg, device="meta"),
        PositionWeightedModule({"f0": Lg}, device="meta"))
    dmp = DistributedModelParallel(
        _FpModel(fpebc, Dg), device="cpu",
        plan=ShardingPlan({"fpebc": {"t0": ParameterSharding(
            ShardingType.ROW_WISE)}}),
        fused_optim=EmbOptimType.EXACT_SGD,
        fused_params={"learning_rate": lr_emb},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=lr_dense))
    p = _np(params)
    load_jax_weights(
        dmp, {"fpebc": {"feature_processor": p["fpebc"]["feature_processor"]},
              "Dense_0": p["Dense_0"]},
        {"t0": p["fpebc"]["embedding_bag_collection"]["t0"]})
    kjt = KeyedJaggedTensor.from_lengths(
        ["f0"], np.array(sb.ids[0]).reshape(-1),
        np.array(sb.lengths).reshape(-1))
    t_labels = torch.as_tensor(np.array(labels))

    loss0, (_, logits0) = dmp.make_eval_fn()(kjt, t_labels)
    np.testing.assert_allclose(logits0.numpy(), np.asarray(g_logits),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(loss0), float(g_loss), rtol=1e-5)
    loss, _ = dmp.make_train_step()(kjt, t_labels)
    np.testing.assert_allclose(float(loss), float(g_loss), rtol=1e-5)
    g_pw = grads["fpebc"]["feature_processor"]["position_weight_f0"]
    assert float(jnp.abs(g_pw).max()) > 1e-6
    np.testing.assert_allclose(
        dmp.module.fpebc.feature_processor.position_weight_f0.detach()
        .numpy(), np.asarray(pw0 - lr_dense * g_pw), rtol=1e-5, atol=1e-6)
    ref_t0 = np.asarray(params["fpebc"]["embedding_bag_collection"]["t0"]
                        - lr_emb * grads["fpebc"]["embedding_bag_collection"]
                        ["t0"])
    np.testing.assert_allclose(
        dmp.sharded_ebcs["fpebc"].unshard_to_dense()["t0"], ref_t0,
        rtol=1e-4, atol=1e-6)


def test_bridge_loads_the_position_weighted_dlrm_by_name():
    """The JAX DMP keeps the FP-EBC's processor at
    dlrm/embedding_bag_collection/feature_processor, the port at
    dlrm.sparse_arch.embedding_bag_collection.feature_processor; an
    unknown processor parameter raises."""
    _, state, dmp = _bridged("EXACT_SGD", seed=3)
    dense = _np(state.dense_params)
    flat = flax_dense_to_state_dict(dense, dmp.module)
    assert flat.keys() == dict(dmp.module.named_parameters()).keys()
    jfp = dense["dlrm"]["embedding_bag_collection"]["feature_processor"]
    assert sorted(jfp) == [f"position_weight_{k}" for k in KEYS]
    for key in KEYS:
        np.testing.assert_array_equal(
            flat["dlrm.sparse_arch.embedding_bag_collection."
                 f"feature_processor.position_weight_{key}"],
            jfp[f"position_weight_{key}"])
    np.testing.assert_array_equal(_port_pw(dmp)["position_weight_f2"],
                                  jfp["position_weight_f2"])
    bad = {"dlrm": {"embedding_bag_collection": {"feature_processor": {
        "position_weight_zz": jfp["position_weight_f0"]}}}}
    with pytest.raises(ValueError, match="position_weight_zz"):
        flax_dense_to_state_dict(bad, dmp.module)


# -- as_jagged ----------------------------------------------------------------


def test_unsharded_ec_as_jagged_matches_jax():
    keys, values, lengths = _ec_batch(11)
    rng = np.random.RandomState(12)
    tables = {t["name"]: rng.randn(t["num_embeddings"], EC_D).astype(np.float32)
              for t in _ec_tables()}
    jec = JEC(tables=tuple(JSeqConf(**t) for t in _ec_tables()),
              max_feature_length=EC_L)
    ref = jec.apply({"params": jax.tree.map(jnp.asarray, tables)},
                    _jsb(keys, values, lengths, EC_L), as_jagged=True)
    ec = EmbeddingCollection([EmbeddingConfig(**t) for t in _ec_tables()],
                             max_feature_length=EC_L, device="cpu")
    load_flax_params(ec, tables)
    with torch.no_grad():
        out = ec(KeyedJaggedTensor.from_lengths(keys, values, lengths),
                 as_jagged=True)
    assert out.keys() == ref.keys()
    for name, jt in ref.items():
        assert out[name].values.dtype == torch.float32
        np.testing.assert_array_equal(out[name].values.numpy(),
                                      np.asarray(jt.values))
        assert out[name].lengths.dtype == torch.int32
        np.testing.assert_array_equal(out[name].lengths.numpy(),
                                      np.asarray(jt.lengths))


class _JSeqHead(fnn.Module):
    """A model that asks its EC for JaggedTensors: the JAX DMP's stand-in
    gives the dense rows all the same."""

    ec: JEC

    @fnn.compact
    def __call__(self, sb):
        toks = self.ec(sb, as_jagged=True)
        x = jnp.concatenate([toks[n] for n in sorted(toks)], axis=-1)
        return fnn.Dense(1)(x)[..., 0]


class _SeqHead(nn.Module):
    flax_names = {"Dense_0": "head"}

    def __init__(self, ec, width):
        super().__init__()
        self.ec = ec
        self.head = Dense(width, 1, "meta")

    def forward(self, sb):
        toks = self.ec(sb, as_jagged=True)
        return self.head(torch.cat([toks[n] for n in sorted(toks)], -1))[
            ..., 0]


def test_sharded_ec_as_jagged_matches_the_jax_dmp():
    keys, values, lengths = _ec_batch(14)
    jtables = tuple(JSeqConf(**t) for t in _ec_tables())
    jdmp = JDMP(_JSeqHead(ec=JEC(tables=jtables, max_feature_length=EC_L)),
                env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({"ec": {t.name: JPS(JST.ROW_WISE)
                                   for t in jtables}}))
    sb = _jsb(keys, values, lengths, EC_L)
    state = jdmp.init(jax.random.PRNGKey(2), sb)
    ref = np.asarray(jdmp.make_eval_fn()(state, sb))

    tables = [EmbeddingConfig(**t) for t in _ec_tables()]
    dmp = DistributedModelParallel(
        _SeqHead(EmbeddingCollection(tables, max_feature_length=EC_L,
                                     device="meta"), EC_D * 4),
        plan=ShardingPlan({"ec": {t.name: ParameterSharding(
            ShardingType.ROW_WISE) for t in tables}}), device="cpu")
    load_jax_weights(dmp, _np(state.dense_params),
                     jdmp.sharded_ebcs["ec"].unshard_to_dense(
                         state.emb_states["ec"]))
    kjt = KeyedJaggedTensor.from_lengths(keys, values, lengths)
    out = dmp.make_eval_fn()(kjt)
    assert out.shape == ref.shape == (EC_B, EC_L)
    np.testing.assert_allclose(out.numpy(), ref, **TIGHT)
    with torch.no_grad():
        dense, jagged = dmp.sharded_ebcs["ec"](kjt), dmp.sharded_ebcs["ec"](
            kjt, as_jagged=True)
    for name in dense:
        assert torch.equal(dense[name], jagged[name])
