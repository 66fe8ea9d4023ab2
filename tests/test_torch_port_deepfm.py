"""The port's DeepFM / CrossNet family and module helpers against the JAX
package, on the CPU: modules/utils.py, modules/deepfm.py,
modules/crossnet.py, models/deepfm.py, and SimpleDeepFMNN through the
DMP with the warmup schedule and the warmup(clip(Adam)) dense optimizer.

Inputs are made from a seed with numpy and handed to both sides; weights
and optimizer state go from the JAX side to the port through
utils/jax_bridge.py. The model is SimpleDeepFMNN at a small width: three
tables of 50, 131 and 77 rows at D=8, 5 dense features, hidden 16, deep
width 12, B=32, one id per feature, under a train wrapper with the same
clipped BCE on both sides (the JAX package has no DeepFM train module).

Tolerances: forwards and gradients of the modules rtol 1e-5 / atol 1e-6
(sums in another order); the factorization machine's scalar, a
difference of two large sums, within 1e-5 of (sum x)^2 + sum x^2 per row,
not of itself; the DMP's probabilities, losses, dense parameters, tables,
momenta and Adam moments after three steps rtol 1e-4 / atol 1e-5, as the
DLRM train tests hold them (the Adam second moments atol 1e-8, their
scale); the warmup's lr and count exactly.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from torchrec_tpu.models.deepfm import SimpleDeepFMNN as JSimpleDeepFMNN
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.modules import crossnet as jcross
from torchrec_tpu.modules import utils as jutils
from torchrec_tpu.modules.deepfm import DeepFM as JDeepFM
from torchrec_tpu.modules.deepfm import (
    FactorizationMachine as JFactorizationMachine,
)
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import fused_state_shapes
from torchrec_tpu.optim import CombinedOptimizer as JCombinedOptimizer
from torchrec_tpu.optim import GradientClipping as JClipping
from torchrec_tpu.optim import KeyedOptimizer as JKeyedOptimizer
from torchrec_tpu.optim import WarmupPolicy as JPolicy
from torchrec_tpu.optim import WarmupStage as JStage
from torchrec_tpu.optim import gradient_clipping as jgradient_clipping
from torchrec_tpu.optim import make_warmup_schedule as jmake_warmup_schedule
from torchrec_tpu.optim import warmup_optimizer as jwarmup_optimizer
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.models import SimpleDeepFMNN
from torchrec_tpu_torch.modules import (
    CrossNet,
    DeepFM,
    Dense,
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    FactorizationMachine,
    LowRankCrossNet,
    LowRankMixtureCrossNet,
    VectorCrossNet,
)
from torchrec_tpu_torch.modules import utils as tutils
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.optim import (
    CombinedOptimizer,
    GradientClipping,
    GradientClippingOptimizer,
    KeyedOptimizer,
    WarmupOptimizer,
    WarmupPolicy,
    WarmupStage,
    gradient_clipping,
    make_warmup_schedule,
    warmup_optimizer,
)
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
    keyed_to_optax_state,
    load_flax_params,
    load_jax_weights,
    optax_state_to_keyed,
)

D, DENSE_IN, HIDDEN, DEEP, B = 8, 5, 16, 12, 32
ROWS = (50, 131, 77)
KEYS = [f"f{i}" for i in range(len(ROWS))]
JAX_KEY = "m/embedding_bag_collection"  # the flax field path
PORT_KEY = "m/sparse_arch/embedding_bag_collection"  # the torch module path
FUSED_LR, DENSE_LR, CLIP, STEPS, START = 0.1, 1e-3, 0.1, 3, 5
EPS = 1e-7  # the BCE's clip of the probabilities
TIGHT = dict(rtol=1e-5, atol=1e-6)
MODEL = dict(rtol=1e-4, atol=1e-5)
STAGES = [(JPolicy.LINEAR, 8, 0.1), (JPolicy.CONSTANT, 100, 0.5)]


def _jstages():
    return [JStage(p, m, v) for p, m, v in STAGES]


def _stages():
    return [WarmupStage(WarmupPolicy[p.name], m, v) for p, m, v in STAGES]


# -- modules/utils -------------------------------------------------------------


def test_extract_module_or_tensor_callable():
    dense = Dense(3, 2, "cpu")
    assert tutils.extract_module_or_tensor_callable(dense) is dense
    assert isinstance(tutils.extract_module_or_tensor_callable(nn.ReLU),
                      nn.ReLU)
    fn = torch.tanh
    assert tutils.extract_module_or_tensor_callable(fn) is fn
    for bad in (int, 3):
        with pytest.raises(ValueError):
            tutils.extract_module_or_tensor_callable(bad)
    # the JAX helper treats the same cases alike
    assert isinstance(jutils.extract_module_or_tensor_callable(fnn.Dense(2)),
                      fnn.Dense)
    for bad in (int, 3):
        with pytest.raises(ValueError):
            jutils.extract_module_or_tensor_callable(bad)


@pytest.mark.parametrize("case", ["dense", "crossnet", "sequential",
                                  "callable"])
def test_get_module_output_dimension_matches_jax(case):
    jmod, mod = {
        "dense": (fnn.Dense(7), Dense(5, 7, "meta")),
        "crossnet": (jcross.LowRankCrossNet(num_layers=2, low_rank=3),
                     LowRankCrossNet(5, 2, 3, "cpu")),
        "sequential": (fnn.Sequential([fnn.Dense(4), jax.nn.relu,
                                       fnn.Dense(9)]),
                       nn.Sequential(Dense(5, 4, "cpu"), nn.ReLU(),
                                     Dense(4, 9, "cpu"))),
        "callable": (lambda x: jnp.concatenate([x, x], axis=-1),
                     lambda x: torch.cat([x, x], dim=-1)),
    }[case]
    before = ({n: p.clone() for n, p in mod.named_parameters()}
              if isinstance(mod, nn.Module) else {})
    want = jutils.get_module_output_dimension(jmod, 5)
    assert tutils.get_module_output_dimension(mod, 5) == want
    assert tutils.check_module_output_dimension(mod, 5, want)
    assert not tutils.check_module_output_dimension(mod, 5, want + 1)
    assert tutils.check_module_output_dimension([mod, mod], 5, want)
    # probed on meta: the module's own parameters untouched, where they were
    for n, p in (mod.named_parameters() if before else ()):
        assert p.device == before[n].device
        assert p.is_meta or torch.equal(p, before[n])


def test_xavier_uniform_init_has_flax_bound():
    w = torch.empty(300, 200)
    g = torch.Generator().manual_seed(0)
    tutils.xavier_uniform_init()(w, generator=g)
    flax_w = np.asarray(jutils.xavier_uniform_init()(
        jax.random.PRNGKey(0), (200, 300), jnp.float32))
    bound = (6.0 / 500) ** 0.5
    for x in (w.numpy(), flax_w):
        assert np.abs(x).max() <= bound
        assert abs(x.std() - bound / 3 ** 0.5) < 0.01 * bound
    again = torch.empty(300, 200)
    tutils.xavier_uniform_init()(again,
                                 generator=torch.Generator().manual_seed(0))
    assert torch.equal(w, again)


def test_module_lists():
    proto = Dense(4, 3, "cpu")
    nested = tutils.construct_modulelist_from_single_module(proto, (2, 3))
    assert isinstance(nested, nn.ModuleList) and len(nested) == 2
    assert all(len(row) == 3 for row in nested)
    copies = [m for row in nested for m in row]
    assert len({id(m) for m in copies} | {id(proto)}) == 7
    # each copy re-initialised on its own
    assert not torch.equal(copies[0].weight, copies[1].weight)
    assert len(tutils.construct_modulelist_from_single_module(proto, ())) == 0
    assert len(jutils.construct_modulelist_from_single_module(
        fnn.Dense(3), ())) == 0

    mods = [Dense(2, 2, "cpu") for _ in range(6)]
    grid = tutils.convert_list_of_modules_to_modulelist(mods, (3, 2))
    assert [[id(m) for m in row] for row in grid] == [
        [id(mods[2 * i]), id(mods[2 * i + 1])] for i in range(3)]
    jgrid = jutils.convert_list_of_modules_to_modulelist(list(range(6)),
                                                         (3, 2))
    assert jgrid == ((0, 1), (2, 3), (4, 5))
    for convert in (tutils.convert_list_of_modules_to_modulelist,
                    jutils.convert_list_of_modules_to_modulelist):
        with pytest.raises(ValueError, match="do not match"):
            convert(mods[:5], (3, 2))


# -- DeepFM, FM and the cross nets against flax ------------------------------


def _flax_and_port(jmod, mod, inputs, seed, listed):
    """Forward and VJP of the flax module (params from its init) and of the
    port module (the same params, bridged) on the same inputs and
    cotangent. Returns (jax out, port out, jax grads, port grads), grads
    as (params by port name, [input grads])."""
    jx = [jnp.asarray(x) for x in inputs]
    arg = (lambda xs: xs) if listed else (lambda xs: xs[0])
    variables = jmod.init(jax.random.PRNGKey(seed), arg(jx))
    params = variables.get("params", {})

    def f(p, *xs):
        return jmod.apply({"params": p}, arg(list(xs)))

    jout, vjp = jax.vjp(f, params, *jx)
    cot = np.random.RandomState(seed + 1).randn(*jout.shape).astype(
        np.float32)
    jdp, *jdx = vjp(jnp.asarray(cot))
    load_flax_params(mod, jax.tree.map(np.asarray, params))
    tx = [torch.tensor(x, requires_grad=True) for x in inputs]
    out = mod(arg(tx))
    out.backward(torch.as_tensor(cot))
    jparams = flax_dense_to_state_dict(jax.tree.map(np.asarray, jdp), mod)
    pgrads = {n: p.grad.numpy() for n, p in mod.named_parameters()}
    return (np.asarray(jout), out.detach().numpy(),
            (jparams, [np.asarray(g) for g in jdx]),
            (pgrads, [x.grad.numpy() for x in tx]))


def _check(jout, out, jgrads, grads, **tol):
    np.testing.assert_allclose(out, jout, **tol)
    assert grads[0].keys() == jgrads[0].keys()
    for name in jgrads[0]:
        np.testing.assert_allclose(grads[0][name], jgrads[0][name],
                                   err_msg=name, **tol)
    for g, jg in zip(grads[1], jgrads[1]):
        np.testing.assert_allclose(g, jg, **tol)


def _embeddings(seed, scale=1.0):
    rng = np.random.RandomState(seed)
    return [(scale * rng.randn(*s)).astype(np.float32)
            for s in ((6, 3), (6, 2, 4), (6, 5))]


def test_deepfm_matches_flax():
    inputs = _embeddings(0)
    _check(*_flax_and_port(JDeepFM(deep_module=fnn.Dense(7)),
                           DeepFM(Dense(16, 7, "cpu")), inputs, seed=1,
                           listed=True), **TIGHT)


@pytest.mark.parametrize("scale", [1.0, 30.0])
def test_factorization_machine_matches_flax(scale):
    """At scale 30 (sum x)^2 and sum x^2 reach 1e5 per row and their
    difference cancels: the tolerance follows their size."""
    inputs = _embeddings(2, scale)
    jout, out, jg, g = _flax_and_port(JFactorizationMachine(),
                                      FactorizationMachine(), inputs, seed=3,
                                      listed=True)
    assert out.shape == (6, 1)
    x = np.concatenate([i.reshape(6, -1) for i in inputs], axis=1)
    size = x.sum(1, keepdims=True) ** 2 + (x ** 2).sum(1, keepdims=True)
    assert np.all(np.abs(out - jout) <= 1e-5 * size)
    assert not g[0] and not jg[0]  # no parameters
    for gi, jgi in zip(g[1], jg[1]):  # d/dx = sum x - x, no cancellation
        np.testing.assert_allclose(gi, jgi, rtol=1e-5, atol=1e-5 * scale)


CROSS_NETS = {
    "crossnet": (lambda: jcross.CrossNet(num_layers=2),
                 lambda: CrossNet(12, 2, "cpu")),
    "lowrank": (lambda: jcross.LowRankCrossNet(num_layers=2, low_rank=3),
                lambda: LowRankCrossNet(12, 2, 3, "cpu")),
    "vector": (lambda: jcross.VectorCrossNet(num_layers=3),
               lambda: VectorCrossNet(12, 3, "cpu")),
    "mixture_1": (lambda: jcross.LowRankMixtureCrossNet(
        num_layers=2, num_experts=1, low_rank=3),
        lambda: LowRankMixtureCrossNet(12, 2, 1, 3, "cpu")),
    "mixture_3": (lambda: jcross.LowRankMixtureCrossNet(
        num_layers=2, num_experts=3, low_rank=3),
        lambda: LowRankMixtureCrossNet(12, 2, 3, 3, "cpu")),
}


@pytest.mark.parametrize("name", sorted(CROSS_NETS))
def test_cross_nets_match_flax(name):
    jmake, make = CROSS_NETS[name]
    x = [np.random.RandomState(4).randn(6, 12).astype(np.float32) * 0.5]
    _check(*_flax_and_port(jmake(), make(), x, seed=5, listed=False),
           **TIGHT)


@pytest.mark.parametrize("name", sorted(CROSS_NETS))
def test_cross_nets_draw_flax_initializers(name):
    _, make = CROSS_NETS[name]
    mod = make()
    for m in mod.modules():
        if isinstance(m, Dense):
            m.reset_parameters(torch.Generator().manual_seed(0))
    if isinstance(mod, VectorCrossNet):
        mod.reset_parameters(torch.Generator().manual_seed(0))
    for pname, p in mod.named_parameters():
        if pname.endswith("bias") or pname.startswith("biases"):
            assert not p.any(), pname
        else:
            fan_in = p.shape[1] if p.shape[1] > 1 else p.shape[0]
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            assert 0 < p.abs().max() <= 2 * std + 1e-6, pname


# -- SimpleDeepFMNN ------------------------------------------------------------


def _table_args():
    return [dict(num_embeddings=r, embedding_dim=D, name=f"t{i}",
                 feature_names=[KEYS[i]]) for i, r in enumerate(ROWS)]


def _request(seed, batch=B):
    rng = np.random.RandomState(seed)
    ids = np.concatenate([rng.randint(0, r, size=batch)
                          for r in ROWS]).astype(np.int32)
    lengths = np.ones(len(ROWS) * batch, np.int32)
    dense = rng.randn(batch, DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=batch).astype(np.float32)
    return ids, lengths, dense, labels


def _jsb(ids, lengths):
    return JKJT.from_lengths(KEYS, jnp.asarray(ids),
                             jnp.asarray(lengths)).to_padded(1)


def _kjt(ids, lengths):
    return KeyedJaggedTensor.from_lengths(KEYS, ids, lengths)


def test_simple_deepfm_matches_flax():
    ids, lengths, dense, _ = _request(0)
    jmodel = JSimpleDeepFMNN(
        num_dense_features=DENSE_IN,
        embedding_bag_collection=JEBC(tables=tuple(
            JConfig(**a) for a in _table_args())),
        hidden_layer_size=HIDDEN, deep_fm_dimension=DEEP)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(dense),
                         _jsb(ids, lengths))["params"]
    jout = np.asarray(jmodel.apply({"params": params}, jnp.asarray(dense),
                                   _jsb(ids, lengths)))
    model = SimpleDeepFMNN(DENSE_IN, EmbeddingBagCollection(
        [EmbeddingBagConfig(**a) for a in _table_args()], device="cpu"),
        HIDDEN, DEEP, device="cpu")
    load_flax_params(model, jax.tree.map(np.asarray, params))
    assert "inter_arch.deep_fm.deep_module.0.weight" in dict(
        model.named_parameters())
    with torch.no_grad():
        out = model(torch.as_tensor(dense), _kjt(ids, lengths))
    assert out.shape == (B, 1) and ((out >= 0) & (out <= 1)).all()
    np.testing.assert_allclose(out.numpy(), jout, **TIGHT)


def test_simple_deepfm_refuses_mixed_dims():
    args = _table_args()
    args[1]["embedding_dim"] = 2 * D
    with pytest.raises(ValueError, match="same dimension"):
        SimpleDeepFMNN(DENSE_IN, EmbeddingBagCollection(
            [EmbeddingBagConfig(**a) for a in args], device="meta"),
            HIDDEN, DEEP, device="meta")
    jmodel = JSimpleDeepFMNN(
        num_dense_features=DENSE_IN, embedding_bag_collection=JEBC(
            tables=tuple(JConfig(**a) for a in args)),
        hidden_layer_size=HIDDEN, deep_fm_dimension=DEEP)
    ids, lengths, dense, _ = _request(0)
    with pytest.raises(ValueError, match="same dimension"):
        jmodel.init(jax.random.PRNGKey(0), jnp.asarray(dense),
                    _jsb(ids, lengths))


# -- SimpleDeepFMNN through the DMP --------------------------------------------


class JDeepFMTrain(fnn.Module):
    """SimpleDeepFMNN + a BCE on its probabilities clipped to [EPS,
    1 - EPS]."""

    m: JSimpleDeepFMNN

    def __call__(self, dense, sparse, labels):
        p = self.m(dense, sparse)[:, 0]
        pc = jnp.clip(p, EPS, 1.0 - EPS)
        loss = -jnp.mean(labels * jnp.log(pc)
                         + (1.0 - labels) * jnp.log1p(-pc))
        return loss, (loss, p)


class DeepFMTrain(nn.Module):
    """The same train wrapper for the port."""

    def __init__(self, m: SimpleDeepFMNN):
        super().__init__()
        self.m = m

    def forward(self, dense, sparse, labels):
        p = self.m(dense, sparse)[:, 0]
        pc = p.clamp(EPS, 1.0 - EPS)
        loss = -torch.mean(labels * torch.log(pc)
                           + (1.0 - labels) * torch.log1p(-pc))
        return loss, (loss, p)


def _jax_dmp(optim, clipping="NORM"):
    model = JDeepFMTrain(m=JSimpleDeepFMNN(
        num_dense_features=DENSE_IN,
        embedding_bag_collection=JEBC(tables=tuple(
            JConfig(**a) for a in _table_args()), max_feature_length=1),
        hidden_layer_size=HIDDEN, deep_fm_dimension=DEEP))
    return JDMP(
        model, env=JEnv.from_devices(jax.devices()[:1]),
        plan=JPlan({JAX_KEY: {f"t{i}": JPS(JST.ROW_WISE)
                              for i in range(len(ROWS))}}),
        fused_optim=JOptim[optim],
        fused_params={"learning_rate": FUSED_LR,
                      "lr_schedule": jmake_warmup_schedule(_jstages(),
                                                           FUSED_LR)},
        dense_optimizer=jwarmup_optimizer(jgradient_clipping(
            optax.adam(DENSE_LR), JClipping[clipping], CLIP), _jstages()))


def _port_dmp(optim, clipping="NORM", device="cpu"):
    model = DeepFMTrain(SimpleDeepFMNN(
        DENSE_IN, EmbeddingBagCollection(
            [EmbeddingBagConfig(**a) for a in _table_args()],
            max_feature_length=1, device="meta"),
        HIDDEN, DEEP, device="meta"))
    return DistributedModelParallel(
        model, device=device,
        plan=ShardingPlan({PORT_KEY: {f"t{i}": ParameterSharding(
            ShardingType.ROW_WISE) for i in range(len(ROWS))}}),
        fused_optim=EmbOptimType[optim],
        fused_params={"learning_rate": FUSED_LR,
                      "lr_schedule": make_warmup_schedule(_stages(),
                                                          FUSED_LR)},
        dense_optimizer=warmup_optimizer(gradient_clipping(
            lambda p: torch.optim.Adam(p, lr=DENSE_LR),
            GradientClipping[clipping], CLIP), _stages()))


def _seeded_tree(tree, seed):
    rng = np.random.RandomState(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        0.01 * rng.rand(*np.shape(x)).astype(np.float32)), tree)


def _mid_run(jdmp, state, optim, seed):
    """The JAX state at step START: the fused optimizer's momenta seeded
    in [0, 0.01) at step START, the dense Adam's moments seeded and its
    count and the warmup's at START, the DMP's step (the fused schedule's
    count) at START."""
    rng = np.random.RandomState(seed)
    per_table = {}
    for name, rows in zip([f"t{i}" for i in range(len(ROWS))], ROWS):
        entry = {"step": np.asarray(START, np.int32)}
        for tag, kind in zip(("m1", "m2"), fused_state_shapes(JOptim[optim])):
            shape = {"row": (rows,), "full": (rows, D)}.get(kind)
            if shape is not None:
                entry[f"{tag}__{kind}"] = (rng.rand(*shape) * 0.01).astype(
                    np.float32)
        per_table[name] = entry
    groups = tuple(
        g.replace(opt=strat.shard_opt_from_tables(per_table, g.opt))
        for strat, g in zip(jdmp.sharded_ebcs[JAX_KEY].strategies,
                            state.emb_states[JAX_KEY]))

    def fix(node):
        kind = type(node).__name__
        if kind == "ScaleByAdamState":
            return node._replace(count=jnp.int32(START),
                                 mu=_seeded_tree(node.mu, seed + 1),
                                 nu=_seeded_tree(node.nu, seed + 2))
        if kind == "ScaleByScheduleState":
            return node._replace(count=jnp.int32(START))
        if isinstance(node, tuple) and not hasattr(node, "_fields"):
            return tuple(fix(c) for c in node)
        return node

    return state.replace(emb_states={JAX_KEY: groups},
                         dense_opt=fix(state.dense_opt),
                         step=jnp.asarray(START, state.step.dtype))


def _jax_opt_tables(jdmp, state):
    out = {}
    for strat, g in zip(jdmp.sharded_ebcs[JAX_KEY].strategies,
                        state.emb_states[JAX_KEY]):
        out.update(strat.unshard_opt_to_tables(g.opt))
    return out


def _keyed(dmp):
    return KeyedOptimizer(dmp.dense_optimizer,
                          dict(dmp.module.named_parameters()))


def _bridged(optim, clipping="NORM", seed=0):
    """The JAX DMP at step START and the port's DMP loaded from it: weights,
    tables, fused state, the dense optimizer's state and the step."""
    ids, lengths, dense, labels = _request(seed)
    jdmp = _jax_dmp(optim, clipping)
    state = jdmp.init(jax.random.PRNGKey(seed), jnp.asarray(dense),
                      _jsb(ids, lengths), jnp.asarray(labels))
    state = _mid_run(jdmp, state, optim, seed + 10)
    dmp = _port_dmp(optim, clipping)
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
            state.emb_states[JAX_KEY]),
        opt_state=_jax_opt_tables(jdmp, state))
    _keyed(dmp).load_state_dict(optax_state_to_keyed(
        jax.tree.map(np.asarray, state.dense_opt), dmp.module))
    dmp.step = START
    return jdmp, state, dmp


def test_bridge_maps_the_deepfm_dmp_by_name():
    jdmp, state, dmp = _bridged("EXACT_SGD")
    dense = jax.tree.map(np.asarray, state.dense_params)
    assert set(dense["m"]) == {"dense_arch", "inter_arch", "over_arch"}
    flat = flax_dense_to_state_dict(dense, dmp.module)
    assert flat.keys() == dict(dmp.module.named_parameters()).keys()
    np.testing.assert_array_equal(
        flat["m.inter_arch.deep_fm.deep_module.0.weight"],
        dense["m"]["inter_arch"]["Dense_0"]["kernel"].T)
    np.testing.assert_array_equal(flat["m.dense_arch.out.bias"],
                                  dense["m"]["dense_arch"]["Dense_1"]["bias"])
    assert list(jdmp.sharded_ebcs) == [JAX_KEY]
    assert list(dmp.sharded_ebcs) == [PORT_KEY]
    assert dmp.dense_optimizer.count == START


def test_dmp_eval_matches_jax():
    jdmp, state, dmp = _bridged("ROWWISE_ADAGRAD", seed=1)
    ids, lengths, dense, labels = _request(2)
    jloss, (_, jp) = jdmp.make_eval_fn()(state, jnp.asarray(dense),
                                         _jsb(ids, lengths),
                                         jnp.asarray(labels))
    launches = tracing.counts()
    loss, (_, p) = dmp.make_eval_fn()(torch.as_tensor(dense),
                                      _kjt(ids, lengths),
                                      torch.as_tensor(labels))
    assert tracing.counts() == launches  # plain versions only
    assert p.shape == (B,) and ((p >= 0) & (p <= 1)).all()
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), **MODEL)
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL)


@pytest.mark.parametrize("optim,clipping", [
    ("EXACT_SGD", "NORM"), ("ROWWISE_ADAGRAD", "NORM"),
    ("ROWWISE_ADAGRAD", "VALUE")])
def test_dmp_train_steps_match_jax(optim, clipping):
    jdmp, state, dmp = _bridged(optim, clipping, seed=3)
    jstep, step = jdmp.make_train_step(), dmp.make_train_step()
    jsched = jmake_warmup_schedule(_jstages(), FUSED_LR)
    start = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    touched = {f"t{i}": np.zeros(r, bool) for i, r in enumerate(ROWS)}
    launches = tracing.counts()
    engaged = 0
    for s in range(STEPS):
        ids, lengths, dense, labels = _request(20 + s)
        off = 0
        for i in range(len(ROWS)):
            touched[f"t{i}"][ids[off:off + B]] = True
            off += B
        # the fused lr of this step, from the ported schedule
        assert dmp._fused_lr() == float(jsched(START + s))
        state, jloss, _ = jstep(state, jnp.asarray(dense),
                                _jsb(ids, lengths), jnp.asarray(labels))
        loss, (_, p) = step(torch.as_tensor(dense), _kjt(ids, lengths),
                            torch.as_tensor(labels))
        np.testing.assert_allclose(float(loss), float(jloss), **MODEL)
        if clipping == "NORM":
            engaged += float(dmp.dense_optimizer.inner.last_norm) >= CLIP
    assert tracing.counts() == launches
    assert dmp.step == START + STEPS == int(state.step)
    assert dmp.dense_optimizer.count == START + STEPS
    if clipping == "NORM":
        assert engaged > 0

    jdense = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params), dmp.module)
    for name, p in dmp.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jdense[name],
                                   err_msg=name, **MODEL)
    jtables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    tables = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    for name in jtables:
        np.testing.assert_allclose(tables[name], np.asarray(jtables[name]),
                                   err_msg=name, **MODEL)
        untouched = ~touched[name]
        np.testing.assert_array_equal(tables[name][untouched],
                                      start[name][untouched])
    jopt, opt = _jax_opt_tables(jdmp, state), fused_optimizer_state(dmp)
    for name in jopt:
        assert int(opt[name]["step"]) == START + STEPS
        for tag in set(jopt[name]) - {"step"}:
            np.testing.assert_allclose(opt[name][tag],
                                       np.asarray(jopt[name][tag]),
                                       rtol=1e-4, atol=1e-9,
                                       err_msg=f"{name} {tag}")
    # the dense optimizer's state: Adam's moments and both counts
    jstate = jax.tree.map(np.asarray, state.dense_opt)
    back = keyed_to_optax_state(_keyed(dmp).state_dict(), dmp.module, jstate)
    adam, jadam = back[0][1][0], jstate[0][1][0]
    assert int(adam.count) == int(jadam.count) == START + STEPS
    assert int(back[1].count) == int(jstate[1].count) == START + STEPS
    for a, b in zip(jax.tree.leaves(adam.mu), jax.tree.leaves(jadam.mu)):
        np.testing.assert_allclose(a, b, **MODEL)
    for a, b in zip(jax.tree.leaves(adam.nu), jax.tree.leaves(jadam.nu)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-8)


def test_combined_optimizer_state_dict_matches_jax():
    """On a ROWWISE_ADAGRAD DMP after a step: the JAX CombinedOptimizer's
    and the port's state_dicts, the dense keys mapped by the bridge and
    the sharded module's momentum under the same key, equal."""
    jdmp, state, dmp = _bridged("ROWWISE_ADAGRAD", seed=5)
    ids, lengths, dense, labels = _request(6)
    state, _, _ = jdmp.make_train_step()(
        state, jnp.asarray(dense), _jsb(ids, lengths), jnp.asarray(labels))
    dmp.make_train_step()(torch.as_tensor(dense), _kjt(ids, lengths),
                          torch.as_tensor(labels))
    jcombined = JCombinedOptimizer([
        ("dense", JKeyedOptimizer(jdmp.dense_optimizer)),
        ("ebc", jdmp.sharded_ebcs[JAX_KEY])])
    jsd = jcombined.state_dict(state.dense_opt,
                               {"ebc": state.emb_states[JAX_KEY]})
    combined = CombinedOptimizer([("dense", _keyed(dmp)),
                                  ("ebc", dmp.sharded_ebcs[PORT_KEY])])
    sd = combined.state_dict()
    assert combined.step() is None and jcombined.step() is None
    assert [n for n, _ in combined.optimizers] == ["dense", "ebc"]
    mom = "ebc/momentum/row_wise"
    assert mom in sd and mom in jsd
    np.testing.assert_allclose(sd[mom].numpy(), jsd[mom], rtol=1e-4,
                               atol=1e-9)
    # the dense entries: the JAX state's leaves under the port's keys
    want = optax_state_to_keyed(jax.tree.map(np.asarray, state.dense_opt),
                                dmp.module)
    assert set(sd) - {mom} == {f"dense/{k}" for k in want}
    assert sum(v.size for k, v in jsd.items() if k != mom) == sum(
        np.size(v) for k, v in want.items() if not k.endswith("/step")) + 1
    for k, v in want.items():
        np.testing.assert_allclose(sd[f"dense/{k}"].numpy(), v, rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # EXACT_SGD keeps no momentum: neither side lists one
    jdmp, state, dmp = _bridged("EXACT_SGD", seed=5)
    assert not [k for k in CombinedOptimizer(
        [("ebc", dmp.sharded_ebcs[PORT_KEY])]).state_dict()]
    assert not JCombinedOptimizer(
        [("ebc", jdmp.sharded_ebcs[JAX_KEY])]).state_dict(
            state.dense_opt, {"ebc": state.emb_states[JAX_KEY]})


def test_dmp_init_draws_every_parameter_and_restarts_the_warmup():
    dmp = _port_dmp("ROWWISE_ADAGRAD").init(3)
    opt = dmp.dense_optimizer
    assert isinstance(opt, WarmupOptimizer)
    assert isinstance(opt.inner, GradientClippingOptimizer)
    assert isinstance(opt.base_optimizer(), torch.optim.Adam)
    for m in dmp.module.modules():
        if isinstance(m, Dense):
            std = (1.0 / m.in_features) ** 0.5 / 0.87962566103423978
            assert 0 < m.weight.abs().max() <= 2 * std + 1e-6
            assert not m.bias.any()
    tables = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    for name, r in zip(tables, ROWS):
        assert 0 < np.abs(tables[name]).max() <= (1 / r) ** 0.5
    again = _port_dmp("ROWWISE_ADAGRAD").init(3)
    for a, b in zip(dmp.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    step = dmp.make_train_step()
    for s in range(2):
        ids, lengths, dense, labels = _request(s)
        step(torch.as_tensor(dense), _kjt(ids, lengths),
             torch.as_tensor(labels))
    assert opt.count == 2 and dmp.step == 2
    w = dmp.module.m.over_arch.linear.weight
    assert float(opt.state[w]["step"]) == 2 and opt.state[w]["exp_avg"].any()
    dmp.init(4)
    assert opt.count == 0 and dmp.step == 0
    assert float(opt.state[w]["step"]) == 0
    assert not opt.state[w]["exp_avg"].any()


class _JWithUnused(fnn.Module):
    """The JAX train wrapper beside a parameter the loss does not read."""

    inner: JDeepFMTrain

    @fnn.compact
    def __call__(self, dense, sparse, labels):
        self.param("unused", fnn.initializers.ones, (3,))
        return self.inner(dense, sparse, labels)


class _WithUnused(nn.Module):
    def __init__(self, inner: nn.Module):
        super().__init__()
        self.inner = inner
        self.unused = nn.Parameter(torch.empty(3, device="meta"))

    def forward(self, dense, sparse, labels):
        return self.inner(dense, sparse, labels)


def test_dmp_steps_a_parameter_the_loss_does_not_reach():
    """The JAX step differentiates every dense parameter: one the loss does
    not read gets a zero gradient, and Adam still steps it on its moments.
    The port's step gives it a zero gradient too (torch's Adam skips a
    parameter whose gradient is None)."""
    key = "inner/" + JAX_KEY
    jdmp = JDMP(_JWithUnused(inner=_jax_dmp("EXACT_SGD").module),
                env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({key: {f"t{i}": JPS(JST.ROW_WISE)
                                  for i in range(len(ROWS))}}),
                fused_optim=JOptim.EXACT_SGD,
                fused_params={"learning_rate": FUSED_LR},
                dense_optimizer=optax.adam(DENSE_LR))
    ids, lengths, dense, labels = _request(0)
    state = jdmp.init(jax.random.PRNGKey(0), jnp.asarray(dense),
                      _jsb(ids, lengths), jnp.asarray(labels))
    adam, rest = state.dense_opt
    state = state.replace(dense_opt=(adam._replace(
        count=jnp.int32(START), mu=_seeded_tree(adam.mu, 1),
        nu=_seeded_tree(adam.nu, 2)), rest))
    model = _WithUnused(DeepFMTrain(SimpleDeepFMNN(
        DENSE_IN, EmbeddingBagCollection(
            [EmbeddingBagConfig(**a) for a in _table_args()],
            max_feature_length=1, device="meta"),
        HIDDEN, DEEP, device="meta")))
    dmp = DistributedModelParallel(
        model, device="cpu", fused_optim=EmbOptimType.EXACT_SGD,
        plan=ShardingPlan({"inner/" + PORT_KEY: {f"t{i}": ParameterSharding(
            ShardingType.ROW_WISE) for i in range(len(ROWS))}}),
        fused_params={"learning_rate": FUSED_LR},
        dense_optimizer=lambda p: torch.optim.Adam(p, lr=DENSE_LR))
    load_jax_weights(dmp, jax.tree.map(np.asarray, state.dense_params),
                     jdmp.sharded_ebcs[key].unshard_to_dense(
                         state.emb_states[key]))
    _keyed(dmp).load_state_dict(optax_state_to_keyed(
        jax.tree.map(np.asarray, state.dense_opt), dmp.module))
    state, jloss, _ = jdmp.make_train_step()(
        state, jnp.asarray(dense), _jsb(ids, lengths), jnp.asarray(labels))
    loss, _ = dmp.make_train_step()(torch.as_tensor(dense),
                                    _kjt(ids, lengths),
                                    torch.as_tensor(labels))
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL)
    want = np.asarray(state.dense_params["unused"])
    assert np.abs(want - 1.0).max() > 1e-6  # JAX moved it
    np.testing.assert_allclose(dmp.module.unused.detach().numpy(), want,
                               rtol=1e-5, atol=1e-7)
    assert float(dmp.dense_optimizer.state[dmp.module.unused]["step"]) == (
        START + 1)
