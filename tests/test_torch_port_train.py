"""The port's training step against the JAX package, on the CPU.

A JAX DistributedModelParallel over DLRMTrain (one device, every table
ROW_WISE) and the port's DMP on device="cpu" start from the same weights,
bridged as numpy through utils/jax_bridge.py, and take three steps on the
same batches: fused_params {"learning_rate": 0.1} and a dense SGD at
0.05, as bench.py trains, under every fused optimizer. The optimizer state
starts at step 5 with seeded momenta, set in the JAX state and bridged
into the port with the weights. The small tables (50/131/77 rows, B=32)
make duplicate ids within a batch common; L=3 adds a MEAN table and empty
bags. Both sides run their CPU routes: JAX its XLA fused update, the port
the plain versions of K2-K7 behind the same dispatch as on the card.

Tolerances: the loss rtol 1e-4 / atol 1e-5 and the dense parameters,
tables and full momenta atol 1e-5 (rtol 1e-4), as the serving test holds
the forward: the MLP, Gram and gradient sums run in another order, and
duplicate rows' gradients are combined per run here and per token in
JAX's SGD. The rowwise momenta, sums of mean(g^2), are held to rtol 1e-4
/ atol 1e-9. Optimizer state round trips through the bridge are exact.

`load_tables` (and the sharded EC's `shard_from_dense`) restart the fused
optimizer state as the JAX modules do: the state after a load equals
JAX's exactly, and the next step equals a fresh module's bit for bit
(both sides run the same CPU code).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_port_bert4rec import _ec_batch, _ec_tables
from test_torch_port_dlrm import (
    B,
    D,
    DENSE_ARCH,
    DENSE_IN,
    JAX_KEY,
    OVER_ARCH,
    PORT_KEY,
    ROWS,
    _request,
    _table_args,
)
from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingConfig as JSeqConfig,
)
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import fused_state_shapes
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.parallel.sharded_ec import (
    ShardedEmbeddingCollection as JSEC,
)
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu_torch.models import DLRM, DLRMTrain
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    EmbeddingConfig,
    PoolingType,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardedEmbeddingCollection,
    ShardingEnv,
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

FUSED_LR, DENSE_LR, STEPS = 0.1, 0.05, 3
START_STEP = 5
KEYS = [f"f{i}" for i in range(len(ROWS))]
TABLES = [f"t{i}" for i in range(len(ROWS))]


def _jax_dmp(L, mean, optim, lr_schedule=None):
    args, pooling = _table_args(mean)
    tables = tuple(JConfig(**a, pooling=JPooling[p])
                   for a, p in zip(args, pooling))
    model = JDLRMTrain(dlrm=JDLRM(
        embedding_bag_collection=JEBC(tables=tables, max_feature_length=L),
        dense_in_features=DENSE_IN, dense_arch_layer_sizes=DENSE_ARCH,
        over_arch_layer_sizes=OVER_ARCH))
    fused = {"learning_rate": FUSED_LR}
    if lr_schedule is not None:
        fused["lr_schedule"] = lr_schedule
    return JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({JAX_KEY: {t.name: JPS(JST.ROW_WISE)
                                      for t in tables}}),
                fused_optim=JOptim[optim], fused_params=fused,
                dense_optimizer=optax.sgd(DENSE_LR))


def _port_dmp(L, mean, optim, lr_schedule=None):
    args, pooling = _table_args(mean)
    tables = [EmbeddingBagConfig(**a, pooling=PoolingType[p])
              for a, p in zip(args, pooling)]
    model = DLRMTrain(DLRM(
        EmbeddingBagCollection(tables, max_feature_length=L, device="meta"),
        DENSE_IN, DENSE_ARCH, OVER_ARCH, device="meta"))
    plan = ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
        ShardingType.ROW_WISE) for t in tables}})
    fused = {"learning_rate": FUSED_LR}
    if lr_schedule is not None:
        fused["lr_schedule"] = lr_schedule
    return DistributedModelParallel(
        model, plan=plan, device="cpu", fused_optim=EmbOptimType[optim],
        fused_params=fused,
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR))


def _halving(step):
    return FUSED_LR / (1.0 + step)


def _opt_tables(optim, seed, step=START_STEP):
    """Seeded per-table optimizer state in the JAX strategies' canonical
    form: momenta in [0, 0.01), `step`."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, rows in zip(TABLES, ROWS):
        entry = {"step": np.asarray(step, np.int32)}
        for tag, kind in zip(("m1", "m2"), fused_state_shapes(JOptim[optim])):
            shape = {"row": (rows,), "full": (rows, D)}.get(kind)
            if shape is not None:
                entry[f"{tag}__{kind}"] = (rng.rand(*shape) * 0.01).astype(
                    np.float32)
        out[name] = entry
    return out


def _with_opt_state(jdmp, state, per_table):
    """The JAX state with every group's optimizer state loaded from the
    canonical form."""
    groups = tuple(
        g.replace(opt=strat.shard_opt_from_tables(per_table, g.opt))
        for strat, g in zip(jdmp.sharded_ebcs[JAX_KEY].strategies,
                            state.emb_states[JAX_KEY]))
    return state.replace(emb_states={**state.emb_states, JAX_KEY: groups})


def _jax_opt_tables(jdmp, state):
    out = {}
    for strat, g in zip(jdmp.sharded_ebcs[JAX_KEY].strategies,
                        state.emb_states[JAX_KEY]):
        out.update(strat.unshard_opt_to_tables(g.opt))
    return out


@pytest.mark.parametrize("optim,L,mean,schedule", [
    ("EXACT_SGD", 1, False, None),
    ("EXACT_SGD", 3, True, None),
    ("ROWWISE_ADAGRAD", 1, False, None),
    ("ROWWISE_ADAGRAD", 3, True, None),
    ("ROWWISE_ADAGRAD", 1, False, _halving),
    ("ADAGRAD", 1, False, None),
    ("ADAGRAD", 3, True, None),
    ("ADAM", 1, False, None),
    ("ADAM", 3, True, None),
    ("PARTIAL_ROWWISE_ADAM", 1, False, None),
    ("LAMB", 1, False, None),
    ("PARTIAL_ROWWISE_LAMB", 3, True, None),
    ("LARS_SGD", 1, False, None),
])
def test_train_steps_match_jax(optim, L, mean, schedule):
    batches = [_request(L, seed=10 * L + s) for s in range(STEPS)]
    ids, lengths, dense, labels = batches[0]
    jdmp = _jax_dmp(L, mean, optim, schedule)
    sb0 = JKJT.from_lengths(KEYS, jnp.asarray(ids),
                            jnp.asarray(lengths)).to_padded(L)
    state = jdmp.init(jax.random.PRNGKey(0), jnp.asarray(dense), sb0,
                      jnp.asarray(labels))
    state = _with_opt_state(jdmp, state, _opt_tables(optim, seed=L))
    dmp = _port_dmp(L, mean, optim, schedule)
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
            state.emb_states[JAX_KEY]),
        opt_state=_jax_opt_tables(jdmp, state))

    jstep = jdmp.make_train_step()
    step = dmp.make_train_step()
    launches = tracing.counts()
    for ids, lengths, dense, labels in batches:
        sb = JKJT.from_lengths(KEYS, jnp.asarray(ids),
                               jnp.asarray(lengths)).to_padded(L)
        state, jloss, _ = jstep(state, jnp.asarray(dense), sb,
                                jnp.asarray(labels))
        loss, (_, logits, _) = step(
            torch.as_tensor(dense), KeyedJaggedTensor.from_lengths(
                KEYS, ids, lengths), torch.as_tensor(labels))
        assert not loss.requires_grad and logits.shape == (B,)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   atol=1e-5)
    assert tracing.counts() == launches  # plain versions only
    assert dmp.step == STEPS

    jdense = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params), dmp.module)
    for name, p in dmp.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jdense[name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    jtables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    tables = dmp.sharded_ebcs[PORT_KEY].unshard_to_dense()
    for name in jtables:
        np.testing.assert_allclose(tables[name], np.asarray(jtables[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    strat = dmp.sharded_ebcs[PORT_KEY].strategies[0]
    assert int(strat.step) == START_STEP + STEPS
    jopt, opt = _jax_opt_tables(jdmp, state), fused_optimizer_state(dmp)
    start = _opt_tables(optim, seed=L)
    assert opt.keys() == jopt.keys()
    for name in jopt:
        assert opt[name].keys() == jopt[name].keys()
        assert int(opt[name]["step"]) == START_STEP + STEPS
        for tag in sorted(set(jopt[name]) - {"step"}):
            ref = np.asarray(jopt[name][tag])
            assert not np.array_equal(ref, start[name][tag])  # it moved
            atol = 1e-9 if tag.endswith("__row") else 1e-5
            np.testing.assert_allclose(opt[name][tag], ref, rtol=1e-4,
                                       atol=atol, err_msg=f"{name} {tag}")
    if optim == "EXACT_SGD":
        assert strat.momentum1 is None and strat.momentum2 is None


def test_rowwise_momentum_round_trips_through_bridge():
    L = 1
    ids, lengths, dense, labels = _request(L, seed=3)
    jdmp = _jax_dmp(L, False, "ROWWISE_ADAGRAD")
    sb = JKJT.from_lengths(KEYS, jnp.asarray(ids),
                           jnp.asarray(lengths)).to_padded(L)
    state = jdmp.init(jax.random.PRNGKey(1), jnp.asarray(dense), sb,
                      jnp.asarray(labels))
    jstrat = jdmp.sharded_ebcs[JAX_KEY].strategies[0]
    rng = np.random.RandomState(4)
    jm = {t: rng.rand(r).astype(np.float32)
          for t, r in zip(["t0", "t1", "t2"], ROWS)}
    jm_packed = np.asarray(jstrat.shard_rowwise(jm))

    dmp = _port_dmp(L, False, "ROWWISE_ADAGRAD")
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
            state.emb_states[JAX_KEY]),
        opt_state={t: {"m1__row": m, "step": np.int32(0)}
                   for t, m in jm.items()})
    strat = dmp.sharded_ebcs[PORT_KEY].strategies[0]
    # the port's [n, rows_loc] momentum is the JAX layout, bit for bit
    np.testing.assert_array_equal(strat.momentum1.numpy(), jm_packed)

    def rowwise(d):
        return {t: e["m1__row"] for t, e in fused_optimizer_state(d).items()}

    back = rowwise(dmp)
    assert back.keys() == jm.keys()
    for name in jm:
        np.testing.assert_array_equal(back[name], jm[name])
    # and the JAX side reads the port's packing back unchanged
    again = jstrat.unshard_rowwise(strat.momentum1.numpy())
    for name in jm:
        np.testing.assert_array_equal(np.asarray(again[name]), jm[name])
    # the momentum is a buffer: load_state_dict carries it
    other = _port_dmp(L, False, "ROWWISE_ADAGRAD").init(0)
    other.load_state_dict(dmp.state_dict())
    for name in jm:
        np.testing.assert_array_equal(rowwise(other)[name], jm[name])


@pytest.mark.parametrize("optim", ["ADAM", "PARTIAL_ROWWISE_ADAM"])
def test_opt_state_round_trips_through_bridge(optim):
    """Full and rowwise momenta and the step, JAX -> port -> JAX, exact."""
    L = 1
    ids, lengths, dense, labels = _request(L, seed=3)
    jdmp = _jax_dmp(L, False, optim)
    sb = JKJT.from_lengths(KEYS, jnp.asarray(ids),
                           jnp.asarray(lengths)).to_padded(L)
    state = jdmp.init(jax.random.PRNGKey(1), jnp.asarray(dense), sb,
                      jnp.asarray(labels))
    per_table = _opt_tables(optim, seed=4, step=7)
    state = _with_opt_state(jdmp, state, per_table)
    jopt = state.emb_states[JAX_KEY][0].opt

    dmp = _port_dmp(L, False, optim)
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
            state.emb_states[JAX_KEY]),
        opt_state=_jax_opt_tables(jdmp, state))
    strat = dmp.sharded_ebcs[PORT_KEY].strategies[0]
    # the port's packed state is the JAX layout, bit for bit
    for name in ("momentum1", "momentum2"):
        np.testing.assert_array_equal(getattr(strat, name).numpy(),
                                      np.asarray(getattr(jopt, name)))
    assert int(strat.step) == 7
    back = fused_optimizer_state(dmp)
    assert back.keys() == per_table.keys()
    for name, entry in per_table.items():
        assert back[name].keys() == entry.keys()
        for tag, arr in entry.items():
            np.testing.assert_array_equal(back[name][tag], arr)
    # and the JAX side loads the port's form back unchanged
    again = jdmp.sharded_ebcs[JAX_KEY].strategies[0].shard_opt_from_tables(
        back, jopt)
    for name in ("momentum1", "momentum2"):
        np.testing.assert_array_equal(np.asarray(getattr(again, name)),
                                      np.asarray(getattr(jopt, name)))
    assert int(again.step) == 7
    # a state for another optimizer's momenta is refused
    with pytest.raises(ValueError, match="m2__"):
        load_jax_weights(
            _port_dmp(L, False, optim), jax.tree.map(np.asarray,
                                                     state.dense_params),
            jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
                state.emb_states[JAX_KEY]),
            opt_state=_opt_tables("ADAGRAD", seed=4))


def test_init_zeroes_the_optimizer_state():
    dmp = _port_dmp(1, False, "ROWWISE_ADAGRAD").init(0)
    ids, lengths, dense, labels = _request(1, seed=5)
    dmp.make_train_step()(torch.as_tensor(dense),
                          KeyedJaggedTensor.from_lengths(KEYS, ids, lengths),
                          torch.as_tensor(labels))
    strat = dmp.sharded_ebcs[PORT_KEY].strategies[0]
    assert strat.momentum1.abs().sum() > 0 and int(strat.step) == 1
    dmp.init(0)
    assert strat.momentum1.abs().sum() == 0 and int(strat.step) == 0
    assert dmp.step == 0



def _ebc_load_case(optim):
    """The DLRM DMP. JAX: init, one step on _request(1, 1), load_tables
    with its own tables. Returns (JAX's state after the load, make(seed) ->
    (trained thing, its sharded module), step(thing, seed), load(thing,
    tables))."""
    ids, lengths, dense, labels = _request(1, seed=1)
    jdmp = _jax_dmp(1, False, optim)
    sb = JKJT.from_lengths(KEYS, jnp.asarray(ids),
                           jnp.asarray(lengths)).to_padded(1)
    jargs = (jnp.asarray(dense), sb, jnp.asarray(labels))
    state = jdmp.init(jax.random.PRNGKey(0), *jargs)
    state, _, _ = jdmp.make_train_step()(state, *jargs)
    assert int(_jax_opt_tables(jdmp, state)["t0"]["step"]) == 1
    state = jdmp.load_tables(state, {JAX_KEY: jdmp.sharded_ebcs[
        JAX_KEY].unshard_to_dense(state.emb_states[JAX_KEY])})

    def make(seed):
        d = _port_dmp(1, False, optim).init(seed)
        return d, d.sharded_ebcs[PORT_KEY]

    def step(d, seed):
        ids, lengths, dense, labels = _request(1, seed=seed)
        d.make_train_step()(
            torch.as_tensor(dense),
            KeyedJaggedTensor.from_lengths(KEYS, ids, lengths),
            torch.as_tensor(labels))

    def load(d, tables):
        d.load_tables({PORT_KEY: tables})

    return _jax_opt_tables(jdmp, state), make, step, load


def _ec_load_case(optim):
    """The sharded EC of test_torch_port_bert4rec (tables of 60 and 37
    rows, D=16), loaded through shard_from_dense; JAX's state is that of
    its freshly loaded module."""
    tables = [JSeqConfig(**t) for t in _ec_tables()]
    rng = np.random.RandomState(4)
    jsec = JSEC(JEnv.from_devices(jax.devices()[:1]), tables,
                {t.name: JPS(JST.ROW_WISE) for t in tables},
                optim=JOptim[optim])
    jopt = {}
    dense = {t.name: rng.randn(t.num_embeddings, D).astype(np.float32)
             for t in tables}
    for strat, g in zip(jsec.strategies, jsec.shard_from_dense(dense)):
        jopt.update(strat.unshard_opt_to_tables(g.opt))

    def make(seed):
        tables = [EmbeddingConfig(**t) for t in _ec_tables()]
        sec = ShardedEmbeddingCollection(
            ShardingEnv("cpu"), tables,
            {t.name: ParameterSharding(ShardingType.ROW_WISE)
             for t in tables},
            max_feature_length=8, optim=EmbOptimType[optim])
        sec.init(torch.Generator().manual_seed(seed))
        return sec, sec

    def step(sec, seed):
        keys, values, lengths = _ec_batch(seed)
        kjt = KeyedJaggedTensor.from_lengths(keys, values, lengths)
        rng = np.random.RandomState(seed)
        sec.update(kjt, {n: torch.as_tensor(rng.randn(*o.shape).astype(
            np.float32)) for n, o in sec(kjt).items()}, FUSED_LR)

    def load(sec, tables):
        sec.shard_from_dense(tables)

    return jopt, make, step, load


@pytest.mark.parametrize("module,optim", [
    ("ebc", "ROWWISE_ADAGRAD"), ("ebc", "ADAM"), ("ec", "ROWWISE_ADAGRAD")])
def test_load_tables_restarts_the_optimizer_state(module, optim):
    """A module trained one step and loaded with its own tables holds
    JAX's state after JAX's load: step 0 and zero momenta. Its next step
    then equals that of a fresh module loaded with the same weights."""
    jopt, make, step, load = (_ebc_load_case if module == "ebc"
                              else _ec_load_case)(optim)
    trained, sebc = make(0)
    step(trained, 1)
    assert int(sebc.strategies[0].step) == 1
    assert sebc.strategies[0].momentum1.abs().sum() > 0
    weights = sebc.unshard_to_dense()
    load(trained, weights)
    opt = sebc.unshard_opt_to_tables()
    assert opt.keys() == jopt.keys()
    for name in jopt:
        assert opt[name].keys() == jopt[name].keys()
        assert int(opt[name]["step"]) == 0
        for tag, ref in jopt[name].items():
            assert not np.asarray(ref).any()
            np.testing.assert_array_equal(opt[name][tag], np.asarray(ref),
                                          err_msg=f"{name} {tag}")

    fresh, fresh_sebc = make(1)
    if module == "ebc":  # the trained dense parameters too
        with torch.no_grad():
            for p, q in zip(fresh.module.parameters(),
                            trained.module.parameters()):
                p.copy_(q)
    load(fresh, weights)
    step(trained, 2)
    step(fresh, 2)
    after, ref = sebc.unshard_to_dense(), fresh_sebc.unshard_to_dense()
    for name in ref:
        assert not np.array_equal(after[name], weights[name])  # it moved
        np.testing.assert_array_equal(after[name], ref[name], err_msg=name)
