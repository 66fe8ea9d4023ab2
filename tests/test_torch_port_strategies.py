"""The port's flat sharding strategies against the JAX package at world
size 1, on the CPU.

DATA_PARALLEL, ROW_WISE, TABLE_WISE and COLUMN_WISE, pooled, and
DATA_PARALLEL, ROW_WISE and TABLE_WISE, sequence: each JAX strategy runs on
`jax.devices()[:1]`, the port's on device="cpu" without a process group
(every collective the identity), from the same tables and the same seeded
optimizer state (step 4). Checked: the shard buffer against JAX's
`state.weights` bit for bit, `unshard_to_dense` exactly, the forward (a
gather bit for bit by value, a pooled sum within rtol 1e-6 / atol 1e-7,
its terms added in another order), one update under every EmbOptimType
(rows and momenta at the fused-update tolerances of
test_torch_port_fused_update.py: rtol 1e-5 / atol 1e-6, 1e-4 for the Adam
and LAMB family and LARS), the optimizer state in the canonical form, and
the rows no valid token touched, unchanged. Then a DLRMTrain DMP under a
mixed plan (one table of each pooled strategy) against JAX's mixed-plan
DMP: eval logits and three train steps (loss, dense parameters and tables
rtol 1e-4 / atol 1e-5, as test_torch_port_train.py); the sharders and
the DMP's `sharders=` merge; ShardedEmbeddingBag; `_convert_rowspace` in
both directions, its warning included; and how the sequence lookups read
ids at or past a table's rows and negative ones. The JAX side runs under
jax.jit (its eager shard_map compiles op by op).
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingBagConfig as JBagConfig,
)
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingConfig as JSeqConfig,
)
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import (
    embedding_names_by_table as j_names_by_table,
)
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.ops.fused_update import fused_state_shapes
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.parallel import sharders as jsharders
from torchrec_tpu.parallel.embedding_sharding import (
    group_tables as j_group_tables,
)
from torchrec_tpu.parallel.sequence_strategies import (
    create_sequence_sharding_strategy as j_create_seq,
)
from torchrec_tpu.parallel.sharded_bag import (
    ShardedEmbeddingBag as JShardedEmbeddingBag,
)
from torchrec_tpu.parallel.strategies import (
    BaseEmbeddingShardingStrategy as JBase,
)
from torchrec_tpu.parallel.strategies import EmbeddingGroupState as JState
from torchrec_tpu.parallel.strategies import (
    create_sharding_strategy as j_create,
)
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.sparse import PaddedSparseBatch as JPSB
from torchrec_tpu_torch.models import DLRM, DLRMTrain
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    EmbeddingConfig,
    PoolingType,
)
from torchrec_tpu_torch.modules.embedding_modules import (
    embedding_names_by_table,
)
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardedEmbeddingBag,
    ShardingEnv,
    ShardingPlan,
    ShardingType,
    sharders,
)
from torchrec_tpu_torch.parallel.embedding_sharding import group_tables
from torchrec_tpu_torch.parallel.sequence_strategies import (
    create_sequence_sharding_strategy,
)
from torchrec_tpu_torch.parallel.strategies import (
    BaseEmbeddingShardingStrategy,
    create_sharding_strategy,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor, PaddedSparseBatch
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    fused_optimizer_state,
    load_jax_weights,
)

ROWS = (50, 131, 77)
D, B, L = 16, 8, 3
POOLED = ("DATA_PARALLEL", "ROW_WISE", "TABLE_WISE", "COLUMN_WISE")
SEQUENCE = ("DATA_PARALLEL", "ROW_WISE", "TABLE_WISE")
# the hierarchical strategies at world size 1: one host of one rank
HIERARCHICAL = ("TABLE_ROW_WISE", "TABLE_COLUMN_WISE")
TOL = {"SGD": (1e-5, 1e-6), "EXACT_SGD": (1e-5, 1e-6),
       "ROWWISE_ADAGRAD": (1e-5, 1e-6), "ADAGRAD": (1e-5, 1e-6),
       "ADAM": (1e-4, 1e-6), "PARTIAL_ROWWISE_ADAM": (1e-5, 1e-6),
       "LAMB": (1e-4, 1e-6), "PARTIAL_ROWWISE_LAMB": (1e-4, 1e-6),
       "LARS_SGD": (1e-4, 1e-6)}
START_STEP = 4


def _configs(seq):
    """(JAX configs, port configs): three tables, one MEAN when pooled."""
    out = []
    for Cfg, Pool in ((JBagConfig, JPooling), (EmbeddingBagConfig,
                                                PoolingType)):
        if seq:
            Cfg = JSeqConfig if Cfg is JBagConfig else EmbeddingConfig
        out.append([
            Cfg(num_embeddings=r, embedding_dim=D, name=f"t{i}",
                feature_names=[f"f{i}"],
                **({} if seq else {"pooling": Pool.MEAN if i == 1
                                   else Pool.SUM}))
            for i, r in enumerate(ROWS)])
    return out


def _metas(st, seq, weighted=False):
    """The one group of the three tables under sharding type `st`, in both
    packages."""
    jcfg, cfg = _configs(seq)
    jmeta = j_group_tables(jcfg, j_names_by_table(jcfg),
                           {c.name: JPS(JST[st]) for c in jcfg}, weighted)
    meta = group_tables(cfg, embedding_names_by_table(cfg),
                        {c.name: ParameterSharding(ShardingType[st])
                         for c in cfg}, weighted)
    assert len(jmeta) == len(meta) == 1
    return jmeta[0], meta[0]


def _dense(seed):
    rng = np.random.RandomState(seed)
    return {f"t{i}": (rng.randn(r, D) * 0.1).astype(np.float32)
            for i, r in enumerate(ROWS)}


def _batch(seed, weighted=False, batch=B, length=L):
    """(ids [F, B, L], lengths [F, B], weights or None) in numpy: ids in
    each table's range, lengths 0..L, duplicates common."""
    rng = np.random.RandomState(seed)
    F = len(ROWS)
    ids = np.stack([rng.randint(0, r, size=(batch, length))
                    for r in ROWS]).astype(np.int32)
    lengths = rng.randint(0, length + 1, size=(F, batch)).astype(np.int32)
    w = (rng.rand(F, batch, length).astype(np.float32) + 0.5
         if weighted else None)
    return ids, lengths, w


def _jsb(ids, lengths, w):
    return JPSB(ids=jnp.asarray(ids), lengths=jnp.asarray(lengths),
                keys=tuple(f"f{i}" for i in range(len(ROWS))),
                weights=None if w is None else jnp.asarray(w))


def _sb(ids, lengths, w):
    return PaddedSparseBatch(
        ids=torch.as_tensor(ids), lengths=torch.as_tensor(lengths),
        keys=tuple(f"f{i}" for i in range(len(ROWS))),
        weights=None if w is None else torch.as_tensor(w))


def _opt_tables(optim, seed, rows=ROWS, dim=D, step=START_STEP):
    """Seeded per-table optimizer state in the canonical form."""
    rng = np.random.RandomState(seed)
    out = {}
    for i, r in enumerate(rows):
        entry = {"step": np.asarray(step, np.int32)}
        for tag, kind in zip(("m1", "m2"), fused_state_shapes(JOptim[optim])):
            shape = {"row": (r,), "full": (r, dim)}.get(kind)
            if shape is not None:
                entry[f"{tag}__{kind}"] = (rng.rand(*shape) * 0.01).astype(
                    np.float32)
        out[f"t{i}"] = entry
    return out


def _pair(st, optim, seq, weighted=False, seed=0):
    """A JAX strategy with its state and the port's, loaded with the same
    tables and optimizer state."""
    jmeta, meta = _metas(st, seq, weighted)
    jenv = JEnv.from_devices(jax.devices()[:1])
    jcreate = j_create_seq if seq else j_create
    create = create_sequence_sharding_strategy if seq else \
        create_sharding_strategy
    jstrat = jcreate(jenv, jmeta, JOptim[optim], {})
    strat = create(ShardingEnv("cpu"), meta, EmbOptimType[optim], {})
    dense = _dense(seed)
    jopt = jstrat.shard_opt_from_tables(_opt_tables(optim, seed + 1),
                                        jstrat.init_opt())
    state = JState(weights=jstrat.shard_from_dense(dense), opt=jopt)
    strat.weights = strat.shard_from_dense(dense)
    strat.shard_opt_from_tables(_opt_tables(optim, seed + 1))
    return jstrat, state, strat, dense


def _touched(ids, lengths):
    """{table: rows a valid token addresses}."""
    valid = np.arange(ids.shape[2])[None, None] < lengths[:, :, None]
    return {f"t{f}": np.unique(ids[f][valid[f]]) for f in range(len(ROWS))}


def _check_update(jstrat, state, strat, optim, ids, lengths, dense):
    rtol, atol = TOL[optim]
    np.testing.assert_allclose(strat.weights.numpy(),
                               np.asarray(state.weights), rtol=rtol,
                               atol=atol)
    for name in ("momentum1", "momentum2"):
        m = getattr(strat, name)
        jm = getattr(state.opt, name)
        assert (m is None) == (jm is None)
        if m is not None:
            assert tuple(m.shape) == tuple(jm.shape)
            np.testing.assert_allclose(m.numpy(), np.asarray(jm), rtol=rtol,
                                       atol=atol, err_msg=name)
    assert int(strat.step) == int(state.opt.step) == START_STEP + 1
    jopt, opt = jstrat.unshard_opt_to_tables(state.opt), \
        strat.unshard_opt_to_tables()
    assert opt.keys() == jopt.keys()
    for name in jopt:
        assert opt[name].keys() == jopt[name].keys()
        for tag in jopt[name]:
            np.testing.assert_allclose(opt[name][tag],
                                       np.asarray(jopt[name][tag]),
                                       rtol=rtol, atol=atol,
                                       err_msg=f"{name} {tag}")
    after = strat.unshard_to_dense(strat.weights)
    for name, rows in _touched(ids, lengths).items():
        keep = np.setdiff1d(np.arange(dense[name].shape[0]), rows)
        np.testing.assert_array_equal(after[name][keep], dense[name][keep])
        assert not np.array_equal(after[name][rows], dense[name][rows])


@pytest.mark.parametrize("optim", [o.name for o in EmbOptimType])
@pytest.mark.parametrize("st", POOLED + HIERARCHICAL)
def test_pooled_strategy_matches_jax(st, optim):
    weighted = st in ("ROW_WISE", "TABLE_WISE", "TABLE_ROW_WISE")
    jstrat, state, strat, dense = _pair(st, optim, False, weighted)
    assert strat.weights_shape() == jstrat.weights_shape()
    np.testing.assert_array_equal(strat.weights.numpy(),
                                  np.asarray(state.weights))
    jtables = jstrat.unshard_to_dense(state.weights)
    for name, t in strat.unshard_to_dense(strat.weights).items():
        np.testing.assert_array_equal(t, dense[name])
        np.testing.assert_array_equal(t, np.asarray(jtables[name]))
    ids, lengths, w = _batch(seed=7, weighted=weighted)
    jout = jax.jit(jstrat.forward)(state, _jsb(ids, lengths, w))
    out = strat(_sb(ids, lengths, w))
    assert out.shape == (len(ROWS), B, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-7)
    d = np.random.RandomState(8).randn(len(ROWS), B, D).astype(np.float32)
    state = jax.jit(jstrat.update)(state, _jsb(ids, lengths, w),
                                   jnp.asarray(d), 0.1)
    strat.update(_sb(ids, lengths, w), torch.as_tensor(d), 0.1)
    _check_update(jstrat, state, strat, optim, ids, lengths, dense)


@pytest.mark.parametrize("optim", [o.name for o in EmbOptimType])
@pytest.mark.parametrize("st", SEQUENCE + HIERARCHICAL[:1])
def test_sequence_strategy_matches_jax(st, optim):
    jstrat, state, strat, dense = _pair(st, optim, True)
    np.testing.assert_array_equal(strat.weights.numpy(),
                                  np.asarray(state.weights))
    ids, lengths, _ = _batch(seed=9, length=4)
    jout = jax.jit(jstrat.forward)(state, _jsb(ids, lengths, None))
    out = strat(_sb(ids, lengths, None))
    assert out.shape == (len(ROWS), B, 4, D)
    # a gather: equal as values (+0.0 here where JAX writes -0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
    d = np.random.RandomState(10).randn(len(ROWS), B, 4, D).astype(
        np.float32)
    state = jax.jit(jstrat.update)(state, _jsb(ids, lengths, None),
                                   jnp.asarray(d), 0.1)
    strat.update(_sb(ids, lengths, None), torch.as_tensor(d), 0.1)
    _check_update(jstrat, state, strat, optim, ids, lengths, dense)


@pytest.mark.parametrize("st", ["DATA_PARALLEL", "TABLE_WISE"])
def test_sequence_ids_past_a_table(st):
    """An id at or past its table's rows reads the packed table's next
    rows in both packages (the clip is to the packed rows); a negative id
    gives zeros here and the row before in JAX (logged in ROADMAP.md §3)."""
    jstrat, state, strat, _ = _pair(st, "EXACT_SGD", True)
    ids = np.zeros((len(ROWS), 1, 4), np.int32)
    ids[0, 0] = [ROWS[0], ROWS[0] + 3, 10**6, -1]
    ids[1, 0] = [ROWS[1] - 1, ROWS[1], 0, -2]
    ids[2, 0] = [ROWS[2], 5, 10**5, -ROWS[2]]
    lengths = np.full((len(ROWS), 1), 4, np.int32)
    jout = np.asarray(jax.jit(jstrat.forward)(state, _jsb(ids, lengths, None)))
    out = strat(_sb(ids, lengths, None)).numpy()
    pos = ids >= 0
    np.testing.assert_array_equal(out[pos], jout[pos])
    assert not out[~pos].any()
    packed = np.asarray(state.weights).reshape(-1, D)
    np.testing.assert_array_equal(jout[0, 0, 0], packed[ROWS[0]])
    # JAX reads row id + offset of the packed table for a negative id
    np.testing.assert_array_equal(jout[1, 0, 3], packed[ROWS[0] - 2])
    np.testing.assert_array_equal(jout[2, 0, 3],
                                  packed[ROWS[0] + ROWS[1] - ROWS[2]])


def _dlrm_tables(port):
    rows = ROWS + (20,)
    Cfg, Pool = ((EmbeddingBagConfig, PoolingType) if port
                 else (JBagConfig, JPooling))
    return [Cfg(num_embeddings=r, embedding_dim=D, name=f"t{i}",
                feature_names=[f"f{i}"],
                pooling=Pool.MEAN if i == 1 else Pool.SUM)
            for i, r in enumerate(rows)]


MIXED = ("DATA_PARALLEL", "TABLE_WISE", "COLUMN_WISE", "ROW_WISE")
JAX_KEY = "dlrm/embedding_bag_collection"
PORT_KEY = "dlrm/sparse_arch/embedding_bag_collection"
DENSE_IN = 5


def _mixed_request(seed, batch=B):
    rng = np.random.RandomState(seed)
    rows = ROWS + (20,)
    lengths = rng.randint(0, L + 1, size=len(rows) * batch).astype(np.int32)
    ids = np.concatenate([
        rng.randint(0, rows[f], size=int(lengths[f * batch:(f + 1) * batch]
                                         .sum()))
        for f in range(len(rows))]).astype(np.int32)
    dense = rng.randn(batch, DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=batch).astype(np.float32)
    return ids, lengths, dense, labels


@pytest.mark.parametrize("optim", ["EXACT_SGD", "ROWWISE_ADAGRAD"])
def test_mixed_plan_dmp_matches_jax(optim):
    keys = [f"f{i}" for i in range(4)]
    jtables = tuple(_dlrm_tables(False))
    jdmp = JDMP(
        JDLRMTrain(dlrm=JDLRM(
            embedding_bag_collection=JEBC(tables=jtables,
                                          max_feature_length=L),
            dense_in_features=DENSE_IN, dense_arch_layer_sizes=(16, D),
            over_arch_layer_sizes=(8, 1))),
        env=JEnv.from_devices(jax.devices()[:1]),
        plan=JPlan({JAX_KEY: {t.name: JPS(JST[s])
                              for t, s in zip(jtables, MIXED)}}),
        fused_optim=JOptim[optim], fused_params={"learning_rate": 0.1},
        dense_optimizer=optax.sgd(0.05))
    tables = _dlrm_tables(True)
    dmp = DistributedModelParallel(
        DLRMTrain(DLRM(EmbeddingBagCollection(tables, max_feature_length=L,
                                              device="meta"),
                       DENSE_IN, (16, D), (8, 1), device="meta")),
        plan=ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
            ShardingType[s]) for t, s in zip(tables, MIXED)}}),
        device="cpu", fused_optim=EmbOptimType[optim],
        fused_params={"learning_rate": 0.1},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=0.05))
    sebc = dmp.sharded_ebcs[PORT_KEY]
    assert [g.sharding_type.name for g in sebc.groups] == list(MIXED)
    batches = [_mixed_request(20 + s) for s in range(4)]
    ids, lengths, dense, labels = batches[0]
    sb0 = JKJT.from_lengths(keys, jnp.asarray(ids),
                            jnp.asarray(lengths)).to_padded(L)
    state = jdmp.init(jax.random.PRNGKey(0), jnp.asarray(dense), sb0,
                      jnp.asarray(labels))
    jsebc = jdmp.sharded_ebcs[JAX_KEY]
    load_jax_weights(dmp, jax.tree.map(np.asarray, state.dense_params),
                     jsebc.unshard_to_dense(state.emb_states[JAX_KEY]))
    for strat, jstrat, g in zip(sebc.strategies, jsebc.strategies,
                                state.emb_states[JAX_KEY]):
        np.testing.assert_array_equal(strat.weights.numpy(),
                                      np.asarray(g.weights))
    # eval, then three steps
    jloss, (_, jlogits, _) = jdmp.make_eval_fn()(
        state, jnp.asarray(dense), sb0, jnp.asarray(labels))
    loss, (_, logits, _) = dmp.make_eval_fn()(
        torch.as_tensor(dense), KeyedJaggedTensor.from_lengths(
            keys, ids, lengths), torch.as_tensor(labels))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-4, atol=1e-5)
    jstep, step = jdmp.make_train_step(), dmp.make_train_step()
    for ids, lengths, dense, labels in batches[1:]:
        sb = JKJT.from_lengths(keys, jnp.asarray(ids),
                               jnp.asarray(lengths)).to_padded(L)
        state, jloss, _ = jstep(state, jnp.asarray(dense), sb,
                                jnp.asarray(labels))
        loss, _ = step(torch.as_tensor(dense), KeyedJaggedTensor.from_lengths(
            keys, ids, lengths), torch.as_tensor(labels))
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                                   atol=1e-5)
    jdense = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params), dmp.module)
    for name, p in dmp.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jdense[name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    jt = jsebc.unshard_to_dense(state.emb_states[JAX_KEY])
    for name, t in sebc.unshard_to_dense().items():
        np.testing.assert_allclose(t, np.asarray(jt[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    jopt = {}
    for jstrat, g in zip(jsebc.strategies, state.emb_states[JAX_KEY]):
        jopt.update(jstrat.unshard_opt_to_tables(g.opt))
    opt = fused_optimizer_state(dmp)
    assert opt.keys() == jopt.keys()
    for name in jopt:
        assert opt[name].keys() == jopt[name].keys()
        for tag in jopt[name]:
            np.testing.assert_allclose(opt[name][tag],
                                       np.asarray(jopt[name][tag]),
                                       rtol=1e-4, atol=1e-7)


PIPELINED = ("DATA_PARALLEL", "TABLE_ROW_WISE", "TABLE_COLUMN_WISE",
             "ROW_WISE")


def _dlrm_pair(optim, plan_types, fused_params=None):
    """JAX's DLRMTrain DMP on one device and the port's on the CPU under
    one plan, the port's loaded with JAX's initial state; the JAX state
    and the first of four seeded requests."""
    keys = [f"f{i}" for i in range(4)]
    jtables = tuple(_dlrm_tables(False))
    jdmp = JDMP(
        JDLRMTrain(dlrm=JDLRM(
            embedding_bag_collection=JEBC(tables=jtables,
                                          max_feature_length=L),
            dense_in_features=DENSE_IN, dense_arch_layer_sizes=(16, D),
            over_arch_layer_sizes=(8, 1))),
        env=JEnv.from_devices(jax.devices()[:1]),
        plan=JPlan({JAX_KEY: {t.name: JPS(JST[s])
                              for t, s in zip(jtables, plan_types)}}),
        fused_optim=JOptim[optim],
        fused_params={"learning_rate": 0.1, **(fused_params or {})},
        dense_optimizer=optax.sgd(0.05))
    tables = _dlrm_tables(True)
    dmp = DistributedModelParallel(
        DLRMTrain(DLRM(EmbeddingBagCollection(tables, max_feature_length=L,
                                              device="meta"),
                       DENSE_IN, (16, D), (8, 1), device="meta")),
        plan=ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
            ShardingType[s]) for t, s in zip(tables, plan_types)}}),
        device="cpu", fused_optim=EmbOptimType[optim],
        fused_params={"learning_rate": 0.1, **(fused_params or {})},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=0.05))
    ids, lengths, dense, labels = _mixed_request(30)
    sb0 = JKJT.from_lengths(keys, jnp.asarray(ids),
                            jnp.asarray(lengths)).to_padded(L)
    state = jdmp.init(jax.random.PRNGKey(0), jnp.asarray(dense), sb0,
                      jnp.asarray(labels))
    load_jax_weights(dmp, jax.tree.map(np.asarray, state.dense_params),
                     jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
                         state.emb_states[JAX_KEY]))
    return jdmp, state, dmp


def _port_args(req):
    ids, lengths, dense, labels = req
    return (torch.as_tensor(dense), KeyedJaggedTensor.from_lengths(
        [f"f{i}" for i in range(4)], ids, lengths), torch.as_tensor(labels))


def _jax_args(req):
    ids, lengths, dense, labels = req
    return (jnp.asarray(dense), JKJT.from_lengths(
        [f"f{i}" for i in range(4)], jnp.asarray(ids),
        jnp.asarray(lengths)).to_padded(L), jnp.asarray(labels))


@pytest.mark.parametrize("routing", ["allgather", "a2a"])
@pytest.mark.parametrize("driver", ["prefetched_step", "sparse_dist"])
def test_prefetched_step_and_pipeline_match_jax(driver, routing):
    """The DMP's prefetched step, driven by hand or by SparseDistPipeline
    on the CPU, over 3 batches of a plan with DATA_PARALLEL (no dist),
    TABLE_ROW_WISE, TABLE_COLUMN_WISE and ROW_WISE groups, against JAX's
    prefetched step from the same state: losses, dense parameters and
    tables rtol 1e-4 / atol 1e-5 (test_torch_port_train.py's bound)."""
    from torchrec_tpu_torch.parallel.train_pipeline import (
        SparseDistPipeline,
    )

    fp = {"input_routing": routing} if routing == "a2a" else None
    jdmp, state, dmp = _dlrm_pair("ROWWISE_ADAGRAD", PIPELINED, fp)
    reqs = [_mixed_request(40 + s) for s in range(3)]
    jstep = jdmp.make_prefetched_train_step()
    jdists = jdmp.input_dist(_jax_args(reqs[0])[1])
    jlosses = []
    for i, req in enumerate(reqs):
        nxt = _jax_args(reqs[min(i + 1, 2)])[1]
        state, jloss, _, jdists = jstep(state, jdists, nxt, *_jax_args(req))
        jlosses.append(float(jloss))
    dists = dmp.input_dist(_port_args(reqs[0])[1])
    assert list(dists) == [PORT_KEY]
    assert [d is None for d in dists[PORT_KEY]] == [True, False, False,
                                                     False]
    if driver == "prefetched_step":
        step, losses = dmp.make_prefetched_train_step(), []
        for i, req in enumerate(reqs):
            nxt = _port_args(reqs[min(i + 1, 2)])[1]
            loss, _, dists = step(dists, nxt, *_port_args(req))
            losses.append(float(loss))
    else:
        pipe = SparseDistPipeline(dmp, device="cpu")
        it = iter([_port_args(r) for r in reqs])
        losses = [float(pipe.progress(it)[0]) for _ in reqs]
        with pytest.raises(StopIteration):
            pipe.progress(it)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4, atol=1e-5)
    jdense = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params), dmp.module)
    for name, p in dmp.module.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jdense[name],
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    jt = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    for name, t in dmp.sharded_ebcs[PORT_KEY].unshard_to_dense().items():
        np.testing.assert_allclose(t, np.asarray(jt[name]), rtol=1e-4,
                                   atol=1e-5, err_msg=name)


def test_local_size_must_divide_the_world():
    """A world that local_size does not divide raises, as JAX's
    ShardingEnv does; the default is the whole world."""
    with pytest.raises(ValueError, match="not divisible"):
        ShardingEnv("cpu", local_size=2)
    with pytest.raises(ValueError, match="not divisible"):
        JEnv.from_devices(jax.devices()[:1], local_size=2)
    env = ShardingEnv("cpu")
    assert (env.local_size, env.num_hosts) == (1, 1)
    assert env.subgroups() == (None, None)
    assert env.subgroup_ranks() == ([[0]], [[0]])


@pytest.mark.parametrize("case", ["host_outside", "dim_not_divisible"])
def test_hierarchical_strategies_refuse_as_jax_does(case):
    """A table pinned to a host outside the world's hosts, and TWCW with a
    dim its local size does not divide, raise ValueError in both packages
    (a group-less CPU env that reports 4 ranks of 2 hosts: the checks run
    before any collective)."""
    st, dim, host = (("TABLE_ROW_WISE", D, 2) if case == "host_outside"
                     else ("TABLE_COLUMN_WISE", 15, 0))
    cfg = EmbeddingBagConfig(num_embeddings=10, embedding_dim=dim, name="t",
                             feature_names=["f"])
    jcfg = JBagConfig(num_embeddings=10, embedding_dim=dim, name="t",
                      feature_names=["f"])
    (meta,) = group_tables([cfg], [["f"]], {"t": ParameterSharding(
        ShardingType[st], host=host)})
    (jmeta,) = j_group_tables([jcfg], [["f"]], {"t": JPS(JST[st],
                                                         host=host)})
    env = ShardingEnv("cpu")
    env.world_size, env.local_size = 4, 2
    with pytest.raises(ValueError):
        create_sharding_strategy(env, meta, EmbOptimType.EXACT_SGD)
    with pytest.raises(ValueError):
        j_create(JEnv.from_devices(jax.devices()[:4], local_size=2), jmeta,
                 JOptim.EXACT_SGD)


def test_sharders_match_jax_and_merge_fused_params():
    jdefault, default = jsharders.get_default_sharders(), \
        sharders.get_default_sharders()
    assert [type(s).__name__ for s in default] == \
        [type(s).__name__ for s in jdefault]
    for s, js in zip(default, jdefault):
        assert s.module_kind == js.module_kind
        assert [t.name for t in s.sharding_types()] == \
            [t.name for t in js.sharding_types()]
        for t in s.sharding_types():
            assert [k.name for k in s.compute_kernels(t)] == \
                [k.name for k in js.compute_kernels(JST[t.name])]
    tables = _dlrm_tables(True)[:2]
    dmp = DistributedModelParallel(
        DLRMTrain(DLRM(EmbeddingBagCollection(tables, device="meta"),
                       DENSE_IN, (16, D), (8, 1), device="meta")),
        plan=ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
            ShardingType.DATA_PARALLEL) for t in tables}}),
        device="cpu", fused_params={"learning_rate": 0.2, "eps": 1e-6},
        sharders=[sharders.EmbeddingBagCollectionSharder(
            fused_params={"learning_rate": 0.5, "weight_decay": 0.01})])
    assert dmp.learning_rate == 0.2  # the explicit one wins
    assert dmp.fused_params == {"weight_decay": 0.01, "eps": 1e-6}
    strat = dmp.sharded_ebcs[PORT_KEY].strategies[0]
    assert strat.optim_kwargs == {"weight_decay": 0.01, "eps": 1e-6}


@pytest.mark.parametrize("st", POOLED)
def test_sharded_embedding_bag_matches_jax(st):
    jenv = JEnv.from_devices(jax.devices()[:1])
    jbag = JShardedEmbeddingBag(jenv, 40, D, JPS(JST[st]),
                                pooling=JPooling.MEAN, is_weighted=True,
                                optim=JOptim.ROWWISE_ADAGRAD)
    bag = ShardedEmbeddingBag(ShardingEnv("cpu"), 40, D,
                              ParameterSharding(ShardingType[st]),
                              pooling=PoolingType.MEAN, is_weighted=True)
    w = (np.random.RandomState(3).randn(40, D) * 0.1).astype(np.float32)
    states = jbag.shard_from_dense(w)
    bag.shard_from_dense(w)
    rng = np.random.RandomState(4)
    ids = rng.randint(0, 40, size=(B, L)).astype(np.int32)
    lengths = rng.randint(0, L + 1, size=B).astype(np.int32)
    psw = rng.rand(B, L).astype(np.float32)
    jout = jax.jit(jbag.forward)(states, jnp.asarray(ids),
                                 jnp.asarray(lengths), jnp.asarray(psw))
    out = bag(torch.as_tensor(ids), torch.as_tensor(lengths),
              torch.as_tensor(psw))
    assert out.shape == (B, D)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=1e-6,
                               atol=1e-7)
    d = rng.randn(B, D).astype(np.float32)
    states = jax.jit(jbag.update)(states, jnp.asarray(ids),
                                  jnp.asarray(lengths), jnp.asarray(d), 0.1,
                                  jnp.asarray(psw))
    bag.update(torch.as_tensor(ids), torch.as_tensor(lengths),
               torch.as_tensor(d), 0.1, torch.as_tensor(psw))
    np.testing.assert_allclose(bag.unshard_to_dense(),
                               np.asarray(jbag.unshard_to_dense(states)),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("case", ["same", "collapse", "expand", "one_shard"])
def test_convert_rowspace_matches_jax(case):
    rng = np.random.RandomState(5)
    arr, s = {"same": (rng.rand(4, 7), 4), "collapse": (rng.rand(4, 7), 1),
              "expand": (rng.rand(7), 4),
              "one_shard": (rng.rand(1, 7), 1)}[case]
    arr = arr.astype(np.float32)
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        ref = JBase._convert_rowspace(arr, s)
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = BaseEmbeddingShardingStrategy._convert_rowspace(arr, s)
    np.testing.assert_array_equal(got, ref)
    assert got.shape == ref.shape == ((7,) if s == 1 else (s, 7))
    assert [w.category for w in tw] == [w.category for w in jw]
    assert len(tw) == (1 if case == "expand" else 0)
    for w in tw:
        assert "4 column shards (checkpoint had 1)" in str(w.message)


def test_column_wise_rowwise_state_round_trips():
    """A COLUMN_WISE strategy's rowwise state comes out in JAX's form at
    world size 1 ([1, R] under "m1__row") and loads into a ROW_WISE one
    by JAX's mean, and an [S, R] "cwrow" state of four column shards
    collapses by the mean over shards."""
    jstrat, state, strat, _ = _pair("COLUMN_WISE", "ROWWISE_ADAGRAD", False)
    opt = strat.unshard_opt_to_tables()
    jopt = jstrat.unshard_opt_to_tables(state.opt)
    for name in opt:
        assert opt[name]["m1__row"].shape == (1, ROWS[int(name[1])])
        np.testing.assert_array_equal(opt[name]["m1__row"],
                                      np.asarray(jopt[name]["m1__row"]))
    _, _, rw, _ = _pair("ROW_WISE", "ROWWISE_ADAGRAD", False)
    rng = np.random.RandomState(6)
    cw4 = {f"t{i}": {"m1__cwrow": rng.rand(4, r).astype(np.float32),
                     "step": np.asarray(9, np.int32)}
           for i, r in enumerate(ROWS)}
    rw.shard_opt_from_tables(cw4)
    back = rw.unshard_opt_to_tables()
    for name, entry in cw4.items():
        np.testing.assert_array_equal(back[name]["m1__row"],
                                      entry["m1__cwrow"].mean(axis=0))
        assert int(back[name]["step"]) == 9
