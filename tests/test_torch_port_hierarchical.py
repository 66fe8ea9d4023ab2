"""The port's hierarchical strategies (TABLE_ROW_WISE, TABLE_COLUMN_WISE,
TABLE_ROW_WISE sequence), input dists, prefetched step and pipeline, the
feature processor at world size 2 and quantized serving at world size 4,
under gloo, against the JAX package on `jax.devices()[:n]` with the same
`local_size`, on the CPU.

A module-scoped fixture starts one 4-rank group (a file rendezvous) and
one 2-rank group (started by `ShardingEnv.from_distributed` from
torchrun's variables, LOCAL_WORLD_SIZE=2) at once; each rank runs
tests/torch_port_hier_cases.py, which runs every case at local sizes 1, 2
and 4 on the 4-rank group and 2 on the 2-rank one (H = n / Lc hosts), and
writes its outputs to tmp_path; the ranks import no JAX. The tests then
run the same cases in JAX and compare rank r's outputs with JAX's block r.

Tolerances: the loaded shard buffers, the per-token rows of the sequence
forward, the subgroups' gathers and the quantized module's bytes and SUM
outputs (one id a bag) bit for bit, and the two input routings with each
other (dists, outputs and states) bit for bit; pooled sums rtol 1e-6 /
atol 1e-7 (their terms added in another order); one fused update at
test_torch_port_strategies.py's tolerances (rtol 1e-5 / atol 1e-6, 1e-4
for the Adam and LAMB family and LARS); the DMPs' losses (the mean of the
ranks' local losses against JAX's global one), dense parameters and
tables after 3 steps rtol 1e-4 / atol 1e-5, as test_torch_port_train.py
holds one device. A strategy's `forward_from_dist` / `update_from_dist`
on its input dist equal its `forward` / `update` bit for bit. The
collective calls of each forward and update, and of each DMP step, are
counted. A second part needs no process group: a JAX DMP trained 3 steps
on 4 devices with local_size 2 under a TABLE_COLUMN_WISE plan (rowwise
Adagrad state "m1__cwrow" [2, R]) or a TABLE_ROW_WISE one loads into the
port's one-device DMP under another plan, TWCW's state by JAX's mean over
column shards, and the next step matches JAX's on the same load.
"""

import os
import pathlib
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_hier_cases as cases
from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import FeatureProcessedEmbeddingBagCollection as JFP
from torchrec_tpu.modules import PositionWeightedModule as JPW
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingBagConfig as JBagConfig,
)
from torchrec_tpu.modules.embedding_configs import (
    EmbeddingConfig as JSeqConfig,
)
from torchrec_tpu.modules.embedding_configs import DataType as JDataType
from torchrec_tpu.modules.embedding_configs import PoolingType as JPooling
from torchrec_tpu.modules.embedding_modules import (
    embedding_names_by_table as j_names_by_table,
)
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.parallel.dmp import DMPState as JDMPState
from torchrec_tpu.parallel.embedding_sharding import (
    group_tables as j_group_tables,
)
from torchrec_tpu.parallel.quant_sharded import (
    ShardedQuantEmbeddingBagCollection as JShardedQuant,
)
from torchrec_tpu.parallel.sequence_strategies import (
    create_sequence_sharding_strategy as j_create_seq,
)
from torchrec_tpu.parallel.strategies import EmbeddingGroupState as JState
from torchrec_tpu.parallel.strategies import (
    create_sharding_strategy as j_create,
)
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.sparse import PaddedSparseBatch as JPSB
from torchrec_tpu_torch.models import DLRM, DLRMTrain
from torchrec_tpu_torch.modules import EmbeddingBagCollection
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardingEnv,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    fused_optimizer_state,
    load_jax_weights,
)

SPAWN_TIMEOUT_S = 300
JAX_KEY = "dlrm/embedding_bag_collection"
TOL = {"SGD": (1e-5, 1e-6), "EXACT_SGD": (1e-5, 1e-6),
       "ROWWISE_ADAGRAD": (1e-5, 1e-6), "ADAGRAD": (1e-5, 1e-6),
       "ADAM": (1e-4, 1e-6), "PARTIAL_ROWWISE_ADAM": (1e-5, 1e-6),
       "LAMB": (1e-4, 1e-6), "PARTIAL_ROWWISE_LAMB": (1e-4, 1e-6),
       "LARS_SGD": (1e-4, 1e-6)}
MODEL = dict(rtol=1e-4, atol=1e-5)
ROOT = pathlib.Path(__file__).resolve().parent.parent
CONFIG_IDS = [cases.tag(n, lc) for n, lc in cases.CONFIGS]

# collective calls per forward and per update, the per-sample weights
# travelling in calls of their own: the allgather dist is the batch's
# all_gather (ids and lengths in one call, the weights in another), the
# a2a dist a cross all_to_all and an intra all_gather of each
DIST_CALLS = {"allgather": {"all_gather": 2},
              "a2a": {"all_to_all": 2, "all_gather": 2}}
TAIL_CALLS = {
    ("pooled", "TABLE_ROW_WISE"): ({"reduce_scatter": 1, "all_to_all": 1},
                                   {"all_to_all": 1, "all_gather": 1}),
    ("pooled", "TABLE_COLUMN_WISE"): ({"all_to_all": 2}, {"all_to_all": 2}),
    ("sequence", "TABLE_ROW_WISE"): ({"reduce_scatter": 1, "all_to_all": 1},
                                     {"all_to_all": 1, "all_gather": 1}),
}
# the DLRM's collective calls per step (DATA_PARALLEL, TABLE_ROW_WISE,
# TABLE_COLUMN_WISE, ROW_WISE groups, unweighted): make_train_step gathers
# each dist group's ids in its forward and again in its update; the
# prefetched step and the pipeline share one dist between the two, made
# for the next batch at the step's end, so each of the three groups with a
# dist makes one all_gather (allgather) or one all_to_all and one
# all_gather pair (a2a) a step instead of two
STEP_CALLS = {
    "train_step": {"all_gather": 2 + 3 * 2 + 1 + 1, "reduce_scatter": 2,
                   "all_to_all": 2 + 4, "all_reduce_mean": 1},
    "pipeline": {"all_gather": 2 + 3 + 1 + 1, "reduce_scatter": 2,
                 "all_to_all": 2 + 4, "all_reduce_mean": 1},
    "prefetched": {"all_gather": 2 + 2 + 1 + 1 + 1, "reduce_scatter": 2,
                   "all_to_all": 2 + 4 + 2, "all_reduce_mean": 1},
}


def _calls(out, prefix):
    return {k[len(prefix) + 7:]: int(v) for k, v in out.items()
            if k.startswith(prefix + "/calls/") and int(v)}


def _add(*parts):
    out = {}
    for p in parts:
        for k, v in p.items():
            out[k] = out.get(k, 0) + v
    return out


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jenv(n, lc):
    return JEnv.from_devices(jax.devices()[:n], local_size=lc)


def _jcfgs(seq, rows=cases.ROWS, feat_table=cases.FEAT_TABLE, dim=cases.D,
           mean=True):
    feats = [[f"f{f}" for f, t in enumerate(feat_table) if t == i]
             for i in range(len(rows))]
    if seq:
        return [JSeqConfig(num_embeddings=r, embedding_dim=dim, name=f"t{i}",
                           feature_names=feats[i])
                for i, r in enumerate(rows)]
    return [JBagConfig(num_embeddings=r, embedding_dim=dim, name=f"t{i}",
                       feature_names=feats[i],
                       pooling=JPooling.MEAN if mean and i == 1
                       else JPooling.SUM)
            for i, r in enumerate(rows)]


def _jax_dlrm(n, lc, optim, plan_types, tables=None):
    tables = tables or tuple(_jcfgs(False, cases.DLRM_ROWS,
                                    tuple(range(len(cases.DLRM_ROWS)))))
    plan = JPlan({JAX_KEY: {t.name: JPS(JST[s], host=i % (n // lc))
                            for i, (t, s) in enumerate(zip(tables,
                                                           plan_types))}})
    return JDMP(
        JDLRMTrain(dlrm=JDLRM(
            embedding_bag_collection=JEBC(tables=tables,
                                          max_feature_length=cases.L),
            dense_in_features=cases.DENSE_IN,
            dense_arch_layer_sizes=(16, cases.D),
            over_arch_layer_sizes=(8, 1))),
        env=_jenv(n, lc), plan=plan, fused_optim=JOptim[optim],
        fused_params={"learning_rate": cases.FUSED_LR},
        dense_optimizer=optax.sgd(cases.DENSE_LR))


def _jax_request(req, batch_keys=None):
    ids, lengths, dense, labels = req
    values, lens = cases.jagged(ids, lengths)
    keys = batch_keys or [f"f{i}" for i in range(ids.shape[0])]
    sb = JKJT.from_lengths(keys, jnp.asarray(values),
                           jnp.asarray(lens)).to_padded(ids.shape[2])
    return jnp.asarray(dense), sb, jnp.asarray(labels)


def _write_dlrm_init(path):
    """Dense parameters and tables of a JAX DLRMTrain, shared by every
    configuration."""
    jdmp = _jax_dlrm(1, 1, "EXACT_SGD", ("ROW_WISE",) * 4)
    state = jdmp.init(jax.random.PRNGKey(0), *_jax_request(
        cases.dlrm_request(cases.case_seed("dmp", "init"))))
    tables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    np.savez(path / "dlrm_init.npz",
             **{f"dense/{k}": v for k, v in _flat(
                 jax.tree.map(np.asarray, state.dense_params)).items()},
             **{f"table/{k}": np.asarray(v) for k, v in tables.items()})


def _jax_fp_dmp():
    tables = tuple(JBagConfig(num_embeddings=cases.FP_ROWS,
                              embedding_dim=cases.FP_D, name=f"t{i}",
                              feature_names=[f"f{i}"])
                   for i in range(len(cases.FP_PLAN)))
    fp = JFP(embedding_bag_collection=JEBC(tables=tables, is_weighted=True,
                                           max_feature_length=cases.FP_L),
             feature_processor=JPW(
                 max_feature_lengths=tuple(cases.FP_MAX_LENGTHS.items())))
    plan = JPlan({JAX_KEY: {t.name: JPS(
        JST[s], ranks=[1] if s == "TABLE_WISE" else None, host=0)
        for t, s in zip(tables, cases.FP_PLAN)}})
    return JDMP(
        JDLRMTrain(dlrm=JDLRM(embedding_bag_collection=fp,
                              dense_in_features=cases.DENSE_IN,
                              dense_arch_layer_sizes=(cases.FP_D,),
                              over_arch_layer_sizes=(8, 1))),
        env=_jenv(2, 2), plan=plan, fused_optim=JOptim.EXACT_SGD,
        fused_params={"learning_rate": cases.FUSED_LR},
        dense_optimizer=optax.sgd(cases.DENSE_LR))


def _fp_state(jdmp):
    """The FP DLRM's JAX state with random position weights in 0.5..1.5."""
    state = jdmp.init(jax.random.PRNGKey(1), *_jax_request(
        cases.fp_request(cases.case_seed("fp", "init"))))
    dense = jax.tree.map(np.asarray, state.dense_params)
    fp = dense["dlrm"]["embedding_bag_collection"]["feature_processor"]
    rng = np.random.RandomState(11)
    for k, v in fp.items():
        fp[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    dense = jax.tree.map(jnp.asarray, dense)
    return state.replace(dense_params=dense,
                         dense_opt=jdmp.dense_optimizer.init(dense))


def _write_fp_init(path):
    jdmp = _jax_fp_dmp()
    state = _fp_state(jdmp)
    tables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    np.savez(path / "fp_init.npz",
             **{f"dense/{k}": v for k, v in _flat(
                 jax.tree.map(np.asarray, state.dense_params)).items()},
             **{f"table/{k}": np.asarray(v) for k, v in tables.items()})


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{n: [rank 0's outputs, ..., rank n-1's]} of the 4-rank and the
    2-rank group, and "init": the DLRM's initial state they loaded."""
    base = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    dirs = {n: tmp_path_factory.mktemp(f"hier{n}") for n in (4, 2)}
    _write_dlrm_init(dirs[4])
    (dirs[2] / "dlrm_init.npz").write_bytes(
        (dirs[4] / "dlrm_init.npz").read_bytes())
    _write_fp_init(dirs[2])
    port = str(_free_port())
    runs = [(4, r, str(dirs[4] / "rendezvous"), dict(base,
                                                     LOCAL_WORLD_SIZE="4"))
            for r in range(4)]
    runs += [(2, r, "env", dict(
        base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
        LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost", MASTER_PORT=port))
        for r in range(2)]
    procs, logs = [], []
    for n, r, init, env in runs:
        # a file, not a pipe: a rank that fills an unread pipe would block
        logs.append(open(dirs[n] / f"log{r}", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, cases.__file__, str(r), str(n), str(dirs[n]),
             init], env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
    for p, f in zip(procs, logs):
        assert p.returncode == 0, pathlib.Path(f.name).read_text()[-4000:]
    outs = {n: [dict(np.load(d / f"rank{r}.npz")) for r in range(n)]
            for n, d in dirs.items()}
    outs["init"] = dirs[4] / "dlrm_init.npz"
    return outs


def _outs(ranks, n, lc):
    return ranks[n], cases.tag(n, lc)


def _jax_strategy(kind, st, optim, n, lc):
    seq = kind == "sequence"
    cfgs = _jcfgs(seq)
    plan = {c.name: JPS(JST[st], host=cases.host_of(i, n // lc))
            for i, c in enumerate(cfgs)}
    (meta,) = j_group_tables(cfgs, j_names_by_table(cfgs), plan, not seq)
    create = j_create_seq if seq else j_create
    return create(_jenv(n, lc), meta, JOptim[optim], {})


def _jsb(ids, lengths, w):
    return JPSB(ids=jnp.asarray(ids), lengths=jnp.asarray(lengths),
                keys=cases.FEATS,
                weights=None if w is None else jnp.asarray(w))


_FORWARDS = {}


def _jax_case(kind, st, optim, n, lc):
    """JAX's forward (shared by the optimizers of a strategy) and its
    state before and after one update."""
    tables, opt, ids, lengths, w, d = cases.case_inputs(kind, st, optim, lc)
    jstrat = _jax_strategy(kind, st, optim, n, lc)
    state = JState(weights=jstrat.shard_from_dense(tables),
                   opt=jstrat.shard_opt_from_tables(opt, jstrat.init_opt()))
    sb = _jsb(ids, lengths, w)
    key = (kind, st, n, lc)
    if key not in _FORWARDS:
        _FORWARDS[key] = np.asarray(jax.jit(jstrat.forward)(state, sb))
    loaded = np.asarray(state.weights)
    state = jax.jit(jstrat.update)(state, sb, jnp.asarray(d),
                                   cases.FUSED_LR)
    return jstrat, _FORWARDS[key], loaded, state


def _check_state(outs, prefix, jstrat, state, n, rtol, atol):
    for r, out in enumerate(outs):
        np.testing.assert_allclose(
            out[f"{prefix}/weights"],
            np.asarray(state.weights)[r:r + 1].astype(np.float32),
            rtol=rtol, atol=atol, err_msg=f"rank {r}")
        for name in ("momentum1", "momentum2"):
            jm = getattr(state.opt, name)
            assert (jm is None) == (f"{prefix}/{name}" not in out)
            if jm is not None:
                np.testing.assert_allclose(
                    out[f"{prefix}/{name}"], np.asarray(jm)[r:r + 1],
                    rtol=rtol, atol=atol, err_msg=f"rank {r} {name}")
        assert int(out[f"{prefix}/step"]) == int(state.opt.step)
    jtables = jstrat.unshard_to_dense(state.weights)
    jopt = jstrat.unshard_opt_to_tables(state.opt)
    for name in jtables:
        for out in outs:  # an all_gather: the ranks agree bit for bit
            np.testing.assert_array_equal(out[f"{prefix}/table/{name}"],
                                          outs[0][f"{prefix}/table/{name}"])
        np.testing.assert_allclose(outs[0][f"{prefix}/table/{name}"],
                                   np.asarray(jtables[name]), rtol=rtol,
                                   atol=atol, err_msg=name)
        assert {k.split("/")[-1] for k in outs[0]
                if k.startswith(f"{prefix}/opt/{name}/")} == set(jopt[name])
        for key, v in jopt[name].items():
            np.testing.assert_allclose(outs[0][f"{prefix}/opt/{name}/{key}"],
                                       np.asarray(v), rtol=rtol, atol=atol,
                                       err_msg=f"{name} {key}")


def _check_routings_agree(outs, prefix):
    """The a2a routing's dist, forward and state equal the allgather
    routing's bit for bit."""
    a, b = prefix + "/allgather", prefix + "/a2a"
    for out in outs:
        keys = [k[len(a):] for k in out if k.startswith(a + "/")
                and "/calls/" not in k]
        assert keys and {k[len(b):] for k in out if k.startswith(b + "/")
                         and "/calls/" not in k} == set(keys)
        for k in keys:
            np.testing.assert_array_equal(out[b + k], out[a + k], err_msg=k)


def _check_strategy(outs, kind, st, optim, n, lc, pooled):
    prefix = f"{cases.tag(n, lc)}/{kind}/{st}/{optim}"
    jstrat, fwd, loaded, state = _jax_case(kind, st, optim, n, lc)
    B_loc = cases.B // n
    for r, out in enumerate(outs):
        np.testing.assert_array_equal(out[f"{prefix}/allgather/loaded"],
                                      loaded[r:r + 1])
        got = out[f"{prefix}/allgather/forward"]
        want = fwd[:, r * B_loc:(r + 1) * B_loc]
        if pooled:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7,
                                       err_msg=f"rank {r}")
        else:  # a gather: bit for bit as values
            np.testing.assert_array_equal(got, want)
    _check_state(outs, prefix + "/allgather", jstrat, state, n,
                 *TOL[optim])


# the JAX comparisons: every optimizer on the 4-rank group of two hosts of
# two ranks, the three kinds of optimizer state (none, rowwise, full) at
# the other local sizes; the ranks run every optimizer at every one, and
# their two routings agree in every case
JAX_CASES = [(n, lc, optim) for n, lc in cases.CONFIGS
             for optim in cases.OPTIMS
             if (n, lc) == (4, 2)
             or optim in ("EXACT_SGD", "ROWWISE_ADAGRAD", "ADAM")]
JAX_IDS = [f"{cases.tag(n, lc)}-{o}" for n, lc, o in JAX_CASES]
KINDS = [("pooled", st) for st in cases.HIER] + [("sequence",
                                                  "TABLE_ROW_WISE")]


@pytest.mark.parametrize("st", cases.HIER)
@pytest.mark.parametrize("n,lc,optim", JAX_CASES, ids=JAX_IDS)
def test_pooled_hierarchical_strategy_matches_jax(ranks, n, lc, optim, st):
    _check_strategy(ranks[n], "pooled", st, optim, n, lc, pooled=True)


@pytest.mark.parametrize("n,lc,optim", JAX_CASES, ids=JAX_IDS)
def test_sequence_table_row_wise_matches_jax(ranks, n, lc, optim):
    _check_strategy(ranks[n], "sequence", "TABLE_ROW_WISE", optim, n, lc,
                    pooled=False)


@pytest.mark.parametrize("optim", cases.OPTIMS)
@pytest.mark.parametrize("kind,st", KINDS,
                         ids=[f"{k}-{s}" for k, s in KINDS])
@pytest.mark.parametrize("n,lc", cases.CONFIGS, ids=CONFIG_IDS)
def test_input_routings_agree_and_count_calls(ranks, n, lc, kind, st,
                                              optim):
    """"a2a" gives the "allgather" routing's dist, forward, updated state
    and unsharded tables and optimizer state bit for bit; every forward
    and update makes the calls counted in DIST_CALLS and TAIL_CALLS."""
    prefix = f"{cases.tag(n, lc)}/{kind}/{st}/{optim}"
    pooled = kind == "pooled"
    fwd_calls, upd_calls = TAIL_CALLS[kind, st]
    for out in ranks[n]:
        for routing in cases.ROUTINGS:
            dist_calls = DIST_CALLS[routing] if pooled else {
                k: v // 2 for k, v in DIST_CALLS[routing].items()}
            p = f"{prefix}/{routing}"
            assert _calls(out, p + "/fwd") == _add(dist_calls, fwd_calls)
            assert _calls(out, p + "/upd") == _add(dist_calls, upd_calls)
    _check_routings_agree(ranks[n], prefix)


@pytest.mark.parametrize("kind,st", cases.DIST_CASES,
                         ids=[f"{k}-{s}" for k, s in cases.DIST_CASES])
@pytest.mark.parametrize("n,lc", cases.CONFIGS, ids=CONFIG_IDS)
def test_from_dist_equals_the_in_step_path(ranks, n, lc, kind, st):
    for out in ranks[n]:
        assert bool(out[f"{cases.tag(n, lc)}/dist/{kind}/{st}/equal"])


@pytest.mark.parametrize("n,lc", cases.CONFIGS, ids=CONFIG_IDS)
def test_subgroups_follow_jax_groups(ranks, n, lc):
    """Each rank's intra- and cross-host groups hold JAX's
    axis_index_groups' ranks, and a collective over one orders its blocks
    as the list does (ascending), tiled and stacked alike."""
    jstrat = _jax_strategy("pooled", "TABLE_ROW_WISE", "EXACT_SGD", n, lc)
    for r, out in enumerate(ranks[n]):
        h, l = divmod(r, lc)
        for what, want in (("intra", jstrat.intra_groups[h]),
                           ("cross", jstrat.cross_groups[l])):
            p = f"{cases.tag(n, lc)}/groups/{what}"
            np.testing.assert_array_equal(out[p + "/ranks"], want)
            np.testing.assert_array_equal(out[p + "/gathered"], want)
            np.testing.assert_array_equal(out[p + "/stacked"],
                                          np.asarray(want)[:, None])


@pytest.mark.parametrize("st", cases.HIER)
@pytest.mark.parametrize("n,lc", cases.CONFIGS, ids=CONFIG_IDS)
def test_a_rank_loads_only_its_block(ranks, n, lc, st):
    """shard_from_dense and shard_opt_from_tables give each rank JAX's
    block bit for bit; no op of init_weights or of the loads makes a
    tensor of the global layout; init_weights draws one set of tables,
    the same on every rank and under both strategies."""
    prefix = f"{cases.tag(n, lc)}/load/{st}"
    tables, opt, *_ = cases.case_inputs("pooled", st, "ROWWISE_ADAGRAD", lc)
    jstrat = _jax_strategy("pooled", st, "ROWWISE_ADAGRAD", n, lc)
    jw = np.asarray(jstrat.shard_from_dense(tables))
    jm = np.asarray(jstrat.shard_opt_from_tables(
        opt, jstrat.init_opt()).momentum1)
    table = max(cases.ROWS) * cases.D
    ref = ranks[n][0]
    for r, out in enumerate(ranks[n]):
        np.testing.assert_array_equal(out[f"{prefix}/weights"], jw[r:r + 1])
        np.testing.assert_array_equal(out[f"{prefix}/momentum1"],
                                      jm[r:r + 1])
        largest = int(out[f"{prefix}/largest"])
        assert largest <= max(int(out[f"{prefix}/local"]), table), r
        if n > 1:
            assert largest < int(out[f"{prefix}/global"]), r
        for i, rows in enumerate(cases.ROWS):
            key = f"/init/t{i}"
            np.testing.assert_array_equal(
                out[prefix + key],
                ref[f"{cases.tag(n, lc)}/load/TABLE_ROW_WISE" + key])
            assert out[prefix + key].shape == (rows, cases.D)


def _jax_dmp_state(jdmp, init_path):
    init = dict(np.load(init_path))
    dense = {}
    for k, v in init.items():
        if k.startswith("dense/"):
            node = dense
            parts = k[len("dense/"):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = jnp.asarray(v)
    tables = {k[len("table/"):]: v for k, v in init.items()
              if k.startswith("table/")}
    emb = tuple(JState(weights=s.shard_from_dense(tables), opt=s.init_opt())
                for s in jdmp.sharded_ebcs[JAX_KEY].strategies)
    return JDMPState(dense_params=dense,
                     dense_opt=jdmp.dense_optimizer.init(dense),
                     emb_states={JAX_KEY: emb},
                     step=jnp.asarray(0, jnp.int32))


def _check_dmp(outs, prefix, jdmp, state, jlosses, module):
    for s, jloss in enumerate(jlosses):
        np.testing.assert_allclose(
            np.mean([float(o[f"{prefix}/loss{s}"]) for o in outs]), jloss,
            err_msg=f"{prefix} step {s}", **MODEL)
    jdense = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params), module)
    for name in jdense:
        for out in outs:  # equal steps keep the replicas equal
            np.testing.assert_array_equal(out[f"{prefix}/param/{name}"],
                                          outs[0][f"{prefix}/param/{name}"])
        np.testing.assert_allclose(outs[0][f"{prefix}/param/{name}"],
                                   jdense[name], err_msg=name, **MODEL)
    jtables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    for name in jtables:
        for out in outs:
            np.testing.assert_allclose(out[f"{prefix}/table/{name}"],
                                       np.asarray(jtables[name]),
                                       err_msg=name, **MODEL)


@pytest.mark.parametrize("n,lc", cases.CONFIGS, ids=CONFIG_IDS)
def test_prefetched_step_and_pipeline_match_jax(ranks, n, lc):
    """make_train_step, the prefetched step (a2a routing) and
    SparseDistPipeline (allgather) over 3 batches against JAX's prefetched
    step; each group with a dist makes one fewer all_gather of its ids a
    step (STEP_CALLS)."""
    outs, t = ranks[n], cases.tag(n, lc)
    jdmp = _jax_dlrm(n, lc, "ROWWISE_ADAGRAD", cases.DLRM_PLAN)
    state = _jax_dmp_state(jdmp, ranks["init"])
    reqs = [cases.dlrm_request(cases.case_seed("dmp", str(s)))
            for s in range(cases.STEPS)]
    jstep = jdmp.make_prefetched_train_step()
    dists = jax.jit(jdmp.input_dist)(_jax_request(reqs[0])[1])
    jlosses = []
    for i, req in enumerate(reqs):
        nxt = _jax_request(reqs[min(i + 1, cases.STEPS - 1)])[1]
        state, loss, _, dists = jstep(state, dists, nxt, *_jax_request(req))
        jlosses.append(float(loss))
    module = cases.build_port_dmp(ShardingEnv("cpu"), "EXACT_SGD").module
    for driver in ("train_step", "prefetched", "pipeline"):
        prefix = f"{t}/dmp/{driver}"
        _check_dmp(outs, prefix, jdmp, state, jlosses, module)
        for out in outs:
            for s in range(cases.STEPS):
                want = STEP_CALLS[driver]
                if driver == "pipeline" and s == 0:  # it primes batch 0's
                    want = _add(want, {"all_gather": 3})
                assert _calls(out, f"{prefix}/step{s}") == want


def test_from_distributed_reads_local_world_size(ranks):
    """The 2-rank group came up through ShardingEnv.from_distributed with
    LOCAL_WORLD_SIZE=2: local_size 2, one host; the 4-rank group's env
    over the group it was given has the whole world as its local size."""
    assert [int(o["local_size"]) for o in ranks[2]] == [2, 2]
    assert [int(o["local_size"]) for o in ranks[4]] == [4] * 4


def test_ranks_import_no_jax(ranks):
    for n in (4, 2):
        assert not any(bool(o["jax_imported"]) for o in ranks[n])


def test_fp_ebc_at_world_size_2_matches_jax(ranks):
    """The position-weighted DLRM at n = 2 (ROW_WISE, TABLE_WISE,
    TABLE_ROW_WISE and TABLE_COLUMN_WISE tables; batches whose halves
    differ): 3 EXACT_SGD steps, the losses, position weights, dense
    parameters and tables against JAX's. The processor's gradient takes
    the dense all_reduce's mean and no 1 / n."""
    outs = ranks[2]
    jdmp = _jax_fp_dmp()
    state = _fp_state(jdmp)
    pw0 = jax.tree.map(np.asarray, state.dense_params["dlrm"][
        "embedding_bag_collection"]["feature_processor"])
    jstep = jdmp.make_train_step()
    jlosses = []
    for s in range(cases.STEPS):
        req = cases.fp_request(cases.case_seed("fp", str(s)))
        half = cases.FP_B // 2
        assert not np.array_equal(req[0][:, :half], req[0][:, half:])
        state, loss, _ = jstep(state, *_jax_request(req))
        jlosses.append(float(loss))
    names = ShardingEnv("cpu")
    names.world_size = 2  # the plan's TABLE_WISE table is on rank 1
    module = cases.build_fp_dmp(names).module
    _check_dmp(outs, "fp", jdmp, state, jlosses, module)
    jpw = jax.tree.map(np.asarray, state.dense_params["dlrm"][
        "embedding_bag_collection"]["feature_processor"])
    for name, w in jpw.items():
        got = outs[0][f"fp/param/dlrm.sparse_arch.embedding_bag_collection."
                      f"feature_processor.{name}"]
        assert np.abs(w - pw0[name]).max() > 1e-6, name
        np.testing.assert_allclose(got - pw0[name], w - pw0[name],
                                   rtol=1e-4, atol=1e-8, err_msg=name)


@pytest.mark.parametrize("dtype", ["INT8"])
def test_quantized_module_at_world_size_4_matches_jax(ranks, dtype):
    """Explicit table ranks (rank 0 holds no table): each rank's packed
    bytes, scales and shifts equal JAX's device-r block, and every rank's
    pooled SUM values (one id a bag) equal JAX's bit for bit."""
    cfgs = tuple(_jcfgs(False, cases.DLRM_ROWS,
                        tuple(range(len(cases.DLRM_ROWS))), mean=False))
    jq = JShardedQuant.from_float(
        _jenv(4, 4), cfgs, cases.quant_tables(), JDataType[dtype],
        table_ranks=cases.QUANT_RANKS, is_weighted=True,
        max_feature_length=cases.QUANT_L)
    ids, lengths, w = cases.global_batch(
        cases.case_seed("quant", "batch"), True, cases.QUANT_L,
        cases.DLRM_ROWS)
    want = np.asarray(jq(JPSB(ids=jnp.asarray(ids),
                              lengths=jnp.asarray(lengths),
                              keys=tuple(f"f{i}" for i in range(4)),
                              weights=jnp.asarray(w))).values)
    for r, out in enumerate(ranks[4]):
        for part in ("data", "scale", "shift"):
            np.testing.assert_array_equal(out[f"quant/{dtype}/{part}"],
                                          np.asarray(getattr(jq, part))[r])
        np.testing.assert_array_equal(out[f"quant/{dtype}/values"], want)
    assert not ranks[4][0][f"quant/{dtype}/data"].any()


def _port_dmp1(optim, plan_types):
    """The port's DLRMTrain on one CPU device under `plan_types`."""
    tables = cases._configs(False, cases.DLRM_ROWS,
                            tuple(range(len(cases.DLRM_ROWS))))
    return DistributedModelParallel(
        DLRMTrain(DLRM(EmbeddingBagCollection(
            tables, max_feature_length=cases.L, device="meta"),
            cases.DENSE_IN, (16, cases.D), (8, 1), device="meta")),
        env=ShardingEnv("cpu"),
        plan=ShardingPlan({cases.PORT_KEY: {t.name: ParameterSharding(
            ShardingType[s]) for t, s in zip(tables, plan_types)}}),
        fused_optim=EmbOptimType[optim],
        fused_params={"learning_rate": cases.FUSED_LR},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=cases.DENSE_LR))


BRIDGE = [("TABLE_COLUMN_WISE", ("ROW_WISE",) * 4),
          ("TABLE_ROW_WISE", ("ROW_WISE",) * 4),
          ("TABLE_COLUMN_WISE", cases.DLRM_PLAN)]


@pytest.mark.parametrize("source,target", BRIDGE,
                         ids=["twcw-rw", "twrw-rw", "twcw-mixed"])
def test_hierarchical_state_loads_as_jax_loads_it(source, target):
    """A JAX DMP trained 3 steps on 4 devices of 2 hosts under `source`
    with ROWWISE_ADAGRAD loads into the port's one-device DMP under
    `target` (TWCW's "m1__cwrow" [2, R] state by JAX's mean over column
    shards); the next step matches JAX's on the same load."""
    optim = "ROWWISE_ADAGRAD"
    jdmp4 = _jax_dlrm(4, 2, optim, (source,) * 4)
    state = jdmp4.init(jax.random.PRNGKey(0), *_jax_request(
        cases.dlrm_request(cases.case_seed("cw", "init"))))
    step4 = jdmp4.make_train_step()
    for s in range(cases.STEPS):
        state, _, _ = step4(state, *_jax_request(
            cases.dlrm_request(cases.case_seed("cw", str(s)))))
    jsebc4 = jdmp4.sharded_ebcs[JAX_KEY]
    tables = {k: np.asarray(v) for k, v in jsebc4.unshard_to_dense(
        state.emb_states[JAX_KEY]).items()}
    opt = {}
    for jstrat, g in zip(jsebc4.strategies, state.emb_states[JAX_KEY]):
        opt.update(jstrat.unshard_opt_to_tables(g.opt))
    row = "m1__cwrow" if source == "TABLE_COLUMN_WISE" else "m1__row"
    for name in tables:
        rows = cases.DLRM_ROWS[int(name[1:])]
        assert set(opt[name]) == {row, "step"}
        assert opt[name][row].shape == ((2, rows) if row == "m1__cwrow"
                                        else (rows,))
    dense = jax.tree.map(np.asarray, state.dense_params)

    jdmp1 = _jax_dlrm(1, 1, optim, target)
    state1 = jdmp1.init(jax.random.PRNGKey(0), *_jax_request(
        cases.dlrm_request(cases.case_seed("cw", "init"))))
    jsebc1 = jdmp1.sharded_ebcs[JAX_KEY]
    groups = tuple(
        JState(weights=jstrat.shard_from_dense(tables),
               opt=jstrat.shard_opt_from_tables(opt, g.opt))
        for jstrat, g in zip(jsebc1.strategies, state1.emb_states[JAX_KEY]))
    state1 = state1.replace(
        dense_params=jax.tree.map(jnp.asarray, dense),
        emb_states={**state1.emb_states, JAX_KEY: groups})
    dmp = _port_dmp1(optim, target)
    load_jax_weights(dmp, dense, tables, opt_state=opt)
    for name in tables:
        np.testing.assert_array_equal(
            np.reshape(fused_optimizer_state(dmp)[name]["m1__row"], -1),
            opt[name][row].mean(axis=0) if row == "m1__cwrow"
            else opt[name][row])
    req = cases.dlrm_request(cases.case_seed("cw", "next"))
    state1, jloss, _ = jdmp1.make_train_step()(state1, *_jax_request(req))
    ids, lengths, dense_x, labels = req
    values, lens = cases.jagged(ids, lengths)
    loss, _ = dmp.make_train_step()(
        torch.as_tensor(dense_x), KeyedJaggedTensor.from_lengths(
            [f"f{i}" for i in range(4)], values, lens),
        torch.as_tensor(labels))
    np.testing.assert_allclose(float(loss), float(jloss), **MODEL)
    jtables = jsebc1.unshard_to_dense(state1.emb_states[JAX_KEY])
    got = dmp.sharded_ebcs[cases.PORT_KEY].unshard_to_dense()
    jopt = {}
    for jstrat, g in zip(jsebc1.strategies, state1.emb_states[JAX_KEY]):
        jopt.update(jstrat.unshard_opt_to_tables(g.opt))
    opt_after = fused_optimizer_state(dmp)
    for name in tables:
        np.testing.assert_allclose(got[name], np.asarray(jtables[name]),
                                   err_msg=name, **MODEL)
        assert opt_after[name].keys() == jopt[name].keys()
        for key in jopt[name]:
            np.testing.assert_allclose(opt_after[name][key],
                                       np.asarray(jopt[name][key]),
                                       rtol=1e-4, atol=1e-9, err_msg=name)
