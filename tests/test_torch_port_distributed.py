"""The port's flat strategies and DMP at world size 1, 2 and 4 under gloo,
against the JAX package on `jax.devices()[:n]`, on the CPU.

A module-scoped fixture starts the ranks once per world size (1, 2 and 4,
all seven processes at once; a group of one rank makes every collective a
real call), each running tests/torch_port_gloo_cases.py on its
slice of seeded global batches and writing its outputs to tmp_path; the
ranks import no JAX. The parametrised tests then run the same cases in JAX
on the n-device CPU mesh and compare rank r's outputs with JAX's block r.

Tolerances: gathers and row writes bit for bit (the sequence forwards, the
shard buffers before an update, every rank's unsharded tables against the
others'); pooled sums rtol 1e-6 / atol 1e-7 (their terms added in another
order); one fused update at the tolerances of
test_torch_port_strategies.py (rtol 1e-5 / atol 1e-6, 1e-4 for ADAM); the
DMP's logits, losses (the mean of the ranks' local losses against JAX's
global one), dense parameters, tables and optimizer state after 3 steps
rtol 1e-4 / atol 1e-5, as test_torch_port_train.py holds one device. The
dense parameters of the ranks equal each other bit for bit. bf16 tables
with stochastic rounding: each rank's rows equal, bit for bit, the
strategy's own update on the global batch with that rank's bits (keyed by
rank * rows_loc + local row), differ from the bits of the old local-row
key on ranks > 0, and lie within one bf16 ulp of JAX's (whose bits are its
own). Every collective call per forward and update is counted. Loading
tables and optimizer state gives each rank JAX's block bit for bit, and no
op of the load or of `init_weights` makes a tensor of the global layout
(a dispatch mode in the rank records the largest); `init_weights` draws
the same tables under every plan and world size.

A second part needs no process group: a JAX DMP trained 3 steps on a
4-device mesh under a COLUMN_WISE plan saves its rowwise Adagrad state as
"m1__cwrow" [4, R]; it loads into the port's one-device ROW_WISE DMP by
JAX's mean over column shards, and the next step matches JAX's on the
same load.
"""

import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_gloo_cases as cases
from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
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
from torchrec_tpu.parallel.embedding_sharding import (
    group_tables as j_group_tables,
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
from torchrec_tpu_torch.modules.embedding_configs import DataType
from torchrec_tpu_torch.parallel import ShardingEnv
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils.jax_bridge import (
    flax_dense_to_state_dict,
    fused_optimizer_state,
    load_jax_weights,
)

WORLDS = (1, 2, 4)
SPAWN_TIMEOUT_S = 300
JAX_KEY = "dlrm/embedding_bag_collection"
TOL = {"EXACT_SGD": (1e-5, 1e-6), "ROWWISE_ADAGRAD": (1e-5, 1e-6),
       "ADAM": (1e-4, 1e-6)}
ROOT = pathlib.Path(__file__).resolve().parent.parent

# collective calls per forward and per update: {all_gather, reduce_scatter,
# all_to_all}; the ids and lengths travel in one all_gather, the
# per-sample weights (ROW_WISE and TABLE_WISE here) in another
CALLS = {
    ("pooled", "DATA_PARALLEL"): ({}, {"all_gather": 2}),
    ("pooled", "ROW_WISE"): ({"all_gather": 2, "reduce_scatter": 1},
                             {"all_gather": 3}),
    ("pooled", "TABLE_WISE"): ({"all_gather": 2, "all_to_all": 1},
                               {"all_gather": 2, "all_to_all": 1}),
    ("pooled", "COLUMN_WISE"): ({"all_gather": 1, "all_to_all": 1},
                                {"all_gather": 1, "all_to_all": 1}),
    ("sequence", "DATA_PARALLEL"): ({}, {"all_gather": 2}),
    ("sequence", "ROW_WISE"): ({"all_gather": 1, "reduce_scatter": 1},
                               {"all_gather": 2}),
    ("sequence", "TABLE_WISE"): ({"all_gather": 1, "all_to_all": 1},
                                 {"all_gather": 1, "all_to_all": 1}),
}
# the mixed-plan DMP (no per-sample weights): per request and per step
DMP_CALLS = ({"all_gather": 3, "reduce_scatter": 1, "all_to_all": 2},
             {"all_gather": 9, "reduce_scatter": 1, "all_to_all": 4,
              "all_reduce_mean": 1})


def _calls(out, prefix):
    return {k[len(prefix) + 7:]: int(v) for k, v in out.items()
            if k.startswith(prefix + "/calls/") and int(v)}


def _jax_dlrm(n, optim, plan_types=cases.MIXED):
    tables = tuple(JBagConfig(
        num_embeddings=r, embedding_dim=cases.D, name=f"t{i}",
        feature_names=[f"f{i}"],
        pooling=JPooling.MEAN if i == 1 else JPooling.SUM)
        for i, r in enumerate(cases.DLRM_ROWS))
    plan = JPlan({JAX_KEY: {t.name: JPS(
        JST[s],
        ranks=[cases.dmp_tw_rank(n)] if s == "TABLE_WISE" else None)
        for t, s in zip(tables, plan_types)}})
    return JDMP(
        JDLRMTrain(dlrm=JDLRM(
            embedding_bag_collection=JEBC(tables=tables,
                                          max_feature_length=cases.L),
            dense_in_features=cases.DENSE_IN, dense_arch_layer_sizes=(16,
                                                                    cases.D),
            over_arch_layer_sizes=(8, 1))),
        env=JEnv.from_devices(jax.devices()[:n]), plan=plan,
        fused_optim=JOptim[optim],
        fused_params={"learning_rate": cases.FUSED_LR},
        dense_optimizer=optax.sgd(cases.DENSE_LR))


def _jax_request(seed):
    ids, lengths, dense, labels = cases.dlrm_request(seed)
    values, lens = cases.jagged(ids, lengths)
    sb = JKJT.from_lengths([f"f{i}" for i in range(len(cases.DLRM_ROWS))],
                           jnp.asarray(values),
                           jnp.asarray(lens)).to_padded(cases.L)
    return sb, jnp.asarray(dense), jnp.asarray(labels)


def _jax_init(jdmp):
    sb, dense, labels = _jax_request(cases.case_seed("dmp", "eval"))
    return jdmp.init(jax.random.PRNGKey(0), dense, sb, labels)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _write_init(path, n):
    jdmp = _jax_dlrm(n, "EXACT_SGD")
    state = _jax_init(jdmp)
    tables = jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
        state.emb_states[JAX_KEY])
    np.savez(path / "dlrm_init.npz",
             **{f"dense/{k}": v for k, v in _flat(
                 jax.tree.map(np.asarray, state.dense_params)).items()},
             **{f"table/{k}": np.asarray(v) for k, v in tables.items()})


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """{n: [rank 0's outputs, ..., rank n-1's]}: every case run once per
    world size by n processes over gloo."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    procs, dirs = [], {}
    for n in WORLDS:
        d = tmp_path_factory.mktemp(f"gloo{n}")
        _write_init(d, n)
        dirs[n] = d
        procs += [subprocess.Popen(
            [sys.executable, cases.__file__, str(r), str(n), str(d),
             str(d / "rendezvous")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True) for r in range(n)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=SPAWN_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate(timeout=30)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-4000:]
    return {n: [dict(np.load(dirs[n] / f"rank{r}.npz")) for r in range(n)]
            for n in WORLDS}


def _jax_strategy(kind, st, optim, n, dtype=None):
    seq = kind == "sequence"
    Cfg = JSeqConfig if seq else JBagConfig
    cfgs = [Cfg(num_embeddings=r, embedding_dim=cases.D, name=f"t{i}",
                feature_names=[f"f{i}"],
                data_type=dtype or JDataType.FP32,
                **({} if seq else {"pooling": JPooling.MEAN if i == 1
                                   else JPooling.SUM}))
            for i, r in enumerate(cases.ROWS)]
    plan = {c.name: JPS(JST[st], ranks=[cases.tw_rank(i, n)]
                        if st == "TABLE_WISE" else None)
            for i, c in enumerate(cfgs)}
    (meta,) = j_group_tables(cfgs, j_names_by_table(cfgs), plan,
                             not seq and cases.weighted(st))
    create = j_create_seq if seq else j_create
    return create(JEnv.from_devices(jax.devices()[:n]), meta, JOptim[optim],
                  {})


def _jax_case(kind, st, optim, n, dtype=None):
    """JAX's forward, and its state after one update, of the case."""
    seq = kind == "sequence"
    seed = cases.case_seed(kind, st, optim)
    jstrat = _jax_strategy(kind, st, optim, n, dtype)
    state = JState(
        weights=jstrat.shard_from_dense(cases.dense_tables(seed)),
        opt=jstrat.shard_opt_from_tables(cases.opt_tables(optim, seed + 1),
                                         jstrat.init_opt()))
    ids, lengths, w = cases.global_batch(
        seed + 2, not seq and cases.weighted(st),
        cases.SEQ_L if seq else cases.L)
    sb = JPSB(ids=jnp.asarray(ids), lengths=jnp.asarray(lengths),
              keys=tuple(f"f{i}" for i in range(len(cases.ROWS))),
              weights=None if w is None else jnp.asarray(w))
    fwd = np.asarray(jax.jit(jstrat.forward)(state, sb))
    d = cases.cotangent(seed + 3, (len(cases.ROWS), cases.B, cases.SEQ_L,
                                   cases.D) if seq
                        else (len(cases.ROWS), cases.B, cases.D))
    state = jax.jit(jstrat.update)(state, sb, jnp.asarray(d),
                                   cases.FUSED_LR)
    return jstrat, fwd, state


def _block(x, r, n, sharded):
    x = np.asarray(x)
    return x[r:r + 1] if sharded else x


def _check_state(outs, prefix, jstrat, state, n, rtol, atol):
    sharded = np.asarray(state.weights).ndim == 3
    for r, out in enumerate(outs):
        np.testing.assert_allclose(
            out[f"{prefix}/weights"],
            _block(state.weights, r, n, sharded).astype(np.float32),
            rtol=rtol, atol=atol, err_msg=f"rank {r}")
        for name in ("momentum1", "momentum2"):
            jm = getattr(state.opt, name)
            assert (jm is None) == (f"{prefix}/{name}" not in out)
            if jm is not None:
                np.testing.assert_allclose(
                    out[f"{prefix}/{name}"], _block(jm, r, n, sharded),
                    rtol=rtol, atol=atol, err_msg=f"rank {r} {name}")
        assert int(out[f"{prefix}/step"]) == int(state.opt.step)
    jtables = jstrat.unshard_to_dense(state.weights)
    jopt = jstrat.unshard_opt_to_tables(state.opt)
    for name in jtables:
        for out in outs:  # an all_gather: the ranks agree bit for bit
            np.testing.assert_array_equal(out[f"{prefix}/table/{name}"],
                                          outs[0][f"{prefix}/table/{name}"])
        np.testing.assert_allclose(
            outs[0][f"{prefix}/table/{name}"],
            np.asarray(jtables[name]).astype(np.float32), rtol=rtol,
            atol=atol, err_msg=name)
        for tag, v in jopt[name].items():
            np.testing.assert_allclose(outs[0][f"{prefix}/opt/{name}/{tag}"],
                                       np.asarray(v), rtol=rtol, atol=atol,
                                       err_msg=f"{name} {tag}")
        assert {k.split("/")[-1] for k in outs[0]
                if k.startswith(f"{prefix}/opt/{name}/")} == set(jopt[name])


@pytest.mark.parametrize("optim", cases.POOLED_OPTIMS)
@pytest.mark.parametrize("st", cases.POOLED)
@pytest.mark.parametrize("n", WORLDS)
def test_pooled_strategy_at_world_size_n_matches_jax(ranks, n, st, optim):
    outs = ranks[n]
    prefix = f"pooled/{st}/{optim}"
    jstrat, fwd, state = _jax_case("pooled", st, optim, n)
    B_loc = cases.B // n
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{prefix}/forward"],
                                   fwd[:, r * B_loc:(r + 1) * B_loc],
                                   rtol=1e-6, atol=1e-7, err_msg=f"rank {r}")
        assert _calls(out, prefix + "/fwd") == CALLS["pooled", st][0]
        assert _calls(out, prefix + "/upd") == CALLS["pooled", st][1]
    if st == "TABLE_WISE" and n == 4:  # tables on ranks 1..3 only
        assert not outs[0][f"{prefix}/weights"].any()
    _check_state(outs, prefix, jstrat, state, n, *TOL[optim])


@pytest.mark.parametrize("optim", cases.SEQUENCE_OPTIMS)
@pytest.mark.parametrize("st", cases.SEQUENCE)
@pytest.mark.parametrize("n", WORLDS)
def test_sequence_strategy_at_world_size_n_matches_jax(ranks, n, st, optim):
    outs = ranks[n]
    prefix = f"sequence/{st}/{optim}"
    jstrat, fwd, state = _jax_case("sequence", st, optim, n)
    B_loc = cases.B // n
    for r, out in enumerate(outs):
        # a gather: bit for bit, as values (+0.0 here where JAX has -0.0)
        np.testing.assert_array_equal(out[f"{prefix}/forward"],
                                      fwd[:, r * B_loc:(r + 1) * B_loc])
        assert _calls(out, prefix + "/fwd") == CALLS["sequence", st][0]
        assert _calls(out, prefix + "/upd") == CALLS["sequence", st][1]
    _check_state(outs, prefix, jstrat, state, n, *TOL[optim])


@pytest.mark.parametrize("optim", cases.LOAD_OPTIMS)
@pytest.mark.parametrize("st", cases.POOLED)
@pytest.mark.parametrize("n", WORLDS)
def test_a_rank_loads_only_its_block(ranks, n, st, optim):
    """shard_from_dense and shard_opt_from_tables give each rank JAX's
    block r bit for bit, and no op of init_weights or of the loads makes
    a tensor larger than the rank's block or one table: never the global
    layout of n blocks."""
    prefix = f"load/{st}/{optim}"
    seed = cases.case_seed("load", st, optim)
    jstrat = _jax_strategy("pooled", st, optim, n)
    jw = np.asarray(jstrat.shard_from_dense(cases.dense_tables(seed)))
    jopt = jstrat.shard_opt_from_tables(cases.opt_tables(optim, seed + 1),
                                        jstrat.init_opt())
    sharded = jw.ndim == 3
    table = max(cases.ROWS) * cases.D
    for r, out in enumerate(ranks[n]):
        np.testing.assert_array_equal(out[f"{prefix}/weights"],
                                      _block(jw, r, n, sharded))
        for name in ("momentum1", "momentum2"):
            jm = getattr(jopt, name)
            assert (jm is None) == (f"{prefix}/{name}" not in out)
            if jm is not None:
                np.testing.assert_array_equal(out[f"{prefix}/{name}"],
                                              _block(jm, r, n, sharded))
        largest = int(out[f"{prefix}/largest"])
        assert largest <= max(int(out[f"{prefix}/local"]), table), r
        if sharded and n > 1:
            assert largest < int(out[f"{prefix}/global"]), r


@pytest.mark.parametrize("st", cases.POOLED)
@pytest.mark.parametrize("n", WORLDS)
def test_init_draws_one_set_of_tables_under_every_plan(ranks, n, st):
    """init_weights from one seed gives the same tables, bit for bit, on
    every rank, under every strategy and at every world size, each within
    U(-b, b), b = sqrt(1 / rows)."""
    ref = ranks[1][0]
    for out in ranks[n]:
        for optim in cases.LOAD_OPTIMS:
            for i, rows in enumerate(cases.ROWS):
                key = f"init/t{i}"
                got = out[f"load/{st}/{optim}/{key}"]
                np.testing.assert_array_equal(
                    got, ref[f"load/DATA_PARALLEL/ROWWISE_ADAGRAD/{key}"])
                assert got.shape == (rows, cases.D)
                assert 0 < np.abs(got).max() <= (1.0 / rows) ** 0.5


@pytest.mark.parametrize("optim", cases.DMP_OPTIMS)
@pytest.mark.parametrize("n", WORLDS)
def test_mixed_plan_dmp_at_world_size_n_matches_jax(ranks, n, optim):
    outs = ranks[n]
    prefix = f"dmp/{optim}"
    jdmp = _jax_dlrm(n, optim)
    state = _jax_init(jdmp)
    B_loc = cases.B // n
    sb, dense, labels = _jax_request(cases.case_seed("dmp", "eval"))
    _, (_, jlogits, _) = jdmp.make_eval_fn()(state, dense, sb, labels)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(
            out[f"{prefix}/eval_logits"],
            np.asarray(jlogits)[r * B_loc:(r + 1) * B_loc], rtol=1e-4,
            atol=1e-5)
        assert _calls(out, prefix + "/eval") == DMP_CALLS[0]
    jstep = jdmp.make_train_step()
    for s in range(cases.STEPS):
        ids, lengths, _, _ = cases.dlrm_request(cases.case_seed("dmp",
                                                                str(s)))
        half = cases.B // 2
        assert not np.array_equal(ids[:, :half], ids[:, half:])
        state, jloss, _ = jstep(state, *_reorder(
            _jax_request(cases.case_seed("dmp", str(s)))))
        losses = [float(out[f"{prefix}/loss{s}"]) for out in outs]
        np.testing.assert_allclose(np.mean(losses), float(jloss),
                                   rtol=1e-4, atol=1e-5)
        for out in outs:
            assert _calls(out, f"{prefix}/step{s}") == DMP_CALLS[1]
    module = cases.build_port_dmp(ShardingEnv("cpu"), optim,
                                  ("ROW_WISE",) * 4).module
    jdense = flax_dense_to_state_dict(
        jax.tree.map(np.asarray, state.dense_params), module)
    for name in jdense:
        for out in outs:  # equal steps keep the replicas equal
            np.testing.assert_array_equal(out[f"{prefix}/param/{name}"],
                                          outs[0][f"{prefix}/param/{name}"])
        np.testing.assert_allclose(outs[0][f"{prefix}/param/{name}"],
                                   jdense[name], rtol=1e-4, atol=1e-5,
                                   err_msg=name)
    jsebc = jdmp.sharded_ebcs[JAX_KEY]
    jtables = jsebc.unshard_to_dense(state.emb_states[JAX_KEY])
    jopt = {}
    for jstrat, g in zip(jsebc.strategies, state.emb_states[JAX_KEY]):
        jopt.update(jstrat.unshard_opt_to_tables(g.opt))
    for name in jtables:
        for out in outs:
            np.testing.assert_allclose(out[f"{prefix}/table/{name}"],
                                       np.asarray(jtables[name]), rtol=1e-4,
                                       atol=1e-5, err_msg=name)
        for tag, v in jopt[name].items():
            np.testing.assert_allclose(outs[0][f"{prefix}/opt/{name}/{tag}"],
                                       np.asarray(v), rtol=1e-4, atol=1e-5,
                                       err_msg=f"{name} {tag}")


def _reorder(req):
    sb, dense, labels = req
    return dense, sb, labels


def _local_env(n, r):
    """A CPU env that reports rank r of n and has no group: the
    strategy's own update body run here on the global batch."""
    env = ShardingEnv("cpu")
    env.world_size, env.rank = n, r
    return env


@pytest.mark.parametrize("optim", ["EXACT_SGD", "ROWWISE_ADAGRAD"])
@pytest.mark.parametrize("n", WORLDS)
def test_bf16_rows_round_with_the_ranks_own_bits(ranks, n, optim):
    outs = ranks[n]
    prefix = f"bf16/ROW_WISE/{optim}"
    seed = cases.case_seed("bf16", "ROW_WISE", optim)
    ids, lengths, w = cases.global_batch(seed + 2, True)
    d = cases.cotangent(seed + 3, (len(cases.ROWS), cases.B, cases.D))
    jstrat, fwd, state = _jax_case("bf16", "ROW_WISE", optim, n,
                                   JDataType.BF16)
    B_loc = cases.B // n
    jw = np.asarray(state.weights).astype(np.float32)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out[f"{prefix}/forward"],
                                   fwd[:, r * B_loc:(r + 1) * B_loc],
                                   rtol=1e-5, atol=1e-6)
        got = out[f"{prefix}/weights"]
        mine = {}
        for key in ("new", "old"):
            strat = cases._strategy(_local_env(n, r), "ROW_WISE", optim,
                                    False, DataType.BF16)
            strat.weights = strat.shard_from_dense(cases.dense_tables(seed))
            strat.shard_opt_from_tables(cases.opt_tables(optim, seed + 1))
            if key == "old":
                strat.sr_row_base = lambda: 0
            with torch.no_grad():
                strat._upd_gathered(torch.as_tensor(ids),
                                    torch.as_tensor(lengths),
                                    torch.as_tensor(w), torch.as_tensor(d),
                                    cases.FUSED_LR, cases.L)
            mine[key] = strat.weights.float().numpy()
        np.testing.assert_array_equal(got, mine["new"])
        if r > 0:
            assert not np.array_equal(got, mine["old"])
        # JAX rounds with bits of its own: the same two neighbours
        np.testing.assert_allclose(got, jw[r:r + 1], rtol=2**-7, atol=1e-6)


def test_from_distributed_starts_a_gloo_group_from_env(tmp_path):
    """`ShardingEnv.from_distributed(device="cpu")` reads torch's env://
    variables and starts a gloo group of its own (a localhost rendezvous
    in a process of its own)."""
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    code = ("import torch.distributed as dist\n"
            "from torchrec_tpu_torch.parallel import ShardingEnv\n"
            "env = ShardingEnv.from_distributed(device='cpu')\n"
            "print(env.rank, env.world_size, env.num_hosts, env.device,\n"
            "      dist.get_backend())\n"
            "dist.destroy_process_group()\n")
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="localhost", MASTER_PORT=str(port),
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True,
                         timeout=SPAWN_TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.split() == ["0", "1", "1", "cpu", "gloo"]


def test_cwrow_state_of_a_four_device_run_loads_as_jax_loads_it():
    optim = "ROWWISE_ADAGRAD"
    all_cw = ("COLUMN_WISE",) * len(cases.DLRM_ROWS)
    jdmp4 = _jax_dlrm(4, optim, all_cw)
    state = _jax_init(jdmp4)
    step4 = jdmp4.make_train_step()
    for s in range(cases.STEPS):
        state, _, _ = step4(state, *_reorder(
            _jax_request(cases.case_seed("cw", str(s)))))
    jsebc4 = jdmp4.sharded_ebcs[JAX_KEY]
    tables = {k: np.asarray(v) for k, v in jsebc4.unshard_to_dense(
        state.emb_states[JAX_KEY]).items()}
    opt = {}
    for jstrat, g in zip(jsebc4.strategies, state.emb_states[JAX_KEY]):
        opt.update(jstrat.unshard_opt_to_tables(g.opt))
    for name, r in zip(tables, cases.DLRM_ROWS):
        assert set(opt[name]) == {"m1__cwrow", "step"}
        assert opt[name]["m1__cwrow"].shape == (4, r)
    dense = jax.tree.map(np.asarray, state.dense_params)

    # JAX: a one-device ROW_WISE DMP loaded from the same state
    all_rw = ("ROW_WISE",) * len(cases.DLRM_ROWS)
    jdmp1 = _jax_dlrm(1, optim, all_rw)
    state1 = _jax_init(jdmp1)
    jsebc1 = jdmp1.sharded_ebcs[JAX_KEY]
    groups = tuple(
        JState(weights=jstrat.shard_from_dense(tables),
               opt=jstrat.shard_opt_from_tables(opt, g.opt))
        for jstrat, g in zip(jsebc1.strategies, state1.emb_states[JAX_KEY]))
    state1 = state1.replace(
        dense_params=jax.tree.map(jnp.asarray, dense),
        emb_states={**state1.emb_states, JAX_KEY: groups})
    # the port: its one-device ROW_WISE DMP through the bridge
    dmp = cases.build_port_dmp(ShardingEnv("cpu"), optim, all_rw)
    load_jax_weights(dmp, dense, tables, opt_state=opt)
    loaded = fused_optimizer_state(dmp)
    for name in tables:
        np.testing.assert_array_equal(loaded[name]["m1__row"],
                                      opt[name]["m1__cwrow"].mean(axis=0))

    ids, lengths, dense_x, labels = cases.dlrm_request(
        cases.case_seed("cw", "next"))
    state1, jloss, _ = jdmp1.make_train_step()(state1, *_reorder(
        _jax_request(cases.case_seed("cw", "next"))))
    values, lens = cases.jagged(ids, lengths)
    loss, _ = dmp.make_train_step()(
        torch.as_tensor(dense_x), KeyedJaggedTensor.from_lengths(
            [f"f{i}" for i in range(len(cases.DLRM_ROWS))], values, lens),
        torch.as_tensor(labels))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4,
                               atol=1e-5)
    jtables = jsebc1.unshard_to_dense(state1.emb_states[JAX_KEY])
    got = dmp.sharded_ebcs[cases.PORT_KEY].unshard_to_dense()
    jopt = {}
    for jstrat, g in zip(jsebc1.strategies, state1.emb_states[JAX_KEY]):
        jopt.update(jstrat.unshard_opt_to_tables(g.opt))
    opt_after = fused_optimizer_state(dmp)
    for name in tables:
        np.testing.assert_allclose(got[name], np.asarray(jtables[name]),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(opt_after[name]["m1__row"],
                                   np.asarray(jopt[name]["m1__row"]),
                                   rtol=1e-4, atol=1e-9, err_msg=name)

