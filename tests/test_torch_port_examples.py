"""The port's examples on the CPU: tests/test_examples.py's smoke runs
through the port's `main(argv)` with `--device cpu`, the example DLRM
held to the JAX example's on one loader batch, and `--multihost` on two
gloo ranks.

The runs cover every dlrm_main data path (card-made synthetic and
synthetic Criteo streams, the in-memory Criteo npys under both
pipelines, shuffled, memory-mapped and undersampled), the lr change
point, `--save_dir`, `--package_dir` into dlrm_predict (direct, through
the batching server and the native TCP server), and bert4rec_main on
synthetic and MovieLens sequences, sharded and data-parallel.
"""

import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import optax
import pytest
import torch

from torchrec_tpu.datasets.criteo import (
    InMemoryBinaryCriteoIterDataPipe as JLoader,
)
from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.planner import EmbeddingShardingPlanner as JPlanner
from torchrec_tpu.planner import Topology as JTopology
from torchrec_tpu_torch.examples import bert4rec_main, dlrm_main, dlrm_predict
from torchrec_tpu_torch.utils.checkpoint import load_reshardable
from torchrec_tpu_torch.utils.jax_bridge import load_jax_weights

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--embedding_dim", "16", "--dense_arch_layer_sizes", "16,16",
         "--over_arch_layer_sizes", "16,1", "--device", "cpu"]
ROWS = 500
JAX_KEY = "dlrm/embedding_bag_collection"


def _npy_days(directory, days=2, n=640, seed=0):
    """Criteo npy triples whose labels follow feature 0's id parity, so
    that a few steps learn something."""
    rng = np.random.RandomState(seed)
    for d in range(days):
        sparse = rng.randint(0, 100_000, (n, 26)).astype(np.int32)
        labels = ((sparse[:, :1] % ROWS) % 2).astype(np.int32)
        np.save(directory / f"day_{d}_dense.npy",
                rng.randn(n, 13).astype(np.float32))
        np.save(directory / f"day_{d}_sparse.npy", sparse)
        np.save(directory / f"day_{d}_labels.npy", labels)
    return directory


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The examples' models here are tiny: one intra-op thread runs them
    about ten times faster than torch's default pool, the more so beside
    the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def days(tmp_path_factory):
    return _npy_days(tmp_path_factory.mktemp("criteo"))


@pytest.fixture(scope="module")
def npy_runs(days):
    """dlrm_main over the npy days under each pipeline."""
    return {pipeline: dlrm_main.main([
        "--in_memory_binary_criteo_path", str(days), "--batch_size", "64",
        "--num_embeddings", str(ROWS), "--train_pipeline", pipeline,
        "--learning_rate", "0.5", *SMALL])
        for pipeline in ("base", "sparse_dist")}


@pytest.mark.parametrize("source", ["synthetic", "synthetic_criteo"])
def test_dlrm_main_card_made_streams(source):
    r = dlrm_main.main([f"--{source}", "--batch_size", "64",
                        "--num_batches", "5", "--num_embeddings", "100",
                        "--max_ind_range", "500", *SMALL])
    assert np.isfinite(r["auroc"]) and r["throughput"] > 0
    assert 0.0 <= r["accuracy"] <= 1.0 and np.isfinite(r["loss"])
    assert r["steps"] == 6  # the warm-up and 5 timed
    assert r["groups"] == 1
    assert r["eval_batches"] == (5 if source == "synthetic" else 4)


@pytest.mark.parametrize("case", ["base", "sparse_dist",
                                  "shuffled_mmap_undersampled"])
def test_dlrm_main_criteo_npys(days, npy_runs, case):
    if case in npy_runs:
        r = npy_runs[case]
        assert r["steps"] == r["eval_batches"] == 20
        # the labels are a function of feature 0's id: it learns
        assert r["auroc"] > 0.6, r
    else:
        r = dlrm_main.main([
            "--in_memory_binary_criteo_path", str(days), "--batch_size",
            "64", "--num_embeddings", str(ROWS), "--learning_rate", "0.5",
            "--shuffle_batches", "--mmap_mode", "--undersampled_rate", "0.5",
            "--validation_freq_within_epoch", "4", *SMALL])
        assert 5 <= r["steps"] < 20
        assert r["eval_batches"] == 20 + 20 * (r["steps"] // 4)
    assert 0.0 <= r["auroc"] <= 1.0 and r["throughput"] > 0


def test_dlrm_main_pipelines_agree(npy_runs):
    """Both pipelines take the same steps: the same validation."""
    base, dist = npy_runs["base"], npy_runs["sparse_dist"]
    assert base["auroc"] == pytest.approx(dist["auroc"], rel=1e-6)
    assert base["loss"] == pytest.approx(dist["loss"], rel=1e-5)


def test_dlrm_main_lr_change_point():
    """The step function lr: the DMP's fused lr is --learning_rate before
    the change point and --lr_after_change_point from it on; a run with a
    change point trains."""
    args = dlrm_main.parse_args(["--synthetic", "--num_embeddings", "100",
                                 "--batch_size", "32", "--lr_change_point",
                                 "3", "--lr_after_change_point", "0.0",
                                 *SMALL])
    env = dlrm_main.make_env(args)
    dmp = dlrm_main.build_dmp(args, env, dlrm_main.table_rows(args))
    assert [dmp._fused_lr() for dmp.step in range(5)] == [1.0] * 3 + [0.0] * 2
    r = dlrm_main.main(["--synthetic", "--num_embeddings", "100",
                        "--batch_size", "32", "--num_batches", "3",
                        "--lr_change_point", "2", "--lr_after_change_point",
                        "0.01", *SMALL])
    assert np.isfinite(r["loss"])


def test_dlrm_main_save_package_and_predict(tmp_path):
    """--save_dir writes the reshardable checkpoint, which loads back;
    --package_dir the int8 package that dlrm_predict serves directly,
    through the batching server and through the native TCP server, the
    direct logits equal to the package's PredictModule's."""
    ckpt, pkg = str(tmp_path / "ckpt"), str(tmp_path / "pkg")
    train = ["--synthetic_criteo", "--batch_size", "64", "--num_batches",
             "4", "--max_ind_range", "300", *SMALL]
    dlrm_main.main([*train, "--save_dir", ckpt, "--package_dir", pkg])
    with np.load(ckpt + ".npz") as z:
        assert int(z["step"]) == 5
        assert z[f"tables/dlrm/sparse_arch/embedding_bag_collection/"
                 f"t_cat_2"].shape == (300, 16)
    args = dlrm_main.parse_args(train)
    dmp = dlrm_main.build_dmp(args, dlrm_main.make_env(args),
                              dlrm_main.table_rows(args))
    load_reshardable(ckpt + ".npz", dmp)
    assert dmp.step == 5
    assert sorted(os.listdir(pkg)) == ["arrays.npz", "manifest.json"]
    serve = ["--package_dir", pkg, "--batch_size", "32", *SMALL]
    direct = dlrm_predict.main([*serve, "--num_requests", "3"])
    assert direct["qps"] > 0 and direct["predictions_per_sec"] > 0
    dense, ids, logits = direct["last"]
    assert ids.shape == (26, 32, 1) and logits.shape == (32,)
    from torchrec_tpu_torch.inference import PredictModule
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    scaffold = dlrm_main.build_dmp(args, dlrm_main.make_env(args),
                                   dlrm_main.table_rows(args))
    pm = PredictModule.load(pkg, scaffold, "cpu")

    def package_logits(dense, ids):
        n = dense.shape[0]
        sb = PaddedSparseBatch(ids=torch.from_numpy(ids),
                               lengths=torch.ones((26, n), dtype=torch.int32),
                               keys=tuple(f"cat_{i}" for i in range(26)))
        _, (_, want, _) = pm.predict(torch.from_numpy(dense), sb,
                                     torch.zeros(n))
        return want

    torch.testing.assert_close(logits, package_logits(dense, ids),
                               rtol=1e-6, atol=1e-7)
    for mode in ("--serve_batching", "--serve_native"):
        r = dlrm_predict.main([*serve, "--num_requests", "6", mode])
        assert r["qps"] > 0 and r["predictions_per_sec"] > 0
        assert r["latency"]["p50_ms"] > 0 and r["requests"] == 6
        # the last ragged request, served inside a padded server batch
        dense, ids, logits = r["last"]
        assert ids.shape == (26, dense.shape[0], 1)
        torch.testing.assert_close(logits, package_logits(dense, ids),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mode", ["dmp", "dp"])
def test_bert4rec_main_synthetic(mode):
    r = bert4rec_main.main([
        "--synthetic", "--num_batches", "4", "--batch_size", "8",
        "--max_len", "8", "--emb_dim", "16", "--vocab_size", "50",
        "--nhead", "2", "--num_layers", "1", "--mode", mode,
        "--device", "cpu"])
    assert 0.0 <= r["hr@10"] <= 1.0 and 0.0 <= r["ndcg@10"] <= 1.0
    assert np.isfinite(r["loss"]) and r["steps"] == 5


def test_bert4rec_main_movielens(tmp_path):
    """load_movielens_sequences as JAX's example reads ratings.csv, and a
    run over the file."""
    sys.path.insert(0, ROOT)
    from examples import bert4rec_main as jax_main

    rng = np.random.RandomState(0)
    lines = ["userId,movieId,rating,timestamp"]
    for user in range(40):
        for t in range(rng.randint(3, 20)):
            lines.append(f"{user},{rng.randint(1, 60) * 10},4.0,"
                         f"{rng.randint(0, 10**6)}")
    (tmp_path / "ratings.csv").write_text("\n".join(lines) + "\n")
    seqs = bert4rec_main.load_movielens_sequences(str(tmp_path))
    assert seqs == jax_main.load_movielens_sequences(str(tmp_path))
    r = bert4rec_main.main([
        "--movielens_dir", str(tmp_path), "--num_batches", "3",
        "--batch_size", "8", "--max_len", "8", "--emb_dim", "16",
        "--nhead", "2", "--num_layers", "1", "--device", "cpu"])
    assert 0.0 <= r["hr@10"] <= 1.0


def test_dlrm_main_model_gives_jax_logits(days):
    """The DMP that dlrm_main builds (the planner's plan under the port's
    module path), loaded with the weights of a JAX DMP built as
    examples/dlrm_main.py builds it, gives JAX's logits on one loader
    batch (rtol 1e-5, atol 1e-6)."""
    argv = ["--in_memory_binary_criteo_path", str(days), "--batch_size",
            "64", "--num_embeddings", str(ROWS), "--seed", "3", *SMALL]
    args = dlrm_main.parse_args(argv)
    rows = dlrm_main.table_rows(args)
    dmp = dlrm_main.build_dmp(args, dlrm_main.make_env(args), rows)
    batch = next(iter(dlrm_main.make_loader(args, "val",
                                            dmp.env, rows)))

    keys = [f"cat_{i}" for i in range(26)]
    tables = tuple(JConfig(num_embeddings=rows[i], embedding_dim=16,
                           name=f"t_{k}", feature_names=[k])
                   for i, k in enumerate(keys))
    model = JDLRMTrain(dlrm=JDLRM(
        embedding_bag_collection=JEBC(tables=tables, max_feature_length=1),
        dense_in_features=13, dense_arch_layer_sizes=(16, 16),
        over_arch_layer_sizes=(16, 1)))
    plan = JPlanner(JTopology(world_size=1, tpu_gen="v5e",
                              batch_size=64)).plan(tables,
                                                   module_path=JAX_KEY)
    jdmp = JDMP(model, env=JEnv.from_devices(jax.devices()[:1]), plan=plan,
                fused_optim=JOptim.ROWWISE_ADAGRAD,
                fused_params={"learning_rate": 1.0, "eps": 1e-8},
                dense_optimizer=optax.sgd(0.1))
    jbatch = next(iter(JLoader(*[sorted(
        str(p) for p in days.glob(f"*_{k}.npy"))
        for k in ("dense", "sparse", "labels")], batch_size=64,
        hashes=rows)))
    jargs = (jbatch.dense_features, jbatch.sparse_features, jbatch.labels)
    state = jdmp.init(jax.random.PRNGKey(3), *jargs)
    load_jax_weights(dmp, jax.tree.map(np.asarray, state.dense_params),
                     jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(
                         state.emb_states[JAX_KEY]))
    np.testing.assert_array_equal(batch.sparse_features.ids.numpy(),
                                  jbatch.sparse_features.ids)
    _, (_, got, _) = dmp.make_eval_fn()(*batch.batch_args())
    _, (_, want, _) = jdmp.make_eval_fn()(state, *jargs)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def _free_port():
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


RANK_SCRIPT = """
import json, sys
import torch
torch.set_num_threads(1)
from torchrec_tpu_torch.examples import dlrm_main
r = dlrm_main.main(sys.argv[2:])
with open(sys.argv[1], "w") as f:
    json.dump(r, f)
"""


def test_dlrm_main_multihost_on_two_gloo_ranks(days, tmp_path):
    """--multihost under torchrun's variables (gloo, --device cpu): each
    rank trains its share of the rows; both finish with the same mean
    loss, the same validation over both ranks' batches, and rank 0 writes
    the checkpoint."""
    port = str(_free_port())
    base = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    argv = ["--multihost", "--in_memory_binary_criteo_path", str(days),
            "--batch_size", "32", "--num_embeddings", str(ROWS),
            "--train_pipeline", "sparse_dist", "--save_dir",
            str(tmp_path / "ckpt"), *SMALL]
    procs, logs = [], []
    for r in range(2):
        env = dict(base, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                   LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                   MASTER_PORT=port)
        logs.append(open(tmp_path / f"log{r}", "w"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT,
             str(tmp_path / f"rank{r}.json"), *argv],
            env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
    try:
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
        for f in logs:
            f.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, (tmp_path / f"log{r}").read_text()[-4000:]
    res = [json.loads((tmp_path / f"rank{r}.json").read_text())
           for r in range(2)]
    assert res[0]["loss"] == res[1]["loss"]
    assert res[0]["auroc"] == res[1]["auroc"]
    assert res[0]["accuracy"] == res[1]["accuracy"]
    # 1,280 rows: 640 a rank, 20 batches of 32 each
    assert res[0]["steps"] == res[1]["steps"] == 20
    assert res[0]["eval_batches"] == 20
    assert np.isfinite(res[0]["loss"]) and 0.0 <= res[0]["auroc"] <= 1.0
    with np.load(tmp_path / "ckpt.npz") as z:
        assert int(z["step"]) == 20


def test_init_and_load_hold_one_block_of_the_tables(monkeypatch):
    """The DMP's init and load_tables drop each group's old block before
    drawing or loading its new one, so that a card holds one block of a
    table set, not two (the examples' Criteo Kaggle DLRM peaked at twice
    its 8.64 GB of tables on the card before)."""
    from torchrec_tpu_torch.parallel import strategies

    seen = []
    base = strategies.BaseEmbeddingShardingStrategy
    for name in ("init_weights", "shard_from_dense"):
        def held(self, *args, _orig=getattr(base, name), _name=name, **kw):
            seen.append((_name, self.weights.numel()))
            return _orig(self, *args, **kw)

        monkeypatch.setattr(base, name, held)
    args = dlrm_main.parse_args(["--synthetic", "--num_embeddings", "100",
                                 *SMALL])
    dmp = dlrm_main.build_dmp(args, dlrm_main.make_env(args),
                              dlrm_main.table_rows(args))
    key = dlrm_main.EBC_KEY
    tables = dmp.sharded_ebcs[key].unshard_to_dense()
    dmp.load_tables({key: {k: v * 2 for k, v in tables.items()}})
    assert seen == [("init_weights", 0), ("shard_from_dense", 0)]
    for name, w in dmp.sharded_ebcs[key].unshard_to_dense().items():
        np.testing.assert_array_equal(w, tables[name] * 2)
