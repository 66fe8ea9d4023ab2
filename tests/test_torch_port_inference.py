"""The port's quantized inference stack against the JAX package, on the CPU.

A JAX DistributedModelParallel over a small DLRMTrain (3 tables of 96, 200
and 64 rows, D=16, L=2, ROW_WISE on one device) takes 3 train steps; its
dense params and tables go through utils/jax_bridge.py into the port's DMP
on device="cpu". Both are quantized (int8 and int4) and served: the
predictions agree within rtol 1e-5 (the dense arches sum in another
order), quantized bytes bit for bit. Packages round-trip bit for bit, and
a package that the JAX package wrote loads into the port. The batching
servers are held to tests/test_batching_server.py's and
tests/test_native_batching.py's cases; every wait has a timeout.
"""

import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torchrec_tpu.inference import PredictFactory as JPredictFactory
from torchrec_tpu.inference import PredictFactoryPackager as JPackager
from torchrec_tpu.inference import quantize_embeddings as j_quantize
from torchrec_tpu.inference import shard_quantized as j_shard
from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.modules.embedding_configs import DataType as JDataType
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.sparse import PaddedSparseBatch as JPSB
from torchrec_tpu_torch.inference import (
    BatchingPredictServer,
    NativePredictServer,
    PredictClient,
    PredictFactory,
    PredictFactoryPackager,
    PredictModule,
    ShardedPredictModule,
    make_dlrm_collate,
    native_serving_available,
    quantize_embeddings,
    shard_quantized,
)
from torchrec_tpu_torch.models import DLRM, DLRMTrain
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    FeatureProcessedEmbeddingBagCollection,
    PositionWeightedModule,
)
from torchrec_tpu_torch.modules.embedding_configs import DataType
from torchrec_tpu_torch.ops.fused_update import EmbOptimType
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.sparse import PaddedSparseBatch
from torchrec_tpu_torch.utils import tracing
from torchrec_tpu_torch.utils.jax_bridge import (
    load_jax_predict_package,
    load_jax_weights,
)

ROWS = (96, 200, 64)
KEYS = ("f0", "f1", "f2")
D, DENSE_IN, B, L = 16, 5, 16, 2
DENSE_ARCH, OVER_ARCH = (16, D), (16, 1)
JAX_KEY = "dlrm/embedding_bag_collection"
PORT_KEY = "dlrm/sparse_arch/embedding_bag_collection"
TYPES = ["INT8", "INT4"]
TIMEOUT = 30.0


def _request(seed, batch=B):
    """(dense [B, 5], ids [3, B, L], lengths [3, B], labels [B]), numpy."""
    rng = np.random.RandomState(seed)
    ids = np.stack([rng.randint(0, r, size=(batch, L)) for r in ROWS]
                   ).astype(np.int32)
    lengths = rng.randint(0, L + 1, size=(3, batch)).astype(np.int32)
    dense = rng.randn(batch, DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=batch).astype(np.float32)
    return dense, ids, lengths, labels


def _jargs(req):
    dense, ids, lengths, labels = req
    return (jnp.asarray(dense),
            JPSB(ids=jnp.asarray(ids), lengths=jnp.asarray(lengths),
                 keys=KEYS),
            jnp.asarray(labels))


def _targs(req):
    dense, ids, lengths, labels = req
    return (torch.from_numpy(dense),
            PaddedSparseBatch(ids=torch.from_numpy(ids),
                              lengths=torch.from_numpy(lengths), keys=KEYS),
            torch.from_numpy(labels))


def _jlogits(out):
    return np.asarray(out[1][1])


def _tlogits(out):
    return out[1][1].numpy()


def _jax_model(data_type=JDataType.FP32):
    tables = tuple(JConfig(num_embeddings=r, embedding_dim=D, name=f"t{i}",
                           feature_names=[KEYS[i]], data_type=data_type)
                   for i, r in enumerate(ROWS))
    return tables, JDLRMTrain(dlrm=JDLRM(
        embedding_bag_collection=JEBC(tables=tables, max_feature_length=L),
        dense_in_features=DENSE_IN, dense_arch_layer_sizes=DENSE_ARCH,
        over_arch_layer_sizes=OVER_ARCH))


def _port_dmp(device="cpu", data_type=DataType.FP32):
    tables = [EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                                 name=f"t{i}", feature_names=[KEYS[i]],
                                 data_type=data_type)
              for i, r in enumerate(ROWS)]
    model = DLRMTrain(DLRM(
        EmbeddingBagCollection(tables, max_feature_length=L, device="meta"),
        DENSE_IN, DENSE_ARCH, OVER_ARCH, device="meta"))
    return DistributedModelParallel(
        model, device=device, fused_optim=EmbOptimType.ROWWISE_ADAGRAD,
        plan=ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
            ShardingType.ROW_WISE) for t in tables}}))


@pytest.fixture(scope="module")
def trained():
    """The JAX DMP after 3 steps, and the port DMP loaded from it."""
    import optax

    tables, model = _jax_model()
    jdmp = JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({JAX_KEY: {t.name: JPS(JST.ROW_WISE)
                                      for t in tables}}),
                fused_optim=JOptim.ROWWISE_ADAGRAD,
                fused_params={"learning_rate": 0.1},
                dense_optimizer=optax.sgd(0.05))
    state = jdmp.init(jax.random.PRNGKey(1), *_jargs(_request(0)))
    step = jdmp.make_train_step(donate=False)
    for i in range(3):
        state, _, _ = step(state, *_jargs(_request(i + 1)))
    dmp = _port_dmp()
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(state.emb_states[JAX_KEY]))
    return jdmp, state, dmp


@pytest.fixture(scope="module")
def quantized(trained):
    jdmp, state, dmp = trained
    return {name: (j_quantize(jdmp, state, JDataType[name]),
                   quantize_embeddings(dmp, DataType[name], device="cpu"))
            for name in TYPES}


@pytest.mark.parametrize("name", TYPES)
def test_quantize_embeddings_matches_jax(quantized, name):
    jpm, tpm = quantized[name]
    jq = jpm._quant_ebcs[JAX_KEY].quantized
    for tname, q in tpm._quant_ebcs[PORT_KEY].quantized.items():
        for part in ("data", "scale", "shift"):
            np.testing.assert_array_equal(getattr(q, part).numpy(),
                                          np.asarray(getattr(jq[tname], part)))
    req = _request(9)
    np.testing.assert_allclose(_tlogits(tpm.predict(*_targs(req))),
                               _jlogits(jpm.predict(*_jargs(req))),
                               rtol=1e-5, atol=1e-6)
    assert tpm.batching_metadata() == jpm.batching_metadata() == {
        k: "sparse" for k in KEYS}
    assert tpm.result_metadata() == jpm.result_metadata() == "dense"


@pytest.mark.parametrize("name", TYPES)
@pytest.mark.parametrize("half", ["BF16", "FP16"])
def test_quantize_embeddings_of_half_tables_matches_jax(half, name):
    """A bf16 or fp16 DMP, its JAX initial state bridged into the port,
    quantizes to JAX's bytes, scales and shifts bit for bit (the port
    computes a half table's range in its dtype, as JAX does)."""
    tables, model = _jax_model(JDataType[half])
    jdmp = JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({JAX_KEY: {t.name: JPS(JST.ROW_WISE)
                                      for t in tables}}))
    state = jdmp.init(jax.random.PRNGKey(2), *_jargs(_request(0)))
    dmp = _port_dmp(data_type=DataType[half])
    load_jax_weights(
        dmp, jax.tree.map(np.asarray, state.dense_params),
        jdmp.sharded_ebcs[JAX_KEY].unshard_to_dense(state.emb_states[JAX_KEY]))
    jq = j_quantize(jdmp, state, JDataType[name])._quant_ebcs[JAX_KEY]
    tpm = quantize_embeddings(dmp, DataType[name], device="cpu")
    for tname, q in tpm._quant_ebcs[PORT_KEY].quantized.items():
        for part in ("data", "scale", "shift"):
            np.testing.assert_array_equal(
                getattr(q, part).numpy(),
                np.asarray(getattr(jq.quantized[tname], part)),
                err_msg=f"{tname} {part}")


def test_predict_module_holds_no_float_table(quantized, trained):
    """The predict module is the dense part and the int-N tables only."""
    _, tpm = quantized["INT8"]
    dmp = trained[2]
    assert not any(m is dmp.sharded_ebcs[PORT_KEY] for m in tpm.modules())
    dense = {n for n, _ in dmp.module.named_parameters()}
    assert {n for n, _ in tpm.module.named_parameters()} == dense
    for name, b in tpm.named_buffers():
        assert (b.dtype == torch.uint8 if name.endswith("data")
                else b.dim() == 1), name
    for (n, p), (_, q) in zip(tpm.module.named_parameters(),
                              dmp.module.named_parameters()):
        assert torch.equal(p, q) and p.data_ptr() != q.data_ptr(), n
        assert not p.requires_grad


@pytest.mark.parametrize("name", TYPES)
def test_predict_module_save_load_round_trip(quantized, name, tmp_path):
    """Save, then load with a scaffold on `meta` (no table allocated):
    the same arrays and the same predictions, bit for bit."""
    _, tpm = quantized[name]
    tpm.save(str(tmp_path))
    scaffold = _port_dmp("meta")
    loaded = PredictModule.load(str(tmp_path), scaffold, device="cpu")
    assert all(t.is_meta for t in scaffold.sharded_ebcs[PORT_KEY].buffers())
    for tname, q in tpm._quant_ebcs[PORT_KEY].quantized.items():
        got = loaded._quant_ebcs[PORT_KEY].quantized[tname]
        for part in ("data", "scale", "shift"):
            assert torch.equal(getattr(got, part), getattr(q, part))
    req = _targs(_request(10))
    np.testing.assert_array_equal(_tlogits(loaded.predict(*req)),
                                  _tlogits(tpm.predict(*req)))
    with np.load(tmp_path / "arrays.npz") as arrays:
        keys = set(arrays.files)
    assert "dense/dlrm/dense_arch/mlp/perceptrons/0/linear/weight" in keys
    assert f"quant/{PORT_KEY}/t1/data" in keys


@pytest.mark.parametrize("name", TYPES)
def test_sharded_predict_module_matches_unsharded_and_jax(quantized, name):
    """shard_quantized at world size 1: every table on rank 0, one Kq over
    the packed group; SUM tables, so bit for bit with the unsharded
    module, and within rtol 1e-5 of JAX's sharded module on one device."""
    jpm, tpm = quantized[name]
    spm = shard_quantized(tpm)
    assert isinstance(spm, ShardedPredictModule)
    sq = spm._sharded[PORT_KEY]
    assert sq.data.shape == (384, sq.dim * sq.bits // 8)
    jspm = j_shard(jpm, JEnv.from_devices(jax.devices()[:1]),
                   table_ranks={JAX_KEY: {f"t{i}": 0 for i in range(3)}})
    req = _request(11)
    got = _tlogits(spm.predict(*_targs(req)))
    np.testing.assert_array_equal(got, _tlogits(tpm.predict(*_targs(req))))
    np.testing.assert_allclose(got, _jlogits(jspm.predict(*_jargs(req))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jspm._sharded[JAX_KEY].data)[0],
                                  sq.data.numpy())


def test_sharded_predict_module_saves_the_same_package(quantized, tmp_path):
    _, tpm = quantized["INT4"]
    shard_quantized(tpm).save(str(tmp_path / "s"))
    tpm.save(str(tmp_path / "u"))
    with np.load(tmp_path / "s" / "arrays.npz") as s, \
            np.load(tmp_path / "u" / "arrays.npz") as u:
        assert set(s.files) == set(u.files)
        for k in s.files:
            np.testing.assert_array_equal(s[k], u[k])
    assert (json.loads((tmp_path / "s" / "manifest.json").read_text())
            == json.loads((tmp_path / "u" / "manifest.json").read_text()))


def test_shard_quantized_refuses_several_devices(quantized):
    """Placement over several GPUs without explicit `table_ranks` (which
    raised until the planner was ported) now plans, as JAX does: the port's
    `_plan_quant_ranks` equals JAX's on JAX's topology, and on the card's
    own it places each table whole on one of the two ranks; rank 0's
    sharded module holds the tables placed on it."""
    from torchrec_tpu.inference.modules import _plan_quant_ranks as j_ranks
    from torchrec_tpu.ops import cost_model as jcm
    from torchrec_tpu.planner import constants as JC
    from torchrec_tpu_torch.inference.modules import _plan_quant_ranks
    from torchrec_tpu_torch.planner import CostModel, DeviceSpec, Topology

    class TwoDevices:
        world_size, rank, device, group = 2, 0, torch.device("cpu"), None

    jpm, tpm = quantized["INT8"]
    cap, hbm, ici, dcn = JC.TPU_SPECS["v5e"]
    v5e = Topology(2, device=DeviceSpec(
        "v5e", cap, hbm * 1024**3, ici * 1024**3, dcn * 1024**3,
        JC.DDR_MEM_BW, JC.HOST_DDR_CAP), cost_model=CostModel(
        jcm.fused_lookup_s, jcm.fused_update_s, JC.FUSED_KERNEL_BW_FRACTION,
        JC.DENSE_KERNEL_BW_FRACTION, JC.QUANT_KERNEL_BW_FRACTION))
    want = j_ranks(TwoDevices(), jpm._quant_ebcs)[JAX_KEY]
    assert _plan_quant_ranks(TwoDevices(), tpm._quant_ebcs,
                             topology=v5e)[PORT_KEY] == want
    planned = _plan_quant_ranks(TwoDevices(), tpm._quant_ebcs)[PORT_KEY]
    assert sorted(planned) == ["t0", "t1", "t2"]
    assert set(planned.values()) == {0, 1}
    spm = shard_quantized(tpm, TwoDevices())
    (sq,) = spm._sharded.values()
    assert sorted(sq.quantized) == sorted(t for t, r in planned.items()
                                          if r == 0)


@pytest.mark.parametrize("name", TYPES)
def test_load_jax_predict_package(quantized, name, tmp_path):
    """A package that JAX's PredictModule.save wrote: the same arrays and
    predictions within rtol 1e-5 of JAX's."""
    jpm, _ = quantized[name]
    jpm.save(str(tmp_path))
    pm = load_jax_predict_package(str(tmp_path), _port_dmp("meta"), "cpu")
    jq = jpm._quant_ebcs[JAX_KEY].quantized
    for tname, q in pm._quant_ebcs[PORT_KEY].quantized.items():
        np.testing.assert_array_equal(q.data.numpy(), np.asarray(jq[tname].data))
        assert q.bits == jq[tname].bits
    req = _request(12)
    np.testing.assert_allclose(_tlogits(pm.predict(*_targs(req))),
                               _jlogits(jpm.predict(*_jargs(req))),
                               rtol=1e-5, atol=1e-6)


def test_load_jax_predict_package_refuses_unknown_tables(quantized, tmp_path):
    jpm, _ = quantized["INT8"]
    jpm.save(str(tmp_path))
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    manifest["quant"][JAX_KEY]["t9"] = {"bits": 8, "dim": D}
    (tmp_path / "manifest.json").write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="tables without arrays"):
        load_jax_predict_package(str(tmp_path), _port_dmp("meta"), "cpu")
    # with its arrays, t9 is still no table of the port's module
    with np.load(tmp_path / "arrays.npz") as data:
        arrays = {k: data[k] for k in data.files}
    for part in ("data", "scale", "shift"):
        arrays[f"quant/{JAX_KEY}/t9/{part}"] = arrays[
            f"quant/{JAX_KEY}/t1/{part}"]
    np.savez(tmp_path / "arrays.npz", **arrays)
    with pytest.raises(ValueError, match="are not the tables of one port"):
        load_jax_predict_package(str(tmp_path), _port_dmp("meta"), "cpu")


def test_predict_factory_packager_matches_jax(quantized, tmp_path):
    jpm, tpm = quantized["INT8"]

    class Factory(PredictFactory):
        def create_predict_module(self):
            return tpm

        def batching_metadata(self):
            return tpm.batching_metadata()

    class JFactory(JPredictFactory):
        def create_predict_module(self):
            return jpm

        def batching_metadata(self):
            return jpm.batching_metadata()

    PredictFactoryPackager.save_predict_factory(Factory(), str(tmp_path / "t"))
    JPackager.save_predict_factory(JFactory(), str(tmp_path / "j"))
    got = PredictFactoryPackager.load_metadata(str(tmp_path / "t"))
    want = JPackager.load_metadata(str(tmp_path / "j"))
    for key in ("batching_metadata", "result_metadata"):
        assert got[key] == want[key]
    assert got["factory_class"].endswith("Factory")
    assert set(got) == set(want)
    tm = json.loads((tmp_path / "t" / "manifest.json").read_text())
    jm = json.loads((tmp_path / "j" / "manifest.json").read_text())
    assert tm["quant"][PORT_KEY] == jm["quant"][JAX_KEY]
    assert os.path.exists(tmp_path / "t" / "arrays.npz")


def _fp_port_dmp():
    tables = [EmbeddingBagConfig(num_embeddings=4, embedding_dim=2,
                                 name="t0", feature_names=["f0"])]
    fp = FeatureProcessedEmbeddingBagCollection(
        EmbeddingBagCollection(tables, is_weighted=True, max_feature_length=2,
                               device="meta"),
        PositionWeightedModule({"f0": 2}, device="meta"))

    class M(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.ebc = fp

        def forward(self, sb):
            return self.ebc(sb).values

    return DistributedModelParallel(M(), device="cpu", plan=ShardingPlan(
        {"ebc": {"t0": ParameterSharding(ShardingType.ROW_WISE)}}))


def test_quantized_serving_refuses_a_feature_processor(tmp_path):
    """ROADMAP section 3: the JAX PredictModule runs the quantized EBC on
    the raw batch, without the feature processor, so its predictions
    ignore the learned position weights. Smallest input: one table of
    4 x 2 rows, one bag of ids [0, 1], position weights [2.0, 0.5]: the
    JAX DMP gives 2 W[0] + 0.5 W[1], its quantized predict W[0] + W[1]
    (0.285 apart at seed 0). The port raises instead."""
    import flax.linen as fnn
    import optax

    from torchrec_tpu.modules import (
        FeatureProcessedEmbeddingBagCollection as JFP,
    )
    from torchrec_tpu.modules import PositionWeightedModule as JPW

    class M(fnn.Module):
        ebc: fnn.Module

        @fnn.compact
        def __call__(self, sb):
            return self.ebc(sb).values

    tables = (JConfig(num_embeddings=4, embedding_dim=2, name="t0",
                      feature_names=["f0"]),)
    fp = JFP(JEBC(tables=tables, is_weighted=True, max_feature_length=2),
             JPW(max_feature_lengths=(("f0", 2),)))
    jdmp = JDMP(M(ebc=fp), env=JEnv.from_devices(jax.devices()[:1]),
                plan=JPlan({"ebc": {"t0": JPS(JST.ROW_WISE)}}),
                dense_optimizer=optax.sgd(0.1))
    sb = JKJT.from_lengths(["f0"], jnp.asarray([0, 1], jnp.int32),
                           jnp.asarray([2], jnp.int32)).to_padded(2)
    state = jdmp.init(jax.random.PRNGKey(0), sb)
    params = jax.tree.map(np.asarray, state.dense_params)
    params["ebc"]["feature_processor"]["position_weight_f0"] = np.asarray(
        [2.0, 0.5], np.float32)
    state = state.replace(dense_params=jax.tree.map(jnp.asarray, params))
    w = jdmp.sharded_ebcs["ebc"].unshard_to_dense(state.emb_states["ebc"])[
        "t0"]
    f32 = np.asarray(jdmp.forward(state, sb))[0]
    quant = np.asarray(j_quantize(jdmp, state, JDataType.INT8).predict(sb))[0]
    np.testing.assert_allclose(f32, 2 * w[0] + 0.5 * w[1], rtol=1e-6)
    np.testing.assert_allclose(quant, w[0] + w[1], atol=1e-3)
    assert np.abs(f32 - quant).max() > 0.1

    dmp = _fp_port_dmp().init(0)
    with pytest.raises(NotImplementedError,
                       match="FeatureProcessedEmbeddingBagCollection"):
        quantize_embeddings(dmp, device="cpu")
    with pytest.raises(NotImplementedError,
                       match="FeatureProcessedEmbeddingBagCollection"):
        PredictModule.from_dmp(dmp, {}, "cpu")


def test_quantized_serving_refuses_an_embedding_collection():
    from torchrec_tpu_torch.models import BERT4Rec, BERT4RecTrain
    from torchrec_tpu_torch.modules import EmbeddingCollection, EmbeddingConfig

    ec = EmbeddingCollection([EmbeddingConfig(12, 8, "item_embedding",
                                              feature_names=["item"])],
                             max_feature_length=4, device="meta")
    dmp = DistributedModelParallel(
        BERT4RecTrain(BERT4Rec(12, 4, 8, 2, 1, ec=ec, device="meta")),
        device="cpu", plan=ShardingPlan({"model/ec": {
            "item_embedding": ParameterSharding(ShardingType.ROW_WISE)}}))
    with pytest.raises(NotImplementedError, match="EmbeddingCollection"):
        quantize_embeddings(dmp, device="cpu")


# -- BatchingPredictServer (tests/test_batching_server.py's cases) -----------

SB = 8


def _echo(x):
    return x * 2.0


def _collate(requests, batch_size):
    arr = np.concatenate(requests, axis=0)
    n = arr.shape[0]
    if n < batch_size:
        arr = np.concatenate(
            [arr, np.repeat(arr[:1], batch_size - n, axis=0)])
    return (torch.from_numpy(arr.astype(np.float32)),)


def _server(**kw):
    return BatchingPredictServer(_echo, _collate, SB,
                                 n_examples=lambda r: r.shape[0], **kw)


def test_batcher_coalesces_a_full_batch_and_demuxes():
    srv = _server(max_latency_s=5.0)  # no deadline flush: force coalesce
    try:
        reqs = [np.full((n, 2), i, np.float32)
                for i, n in enumerate([3, 2, 3])]
        futs = [srv.submit(r) for r in reqs]
        for f, r in zip(futs, reqs):
            out = f.result(timeout=TIMEOUT)
            assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
            np.testing.assert_array_equal(out.numpy(), r * 2.0)
    finally:
        srv.stop()


def test_batcher_flushes_a_partial_batch_on_its_deadline():
    srv = _server(max_latency_s=0.05)
    try:
        t0 = time.monotonic()
        out = srv.predict(np.ones((2, 2), np.float32), timeout=TIMEOUT)
        assert time.monotonic() - t0 < 2.0
        np.testing.assert_array_equal(out.numpy(), 2.0 * np.ones((2, 2)))
    finally:
        srv.stop()


def test_batcher_rejects_an_oversized_request():
    srv = _server()
    try:
        with pytest.raises(ValueError, match="exceeds server batch"):
            srv.submit(np.ones((SB + 1, 2), np.float32))
    finally:
        srv.stop()


def test_batcher_serves_concurrent_clients():
    srv = _server(max_latency_s=0.01)
    results = {}

    def client(i):
        r = np.full((1 + i % 3, 2), i, np.float32)
        results[i] = (r, srv.predict(r, timeout=TIMEOUT))

    try:
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert len(results) == 20
        for r, out in results.values():
            np.testing.assert_array_equal(out.numpy(), r * 2.0)
    finally:
        srv.stop()


def test_batcher_delivers_a_predict_error_to_every_future():
    def boom(x):
        raise RuntimeError("model exploded")

    srv = BatchingPredictServer(boom, _collate, SB,
                                n_examples=lambda r: r.shape[0],
                                max_latency_s=0.01)
    try:
        futs = [srv.submit(np.ones((1, 2), np.float32)) for _ in range(3)]
        for f in futs:
            with pytest.raises(RuntimeError, match="model exploded"):
                f.result(timeout=TIMEOUT)
    finally:
        srv.stop()


def _serve_requests(seed, count, max_n=3):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(count):
        n = 1 + i % max_n
        out.append((rng.randn(n, DENSE_IN).astype(np.float32),
                    np.stack([rng.randint(0, r, size=(n, L)) for r in ROWS]
                             ).astype(np.int32)))
    return out


def test_dlrm_collate_through_quantized_serving(quantized):
    """The DLRM collate feeds the port's quantized PredictModule through
    the batcher; every response equals a direct predict of the request
    alone through the same collate (rtol 1e-5)."""
    _, tpm = quantized["INT8"]
    collate = make_dlrm_collate(KEYS, "cpu")

    def predict_logits(dense, sb, labels):
        return tpm.predict(dense, sb, labels)[1][1]

    srv = BatchingPredictServer(predict_logits, collate, SB,
                                n_examples=lambda r: r[0].shape[0],
                                max_latency_s=0.02)
    try:
        reqs = _serve_requests(13, 6)
        futs = [srv.submit(r) for r in reqs]
        outs = [f.result(timeout=TIMEOUT) for f in futs]
        for (dense, ids), out in zip(reqs, outs):
            want = predict_logits(*collate([(dense, ids)], SB))
            np.testing.assert_allclose(out.numpy(),
                                       want[:dense.shape[0]].numpy(),
                                       rtol=1e-5, atol=1e-6)
    finally:
        srv.stop()


def test_dlrm_collate_pads_with_example_zero():
    collate = make_dlrm_collate(KEYS, "cpu")
    (dense, ids), = _serve_requests(14, 1)
    d, sb, labels = collate([(dense, ids)], 4)
    assert d.shape == (4, DENSE_IN) and sb.ids.shape == (3, 4, L)
    assert torch.equal(d[1:], torch.from_numpy(dense[:1]).expand(3, -1))
    assert torch.equal(sb.lengths, torch.full((3, 4), L, dtype=torch.int32))
    assert sb.keys == KEYS and not labels.any()


# -- NativePredictServer (tests/test_native_batching.py's cases) -------------

needs_gxx = pytest.mark.skipif(not native_serving_available(),
                               reason="g++ toolchain unavailable")
NB_, ND, NF, NL = 8, 2, 3, 1


def _npredict(dense, ids):
    # deterministic "model": per-example sum of dense + sum of ids, as a
    # torch tensor (the executor takes the first output of >= 1 dim)
    return torch.from_numpy(dense.sum(axis=1)
                            + ids.sum(axis=(0, 2)).astype(np.float32))


def _nexpected(dense, ids):
    return (dense.sum(axis=1) + ids.sum(axis=(0, 2)).astype(np.float32)
            )[:, None]


def _nreq(rng, n):
    return (rng.rand(n, ND).astype(np.float32),
            rng.randint(0, 100, size=(NF, n, NL)).astype(np.int32))


def _nserver(**kw):
    kw.setdefault("max_latency_s", 0.02)
    return NativePredictServer(_npredict, NB_, ND, NF, NL, **kw)


@needs_gxx
def test_native_coalesces_and_demuxes():
    srv = _nserver(max_latency_s=5.0)
    try:
        rng = np.random.RandomState(0)
        reqs = [_nreq(rng, n) for n in (3, 2, 3)]
        futs = [srv.submit(d, i) for d, i in reqs]
        for f, (d, i) in zip(futs, reqs):
            np.testing.assert_allclose(f.result(timeout=TIMEOUT),
                                       _nexpected(d, i), rtol=1e-6)
    finally:
        srv.stop()


@needs_gxx
def test_native_flushes_a_partial_batch_on_its_deadline():
    srv = _nserver(max_latency_s=0.05)
    try:
        d, i = _nreq(np.random.RandomState(1), 2)
        t0 = time.monotonic()
        out = srv.predict(d, i, timeout=TIMEOUT)
        assert time.monotonic() - t0 < 2.0
        np.testing.assert_allclose(out, _nexpected(d, i), rtol=1e-6)
    finally:
        srv.stop()


@needs_gxx
@pytest.mark.parametrize("pipeline", [False, True])
def test_native_never_splits_a_request_across_batches(pipeline):
    srv = _nserver(max_latency_s=0.01, pipeline=pipeline)
    try:
        rng = np.random.RandomState(2)
        reqs = [_nreq(rng, n) for n in (5, 6, 7, 4)]
        futs = [srv.submit(d, i) for d, i in reqs]
        for f, (d, i) in zip(futs, reqs):
            np.testing.assert_allclose(f.result(timeout=TIMEOUT),
                                       _nexpected(d, i), rtol=1e-6)
    finally:
        srv.stop()


@needs_gxx
def test_native_rejects_oversized_and_stopped():
    srv = _nserver()
    rng = np.random.RandomState(3)
    d, i = _nreq(rng, NB_ + 1)
    with pytest.raises(RuntimeError, match="bad request size"):
        srv.submit(d, i).result(timeout=TIMEOUT)
    srv.stop()
    d, i = _nreq(rng, 1)
    with pytest.raises(RuntimeError, match="server stopped"):
        srv.submit(d, i).result(timeout=TIMEOUT)


@needs_gxx
def test_native_delivers_an_executor_error_per_request():
    calls = {"n": 0}

    def flaky(dense, ids):
        calls["n"] += 1
        if calls["n"] == 1:
            raise ValueError("boom on batch 1")
        return _npredict(dense, ids)

    srv = NativePredictServer(flaky, NB_, ND, NF, NL, max_latency_s=0.02)
    try:
        rng = np.random.RandomState(4)
        d, i = _nreq(rng, 3)
        with pytest.raises(RuntimeError, match="boom on batch 1"):
            srv.predict(d, i, timeout=TIMEOUT)
        d2, i2 = _nreq(rng, 3)  # the server survives the failed batch
        np.testing.assert_allclose(srv.predict(d2, i2, timeout=TIMEOUT),
                                   _nexpected(d2, i2), rtol=1e-6)
    finally:
        srv.stop()


@needs_gxx
def test_native_serves_concurrent_clients():
    srv = _nserver(max_latency_s=0.005)
    results, errors = {}, []

    def client(k):
        rng = np.random.RandomState(100 + k)
        try:
            d, i = _nreq(rng, 1 + k % 4)
            results[k] = (srv.predict(d, i, timeout=TIMEOUT),
                          _nexpected(d, i))
        except Exception as e:  # noqa: BLE001
            errors.append((k, e))

    try:
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(24)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not errors, errors
        assert len(results) == 24
        for out, want in results.values():
            np.testing.assert_allclose(out, want, rtol=1e-6)
    finally:
        srv.stop()


@needs_gxx
def test_native_tcp_round_trip():
    srv = _nserver(max_latency_s=0.005)
    try:
        cli = PredictClient(srv.serve_tcp(0), timeout_s=TIMEOUT)
        rng = np.random.RandomState(5)
        for n in (1, 3, NB_):
            d, i = _nreq(rng, n)
            np.testing.assert_allclose(cli.predict(d, i), _nexpected(d, i),
                                       rtol=1e-6)
        cli.close()
    finally:
        srv.stop()


@needs_gxx
def test_native_tcp_concurrent_connections():
    srv = _nserver(max_latency_s=0.005)
    try:
        port = srv.serve_tcp(0)
        results, errors = {}, []

        def client(k):
            rng = np.random.RandomState(200 + k)
            try:
                cli = PredictClient(port, timeout_s=TIMEOUT)
                for _ in range(3):
                    d, i = _nreq(rng, 1 + k % 3)
                    np.testing.assert_allclose(cli.predict(d, i),
                                               _nexpected(d, i), rtol=1e-6)
                cli.close()
                results[k] = True
            except Exception as e:  # noqa: BLE001
                errors.append((k, e))

        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(TIMEOUT)
        assert not errors, errors
        assert len(results) == 8
    finally:
        srv.stop()


@needs_gxx
def test_native_does_not_hold_lone_requests_when_pipelined():
    srv = _nserver(max_latency_s=0.005, pipeline=True)
    try:
        rng = np.random.RandomState(10)
        for _ in range(3):
            d, i = _nreq(rng, 2)
            t0 = time.monotonic()
            out = srv.predict(d, i, timeout=TIMEOUT)
            assert time.monotonic() - t0 < 1.0
            np.testing.assert_allclose(out, _nexpected(d, i), rtol=1e-6)
            time.sleep(0.05)
    finally:
        srv.stop()


@needs_gxx
def test_native_resolves_many_inflight_submits_on_one_drain_thread():
    srv = _nserver(max_latency_s=0.002, max_pending=4096)
    try:
        rng = np.random.RandomState(11)
        before = threading.active_count()
        reqs = [_nreq(rng, 1 + (k % 3)) for k in range(300)]
        futs = [srv.submit(d, i) for d, i in reqs]
        assert threading.active_count() - before < 10
        for f, (d, i) in zip(futs, reqs):
            np.testing.assert_allclose(f.result(timeout=TIMEOUT),
                                       _nexpected(d, i), rtol=1e-6)
    finally:
        srv.stop()


@needs_gxx
def test_native_stop_returns_with_an_idle_connection_open():
    srv = _nserver()
    try:
        cli = PredictClient(srv.serve_tcp(0), timeout_s=TIMEOUT)
        d, i = _nreq(np.random.RandomState(6), 2)
        cli.predict(d, i)  # the connection is now idle but open
        t0 = time.monotonic()
        srv.stop()
        assert time.monotonic() - t0 < 5.0
        cli.close()
    finally:
        srv.stop()


@needs_gxx
def test_native_refuses_a_second_serve_tcp():
    srv = _nserver()
    try:
        srv.serve_tcp(0)
        with pytest.raises(RuntimeError, match="already started"):
            srv.serve_tcp(0)
    finally:
        srv.stop()


@needs_gxx
def test_native_pipeline_defaults_on_for_a_cuda_predict_module():
    class OnCuda:
        device = torch.device("cuda")

        def __call__(self, dense, ids):
            return _npredict(dense, ids)

        def predict_numpy(self, dense, ids):
            return _npredict(dense, ids)

    for predict, kw, want in ((OnCuda(), {}, True), (_npredict, {}, False),
                              (OnCuda().predict_numpy, {}, True),
                              (_npredict, {"device": "cuda"}, True),
                              (OnCuda(), {"pipeline": False}, False)):
        srv = NativePredictServer(predict, NB_, ND, NF, NL, **kw)
        try:
            assert srv._pipeline is want
        finally:
            srv.stop()


def _quant_native(pm, dense_dim=DENSE_IN):
    lengths = torch.full((3, NB_), L, dtype=torch.int32)
    labels = torch.zeros(NB_)

    def predict(dense, ids):
        sb = PaddedSparseBatch(ids=torch.from_numpy(ids), lengths=lengths,
                               keys=KEYS)
        return pm.predict(torch.from_numpy(dense), sb, labels)

    return NativePredictServer(predict, NB_, dense_dim, 3, L,
                               max_latency_s=0.005, pipeline=True)


@needs_gxx
def test_native_matches_the_python_batcher_on_the_quantized_dlrm(quantized):
    """The native server (pipelined, in process and over TCP) and the
    Python batcher serve the same int8 PredictModule: equal predictions
    within rtol 1e-5, and Kq's plain version 3 times per batch."""
    _, tpm = quantized["INT8"]
    nat = _quant_native(tpm)
    pyb = BatchingPredictServer(
        lambda *a: tpm.predict(*a)[1][1], make_dlrm_collate(KEYS, "cpu"),
        NB_, n_examples=lambda r: r[0].shape[0], max_latency_s=0.005)
    try:
        cli = PredictClient(nat.serve_tcp(0), timeout_s=TIMEOUT)
        for dense, ids in _serve_requests(15, 4, max_n=NB_):
            out_n = nat.predict(dense, ids, timeout=TIMEOUT).reshape(-1)
            out_t = cli.predict(dense, ids).reshape(-1)
            out_p = pyb.predict((dense, ids), timeout=TIMEOUT).numpy()
            np.testing.assert_allclose(out_n, out_p, rtol=1e-5, atol=1e-6)
            np.testing.assert_array_equal(out_t, out_n)
        cli.close()
    finally:
        nat.stop()
        pyb.stop()


@needs_gxx
def test_native_answers_as_the_jax_server_on_the_same_quantized_model(
        quantized):
    """JAX's NativePredictServer over JAX's quantized PredictModule and the
    port's over the port's, from the same trained weights: the same
    answers within rtol 1e-5."""
    from torchrec_tpu.inference.native_batching import (
        NativePredictServer as JNative,
    )

    jpm, tpm = quantized["INT8"]
    lengths = jnp.full((3, NB_), L, jnp.int32)
    labels = jnp.zeros((NB_,), jnp.float32)

    def jpredict(dense, ids):
        sb = JPSB(ids=jnp.asarray(ids), lengths=lengths, keys=KEYS)
        return jpm.predict(jnp.asarray(dense), sb, labels)

    jnat = JNative(jpredict, NB_, DENSE_IN, 3, L, max_latency_s=0.005)
    nat = _quant_native(tpm)
    try:
        for dense, ids in _serve_requests(16, 4, max_n=NB_):
            np.testing.assert_allclose(
                nat.predict(dense, ids, timeout=TIMEOUT),
                jnat.predict(dense, ids, timeout=TIMEOUT),
                rtol=1e-5, atol=1e-6)
    finally:
        nat.stop()
        jnat.stop()


def test_kq_plain_version_serves_the_cpu_predict_module(quantized):
    """On the CPU the predict module's lookups take Kq's plain version
    and launch no kernel."""
    _, tpm = quantized["INT4"]
    launches = tracing.counts()
    out = tpm.predict(*_targs(_request(17)))
    assert tracing.counts() == launches
    assert np.isfinite(_tlogits(out)).all()
