"""The port's reference-checkpoint interop (utils/torch_interop.py) and
metrics (utils/metrics.py) against the JAX package's, on the CPU.

tests/test_torch_interop.py's 14 cases on the port's DMP (the same tables
60 / 40 / 32 x 16 under ROW_WISE, TABLE_WISE and COLUMN_WISE, on one
device where JAX's fixture takes eight): the same reference state dicts
give the same reports (loaded tables, skipped keys, partial rows) as
JAX's import, module keys aside (the port's DLRM holds its EBC under
`sparse_arch`), and the same tables, bit for bit. The reference DLRM's
dense layers load into the port's nn.Linear layers as they are (JAX
transposes them into flax kernels): the port's dense arch gives the
reference MLP's output, and JAX's imported kernels are their transposes.
A UVM table exports and imports like the others.

The metrics: AUROC with tied scores, accuracy, HR@k and NDCG@k on seeded
scores, from numpy arrays and from tensors, equal JAX's exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import torch_port_uvm_cases as cases
from torchrec_tpu.models import DLRM as JDLRM
from torchrec_tpu.models import DLRMTrain as JDLRMTrain
from torchrec_tpu.modules import EmbeddingBagCollection as JEBC
from torchrec_tpu.modules import EmbeddingBagConfig as JConfig
from torchrec_tpu.ops.fused_update import EmbOptimType as JOptim
from torchrec_tpu.parallel import DistributedModelParallel as JDMP
from torchrec_tpu.parallel import ParameterSharding as JPS
from torchrec_tpu.parallel import ShardingEnv as JEnv
from torchrec_tpu.parallel import ShardingPlan as JPlan
from torchrec_tpu.parallel import ShardingType as JST
from torchrec_tpu.sparse import KeyedJaggedTensor as JKJT
from torchrec_tpu.utils import metrics as jmetrics
from torchrec_tpu.utils import torch_interop as jinterop
from torchrec_tpu_torch.models import DLRM, DLRMTrain
from torchrec_tpu_torch.modules import (
    EmbeddingBagCollection,
    EmbeddingBagConfig,
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
from torchrec_tpu_torch.sparse import PaddedSparseBatch
from torchrec_tpu_torch.utils import metrics
from torchrec_tpu_torch.utils.torch_interop import (
    ImportReport,
    export_torch_state_dict,
    extract_tables,
    import_dlrm_dense,
    import_torch_state_dict,
)

B, L, D, DENSE_IN = 8, 2, 16, 8
ROWS = (60, 40, 32)
JKEY = "dlrm/embedding_bag_collection"
KEY = "dlrm/sparse_arch/embedding_bag_collection"
PREFIX = "model.sparse_arch.embedding_bag_collection"


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, L + 1, size=(len(ROWS) * B,)).astype(np.int32)
    vals = np.concatenate(
        [rng.randint(0, ROWS[i // B], size=(lengths[i],))
         for i in range(len(lengths))] + [np.zeros((0,))]).astype(np.int32)
    dense = rng.randn(B, DENSE_IN).astype(np.float32)
    labels = (rng.rand(B) > 0.5).astype(np.float32)
    ids, lens = cases.padded(vals, lengths, ("f0", "f1", "f2"), L, B)
    sb = PaddedSparseBatch(ids=torch.as_tensor(ids),
                           lengths=torch.as_tensor(lens),
                           keys=("f0", "f1", "f2"))
    return torch.as_tensor(dense), sb, torch.as_tensor(labels)


def _port_dmp():
    tables = [EmbeddingBagConfig(num_embeddings=r, embedding_dim=D,
                                 name=f"t{i}", feature_names=[f"f{i}"])
              for i, r in enumerate(ROWS)]
    model = DLRMTrain(DLRM(EmbeddingBagCollection(tables, max_feature_length=L,
                                                  device="meta"),
                           DENSE_IN, (16, D), (16, 1), device="meta"))
    plan = ShardingPlan({KEY: {
        "t0": ParameterSharding(ShardingType.ROW_WISE),
        "t1": ParameterSharding(ShardingType.TABLE_WISE, ranks=[0]),
        "t2": ParameterSharding(ShardingType.COLUMN_WISE)}})
    return DistributedModelParallel(
        model, plan=plan, device="cpu", fused_optim=EmbOptimType.EXACT_SGD,
        fused_params={"learning_rate": 0.1},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=0.05)).init(0)


@pytest.fixture(scope="module")
def jax_dmp_state():
    """tests/test_torch_interop.py's fixture (one device here)."""
    tables = tuple(JConfig(num_embeddings=r, embedding_dim=D, name=f"t{i}",
                           feature_names=[f"f{i}"])
                   for i, r in enumerate(ROWS))
    model = JDLRMTrain(dlrm=JDLRM(
        embedding_bag_collection=JEBC(tables=tables, max_feature_length=L),
        dense_in_features=DENSE_IN, dense_arch_layer_sizes=(16, D),
        over_arch_layer_sizes=(16, 1)))
    dmp = JDMP(model, env=JEnv.from_devices(jax.devices()[:1]),
               plan=JPlan({JKEY: {"t0": JPS(JST.ROW_WISE),
                                  "t1": JPS(JST.TABLE_WISE, ranks=[0]),
                                  "t2": JPS(JST.COLUMN_WISE)}}),
               fused_optim=JOptim.EXACT_SGD,
               fused_params={"learning_rate": 0.1},
               dense_optimizer=optax.sgd(0.05))
    dense, sb, labels = _batch()
    jsb = JKJT.from_lengths(
        ["f0", "f1", "f2"],
        jnp.asarray(np.concatenate([sb.ids.numpy()[f, b, :n] for f in range(3)
                                    for b, n in enumerate(
                                        sb.lengths.numpy()[f])])),
        jnp.asarray(sb.lengths.numpy().reshape(-1))).to_padded(L)
    state = dmp.init(jax.random.PRNGKey(0), jnp.asarray(dense.numpy()), jsb,
                     jnp.asarray(labels.numpy()))
    return dmp, state


def _torch_sd(prefix=PREFIX, seed=3, rows=None):
    """A reference-shaped state dict: tables and dense distractors."""
    rng = np.random.RandomState(seed)
    sd = {}
    for i, r0 in enumerate(ROWS):
        r = (rows or {}).get(f"t{i}", r0)
        sd[f"{prefix}.embedding_bags.t{i}.weight"] = torch.from_numpy(
            rng.randn(r, D).astype(np.float32))
    sd["model.dense_arch.model.0.weight"] = torch.zeros(16, DENSE_IN)
    sd["model.dense_arch.model.0.bias"] = torch.zeros(16)
    return sd


def _same_report(report, jreport):
    assert {k.replace("sparse_arch/", ""): v
            for k, v in report.loaded.items()} == jreport.loaded
    assert report.skipped_keys == jreport.skipped_keys
    assert report.partial_rows == jreport.partial_rows


def _tables_of(dmp):
    return dmp.unsharded_state_dict()[f"embeddings/{KEY}"]


def test_extract_tables_fqn_parsing():
    sd = _torch_sd()
    sd["seq.ec.embeddings.items.weight"] = torch.zeros(10, 4)
    sd["not_embeddings.t9.weight"] = torch.zeros(5, 4)  # no dot before
    got = extract_tables(sd)
    want = jinterop.extract_tables(sd)
    assert set(got) == set(want) == {PREFIX, "seq.ec"}
    for p in want:
        for t in want[p]:
            np.testing.assert_array_equal(got[p][t], want[p][t])


def test_import_loads_reference_tables(jax_dmp_state):
    jdmp, state = jax_dmp_state
    dmp = _port_dmp()
    sd = _torch_sd()
    report = import_torch_state_dict(dmp, sd)
    _, jreport = jinterop.import_torch_state_dict(jdmp, state, sd)
    assert isinstance(report, ImportReport) and report.num_tables == 3
    _same_report(report, jreport)
    back = _tables_of(dmp)
    for i in range(3):
        np.testing.assert_array_equal(
            back[f"t{i}"], sd[f"{PREFIX}.embedding_bags.t{i}.weight"].numpy())
    # the import reaches the sharded forward
    fresh = _port_dmp()
    step = dmp.make_train_step()
    assert float(step(*_batch(1))[0]) != float(
        fresh.make_train_step()(*_batch(1))[0])


def test_import_partial_rows_prefix(jax_dmp_state):
    jdmp, state = jax_dmp_state
    dmp = _port_dmp()
    old = _tables_of(dmp)
    sd = _torch_sd(rows={"t0": 50})
    report = import_torch_state_dict(dmp, sd)
    _same_report(report, jinterop.import_torch_state_dict(jdmp, state,
                                                           sd)[1])
    assert report.partial_rows == ["t0"]
    back = _tables_of(dmp)
    np.testing.assert_array_equal(
        back["t0"][:50], sd[f"{PREFIX}.embedding_bags.t0.weight"].numpy())
    np.testing.assert_array_equal(back["t0"][50:], old["t0"][50:])


def test_import_dim_mismatch_strict_raises(jax_dmp_state):
    dmp = _port_dmp()
    sd = {"m.embedding_bags.t0.weight": torch.zeros(60, D + 4)}
    with pytest.raises(ValueError, match="dim"):
        import_torch_state_dict(dmp, sd)
    report = import_torch_state_dict(dmp, sd, strict=False)
    assert report.num_tables == 0
    jdmp, state = jax_dmp_state
    _same_report(report, jinterop.import_torch_state_dict(
        jdmp, state, sd, strict=False)[1])


def test_import_no_tables_raises():
    with pytest.raises(ValueError, match="no embedding tables"):
        import_torch_state_dict(_port_dmp(), {"w": torch.zeros(3)})


def test_import_from_pt_file(tmp_path):
    dmp = _port_dmp()
    p = tmp_path / "ref_ckpt.pt"
    torch.save(_torch_sd(seed=9), p)
    assert import_torch_state_dict(dmp, str(p)).num_tables == 3
    # and from a module: an EBC-shaped ModuleDict of EmbeddingBags
    m = torch.nn.Module()
    m.embedding_bags = torch.nn.ModuleDict(
        {f"t{i}": torch.nn.EmbeddingBag(r, D) for i, r in enumerate(ROWS)})
    assert import_torch_state_dict(dmp, m).num_tables == 3
    np.testing.assert_array_equal(_tables_of(dmp)["t1"],
                                  m.embedding_bags.t1.weight.detach().numpy())


def _torch_dense_sd(seed=11):
    """The reference DLRM's dense params at this model's shapes (dense
    8 -> 16 -> 16; over 22 -> 16 -> 1)."""
    rng = np.random.RandomState(seed)

    def lin(i, o):
        return (torch.from_numpy(rng.randn(o, i).astype(np.float32)),
                torch.from_numpy(rng.randn(o).astype(np.float32)))

    sd = {}
    for i, (fi, fo) in enumerate([(DENSE_IN, 16), (16, D)]):
        sd[f"model.dense_arch.model._mlp.{i}._linear.weight"], \
            sd[f"model.dense_arch.model._mlp.{i}._linear.bias"] = lin(fi, fo)
    sd["model.over_arch.model.0._mlp.0._linear.weight"], \
        sd["model.over_arch.model.0._mlp.0._linear.bias"] = lin(22, 16)
    sd["model.over_arch.model.1.weight"], \
        sd["model.over_arch.model.1.bias"] = lin(16, 1)
    return sd


def test_import_dlrm_dense_maps_without_transpose(jax_dmp_state):
    dmp = _port_dmp()
    sd = _torch_dense_sd()
    before = float(dmp.make_train_step()(*_batch(4))[0])
    dmp = _port_dmp()
    matched = import_dlrm_dense(dmp, sd)
    jdmp, state = jax_dmp_state
    jstate, jmatched = jinterop.import_dlrm_dense(jdmp, state, sd)
    assert matched == jmatched and len(matched) == 8
    params = dict(dmp.module.named_parameters())
    jp = jstate.dense_params["dlrm"]
    for i in range(2):
        w = sd[f"model.dense_arch.model._mlp.{i}._linear.weight"].numpy()
        got = params[f"dlrm.dense_arch.mlp.perceptrons.{i}.linear.weight"]
        np.testing.assert_array_equal(got.detach().numpy(), w)
        np.testing.assert_array_equal(np.asarray(
            jp["dense_arch"]["MLP_0"][f"Perceptron_{i}"]["Dense_0"]["kernel"]),
            w.T)
    np.testing.assert_array_equal(
        params["dlrm.over_arch.head.linear.weight"].detach().numpy(),
        sd["model.over_arch.model.1.weight"].numpy())
    # the port's dense arch computes the reference MLP
    x = torch.from_numpy(np.random.RandomState(1).randn(5, DENSE_IN)
                         .astype(np.float32))
    want = x
    for i in range(2):
        want = torch.relu(
            want @ sd[f"model.dense_arch.model._mlp.{i}._linear.weight"].T
            + sd[f"model.dense_arch.model._mlp.{i}._linear.bias"])
    with torch.no_grad():
        got = dmp.module.dlrm.dense_arch(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert float(dmp.make_train_step()(*_batch(4))[0]) != before


def test_import_dlrm_dense_shape_mismatch_raises():
    sd = {"model.dense_arch.model._mlp.0._linear.weight":
          torch.zeros(16, DENSE_IN + 1)}
    with pytest.raises(ValueError, match="shape"):
        import_dlrm_dense(_port_dmp(), sd)


def test_import_dlrm_dense_no_match_raises():
    with pytest.raises(ValueError, match="no reference DLRM dense"):
        import_dlrm_dense(_port_dmp(), {"x.weight": torch.zeros(2, 2)})


class _FakeDmp:
    """Matching-logic harness: two modules with a shared table name."""

    def __init__(self, kinds=("ebc", "ebc")):
        self.loaded = None
        self.sharded_ebcs = {
            f"{m}/{k}": (ShardedEmbeddingCollection.__new__(
                ShardedEmbeddingCollection) if k == "ec" else object())
            for m, k in zip("ab", kinds)}

    def unsharded_state_dict(self):
        a, b = self.sharded_ebcs
        return {"dense": {},
                f"embeddings/{a}": {"shared": np.zeros((4, 2), np.float32)},
                f"embeddings/{b}": {"shared": np.ones((4, 2), np.float32)}}

    def load_tables(self, tables):
        self.loaded = tables


def test_import_ambiguous_table_uses_torch_path():
    fake = _FakeDmp()
    sd = {"x.b.ebc.embedding_bags.shared.weight": torch.full((4, 2), 7.0)}
    report = import_torch_state_dict(fake, sd)
    assert report.loaded == {"b/ebc": ["shared"]}
    np.testing.assert_array_equal(fake.loaded["b/ebc"]["shared"], 7.0)


def test_import_ambiguous_table_without_path_raises():
    with pytest.raises(ValueError, match="ambiguous"):
        import_torch_state_dict(_FakeDmp(), {
            "embedding_bags.shared.weight": torch.zeros(4, 2)})


def test_export_roundtrip():
    """export -> a reference-style sd -> import restores bit for bit."""
    dmp = _port_dmp()
    dmp.make_train_step()(*_batch(2))
    sd = export_torch_state_dict(dmp)
    assert set(sd) == {f"dlrm.sparse_arch.embedding_bag_collection"
                       f".embedding_bags.t{i}.weight" for i in range(3)}
    assert all(isinstance(v, torch.Tensor) for v in sd.values())
    dmp2 = _port_dmp()
    assert import_torch_state_dict(dmp2, sd).num_tables == 3
    a, b = _tables_of(dmp), _tables_of(dmp2)
    for t in a:
        np.testing.assert_array_equal(a[t], b[t])


def test_export_ec_uses_embeddings_attr():
    fake = _FakeDmp(kinds=("ebc", "ec"))
    out = export_torch_state_dict(fake, as_torch=False)
    assert set(out) == {"a.ebc.embedding_bags.shared.weight",
                        "b.ec.embeddings.shared.weight"}


def test_import_bf16_checkpoint():
    dmp = _port_dmp()
    sd = {k: (v.to(torch.bfloat16) if v.ndim == 2 and "embedding_bags" in k
              else v) for k, v in _torch_sd().items()}
    assert import_torch_state_dict(dmp, sd).num_tables == 3
    np.testing.assert_array_equal(
        _tables_of(dmp)["t0"],
        sd[f"{PREFIX}.embedding_bags.t0.weight"].float().numpy())


def test_export_and_import_a_uvm_table():
    dmp = cases.uvm_dmp(ShardingEnv("cpu"), False, "ROWWISE_ADAGRAD").init(0)
    dmp.make_train_step()(*cases.port_args(0))
    sd = export_torch_state_dict(dmp)
    assert set(sd) == {"ebc.embedding_bags.t0.weight",
                       "ebc.embedding_bags.t1.weight"}
    dmp2 = cases.uvm_dmp(ShardingEnv("cpu"), False, "ROWWISE_ADAGRAD").init(4)
    assert import_torch_state_dict(dmp2, sd).loaded == {"ebc": ["t0", "t1"]}
    got = dmp2.unsharded_state_dict()["embeddings/ebc"]
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k.split(".")[2]], v.numpy())


@pytest.mark.parametrize("as_tensor", [False, True])
def test_metrics_match_jax(as_tensor):
    rng = np.random.RandomState(0)
    # scores on a coarse grid, so that many tie
    scores = np.round(rng.rand(257) * 8) / 8
    labels = (rng.rand(257) > 0.6).astype(np.float32)
    rankings = np.round(rng.randn(64, 50) * 4) / 4
    targets = rng.randint(0, 50, size=64)
    conv = torch.as_tensor if as_tensor else np.asarray
    assert metrics.auroc(conv(scores), conv(labels)) == jmetrics.auroc(
        scores, labels)
    assert metrics.accuracy(conv(scores), conv(labels)) == jmetrics.accuracy(
        scores, labels)
    for k in (1, 5, 10):
        assert metrics.hr_at_k(conv(rankings), conv(targets), k) == \
            jmetrics.hr_at_k(rankings, targets, k)
        assert metrics.ndcg_at_k(conv(rankings), conv(targets), k) == \
            jmetrics.ndcg_at_k(rankings, targets, k)
    assert np.isnan(metrics.auroc(conv(scores), conv(np.zeros(257))))
    assert 0.0 < metrics.auroc(scores, labels) < 1.0
