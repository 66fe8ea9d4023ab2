"""Rules of the port that hold whatever the numbers: no JAX in the port,
no silent fall back to the CPU, and the parts not ported yet raise.

Whether a card is present is decided inside each test, never at import.
"""

import ast
import pathlib

import pytest
import torch

from torchrec_tpu_torch.models import (
    DLRM,
    BERT4Rec,
    BERT4RecTrain,
    SimpleDeepFMNN,
    make_item_embedding_collection,
)
from torchrec_tpu_torch.modules import (
    MLP,
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    EmbeddingCollection,
    EmbeddingConfig,
    LowRankMixtureCrossNet,
    PositionWeightedModule,
    SwishLayerNorm,
)
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardedEmbeddingBag,
    ShardingEnv,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.modules.embedding_configs import DataType
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.parallel.types import ComputeKernel
from torchrec_tpu_torch.sparse import KeyedJaggedTensor
from torchrec_tpu_torch.utils import tracing

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torchrec_tpu")
PORT_FILES = sorted((ROOT / "torchrec_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_serving.py",
    ROOT / "profile_train.py", ROOT / "profile_rowwise.py",
    ROOT / "check_pw_cotangent.py", ROOT / "compare_update_kernels.py",
]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.name} imports {bad}"


def _tables(data_type=DataType.FP32):
    return [EmbeddingBagConfig(num_embeddings=10, embedding_dim=4,
                               name=f"t{i}", feature_names=[f"f{i}"],
                               data_type=data_type)
            for i in range(2)]


def _model(device, data_type=DataType.FP32):
    return DLRM(EmbeddingBagCollection(_tables(data_type), device=device),
                3, (4,), (4, 1), device=device)


def _plan(sharding_type=ShardingType.ROW_WISE, **kw):
    return ShardingPlan({"sparse_arch/embedding_bag_collection": {
        t.name: ParameterSharding(sharding_type, **kw) for t in _tables()}})


def _bert4rec(device="meta", data_type=DataType.FP32, dropout=0.0):
    ec = EmbeddingCollection(
        [EmbeddingConfig(12, 8, "item_embedding", data_type=data_type,
                         feature_names=["item"])],
        max_feature_length=4, device=device)
    return BERT4RecTrain(BERT4Rec(12, 4, 8, 2, 1, dropout=dropout, ec=ec,
                                  device=device))


def _bert4rec_dmp(sharding_type=ShardingType.ROW_WISE,
                  data_type=DataType.FP32, device=None):
    return DistributedModelParallel(
        _bert4rec("meta", data_type),
        plan=ShardingPlan({"model/ec": {"item_embedding": ParameterSharding(
            sharding_type)}}), device=device)


@pytest.mark.parametrize("entry", [
    "env", "dmp", "mlp", "ebc", "train_step", "ec", "bert4rec",
    "bert4rec_dmp", "bert4rec_train_step", "position_weighted",
    "swish_layer_norm", "deepfm", "crossnet", "quant_ebc",
    "sharded_quant_ebc", "quantize_embeddings", "predict_module_load",
    "from_distributed", "sharded_embedding_bag", "from_local",
    "train_pipeline", "sparse_dist_pipeline", "planned_dmp",
    "tower_collection", "tower_dmp", "variable_batch", "uvm_cache",
    "uvm_ebc", "uvm_dmp", "dlrm_main", "dlrm_predict", "bert4rec_main",
    "random_rec_on_device", "synthetic_criteo_device"])
def test_entry_points_refuse_cpu_without_asking(entry, monkeypatch,
                                                tmp_path):
    from torchrec_tpu_torch.inference import (
        PredictModule,
        quantize_embeddings,
    )
    from torchrec_tpu_torch.parallel.quant_sharded import (
        ShardedQuantEmbeddingBagCollection,
    )
    from torchrec_tpu_torch.quant import QuantEmbeddingBagCollection

    from torchrec_tpu_torch.modules.embedding_tower import EmbeddingTower
    from torchrec_tpu_torch.parallel.tower_sharding import (
        ShardedEmbeddingTowerCollection,
        TowerSpec,
    )
    from torchrec_tpu_torch.parallel.train_pipeline import (
        SparseDistPipeline,
        TrainPipeline,
    )
    from torchrec_tpu_torch.parallel.variable_batch import VariableBatch

    cpu_dmp = (DistributedModelParallel(_model("meta"), plan=_plan(),
                                        device="cpu").init(0)
               if entry in ("quantize_embeddings", "predict_module_load",
                            "sparse_dist_pipeline")
               else None)
    weights = {t.name: torch.ones(10, 4) for t in _tables()}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "quant_ebc":
            QuantEmbeddingBagCollection.from_float(_tables(), weights)
        elif entry == "sharded_quant_ebc":
            ShardedQuantEmbeddingBagCollection.from_float(
                ShardingEnv(), _tables(), weights)
        elif entry == "quantize_embeddings":
            quantize_embeddings(cpu_dmp)
        elif entry == "predict_module_load":
            PredictModule.load(str(tmp_path), cpu_dmp)
        elif entry == "env":
            ShardingEnv()
        elif entry == "dmp":
            DistributedModelParallel(_model("meta"), plan=_plan())
        elif entry == "train_step":
            DistributedModelParallel(
                _model("meta"), plan=_plan(),
                fused_optim=tfu.EmbOptimType.EXACT_SGD).make_train_step()
        elif entry == "mlp":
            MLP(3, (4,))
        elif entry == "ec":
            make_item_embedding_collection(12, 8, 4)
        elif entry == "bert4rec":
            BERT4Rec(12, 4, 8, 2, 1)
        elif entry == "bert4rec_dmp":
            _bert4rec_dmp()
        elif entry == "bert4rec_train_step":
            _bert4rec_dmp().make_train_step()
        elif entry == "position_weighted":
            PositionWeightedModule({"f0": 4})
        elif entry == "swish_layer_norm":
            SwishLayerNorm(8)
        elif entry == "deepfm":
            SimpleDeepFMNN(3, EmbeddingBagCollection(_tables(), device="meta"),
                           4, 4)
        elif entry == "crossnet":
            LowRankMixtureCrossNet(8, 2, 2, 4)
        elif entry == "from_distributed":
            ShardingEnv.from_distributed()
        elif entry == "from_local":
            ShardingEnv.from_local(1)
        elif entry == "train_pipeline":
            TrainPipeline(lambda *batch: batch)
        elif entry == "sparse_dist_pipeline":
            SparseDistPipeline(cpu_dmp)
        elif entry == "planned_dmp":
            DistributedModelParallel(_model("meta"))
        elif entry == "tower_collection":
            ShardedEmbeddingTowerCollection(ShardingEnv(), [TowerSpec(
                tuple(_tables()), MLP(8, (2,), device="meta"), 0, 2)])
        elif entry == "tower_dmp":
            DistributedModelParallel(EmbeddingTower(
                EmbeddingBagCollection(_tables(), device="meta"),
                MLP(8, (2,), device="meta")))
        elif entry == "variable_batch":
            VariableBatch.from_ragged([KeyedJaggedTensor.from_lengths(
                ["f0"], [1, 2], [1, 1]).to_padded(1)])
        elif entry == "sharded_embedding_bag":
            ShardedEmbeddingBag(None, 10, 4,
                                ParameterSharding(ShardingType.ROW_WISE))
        elif entry == "uvm_cache":
            from torchrec_tpu_torch.ops.uvm_cache import UvmCachedEmbedding

            UvmCachedEmbedding(torch.ones(10, 4), cache_rows=4)
        elif entry == "uvm_ebc":
            from torchrec_tpu_torch.parallel.uvm_ebc import (
                UvmEmbeddingBagCollection,
            )

            UvmEmbeddingBagCollection(_tables(), weights)
        elif entry == "dlrm_main":
            from torchrec_tpu_torch.examples import dlrm_main

            dlrm_main.main(["--synthetic", "--num_batches", "1"])
        elif entry == "dlrm_predict":
            from torchrec_tpu_torch.examples import dlrm_predict

            dlrm_predict.main(["--package_dir", str(tmp_path)])
        elif entry == "bert4rec_main":
            from torchrec_tpu_torch.examples import bert4rec_main

            bert4rec_main.main(["--synthetic", "--num_batches", "1"])
        elif entry == "random_rec_on_device":
            from torchrec_tpu_torch.datasets import RandomRecDataset

            RandomRecDataset(["f0"], 4, on_device=True)
        elif entry == "synthetic_criteo_device":
            from torchrec_tpu_torch.datasets.synthetic_criteo import (
                SyntheticCriteoDataset,
            )

            SyntheticCriteoDataset(4, max_ind_range=10).device_batch_fn()
        elif entry == "uvm_dmp":
            DistributedModelParallel(
                _model("meta"), plan=_plan(
                    ShardingType.TABLE_WISE, ranks=[0],
                    compute_kernel=ComputeKernel.FUSED_UVM_CACHING))
        else:
            EmbeddingBagCollection(_tables())


def test_dmp_serves_on_cpu_when_asked():
    dmp = DistributedModelParallel(_model("meta"), plan=_plan(),
                                   device="cpu").init(0)
    assert dmp.env.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in dmp.state_dict().values())


@pytest.mark.parametrize(
    "case", ["adam_bf16", "adam_fp16", "bf16_train", "bf16_ec_train"])
def test_half_tables_train(case):
    """Half tables train (these raised while stochastic rounding was not
    ported): an ADAM update of a bf16 / fp16 table, a bf16 DMP's train
    step and a bf16 EC's, each changing the table and taking a step."""
    if case.startswith("adam"):
        dtype = torch.bfloat16 if case == "adam_bf16" else torch.float16
        opt = tfu.init_fused_optimizer_state(10, 4, tfu.EmbOptimType.ADAM)
        w = torch.zeros(10, 4, dtype=dtype)
        tfu.apply_fused_update(w, opt, torch.tensor([3, 3], dtype=torch.int32),
                               torch.ones(2, 4), torch.ones(2, dtype=torch.bool),
                               0.1)
        assert w.dtype == dtype and int(opt.step) == 1
        assert w[3].ne(0).all() and not w[[0, 1, 2, 4]].any()
        return
    if case == "bf16_train":
        dmp = DistributedModelParallel(
            _model("meta", DataType.BF16), plan=_plan(), device="cpu",
            fused_optim=tfu.EmbOptimType.EXACT_SGD).init(0)
        sebc = dmp.sharded_ebcs["sparse_arch/embedding_bag_collection"]
        kjt = KeyedJaggedTensor.from_lengths(["f0", "f1"], [1, 2, 3, 4],
                                             [1, 1, 1, 1])
        args = (torch.ones(2, 3), kjt)
        loss_fn = lambda logits: (logits.square().mean(), logits)  # noqa
    else:
        dmp = _bert4rec_dmp(device="cpu", data_type=DataType.BF16).init(0)
        sebc = dmp.sharded_ebcs["model/ec"]
        kjt = KeyedJaggedTensor.from_lengths(["item"], [1, 2, 3, 4], [4])
        args = (kjt, torch.tensor([[0, 5, 0, 7]], dtype=torch.int32))
        loss_fn = None  # BERT4RecTrain returns (loss, aux)
    strat = sebc.strategies[0]
    before = strat.weights.clone()
    step = dmp.make_train_step(loss_fn)
    loss, _ = step(*args)
    assert torch.isfinite(loss)
    assert strat.weights.dtype == torch.bfloat16
    assert not torch.equal(strat.weights, before) and int(strat.step) == 1


@pytest.mark.parametrize("params", [{"w_impl": "write"},
                                    {"mom_impl": "xla"}],
                         ids=["w_impl_write", "mom_impl_xla"])
def test_half_tables_refuse_unported_routes(params):
    """w_impl="write" and mom_impl="xla" are not ported for half tables:
    make_train_step raises before any step and apply_fused_update before
    it changes anything."""
    optim = tfu.EmbOptimType.ROWWISE_ADAGRAD
    dmp = DistributedModelParallel(_model("meta", DataType.BF16),
                                   plan=_plan(), device="cpu",
                                   fused_optim=optim, fused_params=params)
    with pytest.raises(NotImplementedError, match="not ported"):
        dmp.make_train_step()
    opt = tfu.init_fused_optimizer_state(10, 4, optim)
    w = torch.zeros(10, 4, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="not ported"):
        tfu.apply_fused_update(w, opt, torch.zeros(2, dtype=torch.int32),
                               torch.ones(2, 4), torch.ones(2, dtype=torch.bool),
                               0.1, **params)
    assert int(opt.step) == 0 and not opt.momentum1.any() and not w.any()


def _world_of_two():
    """A CPU env that reports world size 2, for the refusals checked
    before any collective runs (no process group is made)."""
    env = ShardingEnv("cpu")
    env.world_size = 2
    return env


@pytest.mark.parametrize(
    "case", ["no_plan", "uvm", "world_size", "fused_param",
             "shard_quantized_world_size_2"])
def test_unported_parts_raise(case):
    """The parts the port does not take raise: unknown fused_params.
    Several devices in one process raise for good: the port runs one
    process per rank. The planner (item 9) and UVM-cached tables (item
    11) are ported, so their cases, which raised before, now assert what
    they do: a DMP given no plan plans every table and trains;
    shard_quantized over two ranks without `table_ranks` places each table
    whole on one of them; a FUSED_UVM_CACHING plan builds the EBC's UVM
    module, its tables in host memory with a row cache each, and trains."""
    from torchrec_tpu_torch.inference import (
        quantize_embeddings,
        shard_quantized,
    )

    if case == "no_plan":
        dmp = DistributedModelParallel(_model("meta"), device="cpu").init(0)
        plan = dmp.plan.plan["sparse_arch/embedding_bag_collection"]
        assert sorted(plan) == ["t0", "t1"]
        # tables of 10 rows on one device: the planner replicates them
        assert {p.sharding_type for p in plan.values()} == {
            ShardingType.DATA_PARALLEL}
        loss, _ = dmp.make_train_step(
            lambda logits: (logits.square().mean(), logits))(
            torch.ones(2, 3), KeyedJaggedTensor.from_lengths(
                ["f0", "f1"], [1, 2, 3, 4], [1, 1, 1, 1]))
        assert torch.isfinite(loss)
        return
    if case == "shard_quantized_world_size_2":
        pm = quantize_embeddings(
            DistributedModelParallel(_model("meta"), plan=_plan(),
                                     device="cpu").init(0),
            device="cpu")
        spm = shard_quantized(pm, _world_of_two())
        (sq,) = spm._sharded.values()
        assert sorted(sq.table_ranks) == ["t0", "t1"]
        assert sorted(sq.table_ranks.values()) == [0, 1]
        return
    if case == "uvm":
        from torchrec_tpu_torch.parallel.uvm_ebc import (
            UvmSplitEmbeddingBagCollection,
        )

        dmp = DistributedModelParallel(
            _model("meta"), device="cpu",
            plan=_plan(ShardingType.TABLE_WISE, ranks=[0],
                       compute_kernel=ComputeKernel.FUSED_UVM_CACHING)).init(0)
        (sebc,) = dmp.sharded_ebcs.values()
        assert isinstance(sebc, UvmSplitEmbeddingBagCollection)
        assert sebc.device_part is None
        assert [t.name for t in sebc.uvm_tables] == ["t0", "t1"]
        loss, _ = dmp.make_train_step(
            lambda logits: (logits.square().mean(), logits))(
            torch.ones(2, 3), KeyedJaggedTensor.from_lengths(
                ["f0", "f1"], [1, 2, 3, 4], [1, 1, 1, 1]))
        assert torch.isfinite(loss)
        assert dmp.cache_stats()[
            "sparse_arch/embedding_bag_collection"]["t0"]["misses"] == 2
        return
    with pytest.raises(NotImplementedError):
        if case == "world_size":
            ShardingEnv.from_devices(["cpu", "cpu"])
        elif case == "fused_param":
            DistributedModelParallel(
                _model("meta"), plan=_plan(), device="cpu",
                fused_params={"compact": "always"}).make_train_step()


@pytest.mark.parametrize(
    "case", ["table_row_wise", "table_column_wise", "seq_table_row_wise",
             "fp_ebc_world_size_2"])
def test_hierarchical_plans_and_fp_ebc_at_n_build(case):
    """What raised before the hierarchical strategies were ported builds:
    a DLRM DMP under TABLE_ROW_WISE or TABLE_COLUMN_WISE and BERT4Rec's
    under TABLE_ROW_WISE take a train step on the CPU (their numbers are
    held to JAX in test_torch_port_strategies.py and
    test_torch_port_hierarchical.py), and a feature-processed EBC's DMP at
    world size 2 builds (it trains under gloo in
    test_torch_port_hierarchical.py)."""
    from torchrec_tpu_torch.modules import (
        FeatureProcessedEmbeddingBagCollection,
    )

    if case == "fp_ebc_world_size_2":
        fp = FeatureProcessedEmbeddingBagCollection(
            EmbeddingBagCollection(_tables(), is_weighted=True,
                                   max_feature_length=4, device="meta"),
            PositionWeightedModule({"f0": 4, "f1": 4}, device="meta"))
        dmp = DistributedModelParallel(
            DLRM(fp, 3, (4,), (4, 1), device="meta"), plan=_plan(),
            env=_world_of_two())
        assert list(dmp._fp_ebcs) == ["sparse_arch/embedding_bag_collection"]
        return
    if case == "seq_table_row_wise":
        dmp = _bert4rec_dmp(ShardingType.TABLE_ROW_WISE, device="cpu")
        kjt = KeyedJaggedTensor.from_lengths(["item"], [1, 2, 3, 4], [4])
        args = (kjt, torch.tensor([[0, 5, 0, 7]], dtype=torch.int32))
        loss_fn = None
    else:
        dmp = DistributedModelParallel(
            _model("meta"), device="cpu",
            plan=_plan(ShardingType[case.upper()], host=0))
        args = (torch.ones(2, 3), KeyedJaggedTensor.from_lengths(
            ["f0", "f1"], [1, 2, 3, 4], [1, 1, 1, 1]))
        loss_fn = lambda logits: (logits.square().mean(), logits)  # noqa
    dmp.init(0)
    (strat,) = next(iter(dmp.sharded_ebcs.values())).strategies
    before = strat.weights.clone()
    loss, _ = dmp.make_train_step(loss_fn)(*args)
    assert torch.isfinite(loss) and int(strat.step) == 1
    assert not torch.equal(strat.weights, before)


def test_a2a_routing_on_flat_strategy_warns_and_falls_back():
    """input_routing="a2a" on a flat strategy warns and all_gathers, as
    JAX's does (tests/test_advice_fixes_r3.py), and the model still
    trains; a hierarchical strategy takes it without a warning."""
    import warnings

    params = {"input_routing": "a2a"}
    with pytest.warns(UserWarning, match="no routed input dist"):
        dmp = DistributedModelParallel(_model("meta"), plan=_plan(),
                                       device="cpu", fused_params=params)
    (strat,) = dmp.sharded_ebcs["sparse_arch/embedding_bag_collection"] \
        .strategies
    assert strat.input_routing == "allgather"
    dmp.init(0)
    loss, _ = dmp.make_train_step(
        lambda logits: (logits.square().mean(), logits))(
        torch.ones(2, 3), KeyedJaggedTensor.from_lengths(
            ["f0", "f1"], [1, 2, 3, 4], [1, 1, 1, 1]))
    assert torch.isfinite(loss)
    with warnings.catch_warnings():
        warnings.simplefilter("error", UserWarning)
        dmp = DistributedModelParallel(
            _model("meta"), device="cpu", fused_params=params,
            plan=_plan(ShardingType.TABLE_ROW_WISE, host=0))
    (strat,) = dmp.sharded_ebcs["sparse_arch/embedding_bag_collection"] \
        .strategies
    assert strat.input_routing == "a2a"


@pytest.mark.parametrize("wrapper", ["routed_gather_rows", "route_tokens"])
def test_routed_gather_raises_on_a_cuda_tensor_without_a_card(wrapper):
    """CUDA tensors launch the kernel or raise: with no card and no nvcc
    the wrapper raises and does not take the plain version. The tensors
    are fake CUDA tensors (metadata only), which a CPU build can make."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from torchrec_tpu_torch.ops import gather_rows as gr

    launches = tracing.counts()
    with FakeTensorMode():
        ids = torch.zeros(1, 2, 3, dtype=torch.int32, device="cuda")
        lengths = torch.zeros(1, 2, dtype=torch.int32, device="cuda")
        sr = torch.ones(1, dtype=torch.int32, device="cuda")
        args = (ids, lengths, sr, torch.zeros_like(sr), 0)
        with pytest.raises((RuntimeError, AssertionError)):
            if wrapper == "route_tokens":
                gr.route_tokens(*args)
            else:
                gr.routed_gather_rows(
                    torch.zeros(4, 8, device="cuda"), *args)
    assert tracing.counts() == launches


@pytest.mark.parametrize("wrapper", ["quant_lookup_pooled",
                                     "quant_lookup_rows"])
def test_kq_raises_when_its_library_does_not_build(wrapper, monkeypatch):
    """A CUDA tensor launches Kq or raises: with the build failing, the
    wrapper raises the build's error and does not take the plain version.
    The tensors are fake CUDA tensors (metadata only)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from torchrec_tpu_torch.ops import quant_lookup as ql

    def fail(force=False):
        raise RuntimeError("nvcc failed (1): stand-in for a failed build")

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(ql.LIBRARY, "build", fail)
    monkeypatch.setattr(ql.LIBRARY, "_lib", None)
    monkeypatch.setattr(ql, "quant_lookup_pooled_reference", plain)
    monkeypatch.setattr(ql, "quant_lookup_rows_reference", plain)
    launches = tracing.counts()
    with FakeTensorMode():
        data = torch.zeros(8, 4, dtype=torch.uint8, device="cuda")
        scale = torch.ones(8, device="cuda")
        shift = torch.zeros(8, device="cuda")
        ids = torch.zeros(3, 2, dtype=torch.int32, device="cuda")
        coeff = torch.ones(3, 2, device="cuda")
        with pytest.raises(RuntimeError, match="nvcc failed"):
            if wrapper == "quant_lookup_pooled":
                ql.quant_lookup_pooled(data, scale, shift, ids, coeff, 8)
            else:
                ql.quant_lookup_rows(data, scale, shift, ids.reshape(-1), 8)
    assert tracing.counts() == launches


def _code_strings(path):
    """The string constants of a module that are not docstrings."""
    tree = ast.parse(path.read_text(), filename=str(path))
    docs = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)):
            body = node.body
            if (body and isinstance(body[0], ast.Expr)
                    and isinstance(body[0].value, ast.Constant)):
                docs.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docs]


@pytest.mark.parametrize(
    "path", sorted((ROOT / "torchrec_tpu_torch").rglob("*.py")),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_names_no_path_inside_the_jax_package(path):
    """No string the port's code uses names a file or directory of the JAX
    package: its sources build from torchrec_tpu_torch/csrc/."""
    import re

    bad = [s for s in _code_strings(path)
           if re.search(r"(^|[/\\.])torchrec_tpu(?!_torch)($|[/\\.])", s)]
    assert not bad, f"{path.name} names {bad}"


def test_native_and_cuda_sources_build_from_the_port():
    from torchrec_tpu_torch.ops import cuda_build
    from torchrec_tpu_torch.utils import native

    port = ROOT / "torchrec_tpu_torch"
    for csrc in (native.CSRC, cuda_build.CSRC):
        assert csrc.resolve() == (port / "csrc").resolve()
    assert (native.CSRC / "serving_queue.cpp").exists()
    assert native.native_lib_path("serving_queue.cpp").parent == (
        port / "csrc" / "_build").resolve()


# JAX modules with no file at the same path in the port, and why
NOT_AT_THE_SAME_PATH = {
    "ops/pallas_embedding.py": (
        "its eight pl.pallas_calls are hand-written CUDA kernels: "
        "csrc/tbe_lookup.cu, csrc/fused_update.cu and csrc/gather_rows.cu, "
        "bound in ops/tbe_lookup.py, ops/fused_update_kernels.py and "
        "ops/gather_rows.py"),
    "ops/cost_model.py": (
        "not to port (ROADMAP.md): the v5e cost model; the planner costs "
        "the H100 through planner/constants.py's H100_COSTS"),
}


def test_every_jax_module_has_a_counterpart():
    """Every .py and .cpp file of the JAX package has a file at the same
    path in the port, or an entry with its reason above (whose port
    files exist)."""
    jax_pkg, port = ROOT / "torchrec_tpu", ROOT / "torchrec_tpu_torch"
    missing = sorted(
        str(p.relative_to(jax_pkg)) for p in jax_pkg.rglob("*")
        if p.suffix in (".py", ".cpp") and "_build" not in p.parts
        and not (port / p.relative_to(jax_pkg)).exists())
    assert missing == sorted(NOT_AT_THE_SAME_PATH)
    for src in ("tbe_lookup.cu", "fused_update.cu", "gather_rows.cu"):
        assert (port / "csrc" / src).exists()


def _exported_names(path):
    """The names an __init__.py imports from its package, the public
    functions and classes it defines, and the names its module-level
    __getattr__ compares against."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = {a.asname or a.name for node in tree.body
             if isinstance(node, ast.ImportFrom)
             and (node.module or "").startswith("torchrec_tpu")
             for a in node.names}
    names |= {node.name for node in tree.body
              if isinstance(node, (ast.FunctionDef, ast.ClassDef))
              and not node.name.startswith("_")}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            names |= {n.value for n in ast.walk(node)
                      if isinstance(n, ast.Constant)
                      and isinstance(n.value, str) and n.value.isidentifier()}
    return names


@pytest.mark.parametrize(
    "init", sorted(str(p.relative_to(ROOT / "torchrec_tpu"))
                   for p in (ROOT / "torchrec_tpu").rglob("__init__.py")))
def test_exports_match_the_jax_package(init):
    """Every name a JAX __init__.py exports (read by AST) is an attribute
    of the port's package at the same path."""
    import importlib

    want = _exported_names(ROOT / "torchrec_tpu" / init)
    mod = importlib.import_module(
        "torchrec_tpu_torch" + "".join(
            "." + part for part in pathlib.Path(init).parent.parts))
    missing = sorted(n for n in want if not hasattr(mod, n))
    assert not missing, f"{init}: the port does not export {missing}"
