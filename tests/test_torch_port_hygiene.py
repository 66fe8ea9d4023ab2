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
    make_item_embedding_collection,
)
from torchrec_tpu_torch.modules import (
    MLP,
    EmbeddingBagCollection,
    EmbeddingBagConfig,
    EmbeddingCollection,
    EmbeddingConfig,
    PositionWeightedModule,
    SwishLayerNorm,
)
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardingEnv,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.modules.embedding_configs import DataType
from torchrec_tpu_torch.ops import fused_update as tfu
from torchrec_tpu_torch.parallel.types import ComputeKernel
from torchrec_tpu_torch.sparse import KeyedJaggedTensor

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torchrec_tpu")
PORT_FILES = sorted((ROOT / "torchrec_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_serving.py",
    ROOT / "profile_train.py", ROOT / "profile_rowwise.py",
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
    "swish_layer_norm"])
def test_entry_points_refuse_cpu_without_asking(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "env":
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
        else:
            EmbeddingBagCollection(_tables())


def test_dmp_serves_on_cpu_when_asked():
    dmp = DistributedModelParallel(_model("meta"), plan=_plan(),
                                   device="cpu").init(0)
    assert dmp.env.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in dmp.state_dict().values())


@pytest.mark.parametrize(
    "case", ["no_plan", "table_wise", "uvm", "world_size", "update",
             "bf16_train", "fused_param", "seq_table_wise",
             "seq_data_parallel", "bf16_ec_train", "dropout"])
def test_unported_parts_raise(case):
    """`update`: an ADAM update of a bf16 table (stochastic rounding, not
    ported) raises, from make_train_step before any step and from
    apply_fused_update, and changes nothing."""
    if case == "update":
        optim = tfu.EmbOptimType.ADAM
        dmp = DistributedModelParallel(_model("meta", DataType.BF16),
                                       plan=_plan(), device="cpu",
                                       fused_optim=optim)
        with pytest.raises(NotImplementedError, match="stochastic rounding"):
            dmp.make_train_step()
        opt = tfu.init_fused_optimizer_state(10, 4, optim)
        with pytest.raises(NotImplementedError, match="stochastic rounding"):
            tfu.apply_fused_update(
                torch.zeros(10, 4, dtype=torch.bfloat16), opt,
                torch.zeros(2, dtype=torch.int32), torch.zeros(2, 4),
                torch.ones(2, dtype=torch.bool), 0.1)
        assert int(opt.step) == 0 and not opt.momentum1.any()
        return
    with pytest.raises(NotImplementedError):
        if case == "no_plan":
            DistributedModelParallel(_model("meta"), device="cpu")
        elif case == "table_wise":
            DistributedModelParallel(_model("meta"), device="cpu",
                                     plan=_plan(ShardingType.TABLE_WISE))
        elif case == "uvm":
            DistributedModelParallel(
                _model("meta"), device="cpu",
                plan=_plan(compute_kernel=ComputeKernel.FUSED_UVM_CACHING))
        elif case == "world_size":
            ShardingEnv.from_devices(["cpu", "cpu"])
        elif case == "bf16_train":  # bf16 tables train with SR, unported
            DistributedModelParallel(
                _model("meta", DataType.BF16), plan=_plan(), device="cpu",
                fused_optim=tfu.EmbOptimType.EXACT_SGD).make_train_step()
        elif case == "fused_param":
            DistributedModelParallel(
                _model("meta"), plan=_plan(), device="cpu",
                fused_params={"compact": "always"}).make_train_step()
        elif case == "seq_table_wise":  # sequence strategies but ROW_WISE
            _bert4rec_dmp(ShardingType.TABLE_WISE, device="cpu")
        elif case == "seq_data_parallel":
            _bert4rec_dmp(ShardingType.DATA_PARALLEL, device="cpu")
        elif case == "bf16_ec_train":  # stochastic rounding
            _bert4rec_dmp(device="cpu",
                          data_type=DataType.BF16).make_train_step()
        else:  # dropout in training
            model = _bert4rec("cpu", dropout=0.1)
            model(KeyedJaggedTensor.from_lengths(["item"], [1, 2, 3, 4], [4]),
                  torch.zeros(1, 4, dtype=torch.int32), deterministic=False)


@pytest.mark.parametrize("wrapper", ["routed_gather_rows", "route_tokens"])
def test_routed_gather_raises_on_a_cuda_tensor_without_a_card(wrapper):
    """CUDA tensors launch the kernel or raise: with no card and no nvcc
    the wrapper raises and does not take the plain version. The tensors
    are fake CUDA tensors (metadata only), which a CPU build can make."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from torchrec_tpu_torch.ops import gather_rows as gr

    launches = (gr.LAUNCHES, gr.ROUTED_LAUNCHES, gr.ROUTE_LAUNCHES)
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
    assert (gr.LAUNCHES, gr.ROUTED_LAUNCHES, gr.ROUTE_LAUNCHES) == launches
