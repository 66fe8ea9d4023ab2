"""Rules of the port that hold whatever the numbers: no JAX in the port,
no silent fall back to the CPU, and the parts not ported yet raise.

Whether a card is present is decided inside each test, never at import.
"""

import ast
import pathlib

import pytest
import torch

from torchrec_tpu_torch.models import DLRM
from torchrec_tpu_torch.modules import (
    MLP,
    EmbeddingBagCollection,
    EmbeddingBagConfig,
)
from torchrec_tpu_torch.parallel import (
    DistributedModelParallel,
    ParameterSharding,
    ShardingEnv,
    ShardingPlan,
    ShardingType,
)
from torchrec_tpu_torch.parallel.types import ComputeKernel

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "torchrec_tpu")
PORT_FILES = sorted((ROOT / "torchrec_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "profile_serving.py"
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


def _tables():
    return [EmbeddingBagConfig(num_embeddings=10, embedding_dim=4,
                               name=f"t{i}", feature_names=[f"f{i}"])
            for i in range(2)]


def _model(device):
    return DLRM(EmbeddingBagCollection(_tables(), device=device), 3, (4,),
                (4, 1), device=device)


def _plan(sharding_type=ShardingType.ROW_WISE, **kw):
    return ShardingPlan({"sparse_arch/embedding_bag_collection": {
        t.name: ParameterSharding(sharding_type, **kw) for t in _tables()}})


@pytest.mark.parametrize("entry", ["env", "dmp", "mlp", "ebc"])
def test_entry_points_refuse_cpu_without_asking(entry, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "env":
            ShardingEnv()
        elif entry == "dmp":
            DistributedModelParallel(_model("meta"), plan=_plan())
        elif entry == "mlp":
            MLP(3, (4,))
        else:
            EmbeddingBagCollection(_tables())


def test_dmp_serves_on_cpu_when_asked():
    dmp = DistributedModelParallel(_model("meta"), plan=_plan(),
                                   device="cpu").init(0)
    assert dmp.env.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in dmp.state_dict().values())


@pytest.mark.parametrize(
    "case", ["no_plan", "table_wise", "uvm", "world_size", "update"])
def test_unported_parts_raise(case):
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
        else:
            dmp = DistributedModelParallel(_model("meta"), plan=_plan(),
                                           device="cpu")
            dmp.sharded_ebcs["sparse_arch/embedding_bag_collection"] \
                .strategies[0].update()
