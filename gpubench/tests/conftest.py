"""Tests of the benchmark harness. They run on the CPU at tiny sizes,
except those marked `chip`, which need a CUDA card and skip without one
(the decision is made inside the `cuda_card` fixture, never at import):

    python -m pytest gpubench/tests -q              # here
    python -m pytest gpubench/tests -q -m chip      # on a card
"""

import copy

import pytest
import torch

from gpubench import registry
from gpubench.result import Run


def pytest_configure(config):
    config.addinivalue_line("markers",
                            "chip: needs a CUDA card; skips without one")


@pytest.fixture
def cuda_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def tiny_config(cfg: dict) -> dict:
    """The configuration at a CPU test's size: tables of at most 500 rows,
    narrow layers; the structure, optimizers and dtype as stated."""
    c = copy.deepcopy(cfg)
    c["num_embeddings_per_feature"] = [min(n, 500)
                                       for n in c["num_embeddings_per_feature"]]
    if c["model"] == "dlrm":
        c.update(embedding_dim=8, dense_arch_layer_sizes=[16, 8],
                 over_arch_layer_sizes=[16, 1])
    else:
        c.update(hidden_layer_size=16, deep_fm_dimension=16)
    return c


def tiny_run(workload: str, seed: int = 2**33 + 5, trace: bool = False,
             seconds: float = 0.2, **traffic) -> Run:
    """A Run of `workload` on the CPU at a tiny size."""
    bench = registry.benchmark()
    cell = registry.cell(bench, workload)
    cfg = tiny_config(registry.data("configs", cell["config"]))
    tr = dict(registry.data("traffic", cell["traffic"]))
    tr.update(batch=128, pool=6)
    tr.update(traffic)
    return Run(workload=workload, cfg=cfg, traffic=tr, seed=seed,
               seconds=seconds, trace=trace, device=torch.device("cpu"),
               program=registry.module("programs", cfg["model"]),
               model=registry.module("reference", cfg["model"]),
               clock=lambda: 0.0)


TRAIN_CELLS = ("criteo_kaggle_dlrm.train_b65536",
               "criteo_simple_deepfm_d10.train_b262144")
SCORE_CELLS = ("criteo_kaggle_dlrm.score_int8_b65536",)
