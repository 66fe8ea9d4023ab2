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
    the narrow layers its reference module's `tiny_sizes(cfg)` gives; the
    structure, optimizers and dtype as stated."""
    c = copy.deepcopy(cfg)
    c["num_embeddings_per_feature"] = [min(n, 500)
                                       for n in c["num_embeddings_per_feature"]]
    c.update(registry.module("reference", c["model"]).tiny_sizes(c))
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


def cells_of(driver: str) -> tuple:
    """BENCHMARK.json's cells whose traffic `driver` runs."""
    return tuple(w["name"] for w in registry.benchmark()["workloads"]
                 if registry.data("traffic", w["traffic"])["driver"] == driver)


TRAIN_CELLS = cells_of("train")
SCORE_CELLS = cells_of("score")
