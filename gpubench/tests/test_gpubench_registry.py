"""A configuration, a traffic mix, a metric and a cell added as files and
BENCHMARK.json entries alone are found and run, with no file of the
harness edited; and a run refuses a machine without CUDA."""

import json
import shutil
import subprocess
import sys

import torch

from gpubench import registry, run
from gpubench.tests.conftest import SCORE_CELLS, TRAIN_CELLS, tiny_config

NEW_METRIC = '''"""Steps a second in the window (a metric added as a file)."""


def read(ctx):
    return ctx.attempted / ctx.window_s
'''


def test_added_files_are_found(tmp_path, monkeypatch):
    here = tmp_path / "gpubench"
    shutil.copytree(registry.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = registry.benchmark()
    cfg = tiny_config(registry.data("configs", "criteo_kaggle_dlrm"))
    cfg["name"] = "tiny_dlrm"
    (here / "configs" / "tiny_dlrm.json").write_text(json.dumps(cfg))
    tr = dict(registry.data("traffic", "train_b65536"), batch=64, pool=5)
    (here / "traffic" / "train_b64.json").write_text(json.dumps(tr))
    (here / "limits" / "tiny_dlrm.train_b64.json").write_text(json.dumps(
        registry.data("limits", "criteo_kaggle_dlrm.train_b65536")))
    (here / "metrics" / "steps_per_s.tiny.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "tiny_dlrm", "source": "https://x.y",
                             "file": "gpubench/configs/tiny_dlrm.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny_dlrm.train_b64",
                               "config": "tiny_dlrm", "traffic": "train_b64",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "steps_per_s.tiny", "unit": "1/s",
                               "better": "higher", "source": "host_clock",
                               "layer": "entry", "moves": "setup_s",
                               "workloads": ["tiny_dlrm.train_b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "HERE", here)
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    monkeypatch.setattr(registry, "_loaded", {})
    line, rows = run.run_cell(registry.benchmark(), "tiny_dlrm.train_b64",
                              11, 0.2, True, torch.device("cpu"), "cpu")
    assert line["correct"], rows
    assert line["metrics"]["steps_per_s.tiny"]["value"] > 0
    assert "mfu.train" not in line["metrics"]  # listed for other cells only
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown"}
    assert list(line)[-1] == "checks"


def test_run_refuses_without_cuda():
    if torch.cuda.is_available():
        return
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "criteo_kaggle_dlrm.train_b65536", "--seed", str(2**33),
         "--seconds", "1", "--trace", "0"],
        cwd=registry.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_tiny_config_sizes_come_from_the_reference():
    dlrm = tiny_config(registry.data("configs", "criteo_kaggle_dlrm"))
    assert (dlrm["embedding_dim"], dlrm["dense_arch_layer_sizes"],
            dlrm["over_arch_layer_sizes"]) == (8, [16, 8], [16, 1])
    deepfm = tiny_config(registry.data("configs",
                                       "criteo_simple_deepfm_d10"))
    assert (deepfm["hidden_layer_size"], deepfm["deep_fm_dimension"]) == (
        16, 16)
    assert deepfm["embedding_dim"] == 10
    for c in (dlrm, deepfm):
        assert max(c["num_embeddings_per_feature"]) == 500


def test_cells_by_driver_cover_the_benchmark():
    names = {w["name"] for w in registry.benchmark()["workloads"]}
    assert set(TRAIN_CELLS) | set(SCORE_CELLS) == names
    assert "criteo_kaggle_dlrm.train_uniform_b65536" in TRAIN_CELLS
    assert "criteo_kaggle_dlrm.score_int8_b65536" in SCORE_CELLS


def test_build_kernels_takes_the_programs_list(monkeypatch):
    """The driver's libraries and then those the program module lists
    under KERNELS, each built and loaded once, their build seconds
    summed."""
    import importlib
    import types

    from gpubench.drivers import train

    built = []

    class Lib:
        def __init__(self, name):
            self.name = name

        def build(self):
            built.append(self.name)
            return {"seconds": 1.5}

        def load(self):
            return self

    def fake_import(path):
        return types.SimpleNamespace(LIBRARY=Lib(path.rsplit(".", 1)[1]))

    monkeypatch.setattr(importlib, "import_module", fake_import)
    program = types.SimpleNamespace(KERNELS=("b", "c"))
    assert train.build_kernels(("a", "b"), program) == 4.5
    assert built == ["a", "b", "c"]
    built.clear()
    assert train.build_kernels(("a",), types.SimpleNamespace()) == 1.5
    assert built == ["a"]
    assert registry.module("programs", "dlrm").KERNELS == ("dot_interaction",)
