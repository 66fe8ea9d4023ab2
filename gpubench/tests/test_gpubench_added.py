"""A model with per-feature multi-hot traffic, ADAGRAD on the tables and
on the dense layers, layers without a bias and a batch of its own form
(a KeyedJaggedTensor), added as files alone: found, run and checked by
the harness with no file of it edited. `tests/added/` holds the files
(a DLRM-DCNv2-shaped model at a CPU test's size: its configuration,
traffic, limits, program and reference); each test copies the harness,
puts them in place beside its own and adds the cell to BENCHMARK.json."""

import json
import shutil

import pytest
import torch

from gpubench import registry, run
from gpubench.drivers import train
from gpubench.reference import train as ref_train
from gpubench.result import Run

ADDED = registry.HERE / "tests" / "added"
CELL = "tiny_dcn.train_multihot"


@pytest.fixture
def added(tmp_path, monkeypatch):
    """A copy of the harness with the added files in place and the cell
    in its BENCHMARK.json, made the registry's."""
    here = tmp_path / "gpubench"
    shutil.copytree(registry.HERE, here,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for f in ADDED.glob("*/*"):
        shutil.copy(f, here / f.parent.name / f.name)
    bench = registry.benchmark()
    bench["configs"].append({"name": "tiny_dcn",
                             "source": "https://arxiv.org/abs/2008.13535",
                             "file": "gpubench/configs/tiny_dcn.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": CELL, "config": "tiny_dcn",
                               "traffic": "train_multihot", "chips": 1,
                               "why": "a test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m["name"] == "train_examples_per_s" or m["name"].endswith(".train"):
            m["workloads"].append(CELL)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "HERE", here)
    monkeypatch.setattr(registry, "ROOT", tmp_path)
    monkeypatch.setattr(registry, "_loaded", {})
    return registry.benchmark()


def _run(seed: int = 2**33 + 21) -> Run:
    cfg = registry.data("configs", "tiny_dcn")
    return Run(workload=CELL, cfg=cfg,
               traffic=registry.data("traffic", "train_multihot"),
               seed=seed, seconds=0.2, trace=False,
               device=torch.device("cpu"),
               program=registry.module("programs", "tiny_dcn"),
               model=registry.module("reference", "tiny_dcn"),
               clock=lambda: 0.0)


@pytest.mark.parametrize("trace", [False, True])
def test_added_model_runs_correct(added, trace):
    line, rows = run.run_cell(added, CELL, 2**33 + 21, 0.2, trace,
                              torch.device("cpu"), "cpu")
    assert line["correct"], rows
    assert line["attempted"] > 0
    assert "train_examples_per_s" in line["metrics"] or trace


def test_added_model_feeds_its_own_batch_form(added):
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    r = _run()
    pool = train.make_pool(r)
    sb = train.batch_form(r.program)(r.cfg, pool[0])
    assert isinstance(sb, KeyedJaggedTensor)
    # the real ids alone: sum of L_f over the batch
    assert sb.values.numel() == sum(r.traffic["ids_per_feature"]) * 128


def test_added_model_leaves_skip_the_missing_biases(added):
    """The cross net's V layers have no bias: no `.bias` leaf for them in
    the reference's readings nor among the program's parameters, and
    every other layer keeps its bias and its draws."""
    r = _run()
    pool = train.make_pool(r)[:train.CHECKED]
    rowsets = train.make_rowsets(r, pool)
    ref = ref_train.follow(r.cfg, r.model, r.seed, pool, rowsets)
    dense = sorted(n for n in ref.grad if n.startswith("linear"))
    # dense arch 0-1, V 2 / W 3, V 4 / W 5, over arch 6-8
    assert "linear2.bias" not in dense and "linear4.bias" not in dense
    assert "linear3.bias" in dense and "linear8.bias" in dense
    assert len(dense) == 2 * 9 - 2
    dmp, _, _, prog = train.set_up_program(r, train.make_pool(r), rowsets)
    assert set(prog.grad) == set(ref.grad)
    assert dmp.module.dlrm.crossnet.V[0].bias is None


FAULTS = ("unchanged_state", "half_batch", "altered_loss")


@pytest.mark.parametrize("fault", FAULTS)
def test_added_model_fault_is_not_correct(added, fault):
    from gpubench.tests.test_gpubench_reference import TRAIN_FAULTS, _correct

    r = _run()
    res = train.run(r, wrap_step=TRAIN_FAULTS[fault])
    assert not _correct(CELL, res), res.numbers


@pytest.mark.parametrize("kind", train.REFERENCE_KINDS)
def test_added_model_reference_in_the_programs_place(added, kind):
    from gpubench import check

    r = _run()
    numbers = train.reference_numbers(r, kind)
    ok, _ = check.judge(numbers, registry.data("limits", CELL))
    assert not ok, numbers
