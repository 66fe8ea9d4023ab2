"""BENCHMARK.json against the benchmark's contract, and every name in it
resolved to its files."""

import json
import re

import pytest

from gpubench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def test_keys_and_sizes(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert (registry.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["command"]) <= 32
    assert all(TEXT.match(w) for w in bench["command"])
    assert bench["paths"] == ["gpubench"]
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= bench["run_seconds"] <= 51
    # a full check with 24 cells: 2 + 14 x 24 runs of run_seconds + 60,
    # 2 x 90 s of compile a cell, 1200 s spare, within 43,200 s
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43_200


def test_names_units_and_entries(bench):
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert TEXT.match(c["source"]) and c["source"].startswith("https://")
        assert c["file"] == f"gpubench/configs/{c['name']}.json"
        cfg = registry.data("configs", c["name"])
        assert cfg["reduced"] == c["reduced"] == []
        names.add(c["name"])
    cells = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and TEXT.match(w["why"])
        assert w["config"] in names and w["chips"] == 1
        assert (w["config"], w["traffic"]) not in cells
        cells.add((w["config"], w["traffic"]))
    metric_names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert TEXT.match(m["layer"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in bench["workloads"]:
        name = w["name"]
        mine = {m["name"] for m in registry.metrics_of(bench, name,
                                                       "end_to_end")}
        assert "setup_s" in mine and len(mine) >= 2
        layers = registry.metrics_of(bench, name, "per_layer")
        assert layers
        for m in layers:
            # the metric it moves is reported in the same cell
            assert m["moves"] in mine, (name, m["name"])


def test_every_name_has_its_files(bench):
    for w in bench["workloads"]:
        cfg = registry.data("configs", w["config"])
        tr = registry.data("traffic", w["traffic"])
        limits = registry.data("limits", w["name"])
        assert limits and all(v > 0 for v in limits.values())
        registry.module("drivers", tr["driver"])
        registry.module("programs", cfg["model"])
        registry.module("reference", cfg["model"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(registry.module("metrics", m["name"]).read)


def test_layers_name_the_same_layer_alike(bench):
    layers = {m["layer"] for m in bench["per_layer"]}
    # one spelling a layer: no two differ only in case or spacing
    folded = {re.sub(r"\s+", " ", x.lower()) for x in layers}
    assert len(folded) == len(layers)


def test_manifest_is_plain_json():
    with open(registry.ROOT / "BENCHMARK.json") as f:
        json.load(f, parse_constant=lambda c: pytest.fail(c))
