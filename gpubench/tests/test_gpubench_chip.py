"""Each cell end to end on a card, with a short window: the result line
as the contract gives it, correct, and (traced) device time under the
program's spans. Skips without a card."""

import pytest
import torch

from gpubench import registry, run

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


@pytest.mark.chip
@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", CELLS)
def test_cell_on_the_card(cuda_card, workload, trace):
    bench = registry.benchmark()
    line, rows = run.run_cell(bench, workload, 2**31 + 17, 2.0, trace,
                              cuda_card, torch.cuda.get_device_name(cuda_card))
    assert line["correct"], rows
    assert line["attempted"] > 0 and line["failed"] == 0
    section = "per_layer" if trace else "end_to_end"
    want = {m["name"] for m in registry.metrics_of(bench, workload, section)}
    assert set(line["metrics"]) == want
    if trace:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert line["breakdown"]["device_ops"]
        for name, m in line["metrics"].items():
            if name.split(".")[0].endswith("roofline") or "mfu" in name:
                assert 0 < m["value"] <= 100, (name, m)
