"""The no-JAX check: whole top-level names, and what a run imports."""

import ast
import subprocess
import sys

from gpubench import guard, registry


def test_whole_top_level_names():
    assert guard.forbidden_modules(["torchrec_tpu_torch",
                                    "torchrec_tpu_torch.ops.quant",
                                    "jaxtyping", "flaxen", "numpy"]) == []
    assert guard.forbidden_modules(["jax.numpy", "torchrec_tpu.ops",
                                    "optax", "flax.linen", "jaxlib"]) == [
        "flax", "jax", "jaxlib", "optax", "torchrec_tpu"]


def test_a_run_imports_nothing_forbidden():
    """Everything a run loads, in a fresh process: the harness, every
    driver, program, reference and metric, and the port they build."""
    code = """
import sys
from gpubench import registry, run, guard
bench = registry.benchmark()
for w in bench["workloads"]:
    cfg = registry.data("configs", w["config"])
    tr = registry.data("traffic", w["traffic"])
    registry.module("drivers", tr["driver"])
    registry.module("programs", cfg["model"])
    registry.module("reference", cfg["model"])
for m in bench["end_to_end"] + bench["per_layer"]:
    registry.module("metrics", m["name"])
import torchrec_tpu_torch.parallel, torchrec_tpu_torch.inference
import torchrec_tpu_torch.models, torchrec_tpu_torch.ops.fused_update
print(guard.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_harness_sources_import_nothing_forbidden():
    """No file of the harness imports JAX, the JAX package, or the JAX
    bench's files (bench.py, bench_config.py, tools/)."""
    banned = guard.FORBIDDEN | {"bench", "bench_config", "tools"}
    for path in registry.HERE.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            tops = {n.split(".", 1)[0] for n in names}
            assert not tops & banned, (path, tops & banned)
