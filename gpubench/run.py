"""One run of one cell of the benchmark.

    python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks
for. Prints, as the last line of standard output, one JSON object:
`correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer ones), `device`, with
`--trace 1` a `breakdown`, and last `checks`, each number compared with
its limit (also the last lines of standard error). Exits non-zero with no
result where CUDA is missing, where the cell asks for more cards than
there are, or where JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time


def _process_start() -> float:
    """The process's start as a Unix time, from /proc (Linux); the time of
    this module's import elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            boot = next(int(line.split()[1]) for line in f
                        if line.startswith("btime"))
        return boot + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


START = _process_start()


def parse_args(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _finite(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, kind: str):
    """Run one cell on `device` (a card named `kind`): its configuration,
    traffic and limits found by name, its driver's run, the metric
    readers. Returns (the result line, [(number, value, limit)])."""
    import torch

    from gpubench import check, peaks, registry
    from gpubench.result import Run

    cell = registry.cell(bench, workload)
    cfg = registry.data("configs", cell["config"])
    traffic = registry.data("traffic", cell["traffic"])
    limits = registry.data("limits", cell["name"])
    torch.backends.cuda.matmul.allow_tf32 = cfg["allow_tf32"]
    torch.backends.cudnn.allow_tf32 = cfg["allow_tf32"]
    run = Run(workload=workload, cfg=cfg, traffic=traffic, seed=seed,
              seconds=seconds, trace=trace, device=device,
              program=registry.module("programs", cfg["model"]),
              model=registry.module("reference", cfg["model"]),
              clock=lambda: time.time() - START)
    res = registry.module("drivers", traffic["driver"]).run(run)
    res.peaks = peaks.peaks_for(kind)
    res.dtype = cfg["dtype"]

    ok, rows = check.judge(res.numbers, limits)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in registry.metrics_of(bench, workload, section):
        v = registry.module("metrics", m["name"]).read(res)
        if v is not None:
            metrics[m["name"]] = {"value": _finite(v), "unit": m["unit"]}
    dev = {"platform": "gpu", "kind": kind, "count": cell["chips"],
           "memory_peak_bytes": res.memory_peak_bytes}
    line = {"correct": ok and res.failed == 0, "attempted": res.attempted,
            "failed": res.failed, "metrics": metrics, "device": dev}
    if res.reduced is not None:
        dev.update(busy_s=res.reduced.busy_s, window_s=res.reduced.window_s)
        line["breakdown"] = res.reduced.breakdown()
        for names, (sec, ops) in sorted(res.reduced.spans.items(),
                                        key=lambda kv: -kv[1][0])[:12]:
            print(f"gpubench: spans {' | '.join(names) or '(none)'}: "
                  f"{sec!r} s in {ops} device operations", file=sys.stderr)
    line["compile_s"] = res.compile_s
    line["power_limit_w"] = (peaks.power_limit_w()
                             if torch.device(device).type == "cuda" else None)
    line["checks"] = {n: {"value": _finite(v), "limit": lim}
                      for n, v, lim in rows}
    print(f"gpubench: {workload} seed {seed}: {res.attempted} "
          f"{traffic['driver']} calls in the window, {res.failed} failed, "
          f"{len(res.latencies_s)} latencies; setup {res.setup_s!r} s "
          f"(compile {res.compile_s!r} s), window {res.window_s!r} s")
    return line, rows


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    from gpubench import registry

    # caches at fixed places inside the checkout: the kernel builders',
    # and Python's bytecode of every module imported from here on (the
    # installed torch compiles some 1,900 sources, about 9 s a run, where
    # its site-packages hold no bytecode and the environment asks for none
    # to be written)
    cache = registry.ROOT / ".gpubench_cache"
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    sys.pycache_prefix = str(cache / "pycache")
    sys.dont_write_bytecode = False

    import torch

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"gpubench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    line, rows = run_cell(bench, args.workload, args.seed, args.seconds,
                          bool(args.trace), device,
                          torch.cuda.get_device_name(device))
    from gpubench import guard

    found = guard.forbidden_modules()
    if found:
        print(f"gpubench: forbidden modules loaded: {found}", file=sys.stderr)
        return 4
    print(json.dumps(line), flush=True)
    for n, v, lim in rows:
        print(f"check {n} {v!r} limit {lim!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
