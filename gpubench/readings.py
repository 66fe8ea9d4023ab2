"""The readings that a cell's limits are set from, on the card, in one
process (not part of a run):

    python3 -m gpubench.readings --workload <cell> --seeds S1 S2 ... \
        --reference-seeds R1 R2 R3 [--seconds 1] [--out FILE]

For each of `--seeds`, a sound run of the program (its driver's whole
run, with a short window: training compares the checked steps, scoring
the chunks of the window) gives the numbers it compares: the lower
readings. For each of `--reference-seeds`, the reference put in the
program's place, in the next lower precision (the control) and with each
fault the driver can plant there (its `REFERENCE_KINDS`), gives the upper
readings. One JSON
line a reading on standard output (and appended to `--out`).
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

import torch

from gpubench import registry
from gpubench.result import Run

def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--reference-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("gpubench.readings: needs a CUDA card", file=sys.stderr)
        return 3
    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)
    cfg = registry.data("configs", cell["config"])
    traffic = registry.data("traffic", cell["traffic"])
    driver = registry.module("drivers", traffic["driver"])
    device = torch.device("cuda", 0)
    start = time.time()

    def make(seed: int) -> Run:
        torch.backends.cuda.matmul.allow_tf32 = cfg["allow_tf32"]
        torch.backends.cudnn.allow_tf32 = cfg["allow_tf32"]
        return Run(workload=args.workload, cfg=cfg, traffic=traffic,
                   seed=seed, seconds=args.seconds, trace=False,
                   device=device,
                   program=registry.module("programs", cfg["model"]),
                   model=registry.module("reference", cfg["model"]),
                   clock=lambda: time.time() - start)

    def emit(kind: str, seed: int, numbers: dict) -> None:
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "numbers": numbers})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        gc.collect()
        torch.cuda.empty_cache()

    for seed in args.seeds:
        res = driver.run(make(seed))
        emit("program", seed, res.numbers)
    for seed in args.reference_seeds:
        for kind in driver.REFERENCE_KINDS:
            emit(kind, seed, driver.reference_numbers(make(seed), kind))
    return 0


if __name__ == "__main__":
    sys.exit(main())
