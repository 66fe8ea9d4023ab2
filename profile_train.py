"""Trace train steps on the GPU: where the device time goes.

Run from the repository root, on a machine with a CUDA card:

    python3 profile_train.py [--trace_dir DIR] [--optim NAME ...] [--mixed]
    python3 profile_train.py --bert4rec [--trace_dir DIR]

Builds the model that chip_smoke.py trains (bench.py's DLRMTrain at full
width, random weights from seed 0, fused lr 0.1, dense SGD at 0.05) for
each fused optimizer named by --optim (default: EXACT_SGD and
ROWWISE_ADAGRAD; any EmbOptimType name, e.g. ADAGRAD ADAM), takes 3
warm-up steps at B=8192, then
profiles STEPS steps with torch.profiler. For each optimizer it prints the
device time per kernel name and its share, the device busy share between
the first kernel's start and the last kernel's end, the device span and
host time of each phase of the step (`## train_* ##`, `## ebc_* ##` and
`## ec_* ##` labels) and the host time per step; the chrome traces go to
--trace_dir. Times are taken with the profiler on, which slows the host
side. With --bert4rec it profiles chip_smoke.py's BERT4Rec train step
instead (the example's model, ROWWISE_ADAGRAD at 0.01 and dense Adam at
1e-3, B=32). With --mixed it trains the DLRM under chip_smoke.py's
MIXED_PLAN inside an NCCL process group of one rank.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs
from profile_serving import summarize
from torchrec_tpu_torch.ops.fused_update import EmbOptimType

STEPS = 10  # profiled steps per optimizer, after 3 warm-up ones


def profile_steps(step, batches, title: str, trace: str,
                  trace_dir: str) -> None:
    """3 warm-up steps, then the rest profiled."""
    for batch in batches[:3]:
        step(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches[3:]:
            step(*batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"{title}:")
    summarize(prof, len(batches) - 3, "step", wall_ms)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, trace))


def profile_optim(optim, trace_dir: str, mixed: bool = False) -> None:
    with (cs.process_group_of_one() if mixed
          else contextlib.nullcontext()) as env:
        kw = {"env": env, "plan_types": cs.MIXED_PLAN} if mixed else {}
        dmp = cs.make_dmp("cuda", train=True, optim=optim, **kw).init(
            cs.SEED)
        rng = np.random.RandomState(cs.SEED + 2)
        batches = [cs.to_device(cs.make_batch(rng, cs.BENCH_BATCH))
                   for _ in range(STEPS + 3)]
        tag = "_mixed" if mixed else ""
        profile_steps(dmp.make_train_step(), batches,
                      f"train {optim.name} B={cs.BENCH_BATCH}"
                      f"{' mixed plan' if mixed else ''}",
                      f"train_trace{tag}_{optim.name}.json", trace_dir)


def profile_bert4rec(trace_dir: str) -> None:
    dmp = cs.make_b4r_dmp("cuda").init(cs.SEED)
    seqs = cs.b4r_sequences(np.random.RandomState(cs.SEED + 9))
    rng = np.random.RandomState(cs.SEED + 11)
    batches = [cs.b4r_train_batch(rng, seqs, cs.B4R_BATCH)
               for _ in range(STEPS + 3)]
    batches = [(kjt.to("cuda"), labels.to("cuda"))
               for kjt, labels in batches]
    profile_steps(dmp.make_train_step(), batches,
                  f"train BERT4Rec B={cs.B4R_BATCH}",
                  "train_trace_BERT4Rec.json", trace_dir)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace_dir", default="profile_traces")
    p.add_argument("--optim", nargs="+",
                   default=["EXACT_SGD", "ROWWISE_ADAGRAD"],
                   choices=[o.name for o in EmbOptimType],
                   help="fused optimizers to profile")
    p.add_argument("--bert4rec", action="store_true",
                   help="profile the BERT4Rec train step instead")
    p.add_argument("--mixed", action="store_true",
                   help="train the DLRM under the mixed plan inside an "
                        "NCCL group of one rank")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    optims = [EmbOptimType[name] for name in args.optim]
    card = cs.identify()
    if args.bert4rec:
        profile_bert4rec(args.trace_dir)
    else:
        for optim in optims:
            profile_optim(optim, args.trace_dir, args.mixed)
    print(card["smi"])


if __name__ == "__main__":
    main()
