"""Trace served DLRM requests on the GPU: where the device time goes.

Run from the repository root, on a machine with a CUDA card:

    python3 profile_serving.py [--trace_dir DIR] [--bert4rec]

Builds the model that chip_smoke.py serves (bench.py's DLRM at full width,
random weights from seed 0), answers warm-up requests, then profiles
REQUESTS requests at B=8192 and at B=256 with torch.profiler. For each
batch size it prints the device time per kernel name and its share, the
device busy share between the first kernel's start and the last kernel's
end, the device span and host time of each `## ... ##` label (the sharded
modules' `## ebc_* ##` / `## ec_* ##`) and the host time per request; the
chrome traces go to --trace_dir.
Times are taken with the profiler on, which slows the host side. With
--bert4rec it serves chip_smoke.py's BERT4Rec instead, at B=32 and
B=1024.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

REQUESTS = 10  # profiled requests per batch size, after 2 warm-up ones


def summarize(prof, n: int, unit: str, wall_ms: float) -> None:
    """Print the device time of the profiled window per `unit` (request or
    step): busy share of the kernel span, kernel launches, the largest
    kernels, and the device span and host time of each `## ... ##`
    label."""
    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    # device-side ranges of record_function labels would count their
    # kernels twice
    kernels = [e for e in events if not e.is_user_annotation]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    span_us = (max(e.time_range.end for e in kernels)
               - min(e.time_range.start for e in kernels))
    print(f"{n} {unit}s, host {wall_ms / n:.3f} ms/{unit} (profiler on); "
          f"device busy {busy_us / n:.1f} us/{unit}, "
          f"{100 * busy_us / span_us:.1f}% of the kernel span; "
          f"{len(kernels) / n:.1f} kernel launches/{unit}")
    per_name = {}
    for e in kernels:
        per_name[e.name] = per_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(per_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / n:9.1f} us/{unit} {100 * us / busy_us:5.1f}%  "
              f"{name[:110]}")
    labels = {}
    for e in events:
        if e.is_user_annotation and e.name.startswith("##"):
            labels[e.name] = (labels.get(e.name, 0.0)
                              + e.time_range.elapsed_us())
    for name, us in sorted(labels.items(), key=lambda kv: -kv[1]):
        print(f"  {us / n:9.1f} us/{unit} span of {name}")
    host = {}
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name.startswith("##"):
            host[e.name] = host.get(e.name, 0.0) + e.time_range.elapsed_us()
    for name, us in sorted(host.items(), key=lambda kv: -kv[1]):
        print(f"  {us / n:9.1f} us/{unit} host time of {name}")


def profile_batch(answer, reqs, title: str, trace: str,
                  trace_dir: str) -> None:
    """answer(request) for 2 warm-up requests, then the rest profiled."""
    for req in reqs[:2]:
        answer(req)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for req in reqs[2:]:
            answer(req)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    print(f"{title}:")
    summarize(prof, len(reqs) - 2, "request", wall_ms)
    os.makedirs(trace_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(trace_dir, trace))


def profile_dlrm(trace_dir: str) -> None:
    eval_fn = cs.make_dmp("cuda").init(cs.SEED).make_eval_fn()
    rng = np.random.RandomState(cs.SEED)
    for batch in (cs.BENCH_BATCH, cs.SERVE_BATCH):
        reqs = [cs.make_request(rng, batch) for _ in range(REQUESTS + 2)]
        profile_batch(lambda r: eval_fn(r[0].cuda(), r[1].to("cuda")).cpu(),
                      reqs, f"B={batch}", f"serve_trace_B{batch}.json",
                      trace_dir)


def profile_bert4rec(trace_dir: str) -> None:
    eval_fn = cs.make_b4r_dmp("cuda").init(cs.SEED).make_eval_fn()
    seqs = cs.b4r_sequences(np.random.RandomState(cs.SEED + 9))
    rng = np.random.RandomState(cs.SEED + 10)
    for batch in (cs.B4R_BATCH, cs.B4R_RANK_BATCH):
        reqs = [cs.b4r_eval_batch(rng, seqs, batch)
                for _ in range(REQUESTS + 2)]
        profile_batch(lambda r: eval_fn(r[0].to("cuda"), r[1].to("cuda")),
                      reqs, f"BERT4Rec B={batch}",
                      f"serve_trace_BERT4Rec_B{batch}.json", trace_dir)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--trace_dir", default="profile_traces")
    p.add_argument("--bert4rec", action="store_true",
                   help="serve BERT4Rec instead of the DLRM")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")
    card = cs.identify()
    (profile_bert4rec if args.bert4rec else profile_dlrm)(args.trace_dir)
    print(card["smi"])


if __name__ == "__main__":
    main()
