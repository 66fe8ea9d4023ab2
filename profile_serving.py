"""Trace served DLRM requests on the GPU: where the device time goes.

Run from the repository root, on a machine with a CUDA card:

    python3 profile_serving.py [--trace_dir DIR] [--bert4rec | --mixed]

Builds the model that chip_smoke.py serves (bench.py's DLRM at full width,
random weights from seed 0), answers warm-up requests, then profiles
REQUESTS requests at B=8192 and at B=256 with torch.profiler. For each
batch size it prints the device time per kernel name and its share, the
device busy share between the first kernel's start and the last kernel's
end, the device span and host time of each `## ... ##` label (the sharded
modules' `## ebc_* ##` / `## ec_* ##`), the host ops with the most self
time and the host time per request; the chrome traces go to --trace_dir.
Times are taken with the profiler on, which slows the host side. With
--bert4rec it serves chip_smoke.py's BERT4Rec instead, at B=32 and
B=1024. With --mixed it serves the DLRM under chip_smoke.py's MIXED_PLAN
(four groups: DATA_PARALLEL, TABLE_WISE, COLUMN_WISE, ROW_WISE) inside an
NCCL process group of one rank, and then times each collective call of a
request on tensors of its shapes, without the profiler.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import chip_smoke as cs

REQUESTS = 10  # profiled requests per batch size, after 2 warm-up ones
HOST_OPS = 12  # host ops listed by self time
COMM_CALLS = 50  # timed calls per collective


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
    ops = sorted((e for e in prof.key_averages()
                  if not e.key.startswith("##")),
                 key=lambda e: -e.self_cpu_time_total)[:HOST_OPS]
    for e in ops:
        print(f"  {e.self_cpu_time_total / n:9.1f} us/{unit} host self time "
              f"of {e.key[:80]} ({e.count / n:.1f} calls/{unit})")


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


def _ms_per_call(fn, calls: int, sync_each: bool) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
        if sync_each:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def time_collectives(env, batch: int) -> None:
    """Host ms per call of each collective a mixed-plan request makes, on
    tensors of its shapes at `batch` (the largest group's 7 features),
    synchronized after each call and, apart, enqueued back to back: each
    `comm` function, then the bare torch.distributed call on contiguous
    dim-0 tensors, beside a synchronize alone."""
    import torch.distributed as dist

    from torchrec_tpu_torch.parallel import comm

    f = max(cs.MIXED_PLAN.count(t) for t in set(cs.MIXED_PLAN))
    ints = torch.zeros((f, batch, 2), dtype=torch.int32, device="cuda")
    vals = torch.zeros((f, batch, cs.DIM), device="cuda")
    flat_i = ints.reshape(-1).clone()
    flat_v = vals.reshape(-1).clone()
    out_i, out_v = torch.empty_like(flat_i), torch.empty_like(flat_v)
    work = {
        "all_gather of ids and lengths [F, B, 2], axis 1":
            lambda: comm.all_gather(env, ints, 1),
        "reduce_scatter [F, B, D], axis 1 (ROW_WISE)":
            lambda: comm.reduce_scatter(env, vals, 1),
        "all_to_all [F, B, D], split 1 concat 0 (TABLE_WISE)":
            lambda: comm.all_to_all(env, vals, 1, 0),
        "all_to_all [F, B, D], split 1 concat 2 (COLUMN_WISE)":
            lambda: comm.all_to_all(env, vals, 1, 2),
        "bare all_gather_into_tensor of the ids":
            lambda: dist.all_gather_into_tensor(out_i, flat_i,
                                                group=env.group),
        "bare reduce_scatter_tensor of [F, B, D]":
            lambda: dist.reduce_scatter_tensor(out_v, flat_v,
                                               group=env.group),
        "bare all_to_all_single of [F, B, D]":
            lambda: dist.all_to_all_single(out_v, flat_v, group=env.group),
        "torch.cuda.synchronize alone": lambda: None,
    }
    print(f"collectives at B={batch}, F={f} (host clock, {COMM_CALLS} "
          f"calls each, profiler off):")
    for name, fn in work.items():
        synced = _ms_per_call(fn, COMM_CALLS, True)
        queued = _ms_per_call(fn, COMM_CALLS, False)
        print(f"  {synced:8.4f} ms/call synchronized, {queued:8.4f} ms/call "
              f"enqueued: {name}")


def profile_dlrm(trace_dir: str, mixed: bool = False) -> None:
    with (cs.process_group_of_one() if mixed
          else contextlib.nullcontext()) as env:
        kw = {"env": env, "plan_types": cs.MIXED_PLAN} if mixed else {}
        eval_fn = cs.make_dmp("cuda", **kw).init(cs.SEED).make_eval_fn()
        rng = np.random.RandomState(cs.SEED)
        tag = "_mixed" if mixed else ""
        for batch in (cs.BENCH_BATCH, cs.SERVE_BATCH):
            reqs = [cs.make_request(rng, batch) for _ in range(REQUESTS + 2)]
            profile_batch(
                lambda r: eval_fn(r[0].cuda(), r[1].to("cuda")).cpu(), reqs,
                f"B={batch}{' mixed plan' if mixed else ''}",
                f"serve_trace{tag}_B{batch}.json", trace_dir)
        if mixed:
            for batch in (cs.BENCH_BATCH, cs.SERVE_BATCH):
                time_collectives(env, batch)


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
    p.add_argument("--mixed", action="store_true",
                   help="serve the DLRM under the mixed plan inside an "
                        "NCCL group of one rank")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving: no CUDA device")
    card = cs.identify()
    if args.bert4rec:
        profile_bert4rec(args.trace_dir)
    else:
        profile_dlrm(args.trace_dir, args.mixed)
    print(card["smi"])


if __name__ == "__main__":
    main()
