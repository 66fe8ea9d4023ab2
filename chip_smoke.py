"""Drive the PyTorch + CUDA port (torchrec_tpu_torch) on one GPU.

Run from the repository root:

    python3 chip_smoke.py

Phases, each failing the run with a non-zero exit when it fails:

1. Identify the card (name, count, power limit); TF32 is switched off.
2. Build the K1 kernel (csrc/tbe_lookup.cu) with nvcc for sm_90a.
3. Serve the DLRM that bench.py and bench_config.py describe, at full
   width, through the port's DistributedModelParallel.make_eval_fn:
   26 fp32 tables of 100,000 x 128 (ROW_WISE on one device), dense arch
   13 -> 512-256-128, over arch 1024-1024-512-256-1, one id per feature.
   Requests at B=8192 (the bench batch) and B=256 (the serving example's
   default), made from a seed with numpy. Each request must launch K1
   exactly once; logits must be finite and, for one B=256 request, equal
   the same model's logits on the CPU.
4. Hold K1 against its plain PyTorch version on the card, on the served
   model's table at the main path's shape (bit-exact at L=1) and at L=20
   with MEAN / per-sample coefficients and out-of-range ids (rtol 1e-6),
   and time the kernel, the plain version and F.embedding_bag.

The line before the last is a JSON object with every kernel's numbers;
the last line is {"ok": true, "device": {...}}. Without a CUDA device, or
outside a checkout of the repository, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

# bench_config.py's DLRM (copied, not imported: the port reads nothing of
# the JAX package's files)
NUM_TABLES = 26
ROWS = 100_000
DIM = 128
DENSE_IN = 13
DENSE_ARCH = (512, 256, DIM)
OVER_ARCH = (1024, 1024, 512, 256, 1)
L = 1
BENCH_BATCH = 8192  # bench_config.B
SERVE_BATCH = 256  # examples/dlrm_predict.py --batch_size default
REQUESTS_PER_BATCH = 3
SEED = 0

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM fp32 outside the tensor cores
MODULE_KEY = "sparse_arch/embedding_bag_collection"
DEVICE = "cuda"


def log(*args) -> None:
    print(*args, flush=True)


def identify() -> dict:
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    log(f"device: {name} count={torch.cuda.device_count()} "
        f"torch={torch.__version__} cuda={torch.version.cuda}")
    log(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"name": name, "smi": smi}


def build_kernels(tl) -> None:
    info = tl.build(force=True)
    log(f"built {info['path']} in {info['seconds']:.2f} s")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  " + line.strip())


def make_dmp(device: str):
    from torchrec_tpu_torch.models import DLRM
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    tables = [
        EmbeddingBagConfig(num_embeddings=ROWS, embedding_dim=DIM,
                           name=f"t{i}", feature_names=[f"f{i}"])
        for i in range(NUM_TABLES)
    ]
    model = DLRM(
        EmbeddingBagCollection(tables, max_feature_length=L, device="meta"),
        DENSE_IN, DENSE_ARCH, OVER_ARCH, device="meta",
    )
    plan = ShardingPlan({MODULE_KEY: {
        t.name: ParameterSharding(ShardingType.ROW_WISE) for t in tables}})
    return DistributedModelParallel(model, plan=plan, device=device)


def make_request(rng: np.random.RandomState, batch: int):
    """(dense [B, 13] f32, KeyedJaggedTensor of 26 features x B x 1)."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    ids = rng.randint(0, ROWS, size=NUM_TABLES * batch).astype(np.int32)
    lengths = np.ones(NUM_TABLES * batch, np.int32)
    dense = rng.randn(batch, DENSE_IN).astype(np.float32)
    kjt = KeyedJaggedTensor.from_lengths(
        [f"f{i}" for i in range(NUM_TABLES)], ids, lengths)
    return torch.from_numpy(dense), kjt


def serve(dmp, tl) -> dict:
    """The main path: requests through make_eval_fn, K1 counted."""
    eval_fn = dmp.make_eval_fn()
    rng = np.random.RandomState(SEED)
    requests = [(b, *make_request(rng, b))
                for b in [BENCH_BATCH] * REQUESTS_PER_BATCH
                + [SERVE_BATCH] * REQUESTS_PER_BATCH]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tl.LAUNCHES = 0
    latencies = {BENCH_BATCH: [], SERVE_BATCH: []}
    last = None
    for batch, dense, kjt in requests:
        t0 = time.perf_counter()
        logits = eval_fn(dense.to(DEVICE), kjt.to(DEVICE)).cpu()
        latencies[batch].append((time.perf_counter() - t0) * 1e3)
        if logits.shape != (batch, 1) or not torch.isfinite(logits).all():
            raise AssertionError(
                f"bad logits at B={batch}: {tuple(logits.shape)}")
        last = (dense, kjt, logits)
    launches = tl.LAUNCHES
    if launches != len(requests):
        raise AssertionError(
            f"K1 launched {launches} times for {len(requests)} requests")
    peak = torch.cuda.max_memory_allocated()
    for batch, ms in latencies.items():
        log(f"serve B={batch}: request ms (host clock, H2D + forward + "
            f"D2H, first includes warm-up) {ms}")
    log(f"serve: {len(requests)} requests, K1 launches {launches}, "
        f"max_memory_allocated {peak} B")

    # forward alone on device-resident inputs, after the warm-up above
    fwd = {}
    for batch in (BENCH_BATCH, SERVE_BATCH):
        dense, kjt = make_request(rng, batch)
        dense, kjt = dense.to(DEVICE), kjt.to(DEVICE)
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            eval_fn(dense, kjt)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        fwd[batch] = times
        log(f"serve B={batch}: forward ms (host clock, synchronized) "
            f"{times}")
    return {"launches": launches, "last": last, "peak_bytes": peak,
            "request_ms": latencies, "forward_ms": fwd}


def check_against_cpu(dmp, last) -> None:
    dense, kjt, logits = last
    cpu = make_dmp("cpu")
    cpu.load_state_dict(dmp.state_dict())
    ref = cpu.make_eval_fn()(dense, kjt.to("cpu"))
    torch.testing.assert_close(logits, ref, rtol=1e-4, atol=1e-5)
    log(f"serve B={dense.shape[0]}: GPU logits match the CPU run, max abs "
        f"diff {(logits - ref).abs().max().item():.3e}")


def cuda_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(weights, ids, coeff) -> dict:
    """Least time for the lookup: bytes (each input read once, each output
    written once; only the distinct rows that a nonzero coefficient
    reads) over HBM rate, against 2 flops per pooled element over the fp32
    rate."""
    R, D = weights.shape
    NB, Lk = ids.shape
    live = ids.clamp(0, R - 1)[coeff != 0]
    rows = int(torch.unique(live).numel())
    nbytes = rows * D * 4 + ids.numel() * 4 + coeff.numel() * 4 + NB * D * 4
    flops = 2 * int(live.numel()) * D
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS
    return {"bytes": nbytes, "rows": rows, "flops": flops,
            "ms": max(t_bytes, t_ops) * 1e3,
            "by": "bytes" if t_bytes >= t_ops else "operations"}


def check_kernel(dmp, tl) -> dict:
    """K1 on the served table: main-path shape, then L=20."""
    import torch.nn.functional as F

    strat = dmp.sharded_ebcs[MODULE_KEY].strategies[0]
    W = strat.weights[0]  # [2,600,064, 128]: 26 x 100,000 padded to 128
    R, D = W.shape
    rng = np.random.RandomState(SEED + 1)
    NB = NUM_TABLES * BENCH_BATCH
    offs = np.repeat(strat.local_offsets.astype(np.int32), BENCH_BATCH)
    ids = torch.from_numpy(
        (rng.randint(0, ROWS, size=NB).astype(np.int32) + offs)[:, None]
    ).to(DEVICE)
    coeff = torch.ones((NB, 1), device=DEVICE)
    out = tl.tbe_lookup_pooled(W, ids, coeff)
    ref = tl.tbe_lookup_pooled_reference(W, ids, coeff)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("K1 at L=1 is not bit-exact with its plain "
                             "version")
    err = (out - ref).abs().max().item()
    log(f"K1 L=1 NB={NB} D={D}: bit-exact with the plain version")

    # L=20: per-sample weights, MEAN rows, zero-padded slots, ids >= R
    L20 = 20
    ids20 = torch.from_numpy(
        rng.randint(0, R + 1000, size=(NB, L20)).astype(np.int32)).to(DEVICE)
    lengths = torch.from_numpy(rng.randint(0, L20 + 1, size=NB)).to(DEVICE)
    mask = (torch.arange(L20, device=DEVICE)[None, :] < lengths[:, None])
    psw = torch.from_numpy(rng.rand(NB, L20).astype(np.float32)).to(DEVICE)
    mean = mask / lengths.clamp(min=1)[:, None]
    coeff20 = torch.where(
        torch.arange(NB, device=DEVICE)[:, None] % 2 == 0,
        mean, mask * psw).float().contiguous()
    out20 = tl.tbe_lookup_pooled(W, ids20, coeff20)
    ref20 = tl.tbe_lookup_pooled_reference(W, ids20, coeff20)
    torch.testing.assert_close(out20, ref20, rtol=1e-6, atol=1e-6)
    err20 = (out20 - ref20).abs().max().item()
    log(f"K1 L=20: within rtol=atol=1e-6 of the plain version, max abs "
        f"err {err20:.3e}")
    del ref20

    b = bound(W, ids, coeff)
    ms = cuda_ms(lambda: tl.tbe_lookup_pooled(W, ids, coeff))
    plain_ms = cuda_ms(lambda: tl.tbe_lookup_pooled_reference(W, ids, coeff))
    lib_ms = cuda_ms(lambda: F.embedding_bag(
        ids, W, mode="sum", per_sample_weights=coeff))
    log(f"K1 L=1: {ms:.4f} ms; plain {plain_ms:.4f} ms; F.embedding_bag "
        f"{lib_ms:.4f} ms; bound {b['ms']:.4f} ms ({b['by']}: "
        f"{b['bytes']} B with {b['rows']} distinct rows); kernel at "
        f"{100 * b['ms'] / ms:.1f}% of the bound")
    b20 = bound(W, ids20, coeff20)
    ms20 = cuda_ms(lambda: tl.tbe_lookup_pooled(W, ids20, coeff20), iters=20)
    log(f"K1 L=20: {ms20:.4f} ms; bound {b20['ms']:.4f} ms ({b20['by']}); "
        f"kernel at {100 * b20['ms'] / ms20:.1f}% of the bound")
    return {"max_abs_err": max(err, err20), "ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": b["ms"], "bound_by": b["by"]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    from torchrec_tpu_torch.ops import tbe_lookup as tl

    card = identify()
    build_kernels(tl)
    t0 = time.perf_counter()
    dmp = make_dmp(DEVICE).init(SEED)
    torch.cuda.synchronize()
    log(f"DLRM built and initialised on the card in "
        f"{time.perf_counter() - t0:.2f} s")
    served = serve(dmp, tl)
    check_against_cpu(dmp, served["last"])
    k1 = check_kernel(dmp, tl)
    log(card["smi"])
    log(json.dumps({"kernels": [{
        "name": "tbe_lookup_pooled",
        "route": "cuda",
        "source": "torchrec_tpu_torch/csrc/tbe_lookup.cu",
        "replaces": "torchrec_tpu/ops/pallas_embedding.py:298",
        "launches": served["launches"],
        **k1,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card["name"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
