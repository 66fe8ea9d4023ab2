"""Time the fused rowwise-Adagrad kernel on the GPU against its slots per warp.

Run from the repository root, on a machine with a CUDA card:

    python3 profile_rowwise.py

Builds csrc/fused_update.cu, then:

1. holds the fused kernel (`fused_update_rowwise_adagrad` on its default
   route) bit-exact against its plain version at D = 4, 64, 96, 128, 256,
   384 and 512 (one to four 512-byte chunks per row) and D = 640 (the
   wide path: each row read in two passes), at weight decay 0 and 0.01, on
   5,000-row tables and 3,000 slots deduplicated from random ids;
2. launches the kernel, with the lanes per row `fused_geometry` gives,
   at every slot count a warp that those allow (1 to 32 at a warp a row;
   32 / lanes_per_row(D) to 32 on narrow rows) at three shapes, each value
   held bit-exact first, and prints the device time of each
   (torch.profiler, twice, in the order up then down) beside the bound
   and the scaled RMW's time on the same rows: the DLRM's (26 tables x
   100,000 rows x 128, one B=8192 batch of one id per table) and
   BERT4Rec's ([3712, 64], the B=32 batch a train step updates and a
   B=1024 one). `fused_geometry`'s pick is marked.

Ids, gradients and tables are drawn from seed 0.
"""

from __future__ import annotations

import time

import numpy as np
import torch

import chip_smoke as cs
from torchrec_tpu_torch.ops import fused_update as fu
from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.utils import tracing

def launch(lib, W, M, u, g, lr, slots, wd=0.0) -> None:
    """The fused kernel with its geometry's lanes per row and a given
    number of slots per warp."""
    R, D = W.shape
    group = fk.fused_geometry(D, u.numel())[0]
    err = lib.trt_fused_rowwise_adagrad_f32(
        W.data_ptr(), M.data_ptr(), u.data_ptr(), g.data_ptr(), R, D,
        u.numel(), group, slots, lr, 1e-8, wd,
        torch.cuda.current_stream().cuda_stream)
    fk.LIBRARY.check("fused_update_rowwise_adagrad", err)


def check_widths(gen, rng) -> None:
    R, N = 5000, 3000
    for D in (4, 64, 96, 128, 256, 384, 512, 640):
        W = torch.randn((R, D), device="cuda", generator=gen)
        M = torch.rand((R,), device="cuda", generator=gen)
        ids = torch.from_numpy(rng.randint(0, R, size=N).astype(np.int32))
        g = torch.randn((N, D), device="cuda", generator=gen)
        valid = torch.from_numpy(rng.rand(N) > 0.1)
        u, gd = fu.dedup_row_grads(ids.cuda(), g, valid.cuda(), R)
        for wd in (0.0, 0.01):
            before = tracing.counts()
            W1, W2, M1, M2 = W.clone(), W.clone(), M.clone(), M.clone()
            fk.fused_update_rowwise_adagrad(W1, M1, u, gd, 0.1,
                                            weight_decay=wd,
                                            momentum_stream=True)
            launched = {k: v - before.get(k, 0)
                        for k, v in tracing.counts().items()
                        if v != before.get(k, 0)}
            fk.fused_update_rowwise_adagrad_reference(
                W2, M2, u, gd, 0.1, weight_decay=wd, momentum_stream=True)
            cs._hold(f"D={D} wd={wd}", [(W1, W2), (M1, M2)])
            print(f"D={D} wd={wd}: bit-exact with the plain version; "
                  f"launched {launched}", flush=True)


def sweep(lib, gen, W, M, u, g, lr, what: str) -> None:
    R, D = W.shape
    N, n_real = u.numel(), int((u < R).sum())
    b = cs.rows_bound(N, n_real, D, rows_moved=3, extra_bytes=2 * n_real * 4,
                      flops_per_elem=7)
    counts = cs.slot_counts(D, "fused")
    for slots in counts:
        for wd in (0.0, 0.01):
            W1, W2, M1, M2 = W.clone(), W.clone(), M.clone(), M.clone()
            launch(lib, W1, M1, u, g, lr, slots, wd)
            fk.fused_update_rowwise_adagrad_reference(
                W2, M2, u, g, lr, weight_decay=wd, momentum_stream=True)
            cs._hold(f"{what} slots={slots} wd={wd}", [(W1, W2), (M1, M2)])
    W1, M1 = W.clone(), M.clone()
    times = {s: [] for s in counts}
    for order in (counts, counts[::-1]):
        for slots in order:
            times[slots].append(cs.device_ms(
                lambda: launch(lib, W1, M1, u, g, lr, slots),
                cs.ROWWISE_KERNELS, b["ms"]))
    scale = torch.rand(N, device="cuda", generator=gen) * -1e-3
    rmw = cs.device_ms(lambda: fk.scaled_row_update(W1, u, g, scale),
                       "row_update_kernel", b["ms"])
    pick = fk.fused_geometry(D, N)[1]
    print(f"{what}: N={N} slots, {n_real} real, D={D}; bound {b['ms']:.5f} "
          f"ms ({b['bytes']} B); the scaled RMW alone {rmw:.5f} ms; every "
          f"slots-per-warp value bit-exact", flush=True)
    for slots, ts in times.items():
        mark = "  <- fused_geometry" if slots == pick else ""
        print(f"  slots={slots:2d}: {ts[0]:.5f} / {ts[1]:.5f} ms, "
              f"{100 * b['ms'] / min(ts):.1f}% of the bound{mark}",
              flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_rowwise: no CUDA device")
    t0 = time.perf_counter()
    card = cs.identify()
    cs.build_kernels([fk.LIBRARY])
    lib = fk.LIBRARY.load()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    rng = np.random.RandomState(cs.SEED)
    check_widths(gen, rng)

    R, D = 2_600_064, cs.DIM
    W = torch.randn((R, D), device="cuda", generator=gen) * 0.01
    M = torch.rand((R,), device="cuda", generator=gen) * 0.01
    offs = np.repeat(np.arange(cs.NUM_TABLES) * cs.ROWS, cs.BENCH_BATCH)
    ids = rng.randint(0, cs.ROWS, size=offs.size) + offs
    ids = torch.from_numpy(ids.astype(np.int32)).cuda()
    g = torch.randn((ids.numel(), D), device="cuda", generator=gen) * 1e-3
    u, gd = fu.dedup_row_grads(ids, g, torch.ones_like(ids, dtype=torch.bool),
                               R)
    sweep(lib, gen, W, M, u, gd, cs.FUSED_LR, "DLRM")
    del W, M, g, gd

    R, D = 3712, cs.B4R_DIM
    W = torch.randn((R, D), device="cuda", generator=gen) * 0.05
    M = torch.rand((R,), device="cuda", generator=gen) * 0.01
    seqs = cs.b4r_sequences(np.random.RandomState(cs.SEED + 9))
    for batch in (cs.B4R_BATCH, 1024):
        kjt, _ = cs.b4r_train_batch(rng, seqs, batch)
        ids = kjt.values.to("cuda", torch.int32)
        g = torch.randn((ids.numel(), D), device="cuda", generator=gen) * 1e-3
        u, gd = fu.dedup_row_grads(
            ids, g, torch.ones_like(ids, dtype=torch.bool), R)
        sweep(lib, gen, W, M, u, gd, cs.B4R_EMB_LR, f"BERT4Rec B={batch}")
    print(card["smi"])
    print(f"profile_rowwise: done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
