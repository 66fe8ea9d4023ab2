"""Time two builds of the update kernels against each other on one GPU.

Run from the repository root, on a machine with a CUDA card:

    python3 compare_update_kernels.py OTHER_CHECKOUT [--dim D]

Builds this checkout's torchrec_tpu_torch/csrc/fused_update.cu and
OTHER_CHECKOUT's (a tree with the same C entry points, say a parent commit
unpacked with `git archive`), then, at the DLRM's training shape (26
tables of 100,000 rows of D columns, D=128 by default, and one B=8192
batch of one uniform id per table: 212,992 slots), runs K2, K3, K4's
scaled RMW, the fused K4, K5, K6, K7, K3h and K4h (bf16) of each build
through this checkout's wrappers. Each kernel's two results are held bit
for bit, then each build is timed in turns (other, this, this, other; the
device time of torch.profiler through chip_smoke.device_ms) and printed
beside the kernel's bound, with the card's name and power limit. An
OTHER_CHECKOUT older than the masked path takes only D % 4 == 0.
"""

from __future__ import annotations

import argparse
import contextlib
import json
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from torchrec_tpu_torch.ops import fused_update as fu
from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.ops.cuda_build import CudaLibrary

TABLES, ROWS, BATCH, LR = 26, 100_000, 8192, 0.1
DEVICE = "cuda"


@contextlib.contextmanager
def using(lib: CudaLibrary):
    """The wrappers launch `lib`'s kernels while open."""
    saved = fk.LIBRARY
    fk.LIBRARY = lib
    try:
        yield
    finally:
        fk.LIBRARY = saved


def inputs(D: int) -> dict:
    """The table, momenta and one batch's run totals and dedup output."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(cs.SEED)
    R = TABLES * ROWS
    W = torch.randn((R, D), generator=gen, device=DEVICE) * 0.1
    rng = np.random.RandomState(cs.SEED)
    flat = np.concatenate([rng.randint(0, ROWS, BATCH) + t * ROWS
                           for t in range(TABLES)]).astype(np.int32)
    flat = torch.from_numpy(flat).to(DEVICE)
    grads = torch.randn((flat.numel(), D), generator=gen, device=DEVICE)
    grads *= 1e-3
    valid = torch.ones(flat.numel(), dtype=torch.bool, device=DEVICE)
    u_rt, g_rt = fu.run_total_row_grads(flat, grads, valid, R)
    u_dd, g_dd = fu.dedup_row_grads(flat, grads, valid, R)
    rows = W[u_rt.clamp(max=R - 1).long()] - LR * g_rt
    scale = torch.rand(u_dd.numel(), generator=gen, device=DEVICE) * -1e-3
    return {"W": W, "Wh": W.to(torch.bfloat16),
            "M": torch.rand((R,), generator=gen, device=DEVICE),
            "M1": torch.rand((R, D), generator=gen, device=DEVICE) * 0.01,
            "M2": torch.rand((R, D), generator=gen, device=DEVICE) * 0.01,
            "step": torch.full((), 6, dtype=torch.int32, device=DEVICE),
            "u_rt": u_rt, "g_rt": g_rt, "u_dd": u_dd, "g_dd": g_dd,
            "rows": rows, "scale": scale,
            "g_sq": fk.row_mean_sq(g_dd) * (u_dd < R).to(torch.float32)}


def cases(x: dict) -> dict:
    """kernel -> (state names, call on the state, profiler name, bound
    args: rows moved per real slot, extra bytes per real slot, row bytes,
    slots)."""
    u_rt, g_rt, u_dd, g_dd = x["u_rt"], x["g_rt"], x["u_dd"], x["g_dd"]
    step = x["step"]
    return {
        "K2": (("W",), lambda w: fk.scatter_rows_write(w, u_rt, x["rows"]),
               "row_update_kernel", (2, 0, 4, "rt")),
        "K3": (("W",), lambda w: fk.fused_update_sgd(w, u_rt, g_rt, LR),
               "row_update_kernel", (3, 0, 4, "rt")),
        "K4 scaled RMW": (("W",), lambda w: fk.scaled_row_update(
            w, u_dd, g_dd, x["scale"]), "row_update_kernel",
            (3, 0, 4, "dd")),
        "K4": (("W", "M"), lambda w, m: fk.fused_update_rowwise_adagrad(
            w, m, u_dd, g_dd, LR, momentum_stream=True),
            cs.ROWWISE_KERNELS, (3, 8, 4, "dd")),
        "K5": (("M",), lambda m: fk.rowwise_momentum_stream(
            m, u_dd, x["g_sq"]), "rowwise_momentum_kernel", None),
        "K6": (("W", "M1"), lambda w, m: fk.fused_update_adagrad(
            w, m, u_rt, g_rt, LR), "moment_update_kernel", (5, 0, 4, "rt")),
        "K7": (("W", "M1", "M2"), lambda w, m1, m2: fk.fused_update_adam(
            w, m1, m2, u_rt, g_rt, LR, step), "moment_update_kernel",
            (7, 0, 4, "rt")),
        "K3h": (("Wh",), lambda w: fk.fused_update_sgd_half(
            w, u_rt, g_rt, LR, step), "sgd_half_kernel", (2, 0, 2, "rt")),
        "K4h": (("Wh", "M"), lambda w, m:
                fk.fused_update_rowwise_adagrad_half(w, m, u_dd, g_dd, LR,
                                                     step),
                cs.ROWWISE_KERNELS, (2, 8, 2, "dd")),
    }


def bound_ms(x: dict, spec, D: int) -> float:
    """The least time: the slots' ids, `rows` rows of D elements of
    `row_bytes` and `extra` bytes (a momentum word read and written) per
    real slot, and the half kernels' 4-byte g row, over the HBM rate."""
    R = x["W"].shape[0]
    if spec is None:  # K5: chip_smoke's own bound
        N = int(x["u_dd"].numel())
        return cs.k5_bound(N, int((x["u_dd"] < R).sum()))["ms"]
    rows, extra, row_bytes, form = spec
    u = x["u_rt"] if form == "rt" else x["u_dd"]
    n_real = int((u < R).sum())
    g_bytes = n_real * D * 4 if row_bytes == 2 else 0
    return cs.rows_bound(int(u.numel()), n_real, D, rows,
                         extra_bytes=n_real * extra + g_bytes,
                         row_bytes=row_bytes)["ms"]


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other", help="a checkout whose fused_update.cu to time")
    p.add_argument("--dim", type=int, default=128)
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("compare_update_kernels: needs a CUDA card")
    source = (Path(args.other) / "torchrec_tpu_torch" / "csrc"
              / "fused_update.cu").resolve()
    other = CudaLibrary(str(source), fk._bind)
    card = cs.identify()
    cs.build_kernels([fk.LIBRARY, other])
    x = inputs(args.dim)
    out = {}
    for name, (names, call, kernel, spec) in cases(x).items():
        got = {}
        for tag, lib in (("other", other), ("this", fk.LIBRARY)):
            state = [x[n].clone() for n in names]
            with using(lib):
                call(*state)
            got[tag] = state
        cs._hold(f"{name}: this build against the other",
                 list(zip(got["this"], got["other"])))
        state = got["this"]
        times = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            with using(other if tag == "other" else fk.LIBRARY):
                times[tag].append(cs.device_ms(lambda: call(*state), kernel))
        b = bound_ms(x, spec, args.dim)
        out[name] = {"this_ms": times["this"], "other_ms": times["other"],
                     "bound_ms": b}
        cs.log(f"{name} D={args.dim}: this {times['this']} ms, other "
               f"{times['other']} ms (device time, in turns: other, this, "
               f"this, other), bit for bit; bound {b:.5f} ms")
    cs.log(card["smi"])
    cs.log(json.dumps({"dim": args.dim, "kernels": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
