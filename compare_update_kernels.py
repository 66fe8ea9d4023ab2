"""Time two builds of the embedding kernels against each other on one GPU,
or the row kernel against its slots per warp.

Run from the repository root, on a machine with a CUDA card:

    python3 compare_update_kernels.py OTHER_CHECKOUT [--dim D]
    python3 compare_update_kernels.py --sweep [--dim D]

The first form builds this checkout's torchrec_tpu_torch/csrc/tbe_lookup.cu
and fused_update.cu and OTHER_CHECKOUT's (another tree of the repository,
say a parent commit unpacked with `git archive`). Each build is launched
through its own tree's wrappers (ops/tbe_lookup.py and
ops/fused_update_kernels.py, loaded from that tree), so the two may differ
in their C entry points. At the DLRM's training shape (26 tables of
100,000 rows of D columns, D=128 by default, and one B=8192 batch of one
uniform id per table: 212,992 bags and slots) it runs K1 and K1h (bf16)
over the batch, then K2, K3, K4's scaled RMW, the fused K4, K5, K6, K7,
K3h and K4h (bf16) on its run totals and dedup output. Each kernel's two
results are held bit for bit, then each build is timed in turns (other,
this, this, other; the device time of torch.profiler through
chip_smoke.device_ms) and printed beside the kernel's bound, with the
card's name and power limit. An OTHER_CHECKOUT older than the masked path
takes only D % 4 == 0.

The second form (--sweep) times this checkout's row kernel of K2, K3 and
K4's scaled RMW against the slots a warp takes, on the table as it is and
one element into its storage (the masked path), at the same shape and at
the D=10 DeepFM's (the 26 Criteo Kaggle tables of
chip_smoke.kaggle_lookup and one B=8192 batch: 212,992 slots, about
94,000 distinct rows): every power of two from the warp's lane groups (32
/ lanes_per_row(D)) to 32, each held bit for bit with the plain version
first, timed in the order up and then down. `row_slots_per_warp`'s pick
is marked.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from torchrec_tpu_torch.ops import fused_update as fu
from torchrec_tpu_torch.ops import fused_update_kernels as fk
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.ops.cuda_build import CudaLibrary

TABLES, ROWS, BATCH, LR = 26, 100_000, 8192, 0.1
DEVICE = "cuda"
# wrapper module -> its kernel source
WRAPPERS = {"fused_update_kernels": "fused_update.cu",
            "tbe_lookup": "tbe_lookup.cu"}


def load_wrappers(root: Path) -> dict:
    """`root`'s wrapper modules, loaded from its files under their own
    names, each launching `root`'s build of its kernel source."""
    out = {}
    for name, source in WRAPPERS.items():
        path = root / "torchrec_tpu_torch" / "ops" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(f"other_{name}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        src = (root / "torchrec_tpu_torch" / "csrc" / source).resolve()
        mod.LIBRARY = CudaLibrary(str(src), mod._bind)
        out[name] = mod
    return out


def inputs(D: int, kaggle: bool = False) -> dict:
    """The table, one batch's ids and its run totals and dedup output:
    the DLRM's tables, or with `kaggle` the 26 Criteo Kaggle tables and
    batch of chip_smoke.kaggle_lookup (the D=10 DeepFM's shape; 212,992
    slots, about 94,000 distinct rows)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(cs.SEED)
    if kaggle:
        W, ids, _, _, _ = cs.kaggle_lookup(D, cs.SEED + 71)
        flat = ids.reshape(-1)
    else:
        W = torch.randn((TABLES * ROWS, D), generator=gen,
                        device=DEVICE) * 0.1
        rng = np.random.RandomState(cs.SEED)
        flat = np.concatenate([rng.randint(0, ROWS, BATCH) + t * ROWS
                               for t in range(TABLES)]).astype(np.int32)
        flat = torch.from_numpy(flat).to(DEVICE)
    R = W.shape[0]
    grads = torch.randn((flat.numel(), D), generator=gen, device=DEVICE)
    grads *= 1e-3
    valid = torch.ones(flat.numel(), dtype=torch.bool, device=DEVICE)
    u_rt, g_rt = fu.run_total_row_grads(flat, grads, valid, R)
    u_dd, g_dd = fu.dedup_row_grads(flat, grads, valid, R)
    rows = W[u_rt.clamp(max=R - 1).long()] - LR * g_rt
    scale = torch.rand(u_dd.numel(), generator=gen, device=DEVICE) * -1e-3
    return {"W": W, "gen": gen, "ids": flat[:, None].contiguous(),
            "u_rt": u_rt, "g_rt": g_rt, "u_dd": u_dd, "g_dd": g_dd,
            "rows": rows, "scale": scale}


def with_state(x: dict) -> dict:
    """`inputs` with what the other kernels take: a bf16 copy of the
    table, momenta, the step and K5's g_sq."""
    W, gen, u_dd = x["W"], x["gen"], x["u_dd"]
    R, D = W.shape
    return {**x, "Wh": W.to(torch.bfloat16),
            "M": torch.rand((R,), generator=gen, device=DEVICE),
            "M1": torch.rand((R, D), generator=gen, device=DEVICE) * 0.01,
            "M2": torch.rand((R, D), generator=gen, device=DEVICE) * 0.01,
            "step": torch.full((), 6, dtype=torch.int32, device=DEVICE),
            "coeff": torch.ones(x["ids"].shape, device=DEVICE),
            "g_sq": fk.row_mean_sq(x["g_dd"]) * (u_dd < R).to(torch.float32)}


def row_cases(x: dict) -> dict:
    """The row kernel's three uses: kernel -> (call(wrappers, W), the plain
    version on W, bound spec)."""
    u_rt, g_rt, u_dd, g_dd = x["u_rt"], x["g_rt"], x["u_dd"], x["g_dd"]
    rows, scale = x["rows"], x["scale"]
    return {
        "K2": (lambda m, w: m.scatter_rows_write(w, u_rt, rows),
               lambda w: fk.scatter_rows_write_reference(w, u_rt, rows),
               (2, 0, 4, "rt")),
        "K3": (lambda m, w: m.fused_update_sgd(w, u_rt, g_rt, LR),
               lambda w: fk.fused_update_sgd_reference(w, u_rt, g_rt, LR),
               (3, 0, 4, "rt")),
        "K4 scaled RMW": (
            lambda m, w: m.scaled_row_update(w, u_dd, g_dd, scale),
            lambda w: fk.scaled_row_update_reference(w, u_dd, g_dd, scale),
            (3, 4, 4, "dd")),
    }


def cases(x: dict) -> dict:
    """kernel -> (state names, call(wrappers, *state), profiler name, bound
    spec: rows moved per real slot, extra bytes per real slot, row bytes,
    slots; or a callable giving the bound in ms). `wrappers` maps a module
    name of WRAPPERS to a build's module. K1 and K1h are held on what they
    return, the others on their state."""
    u_rt, g_rt, u_dd, g_dd = x["u_rt"], x["g_rt"], x["u_dd"], x["g_dd"]
    ids, coeff, step = x["ids"], x["coeff"], x["step"]
    out = {
        k: (("W" if dtype == torch.float32 else "Wh",),
            lambda m, w: m["tbe_lookup"].tbe_lookup_pooled(w, ids, coeff),
            cs.K1_KERNELS,
            lambda dtype=dtype: cs.bound(
                x["W" if dtype == torch.float32 else "Wh"], ids,
                coeff)["ms"])
        for k, dtype in (("K1", torch.float32), ("K1h", torch.bfloat16))}
    for k, (call, _, spec) in row_cases(x).items():
        out[k] = (("W",), lambda m, w, call=call:
                  call(m["fused_update_kernels"], w), "row_update_kernel",
                  spec)
    out.update({
        "K4": (("W", "M"), lambda m, w, mm: m["fused_update_kernels"]
               .fused_update_rowwise_adagrad(w, mm, u_dd, g_dd, LR,
                                             momentum_stream=True),
               cs.ROWWISE_KERNELS, (3, 8, 4, "dd")),
        "K5": (("M",), lambda m, mm: m["fused_update_kernels"]
               .rowwise_momentum_stream(mm, u_dd, x["g_sq"]),
               "rowwise_momentum_kernel", None),
        "K6": (("W", "M1"), lambda m, w, m1: m["fused_update_kernels"]
               .fused_update_adagrad(w, m1, u_rt, g_rt, LR),
               "moment_update_kernel", (5, 0, 4, "rt")),
        "K7": (("W", "M1", "M2"), lambda m, w, m1, m2:
               m["fused_update_kernels"].fused_update_adam(
                   w, m1, m2, u_rt, g_rt, LR, step),
               "moment_update_kernel", (7, 0, 4, "rt")),
        "K3h": (("Wh",), lambda m, w: m["fused_update_kernels"]
                .fused_update_sgd_half(w, u_rt, g_rt, LR, step),
                "sgd_half_kernel", (2, 0, 2, "rt")),
        "K4h": (("Wh", "M"), lambda m, w, mm: m["fused_update_kernels"]
                .fused_update_rowwise_adagrad_half(w, mm, u_dd, g_dd, LR,
                                                   step),
                cs.ROWWISE_KERNELS, (2, 8, 2, "dd")),
    })
    return out


def bound_ms(x: dict, spec, D: int) -> float:
    """The least time: the slots' ids, `rows` rows of D elements of
    `row_bytes` and `extra` bytes (a momentum word read and written, a
    scale read) per real slot, and the half kernels' 4-byte g row, over the
    HBM rate."""
    R = x["W"].shape[0]
    if callable(spec):
        return spec()
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


def compare(other: dict, x: dict, D: int) -> dict:
    """Every case of `cases` on both builds: held bit for bit, then timed
    in turns."""
    this = {"fused_update_kernels": fk, "tbe_lookup": tl}
    out = {}
    for name, (names, call, kernel, spec) in cases(x).items():
        got = {}
        for tag, mods in (("other", other), ("this", this)):
            state = [x[n].clone() for n in names]
            res = call(mods, *state)
            got[tag] = [res] if name in ("K1", "K1h") else state
        cs._hold(f"{name}: this build against the other",
                 list(zip(got["this"], got["other"])))
        state = [x[n].clone() for n in names]
        times = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            mods = other if tag == "other" else this
            times[tag].append(cs.device_ms(lambda: call(mods, *state),
                                           kernel))
        b = bound_ms(x, spec, D)
        out[name] = {"this_ms": times["this"], "other_ms": times["other"],
                     "bound_ms": b}
        cs.log(f"{name} D={D}: this {times['this']} ms, other "
               f"{times['other']} ms (device time, in turns: other, this, "
               f"this, other), bit for bit; bound {b:.5f} ms")
    return out


def sweep(x: dict, D: int, what: str) -> dict:
    """The row kernel's uses timed against their slots per warp, on the
    table as it is (whole quads, or pairs at an even D) and on copies of
    the table and the gradient rows one element into their storage (the
    masked path)."""
    N = int(x["u_rt"].numel())
    counts = cs.slot_counts(D)
    pick = fk.row_slots_per_warp(D)
    inputs_at = {0: x, 1: {**x, **{k: cs._placed(x[k], 1)
                                    for k in ("g_rt", "g_dd", "rows")}}}
    out = {}
    for name in row_cases(x):
        times = {off: {s: [] for s in counts} for off in inputs_at}
        for off, xo in inputs_at.items():
            call, plain, spec = row_cases(xo)[name]
            ref = cs._placed(x["W"], off)
            plain(ref)
            for slots in counts:
                w = cs._placed(x["W"], off)
                with cs.row_slots(fk, slots):
                    call(fk, w)
                cs._hold(f"{name} D={D} at {slots} slots a warp, offset "
                         f"{off}", [(w, ref)])
            del ref
        ws = {off: cs._placed(x["W"], off) for off in inputs_at}
        for order in (counts, counts[::-1]):
            for slots in order:
                for off, xo in inputs_at.items():
                    call = row_cases(xo)[name][0]
                    with cs.row_slots(fk, slots):
                        times[off][slots].append(cs.device_ms(
                            lambda: call(fk, ws[off]), "row_update_kernel"))
        b = bound_ms(x, row_cases(x)[name][2], D)
        cs.log(f"{name} D={D} ({what}): N={N} slots, lanes per row "
               f"{fk.row_geometry(D)[0]}; bound {b:.5f} ms; every slot "
               f"count bit for bit with the plain version; ms up / down, "
               f"the table as it is, then one element in (masked)")
        for slots in counts:
            t0, t1 = times[0][slots], times[1][slots]
            mark = "  <- row_slots_per_warp" if slots == pick else ""
            cs.log(f"  slots={slots:2d}: {t0[0]:.5f} / {t0[1]:.5f} ms, "
                   f"{100 * b / min(t0):.1f}% of the bound; masked "
                   f"{t1[0]:.5f} / {t1[1]:.5f} ms{mark}")
        out[name] = {"bound_ms": b, "pick": pick,
                     "ms": {str(s): times[0][s] for s in counts},
                     "masked_ms": {str(s): times[1][s] for s in counts}}
        del ws
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other", nargs="?",
                   help="a checkout whose kernel sources to time")
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--sweep", action="store_true",
                   help="time the row kernel against its slots per warp")
    args = p.parse_args()
    if (args.other is None) == (not args.sweep):
        p.error("give OTHER_CHECKOUT or --sweep, not both")
    if not torch.cuda.is_available():
        raise SystemExit("compare_update_kernels: needs a CUDA card")
    card = cs.identify()
    if args.sweep:
        cs.build_kernels([fk.LIBRARY])
        out = {}
        for what, kaggle in (("DLRM tables", False), ("Kaggle tables", True)):
            out[what] = sweep(inputs(args.dim, kaggle), args.dim, what)
            torch.cuda.empty_cache()
        out = {"sweep": out}
    else:
        other = load_wrappers(Path(args.other))
        cs.build_kernels([fk.LIBRARY, tl.LIBRARY]
                         + [m.LIBRARY for m in other.values()])
        x = with_state(inputs(args.dim))
        out = {"kernels": compare(other, x, args.dim)}
    cs.log(card["smi"])
    cs.log(json.dumps({"dim": args.dim, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
