"""Time two builds of the embedding kernels against each other on one GPU,
or the update kernels against their slots per warp.

Run from the repository root, on a machine with a CUDA card:

    python3 compare_update_kernels.py OTHER_CHECKOUT [--dim D ...]
        [--kernels NAME ...]
    python3 compare_update_kernels.py --sweep [--dim D ...]

The first form builds this checkout's torchrec_tpu_torch/csrc/tbe_lookup.cu,
fused_update.cu, gather_rows.cu and quant_lookup.cu and OTHER_CHECKOUT's
(another tree of the repository, say a parent commit unpacked with `git
archive`). Each build is launched through its own tree's wrappers
(ops/tbe_lookup.py, ops/fused_update_kernels.py, ops/gather_rows.py and
ops/quant_lookup.py, loaded from that tree), so the two may differ in
their C entry points (a tree older than the lookups' lane groups passes
no G). For each width D (`--dim`, 128 by default) and
each table set, `dlrm`, the DLRM's training shape (26 tables of 100,000
rows, one B=8192 batch of one uniform id per table: 212,992 bags and
slots), and `kaggle`, the D=10 DeepFM's and the Criteo Kaggle DLRM's (the
26 Criteo Kaggle tables of chip_smoke.kaggle_lookup, 33,762,577 rows, one
B=8192 batch: 212,992 slots, about 94,000 distinct rows), it runs K1,
K1h (bf16), K8, the routed gather (a rank owning every row, one token a
feature and example) and Kq (the table quantized to 8 and to 4 bits) over
the batch, then K2, K3, K4's scaled RMW, the fused K4, K5, K6, K7, K3h
(bf16 and fp16) and K4h (bf16) on its run totals and dedup output. The state a kernel updates is made for it and updated in
place, so that K7's three tables fit on the card at the Kaggle tables'
33.7 M rows: each
build's run starts from the same rows (the held rows are saved and put
back), and the two builds are held bit for bit on every row of the
DLRM's tables and, on the Kaggle tables, which leave no room for copies,
on the rows a kernel updates and chip_smoke.row_sample's seeded rows
(4,096, and 4,096 more past element 2^31 at D=64); the lookups on what
they return. Then each build
is timed in turns (other, this, this, other; the device time of
torch.profiler through chip_smoke.device_ms) and printed beside the
kernel's bound, with the card's name and power limit. An OTHER_CHECKOUT
older than the masked path takes only D % 4 == 0.

The second form (--sweep) times this checkout's row kernel (K2, K3, K3h
in bf16 and K4's scaled RMW), its fused rowwise kernel (K4, K4h in bf16)
and its moment kernel (K6, K7) against the slots a warp takes, on the
table as it is (whole quads, or pairs at an even D) and one element into
its storage (the masked path), for each table set and width: every power
of two from the warp's lane groups (32 / lanes_per_row(D)) to 32 (the
fused kernel also below that at D > 64), each held bit for bit with the
plain version first (on the rows `held` gives), timed in the order up
and then down. The geometry's pick is marked.
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
from torchrec_tpu_torch.ops import gather_rows as gr
from torchrec_tpu_torch.ops import quant_lookup as ql
from torchrec_tpu_torch.ops import tbe_lookup as tl
from torchrec_tpu_torch.ops.cuda_build import CudaLibrary
from torchrec_tpu_torch.ops.quant import quantize_rowwise

TABLES, ROWS, BATCH, LR = 26, 100_000, 8192, 0.1
DEVICE = "cuda"
# wrapper module -> its kernel source
WRAPPERS = {"fused_update_kernels": "fused_update.cu",
            "tbe_lookup": "tbe_lookup.cu", "gather_rows": "gather_rows.cu",
            "quant_lookup": "quant_lookup.cu"}
# this tree's wrapper modules, by the names of WRAPPERS
THIS = {"fused_update_kernels": fk, "tbe_lookup": tl, "gather_rows": gr,
        "quant_lookup": ql}
# table set -> kaggle_lookup's tables (True) or the DLRM's (False)
TABLE_SETS = {"dlrm": False, "kaggle": True}
# the kernel each sweep case launches, by its geometry's name
SWEEPS = {"K2": "row", "K3": "row", "K4 scaled RMW": "row", "K3h": "row",
          "K4": "fused", "K4h": "fused", "K6": "moment", "K7": "moment"}
# K3h's profiler filter: all of the call's device work, its one launch
# (the row kernel on a half table; before, a kernel of its own named
# sgd_half_kernel), so that a tree of either design times alike
K3H_KERNELS = ""


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
    slots, about 94,000 distinct rows); with what the kernels take beside
    their state (K2's rows, the scaled RMW's scale, K1's coefficients,
    K5's g_sq, the step)."""
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(cs.SEED)
    if kaggle:
        W, ids, _, local, offs = cs.kaggle_lookup(D, cs.SEED + 71)
        flat = ids.reshape(-1)
        cards = cs.kd_cards()
    else:
        W = torch.randn((TABLES * ROWS, D), generator=gen,
                        device=DEVICE) * 0.1
        rng = np.random.RandomState(cs.SEED)
        local = np.stack([rng.randint(0, ROWS, BATCH)
                          for _ in range(TABLES)]).astype(np.int32)
        offs = np.arange(TABLES, dtype=np.int64) * ROWS
        flat = torch.from_numpy(
            (local + offs[:, None]).reshape(-1).astype(np.int32)).to(DEVICE)
        cards = (ROWS,) * TABLES
    R = W.shape[0]
    grads = torch.randn((flat.numel(), D), generator=gen, device=DEVICE)
    grads *= 1e-3
    valid = torch.ones(flat.numel(), dtype=torch.bool, device=DEVICE)
    u_rt, g_rt = fu.run_total_row_grads(flat, grads, valid, R)
    u_dd, g_dd = fu.dedup_row_grads(flat, grads, valid, R)
    del grads
    rows = W[u_rt.clamp(max=R - 1).long()] - LR * g_rt
    scale = torch.rand(u_dd.numel(), generator=gen, device=DEVICE) * -1e-3
    ids = flat[:, None].contiguous()
    # the routed gather's batch: one token a feature and example, on a rank
    # that owns every row of every table
    F_, B_ = local.shape
    route = (torch.from_numpy(local.reshape(F_, B_, 1)).to(DEVICE),
             torch.ones((F_, B_), dtype=torch.int32, device=DEVICE),
             torch.tensor(cards, dtype=torch.int32, device=DEVICE),
             torch.from_numpy(offs.astype(np.int32)).to(DEVICE), 0)
    return {"W": W, "gen": gen, "ids": ids, "kaggle": kaggle, "route": route,
            "u_rt": u_rt, "g_rt": g_rt, "u_dd": u_dd, "g_dd": g_dd,
            "rows": rows, "scale": scale,
            "step": torch.full((), 6, dtype=torch.int32, device=DEVICE),
            "coeff": torch.ones(ids.shape, device=DEVICE),
            "g_sq": fk.row_mean_sq(g_dd) * (u_dd < R).to(torch.float32)}


def make_state(x: dict, name: str) -> torch.Tensor:
    """A state tensor a kernel updates: the table (W), a bf16 copy of it
    (Wh), an fp16 copy (Wf), the rowwise momentum (M) or a full momentum
    (M1, M2); or the table quantized to 8 or 4 bits (Q8, Q4), Kq's."""
    W, gen = x["W"], x["gen"]
    R, D = W.shape
    if name == "W":
        return W
    if name in ("Q8", "Q4"):
        return quantize_rowwise(W, int(name[1]))
    if name == "Wh":
        return W.to(torch.bfloat16)
    if name == "Wf":
        return W.to(torch.float16)
    if name == "M":
        return torch.rand((R,), generator=gen, device=DEVICE)
    return torch.rand((R, D), generator=gen, device=DEVICE) * 0.01


def cases(x: dict) -> dict:
    """kernel -> (state names, call(wrappers, *state), plain(*state),
    profiler name, the slots it updates ("rt", "dd", or None for K1 and
    K1h, held on what they return), bound(state) in ms). `wrappers` maps a
    module name of WRAPPERS to a build's module."""
    u_rt, g_rt, u_dd, g_dd = x["u_rt"], x["g_rt"], x["u_dd"], x["g_dd"]
    ids, coeff, step = x["ids"], x["coeff"], x["step"]
    rows, scale = x["rows"], x["scale"]
    R, D = x["W"].shape

    def rows_ms(moved, extra, row_bytes, form):
        """The slots' ids, `moved` rows of D elements of `row_bytes` and
        `extra` bytes (a momentum word read and written, a scale read) per
        real slot, and the half kernels' 4-byte g row, over the HBM
        rate."""
        u = u_rt if form == "rt" else u_dd

        def ms(*_):
            n_real = int((u < R).sum())
            g_bytes = n_real * D * 4 if row_bytes == 2 else 0
            return cs.rows_bound(int(u.numel()), n_real, D, moved,
                                 extra_bytes=n_real * extra + g_bytes,
                                 row_bytes=row_bytes)["ms"]
        return ms

    def lookup_ms(w, *_):
        return cs.bound(w, ids, coeff)["ms"]

    flat = ids.reshape(-1)
    route = x["route"]

    def gather_ms(*_):
        return cs.gather_bound(int(flat.numel()),
                               int(torch.unique(flat).numel()), D)["ms"]

    def routed_ms(*_):
        loc, own = gr.route_tokens_reference(*route)
        return cs.routed_bound(route[0], route[1], loc, own, D)["ms"]

    def kq_ms(q):
        return cs.quant_bound(q.bits, D, ids, coeff)["ms"]

    F = "fused_update_kernels"
    return {
        "K8": (("W",), lambda m, w: m["gather_rows"].gather_rows_forward(
            w, flat), lambda w: gr.gather_rows_reference(w, flat),
            cs.K8_KERNELS, None, gather_ms),
        "K8 routed": (("W",), lambda m, w: m["gather_rows"].routed_gather_rows(
            w, *route), lambda w: gr.routed_gather_rows_reference(w, *route),
            cs.ROUTED_KERNELS, None, routed_ms),
        **{f"Kq int{bits}": ((f"Q{bits}",), lambda m, q:
                              m["quant_lookup"].quant_lookup_pooled(
                                  q.data, q.scale, q.shift, ids, coeff,
                                  q.bits),
                              lambda q: ql.quant_lookup_pooled_reference(
                                  q.data, q.scale, q.shift, ids, coeff,
                                  q.bits), cs.KQ_KERNELS, None, kq_ms)
           for bits in (8, 4)},
        "K1": (("W",), lambda m, w: m["tbe_lookup"].tbe_lookup_pooled(
            w, ids, coeff),
            lambda w: tl.tbe_lookup_pooled_reference(w, ids, coeff),
            cs.K1_KERNELS, None, lookup_ms),
        "K1h": (("Wh",), lambda m, w: m["tbe_lookup"].tbe_lookup_pooled(
            w, ids, coeff),
            lambda w: tl.tbe_lookup_pooled_reference(w, ids, coeff),
            cs.K1_KERNELS, None, lookup_ms),
        "K2": (("W",), lambda m, w: m[F].scatter_rows_write(w, u_rt, rows),
               lambda w: fk.scatter_rows_write_reference(w, u_rt, rows),
               "row_update_kernel", "rt", rows_ms(2, 0, 4, "rt")),
        "K3": (("W",), lambda m, w: m[F].fused_update_sgd(w, u_rt, g_rt, LR),
               lambda w: fk.fused_update_sgd_reference(w, u_rt, g_rt, LR),
               "row_update_kernel", "rt", rows_ms(3, 0, 4, "rt")),
        "K4 scaled RMW": (
            ("W",), lambda m, w: m[F].scaled_row_update(w, u_dd, g_dd, scale),
            lambda w: fk.scaled_row_update_reference(w, u_dd, g_dd, scale),
            "row_update_kernel", "dd", rows_ms(3, 4, 4, "dd")),
        "K4": (("W", "M"), lambda m, w, mm: m[F].fused_update_rowwise_adagrad(
            w, mm, u_dd, g_dd, LR, momentum_stream=True),
            lambda w, mm: fk.fused_update_rowwise_adagrad_reference(
                w, mm, u_dd, g_dd, LR, momentum_stream=True),
            cs.ROWWISE_KERNELS, "dd", rows_ms(3, 8, 4, "dd")),
        "K5": (("M",), lambda m, mm: m[F].rowwise_momentum_stream(
            mm, u_dd, x["g_sq"]),
            lambda mm: fk.rowwise_momentum_stream_reference(
                mm, u_dd, x["g_sq"]),
            "rowwise_momentum_kernel", "dd",
            lambda *_: cs.k5_bound(int(u_dd.numel()),
                                   int((u_dd < R).sum()))["ms"]),
        "K6": (("W", "M1"), lambda m, w, m1: m[F].fused_update_adagrad(
            w, m1, u_rt, g_rt, LR),
            lambda w, m1: fk.fused_update_adagrad_reference(
                w, m1, u_rt, g_rt, LR),
            cs.MOMENT_KERNELS, "rt", rows_ms(5, 0, 4, "rt")),
        "K7": (("W", "M1", "M2"), lambda m, w, m1, m2: m[F].fused_update_adam(
            w, m1, m2, u_rt, g_rt, LR, step),
            lambda w, m1, m2: fk.fused_update_adam_reference(
                w, m1, m2, u_rt, g_rt, LR, step),
            cs.MOMENT_KERNELS, "rt", rows_ms(7, 0, 4, "rt")),
        **{name: ((state,), lambda m, w: m[F].fused_update_sgd_half(
            w, u_rt, g_rt, LR, step),
            lambda w: fk.fused_update_sgd_half_reference(
                w, u_rt, g_rt, LR, step),
            K3H_KERNELS, "rt", rows_ms(2, 0, 2, "rt"))
           for name, state in (("K3h", "Wh"), ("K3h fp16", "Wf"))},
        "K4h": (("Wh", "M"), lambda m, w, mm:
                m[F].fused_update_rowwise_adagrad_half(
                    w, mm, u_dd, g_dd, LR, step),
                lambda w, mm: fk.fused_update_rowwise_adagrad_half_reference(
                    w, mm, u_dd, g_dd, LR, step),
                cs.ROWWISE_KERNELS, "dd", rows_ms(2, 8, 2, "dd")),
    }


def held(x: dict, form: str) -> torch.Tensor:
    """The rows a kernel's state is held on: every row of the DLRM's
    tables; on the Kaggle tables, too large to copy whole, the real ids of
    the run totals ("rt") or of the dedup output ("dd"), which the kernel
    updates, and chip_smoke.row_sample's seeded rows, which it must leave
    as they were."""
    R, D = x["W"].shape
    if not x["kaggle"]:
        return torch.arange(R, device=DEVICE)
    u = x["u_rt"] if form == "rt" else x["u_dd"]
    sample = torch.from_numpy(cs.row_sample(
        R, D, np.random.RandomState(cs.SEED + 74))).to(DEVICE)
    return torch.cat([u[u < R].long(), sample])


def rows_after(state: list, ids: torch.Tensor, fn) -> list:
    """fn(*state) in place; returns the rows `ids` of every state tensor
    after it and puts back what they held before."""
    saved = [t[ids] for t in state]
    fn(*state)
    out = [t[ids] for t in state]
    for t, rows in zip(state, saved):
        t[ids] = rows
    return out


def compare(other: dict, x: dict, D: int, only=None) -> dict:
    """Every kernel of `cases` (those named in `only`, when given) on both
    builds: held bit for bit, then timed in turns."""
    this = THIS
    out = {}
    for name, (state_names, call, _, kernel, form, bound) in cases(x).items():
        if only and name not in only:
            continue
        state = [make_state(x, n) for n in state_names]
        got = {}
        for tag, mods in (("other", other), ("this", this)):
            if form is None:
                got[tag] = [call(mods, *state)]
            else:
                got[tag] = rows_after(state, held(x, form),
                                      lambda *s, mods=mods: call(mods, *s))
        cs._hold(f"{name}: this build against the other",
                 list(zip(got["this"], got["other"])))
        del got
        times = {"other": [], "this": []}
        for tag in ("other", "this", "this", "other"):
            mods = other if tag == "other" else this
            times[tag].append(cs.device_ms(lambda: call(mods, *state),
                                           kernel))
        b = bound(*state)
        out[name] = {"this_ms": times["this"], "other_ms": times["other"],
                     "bound_ms": b}
        cs.log(f"{name} D={D}: this {times['this']} ms, other "
               f"{times['other']} ms (device time, in turns: other, this, "
               f"this, other), bit for bit; bound {b:.5f} ms")
        del state
        torch.cuda.empty_cache()
    return out


def sweep(x: dict, D: int, what: str) -> dict:
    """Each case of SWEEPS timed against its kernel's slots per warp, on
    the state and gradients as they are and on copies one element into
    their storage (the masked path)."""
    N = int(x["u_rt"].numel())
    G = fk.row_geometry(D)[0]
    at = {0: x, 1: {**x, **{k: cs._placed(x[k], 1)
                            for k in ("g_rt", "g_dd", "rows")}}}
    out = {}
    for name, kernel_of in SWEEPS.items():
        state_names, _, plain, profiled, form, bound = cases(x)[name]
        counts = cs.slot_counts(D, kernel_of)
        pick = {"row": lambda: fk.row_geometry(D),
                "fused": lambda: fk.fused_geometry(D, N),
                "moment": lambda: fk.moment_geometry(D)}[kernel_of]()[1]
        base = [make_state(x, n) for n in state_names]
        states = {0: base, 1: [cs._placed(t, 1) for t in base]}
        ids = held(x, form)
        ref = rows_after(base, ids, plain)
        calls = {off: cases(at[off])[name][1] for off in states}

        def run(off, slots):
            with cs.slots_a_warp(fk, kernel_of, slots):
                calls[off]({"fused_update_kernels": fk}, *states[off])

        for off in states:
            for slots in counts:
                got = rows_after(states[off], ids,
                                 lambda *_: run(off, slots))
                cs._hold(f"{name} D={D} at {slots} slots a warp, offset "
                         f"{off}", list(zip(got, ref)))
        times = {(off, s): [] for off in states for s in counts}
        for order in (counts, counts[::-1]):
            for slots in order:
                for off in states:
                    times[off, slots].append(cs.device_ms(
                        lambda: run(off, slots), profiled))
        b = bound(*base)
        cs.log(f"{name} D={D} ({what}): N={N} slots, lanes per row {G}; "
               f"bound {b:.5f} ms; every slot count bit for bit with the "
               f"plain version; ms up / down, the table as it is, then one "
               f"element in (masked)")
        for slots in counts:
            t0, t1 = times[0, slots], times[1, slots]
            mark = "  <- the geometry's pick" if slots == pick else ""
            cs.log(f"  slots={slots:2d}: {t0[0]:.5f} / {t0[1]:.5f} ms, "
                   f"{100 * b / min(t0):.1f}% of the bound; masked "
                   f"{t1[0]:.5f} / {t1[1]:.5f} ms{mark}")
        out[name] = {"bound_ms": b, "pick": pick,
                     "ms": {str(s): times[0, s] for s in counts},
                     "masked_ms": {str(s): times[1, s] for s in counts}}
        del base, states, ref
        torch.cuda.empty_cache()
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("other", nargs="?",
                   help="a checkout whose kernel sources to time")
    p.add_argument("--dim", type=int, nargs="+", default=[128])
    p.add_argument("--sweep", action="store_true",
                   help="time the update kernels against their slots per "
                        "warp")
    p.add_argument("--kernels", nargs="+",
                   help="compare only these kernels (names as printed)")
    args = p.parse_args()
    if (args.other is None) == (not args.sweep):
        p.error("give OTHER_CHECKOUT or --sweep, not both")
    if not torch.cuda.is_available():
        raise SystemExit("compare_update_kernels: needs a CUDA card")
    card = cs.identify()
    if args.sweep:
        cs.build_kernels([fk.LIBRARY])
    else:
        other = load_wrappers(Path(args.other))
        cs.build_kernels([m.LIBRARY for m in THIS.values()]
                         + [m.LIBRARY for m in other.values()])
    out = {}
    for tables, kaggle in TABLE_SETS.items():
        for D in args.dim:
            x = inputs(D, kaggle)
            if args.sweep:
                out[f"{tables} D={D}"] = sweep(x, D, f"{tables} tables")
            else:
                out[f"{tables} D={D}"] = compare(other, x, D, args.kernels)
            del x
            torch.cuda.empty_cache()
    cs.log(card["smi"])
    cs.log(json.dumps({"sweep" if args.sweep else "kernels": out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
