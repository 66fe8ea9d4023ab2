"""Closed-loop training: one trainer steps the program's train step back to
back, with no synchronise between steps, over a pool of batches made on
the card at set-up and cycled; one synchronise ends the window.

Traffic parameters (`traffic/<mix>.json`): `batch`, `ids_per_feature`
(an int L for every feature, or a list of F fixed lengths L_f, as
MLPerf's multi-hot Criteo has: `inputs.make_batch`), `zipf_a` (null:
uniform ids), `pool` (distinct batches), `warmup_steps` (after the
checked ones), `sample_rows` (rows a table is checked at that no checked
batch touches).

The optimizer keys of a configuration (`configs/<name>.json`), read here
and by the reference: `fused_optimizer` (ROWWISE_ADAGRAD, ADAGRAD or
ADAM) with `fused_learning_rate`, `fused_eps` and Adam's `fused_beta1` /
`fused_beta2`; `dense_optimizer` (SGD, ADAGRAD or ADAM) with
`dense_learning_rate` and optionally `dense_eps` (torch.optim's default
where absent). The program module (`programs/<model>.py`) gives
`model(cfg, train)` and `linears(module)`, and may give
`sparse_batch(cfg, batch)` (the port's batch form it feeds the step;
`programs/common.sparse_batch`'s PaddedSparseBatch where absent) and
`KERNELS`, the names of further `torchrec_tpu_torch.ops` libraries it
runs, built at set-up so that their build counts as `compile_s`. The
reference module (`reference/<model>.py`) gives `linear_shapes(cfg)`,
`forward`, `loss`, `flops_per_example`, `tiny_sizes(cfg)` (the sizes the
CPU tests set, `tests/conftest.py`), and may give `linear_biases(cfg)`,
which layers have a bias (all where absent).

Set-up builds one DistributedModelParallel from the seed and drives it
through `CHECKED` steps on pool batches 0..2 through the window's own
call, reading in the first step the gradient as the optimizer gets it
(the dense parameters' from a pre-hook on the dense optimizer's step, the
tables' from the fused state) and after the last the parameters; the window goes on with
the same object. After the window, once the program is freed, the
reference follows the same steps (`reference/train.py`).
"""

from __future__ import annotations

import gc
import sys
import time
from typing import Callable, List

import torch

from gpubench import check, inputs, trace, work
from gpubench.programs import common as prog_common
from gpubench.reference import common as ref_common
from gpubench.reference import train as ref_train
from gpubench.result import Result, Run

CHECKED = 3


def mark(r: Run, what: str) -> None:
    """A set-up stage's end on standard error, in seconds since the
    process started."""
    print(f"gpubench: set-up {what} {r.clock():.3f} s", file=sys.stderr)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def make_pool(r: Run) -> List[dict]:
    return inputs.make_pool(r.cfg["num_embeddings_per_feature"], r.traffic,
                            r.seed, r.device)


def make_rowsets(r: Run, batches: List[dict]) -> List[torch.Tensor]:
    """Each table's checked rows, sorted: those the batches touch and a
    sample of rows drawn from the seed."""
    out = []
    for t, rows in enumerate(r.cfg["num_embeddings_per_feature"]):
        ids = [b["ids"][t][torch.arange(b["ids"].shape[2], device=r.device)
                           [None, :] < b["lengths"][t][:, None]]
               for b in batches]
        sample = inputs.sample_rows(r.seed, t, rows,
                                    r.traffic["sample_rows"], r.device)
        out.append(torch.unique(torch.cat([*(i.to(torch.int64) for i in ids),
                                           sample])))
    return out


def build_kernels(names, program=None) -> float:
    """Build (first run) or load the program's CUDA libraries, `names` and
    those the program module lists in its `KERNELS`; seconds spent
    compiling."""
    import importlib

    spent = 0.0
    for name in dict.fromkeys([*names, *getattr(program, "KERNELS", ())]):
        lib = importlib.import_module(f"torchrec_tpu_torch.ops.{name}").LIBRARY
        spent += lib.build()["seconds"]
        lib.load()
    return spent


def _state_rows(dmp, rowsets, cfg):
    """The program's tables and fused optimizer state at the row sets:
    ({t: rows [U, D]}, {t: momentum1 rows}) by table index."""
    (sebc,) = dmp.sharded_ebcs.values()
    index = {f"t_{k}": t for t, k in enumerate(prog_common.feature_keys(cfg))}
    w = {index[n]: v[rowsets[index[n]]].clone()
         for n, v in sebc.unshard_tables().items()}
    m = {}
    for s in sebc.strategies:
        if s.momentum1 is not None:
            for n, v in s.unshard_tensors(s.momentum1).items():
                m[index[n]] = v[rowsets[index[n]]].clone()
    return w, m


def _read_dense_grads(dmp, params, into: List[float]):
    """A pre-hook on the dense optimizer's next step: each dense
    parameter's gradient norm as the step gets it, into `into`, once.
    Returns the hook's handle."""

    def hook(opt, args, kwargs):
        if not into:
            into.extend(float(p.grad.norm()) if p.grad is not None else 0.0
                        for p in params)
    return dmp.dense_optimizer.register_step_pre_hook(hook)


def _table_grad(cfg, m: torch.Tensor) -> float:
    """A table's first gradient from its fused state over the row set."""
    if cfg["fused_optimizer"] == "ROWWISE_ADAGRAD":
        # m = mean(g^2) over the row's D columns
        return float((m.double().sum() * cfg["embedding_dim"]).sqrt())
    if cfg["fused_optimizer"] == "ADAGRAD":
        # m = g^2, element by element
        return float(m.double().sum().sqrt())
    return float(m.norm()) / (1.0 - cfg["fused_beta1"])


def batch_form(program) -> Callable:
    """`sparse_batch(cfg, batch)`, the port's sparse batch of a benchmark
    batch: the program module's where it gives one, the common
    PaddedSparseBatch otherwise."""
    return getattr(program, "sparse_batch", prog_common.sparse_batch)


def set_up_program(r: Run, pool, rowsets, wrap_step=None):
    """The DMP loaded with the seed's weights and its train step, driven
    through the checked steps. Returns (dmp, step, args, readings)."""
    cfg = r.cfg
    dmp = prog_common.build_dmp(cfg, r.program.model(cfg, train=True),
                                r.device)
    lins = r.program.linears(dmp.module)
    mark(r, "program built")
    biases = ref_common.linear_biases(r.model, cfg)
    prog_common.load_weights(dmp, lins, cfg, r.model.linear_shapes(cfg),
                             r.seed, biases)
    sync(r.device)
    mark(r, "weights")
    params = [p for lin in lins for p in (lin.weight, lin.bias)
              if p is not None]
    step = dmp.make_train_step()
    if wrap_step is not None:
        step = wrap_step(step, dmp)
    make = batch_form(r.program)
    args = [(b["dense"], make(cfg, b), b["labels"]) for b in pool]
    with torch.no_grad():
        p0 = [p.detach().clone() for p in params]
        w0, _ = _state_rows(dmp, rowsets, cfg)
    losses, grad = [], []
    for i in range(CHECKED):
        handle = _read_dense_grads(dmp, params, grad) if i == 0 else None
        loss, _ = step(*args[i])
        losses.append(float(loss))
        if i == 0:
            handle.remove()
            grad = grad or [0.0] * len(params)
            with torch.no_grad():
                _, m1 = _state_rows(dmp, rowsets, cfg)
    with torch.no_grad():
        w3, _ = _state_rows(dmp, rowsets, cfg)
        leaves = ref_train.dense_leaves(biases)
        readings = ref_train.Readings(
            losses=losses,
            grad={**dict(zip(leaves, grad)),
                  **{f"table{t}": _table_grad(cfg, m) for t, m in m1.items()}},
            change={**{n: float((p.detach() - b).norm())
                       for n, p, b in zip(leaves, params, p0)},
                    **{f"table{t}": float((w3[t] - w0[t]).norm())
                       for t in w0}})
    return dmp, step, args, readings


def window(step: Callable, args, start: int, seconds: float, device):
    """Step back to back until `seconds` have passed, then synchronise.
    Returns (steps, wall seconds, host seconds inside each call)."""
    n, host, ends = 0, [], []
    sync(device)
    t0 = time.perf_counter()
    while True:
        a = args[(start + n) % len(args)]
        h0 = time.perf_counter()
        step(*a)
        h1 = time.perf_counter()
        host.append(h1 - h0)
        ends.append(h1 - t0)
        n += 1
        if h1 - t0 >= seconds:
            break
    sync(device)
    slices(ends, "steps")
    return n, time.perf_counter() - t0, host


def slices(ends: List[float], what: str, width: float = 5.0) -> None:
    """Calls ended in each `width`-second slice of the window, on standard
    error: a rate that climbs over the window is warming up inside it."""
    counts = [0] * (int(max(ends, default=0.0) // width) + 1)
    for t in ends:
        counts[int(t // width)] += 1
    print(f"gpubench: {what} a {width:g} s slice: {counts}", file=sys.stderr)


def run(r: Run, wrap_step=None) -> Result:
    tr = r.traffic
    mark(r, "imports")
    compile_s = (build_kernels(("tbe_lookup", "fused_update_kernels"),
                               r.program)
                 if torch.device(r.device).type == "cuda" else 0.0)
    mark(r, "kernels")
    pool = make_pool(r)
    rowsets = make_rowsets(r, pool[:CHECKED])
    sync(r.device)
    mark(r, "inputs")
    dmp, step, args, prog = set_up_program(r, pool, rowsets, wrap_step)
    mark(r, "program and checked steps")
    for i in range(tr["warmup_steps"]):
        step(*args[(CHECKED + i) % len(args)])
    sync(r.device)
    setup_s = r.clock()
    mark(r, "warm-up")
    start = (CHECKED + tr["warmup_steps"]) % len(args)
    with trace.captured(r.trace) as traced:
        with trace.window():
            n, wall, host = window(step, args, start, r.seconds, r.device)
    peak = (torch.cuda.max_memory_allocated(r.device)
            if torch.device(r.device).type == "cuda" else 0)
    del dmp, step, args
    gc.collect()
    if torch.device(r.device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref = ref_train.follow(r.cfg, r.model, r.seed, pool[:CHECKED], rowsets)
    gaps = check.train_gaps(prog, ref)
    numbers = {k: v for k, (v, _) in gaps.items()}
    print(f"gpubench: reference {time.perf_counter() - t_ref:.3f} s; worst "
          + ", ".join(f"{k} at {w}" for k, (_, w) in gaps.items()),
          file=sys.stderr)
    return Result(
        setup_s=setup_s, compile_s=compile_s,
        window_s=traced[0].window_s if traced else wall,
        attempted=n, failed=0, work=n * tr["batch"],
        flops_per_item=r.model.flops_per_example(r.cfg, train=True),
        host_s=host, bytes=_window_bytes(r, pool, start, n),
        numbers=numbers, memory_peak_bytes=peak,
        reduced=traced[0] if traced else None)


def _window_bytes(r: Run, pool, start: int, steps: int) -> dict:
    """The lookup's and the update's work bytes over the window's steps."""
    cfg, tr = r.cfg, r.traffic
    F = len(cfg["num_embeddings_per_feature"])
    B, D = tr["batch"], cfg["embedding_dim"]
    ids = inputs.ids_per_example(F, tr["ids_per_feature"])
    state = work.optimizer_state_floats(cfg["fused_optimizer"], D)
    look = upd = 0
    per = [work.distinct_rows(b["ids"], b["lengths"]) for b in pool]
    for k in range(steps):
        u = per[(start + k) % len(pool)]
        look += work.lookup_bytes(u, F, B, ids, D)
        upd += work.update_bytes(u, F, B, ids, D, state)
    return {"lookup": look, "update": upd}


# what `reference_numbers` puts in the program's place (gpubench.readings)
REFERENCE_KINDS = ("control", "half_batch", "altered_loss", "unchanged_state")


def reference_numbers(r: Run, kind: str) -> dict:
    """The numbers of a reference put in the program's place, against the
    reference: "control" (TF32), "half_batch" (half of each batch left
    out, the mean over the rest), "altered_loss" (the first step's loss
    reported 1 % high), "unchanged_state" (steps that return the state
    they were given: no gradient in the state, no change). No program
    runs."""
    pool = make_pool(r)[:CHECKED]
    rowsets = make_rowsets(r, pool)
    ref = ref_train.follow(r.cfg, r.model, r.seed, pool, rowsets)
    if kind == "unchanged_state":
        got = ref_train.Readings(losses=ref.losses,
                                 grad={n: 0.0 for n in ref.grad},
                                 change={n: 0.0 for n in ref.change})
    elif kind == "altered_loss":
        got = ref_train.Readings(
            losses=[ref.losses[0] * 1.01, *ref.losses[1:]],
            grad=ref.grad, change=ref.change)
    else:
        got = ref_train.follow(
            r.cfg, r.model, r.seed, pool, rowsets,
            precision="tf32" if kind == "control" else "float32",
            half_batch=kind == "half_batch")
    return check.train_numbers(got, ref)
