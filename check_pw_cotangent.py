"""Repeat chip_smoke.py's card-against-CPU check of the position-weighted DLRM.

Run from the repository root, on a machine with a CUDA card:

    python3 check_pw_cotangent.py [SECONDS]

Builds the kernels, then, until SECONDS (default 420) have passed, repeats:
a fresh position-weighted DLRM under ROWWISE_ADAGRAD initialised from seed 0
and trained on the card for chip_smoke.py's 1 + 3 steps at B=8192 (whose
atomic sums leave a slightly different state each time), then a copy of it
and a CPU copy of its state take chip_smoke.py's 2 steps at B=256 in two
ways:

1. each side on its own pooled cotangent (the check as it stood before):
   the last step's position weight gradients' distance from the CPU's in
   norm, the touched rows' and momenta's largest difference, whether the
   rtol 1e-4 / atol 1e-5 bound on them held, and how many ReLU outputs are
   zero on one side only in each step (hooks on the dense arches'
   Perceptrons);
2. `chip_smoke.check_pw_against_cpu` itself, whose CPU side takes the
   card's cotangent and, at ReLU pre-activations within 1e-5 of zero, the
   card's branch: passed or the error it raised, the cotangents' distance
   in norm, and how many units took the card's branch.

Each repetition is a line of chiprun_out/check_pw_cotangent.jsonl; the
summary is the last line of standard output.
"""

from __future__ import annotations

import contextlib
import copy
import io
import json
import os
import re
import sys
import time

import numpy as np
import torch

import chip_smoke as cs

OUT = os.path.join("chiprun_out", "check_pw_cotangent.jsonl")


def zero_masks(dmp, store: dict, step: list) -> list:
    """Forward hooks keeping each ReLU Perceptron's zero mask per step."""
    from torchrec_tpu_torch.modules.mlp import Perceptron

    return [m.register_forward_hook(
        lambda mod, args, out, n=n: store.__setitem__((step[0], n),
                                                      (out == 0).cpu()))
        for n, m in dmp.module.named_modules()
        if isinstance(m, Perceptron) and m.activation is torch.relu]


def own_cotangents(tl, gpu, name: str) -> dict:
    """The check as it stood: both sides on their own cotangents."""
    cpu = cs.make_dmp("cpu", train=True, optim=gpu.fused_optim,
                      position_weighted=True)
    cpu.load_state_dict(gpu.state_dict())
    rng = np.random.RandomState(cs.SEED + 21)
    batches = [cs.make_pw_batch(rng, cs.SERVE_BATCH)
               for _ in range(cs.CPU_STEPS + 1)]
    step, zg, zc = [0], {}, {}
    hooks = zero_masks(gpu, zg, step) + zero_masks(cpu, zc, step)
    step_g, step_c = gpu.make_train_step(), cpu.make_train_step()
    for i, batch in enumerate(batches[1:]):
        step[0] = i
        step_g(*cs.to_device(batch))
        step_c(*batch)
    for h in hooks:
        h.remove()
    g_g = cs._position_weights(gpu, grad=True)
    g_c = cs._position_weights(cpu, grad=True)
    sg = gpu.sharded_ebcs[cs.TRAIN_KEY].strategies[0]
    sc = cpu.sharded_ebcs[cs.TRAIN_KEY].strategies[0]
    touched = cs._touched(sc, batches[1:])
    out = {"pw_grad_rel": ((g_g - g_c).norm() / g_c.norm()).item(),
           "flips": [sum(int((zg[k] != zc[k]).sum()) for k in zg
                         if k[0] == i) for i in range(cs.CPU_STEPS)]}
    held = True
    for what in ("weights", "momentum1"):
        a, b = getattr(sg, what)[0].cpu()[touched], getattr(sc, what)[0][
            touched]
        out[what + "_max_abs_diff"] = (a - b).abs().max().item()
        held &= bool(torch.isclose(a, b, rtol=1e-4, atol=1e-5).all())
    out["rows_held"] = held
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("check_pw_cotangent: no CUDA device", file=sys.stderr)
        return 1
    from torchrec_tpu_torch.ops import fused_update_kernels as fk
    from torchrec_tpu_torch.ops import gather_rows as gr
    from torchrec_tpu_torch.ops import tbe_lookup as tl
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType

    budget = float(sys.argv[1]) if len(sys.argv) > 1 else 420.0
    cs.identify()
    cs.build_kernels([tl.LIBRARY, fk.LIBRARY, gr.LIBRARY])
    optim = EmbOptimType.ROWWISE_ADAGRAD
    rng = np.random.RandomState(cs.SEED + 22)
    train = [cs.to_device(cs.make_pw_batch(rng, cs.BENCH_BATCH))
             for _ in range(cs.PW_WARMUP_STEPS + cs.PW_TIMED_STEPS)]
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    t0, reps = time.perf_counter(), []
    with open(OUT, "w") as f:
        while time.perf_counter() - t0 < budget:
            gpu = cs.make_dmp(cs.DEVICE, train=True, optim=optim,
                              position_weighted=True).init(cs.SEED)
            step = gpu.make_train_step()
            for batch in train:
                step(*batch)
            rec = {"rep": len(reps),
                   "own": own_cotangents(tl, copy.deepcopy(gpu), optim.name)}
            text = io.StringIO()
            try:
                with contextlib.redirect_stdout(text):
                    cs.check_pw_against_cpu(tl, gpu, optim.name)
                rec["check"] = "passed"
            except AssertionError as e:
                rec["check"] = f"failed: {e}"
            rec["cotangent_rel"] = [float(x) for pair in re.findall(
                r"within ([0-9.e+-]+) \(K1's VJP\) and ([0-9.e+-]+) \(the",
                text.getvalue()) for x in pair]
            m = re.search(r"gradients within ([0-9.e+-]+) of", text.getvalue())
            rec["pw_grad_rel"] = float(m.group(1)) if m else None
            m = re.search(r"ReLU branch at (\d+) of the (\d+)",
                          text.getvalue())
            rec["card_branches"] = ([int(m.group(1)), int(m.group(2))]
                                    if m else None)
            reps.append(rec)
            f.write(json.dumps(rec) + "\n")
            f.flush()
            del gpu, step
            torch.cuda.empty_cache()
    own = [r["own"] for r in reps]
    summary = {
        "reps": len(reps),
        "own_pw_grad_rel_over_1e-3": sum(o["pw_grad_rel"] > 1e-3 for o in own),
        "own_rows_not_held": sum(not o["rows_held"] for o in own),
        "own_flips_in_a_step": [sum(o["flips"][i] > 0 for o in own)
                                for i in range(cs.CPU_STEPS)],
        "own_pw_grad_rel_max": max(o["pw_grad_rel"] for o in own),
        "check_failed": sum(r["check"] != "passed" for r in reps),
        "check_pw_grad_rel_max": max(r["pw_grad_rel"] or 0.0 for r in reps),
        "check_cotangent_rel_max": max(max(r["cotangent_rel"], default=0.0)
                                       for r in reps),
        "check_card_branches_taken": sum((r["card_branches"] or [0])[0]
                                         for r in reps),
        "check_reps_with_a_branch_taken": sum(
            bool((r["card_branches"] or [0])[0]) for r in reps),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
