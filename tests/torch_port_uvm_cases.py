"""The port's side of tests/test_torch_port_uvm.py and
tests/test_torch_port_checkpoint.py: one rank of a gloo process group on
the CPU, and the models and batches the tests share with the ranks.

Run as a script, one process per rank (four ranks):

    python tests/torch_port_uvm_cases.py RANK 4 OUT_DIR INIT_FILE WHAT

Each rank joins the group through the file `INIT_FILE`, runs the cases of
WHAT ("uvm": the uvm/ and gather/ cases, from the JAX initial state the
test wrote beside INIT_FILE, `uvm_init.npz`; "reshard": the reshard/
cases) and writes OUT_DIR/<WHAT><RANK>.npz. This module imports torch,
numpy and the port only, never JAX.

Cases:
- uvm/<plan>/<optim> ("uvm"), on ranks 0 and 1 (a subgroup of two): the mixed
  (t0 ROW_WISE, t1 FUSED_UVM_CACHING) or all-UVM DMP of test_advice_fixes_r2
  from the JAX DMP's initial state, its eval and 3 steps on the rank's
  slice of the global batches: logits, losses, the unsharded state dict
  (one table at a time), the owner's cache stats, the collective calls.
- gather/<st> ("reshard"), on ranks 0 and 1: a two-table DLRM at world size 2 under ROW_WISE,
  TABLE_WISE and COLUMN_WISE: `unsharded_state_dict` and the optimizer
  state, with the largest tensor any all_gather made.
- reshard/<case> ("reshard"): test_momentum_reshard.py's cases between a source DMP on
  ranks 0 and 1 and a destination on all four ranks (or two): train the
  source 2 steps, `save_reshardable`, load into the source plan (the
  control) and into the destination, one step each; the tables and the
  loaded optimizer state, and whether loading warned.
"""

from __future__ import annotations

import datetime
import os
import pathlib
import subprocess
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

UVM_B, UVM_L, UVM_D = 16, 2, 16
UVM_ROWS = (96, 200)
UVM_FUSED_LR, UVM_DENSE_LR, UVM_STEPS = 0.1, 0.05, 3
UVM_PLANS = ("mixed", "all_uvm")
UVM_OPTIMS = ("ROWWISE_ADAGRAD", "EXACT_SGD")
RS_ROWS, RS_D, RS_B = 64, 16, 16
RS_KEY = "dlrm/sparse_arch/embedding_bag_collection"
# case -> (source type, destination type, destination n, optimizer,
#          destination local size)
RESHARD = {
    "rw2_tw4": ("ROW_WISE", "TABLE_WISE", 4, "ROWWISE_ADAGRAD", None),
    "tw2_rw4": ("TABLE_WISE", "ROW_WISE", 4, "ROWWISE_ADAGRAD", None),
    "rw2_cw4_adam": ("ROW_WISE", "COLUMN_WISE", 4, "ADAM", None),
    "cw2_rw4": ("COLUMN_WISE", "ROW_WISE", 4, "ROWWISE_ADAGRAD", None),
    "rw2_cw2": ("ROW_WISE", "COLUMN_WISE", 2, "ROWWISE_ADAGRAD", None),
    "cw2_twcw4": ("COLUMN_WISE", "TABLE_COLUMN_WISE", 4, "ROWWISE_ADAGRAD",
                  2),
    "kind_rw2_rw4": ("ROW_WISE", "ROW_WISE", 4, "ROWWISE_ADAGRAD", None),
}
GATHER_TYPES = ("ROW_WISE", "TABLE_WISE", "COLUMN_WISE")
TIMEOUT_S = 120
SPAWN_TIMEOUT_S = 300
ROOT = pathlib.Path(__file__).resolve().parent.parent


class UvmModel(nn.Module):
    """test_advice_fixes_r2's `_M`: an EBC, a Dense(1) head and JAX's BCE
    with logits (its slopes at a logit of 0, as the port's DLRMTrain)."""

    flax_names = {"Dense_0": "head"}

    def __init__(self, tables, L: int = UVM_L):
        super().__init__()
        from torchrec_tpu_torch.modules import EmbeddingBagCollection

        self.ebc = EmbeddingBagCollection(list(tables), max_feature_length=L,
                                          device="meta")
        width = sum(t.embedding_dim * len(t.feature_names) for t in tables)
        self.head = nn.Linear(width, 1, device="meta")

    @torch.no_grad()
    def reset_parameters(self, generator=None) -> None:
        bound = 1.0 / self.head.in_features ** 0.5
        for p in self.head.parameters():
            p.uniform_(-bound, bound, generator=generator)

    def forward(self, sb, labels):
        logits = self.head(self.ebc(sb).values)[:, 0]
        abs_z = torch.where(logits >= 0, logits, -logits)
        loss = (torch.maximum(logits, logits.new_zeros(()))
                - logits * labels + torch.log1p(torch.exp(-abs_z))).mean()
        return loss, (loss, logits)


def uvm_tables():
    from torchrec_tpu_torch.modules import EmbeddingBagConfig

    return [EmbeddingBagConfig(num_embeddings=r, embedding_dim=UVM_D,
                               name=f"t{i}", feature_names=[f"f{i}"])
            for i, r in enumerate(UVM_ROWS)]


def uvm_plan(all_uvm: bool, owner: int = 0):
    from torchrec_tpu_torch.parallel import (
        ComputeKernel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    def uvm():
        return ParameterSharding(
            ShardingType.TABLE_WISE, ranks=[owner],
            compute_kernel=ComputeKernel.FUSED_UVM_CACHING)

    return ShardingPlan({"ebc": {
        "t0": uvm() if all_uvm else ParameterSharding(ShardingType.ROW_WISE),
        "t1": uvm()}})


def uvm_dmp(env, all_uvm: bool, optim: str):
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import DistributedModelParallel

    return DistributedModelParallel(
        UvmModel(uvm_tables()), env=env, plan=uvm_plan(all_uvm),
        fused_optim=EmbOptimType[optim],
        fused_params={"learning_rate": UVM_FUSED_LR},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=UVM_DENSE_LR))


def uvm_batch(seed: int, B: int = UVM_B, L: int = UVM_L):
    """test_advice_fixes_r2's `_uvm_batch`: (jagged values, lengths,
    labels) of the global batch, features f0 and f1."""
    r = np.random.RandomState(seed)
    lengths = r.randint(0, L + 1, size=(2 * B,)).astype(np.int32)
    vals = np.concatenate(
        [r.randint(0, UVM_ROWS[i // B], size=(lengths[i],))
         for i in range(len(lengths))] + [np.zeros((0,), np.int64)]
    ).astype(np.int32)
    labels = (r.rand(B) > 0.5).astype(np.float32)
    return vals, lengths, labels


def padded(vals, lengths, keys, L, B):
    """(ids [F, B, L], lengths [F, B]) of a jagged batch, as to_padded."""
    F = len(keys)
    ids = np.zeros((F, B, L), np.int32)
    lens = np.asarray(lengths, np.int32).reshape(F, B)
    pos = 0
    for f in range(F):
        for b in range(B):
            n = lens[f, b]
            ids[f, b, :n] = vals[pos:pos + n]
            pos += n
    return ids, lens


def port_args(seed: int, rank: int = 0, n: int = 1):
    """The rank's slice of `uvm_batch(seed)` as the port's arguments."""
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    vals, lengths, labels = uvm_batch(seed)
    ids, lens = padded(vals, lengths, ("f0", "f1"), UVM_L, UVM_B)
    b = UVM_B // n
    sl = slice(rank * b, (rank + 1) * b)
    sb = PaddedSparseBatch(ids=torch.as_tensor(ids[:, sl]),
                           lengths=torch.as_tensor(lens[:, sl]),
                           keys=("f0", "f1"))
    return sb, torch.as_tensor(labels[sl])


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def load_uvm_init(dmp, init: dict, prefix: str) -> None:
    """The JAX DMP's initial state (`<prefix>/dense/...`, `<prefix>/tables/
    <t>`) into the port DMP."""
    from torchrec_tpu_torch.utils.jax_bridge import load_jax_weights

    dense = unflatten({k[len(prefix) + 7:]: v for k, v in init.items()
                       if k.startswith(prefix + "/dense/")})
    tables = {k[len(prefix) + 8:]: v for k, v in init.items()
              if k.startswith(prefix + "/tables/")}
    load_jax_weights(dmp, dense, tables)


def record_state(dmp, prefix: str, out: dict) -> None:
    """The DMP's unsharded state dict and cache stats into `out`."""
    sd = dmp.unsharded_state_dict()
    for k, v in sd.items():
        if k == "dense":
            for n, t in v.items():
                out[f"{prefix}/dense/{n}"] = t.numpy()
        else:
            for n, a in v.items():
                out[f"{prefix}/{k}/{n}"] = np.asarray(a)
    for key, per in dmp.cache_stats().items():
        for t, st in per.items():
            out[f"{prefix}/stats/{t}"] = np.asarray(
                [st["hits"], st["misses"]])


def _calls(prefix: str, before: dict, out: dict) -> None:
    from torchrec_tpu_torch.utils import tracing

    for k, v in tracing.counts().items():
        if k.startswith("comm."):
            out[f"{prefix}/calls/{k[5:]}"] = np.asarray(v - before.get(k, 0))


def run_uvm_case(env, plan: str, optim: str, init: dict, out: dict) -> None:
    """The UVM DMP on this rank's slice: eval, then UVM_STEPS steps."""
    from torchrec_tpu_torch.utils import tracing

    prefix = f"uvm/{plan}/{optim}"
    dmp = uvm_dmp(env, plan == "all_uvm", optim)
    load_uvm_init(dmp, init, prefix)
    n, r = env.world_size, env.rank
    before = tracing.counts()
    loss, (_, logits) = dmp.make_eval_fn()(*port_args(100, r, n))
    _calls(prefix + "/eval", before, out)
    out[prefix + "/eval_logits"] = logits.numpy()
    step = dmp.make_train_step()
    for s in range(UVM_STEPS):
        before = tracing.counts()
        loss, (_, logits) = step(*port_args(s, r, n))
        _calls(f"{prefix}/step{s}", before, out)
        out[f"{prefix}/loss{s}"] = loss.numpy()
        out[f"{prefix}/logits{s}"] = logits.numpy()
    record_state(dmp, prefix, out)


# -- the one-table-at-a-time gather and the reshard cases -------------------


def rs_dmp(env, st: str, optim: str, **fused):
    """test_momentum_reshard.py's model: a DLRM over two 64 x 16 tables,
    both planned `st`, dense SGD at 0.1."""
    from torchrec_tpu_torch.models import DLRM, DLRMTrain
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    tables = [EmbeddingBagConfig(num_embeddings=RS_ROWS, embedding_dim=RS_D,
                                 name=f"t{i}", feature_names=[f"f{i}"])
              for i in range(2)]
    model = DLRMTrain(DLRM(EmbeddingBagCollection(tables, device="meta"),
                           4, (8, RS_D), (8, 1), device="meta"))
    stype = ShardingType[st]
    ranks = ([[0], [min(1, env.num_hosts - 1)]]
             if stype is ShardingType.TABLE_COLUMN_WISE else [None, None])
    hosts = ([0, min(1, env.num_hosts - 1)]
             if stype is ShardingType.TABLE_COLUMN_WISE else [None, None])
    plan = ShardingPlan({RS_KEY: {
        f"t{i}": ParameterSharding(stype, ranks=ranks[i], host=hosts[i])
        for i in range(2)}})
    return DistributedModelParallel(
        model, env=env, plan=plan, fused_optim=EmbOptimType[optim],
        fused_params=dict(fused, learning_rate=0.1),
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=0.1))


def rs_args(seed: int, rank: int = 0, n: int = 1):
    """test_momentum_reshard.py's `_batch(seed)`, the rank's slice."""
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    rng = np.random.RandomState(seed)
    ids = rng.randint(0, RS_ROWS, 2 * RS_B).astype(np.int32)
    dense = rng.randn(RS_B, 4).astype(np.float32)
    labels = (rng.rand(RS_B) > 0.5).astype(np.float32)
    b = RS_B // n
    sl = slice(rank * b, (rank + 1) * b)
    sb = PaddedSparseBatch(
        ids=torch.as_tensor(ids.reshape(2, RS_B, 1)[:, sl]),
        lengths=torch.ones((2, b), dtype=torch.int32), keys=("f0", "f1"))
    return torch.as_tensor(dense[sl]), sb, torch.as_tensor(labels[sl])


def rs_train(dmp, steps: int, seed0: int = 0) -> None:
    step = dmp.make_train_step()
    for i in range(steps):
        step(*rs_args(seed0 + i, dmp.env.rank, dmp.env.world_size))


class LargestGather:
    """Records the largest tensor an all_gather returns while active."""

    def __enter__(self):
        from torchrec_tpu_torch.parallel import comm

        self.largest, self._orig = 0, comm._all_gather

        def spy(pg, n, x, axis):
            y = self._orig(pg, n, x, axis)
            self.largest = max(self.largest, y.numel())
            return y

        comm._all_gather = spy
        return self

    def __exit__(self, *exc):
        from torchrec_tpu_torch.parallel import comm

        comm._all_gather = self._orig


def run_gather_case(env, st: str, out: dict) -> None:
    """unsharded_state_dict at world size 2 gathers one table at a time."""
    from torchrec_tpu_torch.utils.jax_bridge import fused_optimizer_state

    prefix = f"gather/{st}"
    dmp = rs_dmp(env, st, "ROWWISE_ADAGRAD")
    dmp.init(5)
    rs_train(dmp, 2)
    with LargestGather() as spy:
        sd = dmp.unsharded_state_dict()
        opt = fused_optimizer_state(dmp)
    out[prefix + "/largest"] = np.asarray(spy.largest)
    layout = sum(s.weights.numel() for s in
                 dmp.sharded_ebcs[RS_KEY].strategies) * env.world_size
    out[prefix + "/layout"] = np.asarray(layout)
    for n, a in sd[f"embeddings/{RS_KEY}"].items():
        out[f"{prefix}/tables/{n}"] = a
    for n, entry in opt.items():
        for tag, a in entry.items():
            out[f"{prefix}/opt/{n}/{tag}"] = np.asarray(a)
    # the same from a gather of the whole layout
    (strat,) = dmp.sharded_ebcs[RS_KEY].strategies
    tag = "m1__row" if strat.rowwise_shards() == 1 else "m1__cwrow"
    for n, t in strat._tables_of(strat._global(strat.weights)).items():
        out[f"{prefix}/layout_gather/tables/{n}"] = t.numpy()
    for n, t in strat._rowwise_of(strat._global(strat.momentum1)).items():
        out[f"{prefix}/layout_gather/opt/{n}/{tag}"] = t.numpy()
        out[f"{prefix}/layout_gather/opt/{n}/step"] = opt[n]["step"]


def run_reshard_case(world, sub, case: str, directory: str,
                     out: dict) -> None:
    """One reshard case: every rank of `world` calls it; the source runs
    on `sub` (ranks 0 and 1), the destination on its n ranks."""
    from torchrec_tpu_torch.parallel import ShardingEnv
    from torchrec_tpu_torch.utils.checkpoint import (
        load_reshardable,
        save_reshardable,
    )
    from torchrec_tpu_torch.utils.jax_bridge import fused_optimizer_state

    src, dst, n_dst, optim, local = RESHARD[case]
    dst_optim = "ADAM" if case.startswith("kind") else optim
    fused = ({"beta1": 0.9, "beta2": 0.999} if optim == "ADAM" else {})
    path = os.path.join(directory, f"reshard_{case}.npz")
    prefix = f"reshard/{case}"
    if sub is not None:
        env = ShardingEnv("cpu", group=sub)
        dmp = rs_dmp(env, src, optim, **fused)
        dmp.init(0)
        rs_train(dmp, 2)
        save_reshardable(path, dmp)
        before = fused_optimizer_state(dmp)
        saved = dmp.unsharded_state_dict()[f"embeddings/{RS_KEY}"]
        if env.rank == 0:
            for t, entry in before.items():
                for tag, a in entry.items():
                    out[f"{prefix}/saved_opt/{t}/{tag}"] = np.asarray(a)
            for t, a in saved.items():
                out[f"{prefix}/saved/{t}"] = a
        control = rs_dmp(env, src, optim, **fused).init(7)
        load_reshardable(path, control)
        rs_train(control, 1, seed0=99)
        sd = control.unsharded_state_dict()
        if env.rank == 0:
            for t, a in sd[f"embeddings/{RS_KEY}"].items():
                out[f"{prefix}/control/{t}"] = a
    dist.barrier(group=world)
    groups = {2: sub, 4: world}
    group = groups[n_dst]
    if group is not None:
        env = ShardingEnv("cpu", group=group, local_size=local)
        dmp = rs_dmp(env, dst, dst_optim, **fused).init(7)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            load_reshardable(path, dmp)
        loaded = fused_optimizer_state(dmp)
        loaded_tables = dmp.unsharded_state_dict()[f"embeddings/{RS_KEY}"]
        if env.rank == 0:
            for t, a in loaded_tables.items():
                out[f"{prefix}/loaded/{t}"] = a
        rs_train(dmp, 1, seed0=99)
        sd = dmp.unsharded_state_dict()
        if env.rank == 0:
            out[f"{prefix}/warnings"] = np.asarray(
                [str(w.message) for w in caught] or [""])
            for t, entry in loaded.items():
                for tag, a in entry.items():
                    out[f"{prefix}/loaded_opt/{t}/{tag}"] = np.asarray(a)
            for t, a in sd[f"embeddings/{RS_KEY}"].items():
                out[f"{prefix}/reshard/{t}"] = a
    dist.barrier(group=world)


def spawn(what: str, n: int, directory: pathlib.Path) -> list:
    """Run the cases of `what` on n gloo ranks (for "uvm", `uvm_init.npz`
    already in `directory`); each rank's outputs. A rank's log goes to a
    file, so that no rank blocks on a full pipe."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT), os.environ.get("PYTHONPATH", "")]))
    logs = [open(directory / f"{what}_log{r}", "w+") for r in range(n)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(n), str(directory),
         str(directory / f"{what}_rendezvous"), what], env=env,
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(n)]
    try:
        for p in procs:
            p.wait(timeout=SPAWN_TIMEOUT_S)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)
    for p, log in zip(procs, logs):
        log.seek(0)
        assert p.returncode == 0, log.read()[-4000:]
        log.close()
    return [dict(np.load(directory / f"{what}{r}.npz")) for r in range(n)]


def main(rank: int, n: int, out_dir: str, init_file: str, what: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    from torchrec_tpu_torch.parallel import ShardingEnv

    world = dist.group.WORLD
    sub = dist.new_group([0, 1])
    sub = sub if rank < 2 else None
    out: dict = {}
    if what == "uvm" and sub is not None:
        init = dict(np.load(pathlib.Path(init_file).parent / "uvm_init.npz"))
        env = ShardingEnv("cpu", group=sub)
        for plan in UVM_PLANS:
            for optim in UVM_OPTIMS:
                run_uvm_case(env, plan, optim, init, out)
    if what == "reshard":
        if sub is not None:
            env = ShardingEnv("cpu", group=sub)
            for st in GATHER_TYPES:
                run_gather_case(env, st, out)
        dist.barrier(group=world)
        for case in RESHARD:
            run_reshard_case(world, sub, case, out_dir, out)
    out["jax_imported"] = np.asarray("jax" in sys.modules)
    np.savez(os.path.join(out_dir, f"{what}{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
