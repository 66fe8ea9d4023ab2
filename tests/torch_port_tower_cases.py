"""The port's side of tests/test_torch_port_tower.py and
tests/test_torch_port_variable_batch.py: one rank of a gloo process group
on the CPU.

Run as a script, one process per rank:

    python tests/torch_port_tower_cases.py RANK WORLD OUT_DIR INIT_FILE WHAT

Each rank joins the group through the file `INIT_FILE`, loads the JAX
initial states the test wrote beside it (`INIT_FILE`'s sibling
`<WHAT>_init.npz`), runs the cases of WHAT ("tower" or "vb") on its slice
of seeded global batches and writes OUT_DIR/<WHAT><RANK>.npz, keyed
"<case>/<what>". This module imports torch, numpy and the port only,
never JAX: the tests import it for the seeded inputs they share with the
ranks (and run the same functions in-process at world size 1).

Cases:
- tower/<variant>/<optim>: test_tower.py's three towers (ranks 0, 3 and 3
  at world size 4, so ranks 1 and 2 hold none; 0 at world size 1) in a
  ShardedEmbeddingTowerCollection: forward, one update, the rank's block,
  momentum and step, every interaction's parameters, the unsharded
  tables and their round trip. Variant "plain" is test_tower.py's
  (SUM, no weights); "mean_weighted" pools table a1 by MEAN and feeds
  per-sample weights.
- vb/<st>: two tables under ROW_WISE, TABLE_WISE or COLUMN_WISE on a
  VariableBatch of per-rank sizes VB_SIZES: forward and one
  ROWWISE_ADAGRAD update from a cotangent that is 0 on the pad rows;
- vb/dmp: an EBC and a linear head under masked_bce_with_logits (the
  global batch's count, `VariableBatch.rank_count`) through the DMP:
  three steps from the JAX DMP's initial state.
Each case also records the collective calls it made (`comm.*` counters,
utils/tracing.py).
"""

from __future__ import annotations

import datetime
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

B, L, DIM = 16, 2, 8
LR, EPS = 0.1, 1e-8
TOWER_VARIANTS = ("plain", "mean_weighted")
TOWER_OPTIMS = ("ROWWISE_ADAGRAD", "EXACT_SGD")
# (tables: (rows, name, features, MEAN in mean_weighted), layer sizes)
TOWERS = (
    (((50, "a0", ("fa0",), False), (30, "a1", ("fa1", "fa2"), True)),
     (12, 6)),
    (((40, "b0", ("fb0",), False),), (10,)),
    (((25, "c0", ("fc0",), False),), (4,)),
)
FEATURES = tuple(f for tables, _ in TOWERS for t in tables for f in t[2])
ROWS_OF = {f: t[0] for tables, _ in TOWERS for t in tables for f in t[2]}
VB_SIZES = (3, 1, 4, 2)
VB_ROWS, VB_DIM = (64, 40), 16
VB_STRATEGIES = ("ROW_WISE", "TABLE_WISE", "COLUMN_WISE")
VB_STEPS, VB_FUSED_LR, VB_DENSE_LR = 3, 0.2, 0.05
VB_KEY = "ebc"
TIMEOUT_S = 120
SPAWN_TIMEOUT_S = 300
ROOT = pathlib.Path(__file__).resolve().parent.parent


def tower_ranks(n: int):
    return (0, 3, 3) if n == 4 else (0,) * len(TOWERS)


def tower_d_in(ti: int) -> int:
    return DIM * sum(len(t[2]) for t in TOWERS[ti][0])


def tower_batch(seed: int, weighted: bool):
    """(ids [F, B, L], lengths [F, B], weights or None) of the global
    batch in FEATURES' order: lengths 0..L, ids in each table's rows."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, L + 1, size=(len(FEATURES), B)).astype(np.int32)
    ids = np.stack([rng.randint(0, ROWS_OF[f], size=(B, L))
                    for f in FEATURES]).astype(np.int32)
    w = (rng.rand(len(FEATURES), B, L).astype(np.float32) + 0.5
         if weighted else None)
    return ids, lengths, w


def tower_cotangent(seed: int) -> np.ndarray:
    d = sum(layers[-1] for _, layers in TOWERS)
    return np.random.RandomState(seed).randn(B, d).astype(np.float32)


def case_seed(*parts: str) -> int:
    return sum((i + 1) * ord(c) for i, c in enumerate("/".join(parts)))


def rows(x: np.ndarray, rank: int, n: int, axis: int = 1) -> np.ndarray:
    b = x.shape[axis] // n
    return np.take(x, np.arange(rank * b, (rank + 1) * b), axis=axis)


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _sb(ids, lengths, w, keys):
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    return PaddedSparseBatch(
        ids=torch.as_tensor(ids), lengths=torch.as_tensor(lengths),
        keys=tuple(keys), weights=None if w is None else torch.as_tensor(w))


def _calls(prefix: str, before: dict, out: dict) -> None:
    from torchrec_tpu_torch.utils import tracing

    for k, v in tracing.counts().items():
        if k.startswith("comm."):
            out[f"{prefix}/calls/{k[5:]}"] = np.asarray(v - before.get(k, 0))


def build_towers(env, variant: str, optim: str):
    """The port's collection of TOWERS on `env`."""
    from torchrec_tpu_torch.modules import MLP, EmbeddingBagConfig
    from torchrec_tpu_torch.modules.embedding_configs import PoolingType
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel.tower_sharding import (
        ShardedEmbeddingTowerCollection,
        TowerSpec,
    )

    specs = []
    for ti, ((tables, layers), rank) in enumerate(
            zip(TOWERS, tower_ranks(env.world_size))):
        cfgs = tuple(EmbeddingBagConfig(
            num_embeddings=r, embedding_dim=DIM, name=name,
            feature_names=list(feats),
            pooling=PoolingType.MEAN if mean and variant == "mean_weighted"
            else PoolingType.SUM) for r, name, feats, mean in tables)
        specs.append(TowerSpec(tables=cfgs, interaction=MLP(
            tower_d_in(ti), layers, device="meta"), device=rank,
            d_out=layers[-1]))
    return ShardedEmbeddingTowerCollection(
        env, specs, optim=EmbOptimType[optim], optim_kwargs={"eps": EPS})


def load_towers(tc, init: dict, variant: str) -> None:
    from torchrec_tpu_torch.utils.jax_bridge import load_flax_params

    tc.load_tables({k.split("/")[-1]: v for k, v in init.items()
                    if k.startswith(f"{variant}/table/")})
    for ti, inter in enumerate(tc.interactions):
        pre = f"{variant}/inter/{ti}/"
        load_flax_params(inter, unflatten({
            k[len(pre):]: v for k, v in init.items() if k.startswith(pre)}))


def run_tower_case(env, variant: str, optim: str, init: dict,
                   out: dict) -> None:
    """One case of the module docstring, its outputs under
    tower/<variant>/<optim>."""
    rank, n = env.rank, env.world_size
    prefix = f"tower/{variant}/{optim}"
    tc = build_towers(env, variant, optim)
    load_towers(tc, init, variant)
    seed = case_seed("tower", variant)
    ids, lengths, w = tower_batch(seed, variant == "mean_weighted")
    sb = _sb(rows(ids, rank, n), rows(lengths, rank, n),
             None if w is None else rows(w, rank, n), FEATURES)
    from torchrec_tpu_torch.utils import tracing

    before = tracing.counts()
    with torch.no_grad():
        fwd = tc(sb)
    _calls(prefix + "/fwd", before, out)
    out[f"{prefix}/forward"] = fwd.numpy()
    d = rows(tower_cotangent(seed + 1), rank, n, axis=0)
    before = tracing.counts()
    tc.update(sb, torch.as_tensor(d), LR)
    _calls(prefix + "/upd", before, out)
    out[f"{prefix}/weights"] = tc.weights.numpy()
    for name in ("momentum1", "momentum2"):
        m = getattr(tc, name)
        if m is not None:
            out[f"{prefix}/{name}"] = m.numpy()
    out[f"{prefix}/step"] = tc.step.numpy()
    for ti, inter in enumerate(tc.interactions):
        for pname, p in inter.named_parameters():
            out[f"{prefix}/inter/{ti}/{pname}"] = p.detach().numpy()
    dense = tc.unshard_to_dense()
    for name, t in dense.items():
        out[f"{prefix}/table/{name}"] = t
    out[f"{prefix}/roundtrip"] = np.asarray(torch.equal(
        tc.shard_tables_from_dense(dense), tc.weights))


def vb_parts(seed: int = 3):
    """One ragged (ids, lengths) part per rank of VB_SIZES, features f0,
    f1 of VB_ROWS, lengths 0..L."""
    rng = np.random.RandomState(seed)
    parts = []
    for b in VB_SIZES:
        lengths = rng.randint(0, L + 1, size=(len(VB_ROWS), b)).astype(
            np.int32)
        ids = np.stack([rng.randint(0, r, size=(b, L))
                        for r in VB_ROWS]).astype(np.int32)
        parts.append((ids, lengths))
    return parts


def vb_tables(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return {f"t{i}": rng.randn(r, VB_DIM).astype(np.float32)
            for i, r in enumerate(VB_ROWS)}


def vb_batch(device="cpu"):
    """The port's VariableBatch of vb_parts, with seeded labels."""
    from torchrec_tpu_torch.parallel.variable_batch import VariableBatch

    parts = vb_parts()
    rng = np.random.RandomState(5)
    labels = [(rng.rand(ids.shape[1]) > 0.5).astype(np.float32)
              for ids, _ in parts]
    return VariableBatch.from_ragged(
        [_sb(ids, lengths, None, ("f0", "f1")) for ids, lengths in parts],
        label_parts=labels, device=device)


def vb_cotangent(mask: np.ndarray) -> np.ndarray:
    rng = np.random.RandomState(1)
    d = rng.randn(mask.shape[0], len(VB_ROWS) * VB_DIM).astype(np.float32)
    return d * mask[:, None]


def vb_configs():
    from torchrec_tpu_torch.modules import EmbeddingBagConfig

    return [EmbeddingBagConfig(num_embeddings=r, embedding_dim=VB_DIM,
                               name=f"t{i}", feature_names=[f"f{i}"])
            for i, r in enumerate(VB_ROWS)]


def _local(sb, rank: int, n: int):
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    b = sb.ids.shape[1] // n
    return PaddedSparseBatch(ids=sb.ids[:, rank * b:(rank + 1) * b],
                             lengths=sb.lengths[:, rank * b:(rank + 1) * b],
                             keys=sb.keys)


def run_vb_strategy_case(env, st: str, out: dict) -> None:
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import (
        ParameterSharding,
        ShardedEmbeddingBagCollection,
        ShardingType,
    )

    rank, n = env.rank, env.world_size
    prefix = f"vb/{st}"
    cfgs = vb_configs()
    plan = {c.name: ParameterSharding(
        ShardingType[st], ranks=[i % n] if st == "TABLE_WISE" else None)
        for i, c in enumerate(cfgs)}
    sebc = ShardedEmbeddingBagCollection(
        env, cfgs, plan, max_feature_length=L,
        optim=EmbOptimType.ROWWISE_ADAGRAD, optim_kwargs={"eps": EPS})
    sebc.shard_from_dense(vb_tables(case_seed("vb", st)))
    vb = vb_batch()
    sb = _local(vb.sparse, rank, n)
    with torch.no_grad():
        out[f"{prefix}/forward"] = sebc(sb).values.numpy()
    d = rows(vb_cotangent(vb.example_mask.numpy()), rank, n, axis=0)
    sebc.update(sb, torch.as_tensor(d), LR)
    (strat,) = sebc.strategies
    out[f"{prefix}/weights"] = strat.weights.numpy()
    out[f"{prefix}/momentum1"] = strat.momentum1.numpy()


def build_vb_dmp(env):
    """The EBC-and-head model of the vb/dmp case in the DMP (ROW_WISE)."""
    from torchrec_tpu_torch.modules import EmbeddingBagCollection
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )
    from torchrec_tpu_torch.parallel.variable_batch import (
        masked_bce_with_logits,
    )

    class VbModel(torch.nn.Module):
        flax_names = {"Dense_0": "head"}

        def __init__(self):
            super().__init__()
            self.ebc = EmbeddingBagCollection(vb_configs(),
                                              max_feature_length=L,
                                              device="meta")
            self.head = torch.nn.Linear(len(VB_ROWS) * VB_DIM, 1,
                                        device="meta")

        def forward(self, sb, labels, example_mask, count):
            logits = self.head(self.ebc(sb).values)[:, 0]
            loss = masked_bce_with_logits(logits, labels, example_mask,
                                          count)
            return loss, (loss, logits)

    plan = ShardingPlan({VB_KEY: {c.name: ParameterSharding(
        ShardingType.ROW_WISE) for c in vb_configs()}})
    return DistributedModelParallel(
        VbModel(), env=env, plan=plan,
        fused_params={"learning_rate": VB_FUSED_LR},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=VB_DENSE_LR))


def run_vb_dmp_case(env, init: dict, out: dict) -> None:
    from torchrec_tpu_torch.utils import tracing
    from torchrec_tpu_torch.utils.jax_bridge import (
        fused_optimizer_state,
        load_jax_weights,
    )

    rank, n = env.rank, env.world_size
    dmp = build_vb_dmp(env)
    load_jax_weights(
        dmp, unflatten({k[6:]: v for k, v in init.items()
                        if k.startswith("dense/")}),
        {k[6:]: v for k, v in init.items() if k.startswith("table/")})
    vb = vb_batch()
    b = vb.padded_batch_per_device * len(VB_SIZES) // n
    args = (_local(vb.sparse, rank, n), vb.labels[rank * b:(rank + 1) * b],
            vb.example_mask[rank * b:(rank + 1) * b], vb.rank_count(n))
    step = dmp.make_train_step()
    for s in range(VB_STEPS):
        before = tracing.counts()
        loss, (_, logits) = step(*args)
        _calls(f"vb/dmp/step{s}", before, out)
        out[f"vb/dmp/loss{s}"] = loss.numpy()
        out[f"vb/dmp/logits{s}"] = logits.detach().numpy()
    for name, p in dmp.module.named_parameters():
        out[f"vb/dmp/param/{name}"] = p.detach().numpy()
    for name, t in dmp.sharded_ebcs[VB_KEY].unshard_to_dense().items():
        out[f"vb/dmp/table/{name}"] = t
    for name, entry in fused_optimizer_state(dmp).items():
        out[f"vb/dmp/m1/{name}"] = np.asarray(entry["m1__row"])


def spawn(what: str, n: int, directory: pathlib.Path) -> list:
    """Run this script's `what` cases on n gloo ranks (the init file
    `<what>_init.npz` already in `directory`); each rank's outputs. A rank's
    log goes to a file, so that no rank blocks on a full pipe."""
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

    env = ShardingEnv.from_process_group(dist.group.WORLD, "cpu")
    assert (env.rank, env.world_size) == (rank, n)
    init = dict(np.load(pathlib.Path(init_file).parent / f"{what}_init.npz"))
    out: dict = {}
    if what == "tower":
        for variant in TOWER_VARIANTS:
            for optim in TOWER_OPTIMS:
                run_tower_case(env, variant, optim, init, out)
    else:
        for st in VB_STRATEGIES:
            run_vb_strategy_case(env, st, out)
        run_vb_dmp_case(env, init, out)
    out["jax_imported"] = np.asarray("jax" in sys.modules)
    np.savez(os.path.join(out_dir, f"{what}{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
         sys.argv[5])
