"""The port's side of tests/test_torch_port_distributed.py: one rank of a
gloo process group on the CPU.

Run as a script, one process per rank:

    python tests/torch_port_gloo_cases.py RANK WORLD OUT_DIR INIT_FILE

Each rank joins the group through the file `INIT_FILE`, runs every case
below on its slice of seeded global batches and writes its outputs to
OUT_DIR/rank<RANK>.npz, keyed "<case>/<what>". The test compares them
with the JAX package on `jax.devices()[:WORLD]`. This module imports
torch, numpy and the port only, never JAX: the test imports it for the
seeded inputs it shares with the ranks.

Cases:
- pooled/<st>/<optim>: a strategy of three tables (50, 131, 77 rows,
  D = 16, one MEAN; per-sample weights on ROW_WISE and TABLE_WISE) under
  DATA_PARALLEL, ROW_WISE, TABLE_WISE (table i on rank (i + 1) % n, so
  rank 0 holds none at n = 4) or COLUMN_WISE: forward, one update, the
  rank's buffers, the unsharded tables and optimizer state;
- sequence/<st>/<optim>: the same for DATA_PARALLEL, ROW_WISE and
  TABLE_WISE sequence strategies (L = 4);
- dmp/<optim>: a DLRMTrain DMP under a mixed plan (one table of each
  pooled strategy, the TABLE_WISE one on rank 1, or 0 in a world of one)
  from the JAX DMP's
  initial state in INIT_FILE's sibling `dlrm_init.npz`: eval logits and
  three train steps (losses, logits, dense parameters, tables, optimizer
  state);
- bf16/<optim>: a ROW_WISE bf16 group trained one step with stochastic
  rounding on (EXACT_SGD, ROWWISE_ADAGRAD);
- load/<st>/<optim>: the pooled strategy's tables drawn by `init_weights`
  (from INIT_SEED, in chunks of INIT_CHUNK rows), then loaded by
  `shard_from_dense` and `shard_opt_from_tables` (ROWWISE_ADAGRAD, ADAM):
  the rank's blocks, the unsharded drawn tables, and the largest tensor
  any op made meanwhile beside the sizes of the rank's block and of the
  global layout.
Each case also records the collective calls it made (`comm.*` counters,
utils/tracing.py).
"""

from __future__ import annotations

import datetime
import math
import os
import pathlib
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ROWS = (50, 131, 77)
DLRM_ROWS = ROWS + (20,)
D, B, L, SEQ_L = 16, 8, 3, 4
DENSE_IN = 5
POOLED = ("DATA_PARALLEL", "ROW_WISE", "TABLE_WISE", "COLUMN_WISE")
SEQUENCE = ("DATA_PARALLEL", "ROW_WISE", "TABLE_WISE")
POOLED_OPTIMS = ("EXACT_SGD", "ROWWISE_ADAGRAD", "ADAM")
SEQUENCE_OPTIMS = ("EXACT_SGD", "ROWWISE_ADAGRAD")
DMP_OPTIMS = ("EXACT_SGD", "ROWWISE_ADAGRAD")
LOAD_OPTIMS = ("ROWWISE_ADAGRAD", "ADAM")
INIT_SEED, INIT_CHUNK = 7, 32
MIXED = ("DATA_PARALLEL", "TABLE_WISE", "COLUMN_WISE", "ROW_WISE")
FUSED_LR, DENSE_LR, STEPS, START_STEP = 0.1, 0.05, 3, 4
PORT_KEY = "dlrm/sparse_arch/embedding_bag_collection"
TIMEOUT_S = 120


def tw_rank(i: int, n: int) -> int:
    """The TABLE_WISE rank of table i: (i + 1) % n."""
    return (i + 1) % n


def dmp_tw_rank(n: int) -> int:
    """The DMP's TABLE_WISE table's rank: 1, or 0 in a world of one."""
    return min(1, n - 1)


def weighted(st: str) -> bool:
    return st in ("ROW_WISE", "TABLE_WISE")


def dense_tables(seed: int, rows=ROWS) -> dict:
    rng = np.random.RandomState(seed)
    return {f"t{i}": (rng.randn(r, D) * 0.1).astype(np.float32)
            for i, r in enumerate(rows)}


def global_batch(seed: int, with_weights: bool, length: int = L):
    """(ids [F, B, L], lengths [F, B], weights or None) of the global
    batch: ids in each table's range, lengths 0..L."""
    rng = np.random.RandomState(seed)
    ids = np.stack([rng.randint(0, r, size=(B, length))
                    for r in ROWS]).astype(np.int32)
    lengths = rng.randint(0, length + 1, size=(len(ROWS), B)).astype(np.int32)
    w = (rng.rand(len(ROWS), B, length).astype(np.float32) + 0.5
         if with_weights else None)
    return ids, lengths, w


def cotangent(seed: int, shape) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def opt_tables(optim: str, seed: int, rows=ROWS) -> dict:
    """Seeded per-table optimizer state in the canonical form, step
    START_STEP."""
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        fused_state_shapes,
    )

    rng = np.random.RandomState(seed)
    out = {}
    for i, r in enumerate(rows):
        entry = {"step": np.asarray(START_STEP, np.int32)}
        for tag, kind in zip(("m1", "m2"),
                             fused_state_shapes(EmbOptimType[optim])):
            shape = {"row": (r,), "full": (r, D)}.get(kind)
            if shape is not None:
                entry[f"{tag}__{kind}"] = (rng.rand(*shape) * 0.01).astype(
                    np.float32)
        out[f"t{i}"] = entry
    return out


def case_seed(*parts: str) -> int:
    """A seed per case, the same in every process (str hash is salted)."""
    return sum((i + 1) * ord(c) for i, c in enumerate("/".join(parts)))


def dlrm_request(seed: int):
    """(ids, lengths, dense [B, 5], labels [B]) of a global DLRM batch in
    KeyedJaggedTensor form; the halves of the batch differ."""
    rng = np.random.RandomState(seed)
    lengths = rng.randint(0, L + 1, size=(len(DLRM_ROWS), B)).astype(
        np.int32)
    ids = [rng.randint(0, r, size=(B, L)).astype(np.int32)
           for r in DLRM_ROWS]
    dense = rng.randn(B, DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=B).astype(np.float32)
    return np.stack(ids), lengths, dense, labels


def jagged(ids: np.ndarray, lengths: np.ndarray):
    """KJT values and lengths of a padded [F, B, L] batch."""
    values = np.concatenate([ids[f, b, :lengths[f, b]]
                             for f in range(ids.shape[0])
                             for b in range(ids.shape[1])]).astype(np.int32)
    return values, lengths.reshape(-1).astype(np.int32)


# -- the ranks' side ---------------------------------------------------------


def _rows(x: np.ndarray, rank: int, n: int, axis: int = 1) -> np.ndarray:
    b = x.shape[axis] // n
    return np.take(x, np.arange(rank * b, (rank + 1) * b), axis=axis)


def _strategy(env, st: str, optim: str, seq: bool, dtype=None):
    from torchrec_tpu_torch.modules import EmbeddingBagConfig, EmbeddingConfig
    from torchrec_tpu_torch.modules.embedding_configs import (
        DataType,
        PoolingType,
    )
    from torchrec_tpu_torch.modules.embedding_modules import (
        embedding_names_by_table,
    )
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import ParameterSharding, ShardingType
    from torchrec_tpu_torch.parallel.embedding_sharding import group_tables
    from torchrec_tpu_torch.parallel.sequence_strategies import (
        create_sequence_sharding_strategy,
    )
    from torchrec_tpu_torch.parallel.strategies import (
        create_sharding_strategy,
    )

    dt = dtype or DataType.FP32
    if seq:
        cfgs = [EmbeddingConfig(num_embeddings=r, embedding_dim=D,
                                name=f"t{i}", feature_names=[f"f{i}"],
                                data_type=dt) for i, r in enumerate(ROWS)]
    else:
        cfgs = [EmbeddingBagConfig(
            num_embeddings=r, embedding_dim=D, name=f"t{i}",
            feature_names=[f"f{i}"], data_type=dt,
            pooling=PoolingType.MEAN if i == 1 else PoolingType.SUM)
            for i, r in enumerate(ROWS)]
    plan = {c.name: ParameterSharding(
        ShardingType[st],
        ranks=[tw_rank(i, env.world_size)] if st == "TABLE_WISE" else None)
        for i, c in enumerate(cfgs)}
    (meta,) = group_tables(cfgs, embedding_names_by_table(cfgs), plan,
                           is_weighted=not seq and weighted(st))
    create = (create_sequence_sharding_strategy if seq
              else create_sharding_strategy)
    return create(env, meta, EmbOptimType[optim], {})


def _batch(ids, lengths, w, rank, n):
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    return PaddedSparseBatch(
        ids=torch.as_tensor(_rows(ids, rank, n)),
        lengths=torch.as_tensor(_rows(lengths, rank, n)),
        keys=tuple(f"f{i}" for i in range(ids.shape[0])),
        weights=None if w is None else torch.as_tensor(_rows(w, rank, n)))


def _state_out(prefix: str, strat, out: dict) -> None:
    out[f"{prefix}/weights"] = strat.weights.float().numpy()
    for name in ("momentum1", "momentum2"):
        m = getattr(strat, name)
        if m is not None:
            out[f"{prefix}/{name}"] = m.numpy()
    out[f"{prefix}/step"] = strat.step.numpy()
    for name, t in strat.unshard_to_dense(strat.weights).items():
        out[f"{prefix}/table/{name}"] = t
    for name, entry in strat.unshard_opt_to_tables().items():
        for tag, v in entry.items():
            out[f"{prefix}/opt/{name}/{tag}"] = np.asarray(v)


def _calls(prefix: str, before: dict, out: dict) -> None:
    from torchrec_tpu_torch.utils import tracing

    for k, v in tracing.counts().items():
        if k.startswith("comm."):
            out[f"{prefix}/calls/{k[5:]}"] = np.asarray(v - before.get(k, 0))


def run_strategy_case(env, kind: str, st: str, optim: str, out: dict,
                      dtype=None) -> None:
    """One strategy's forward and update on this rank's slice."""
    from torchrec_tpu_torch.utils import tracing

    seq = kind == "sequence"
    rank, n = env.rank, env.world_size
    prefix = f"{kind}/{st}/{optim}"
    seed = case_seed(kind, st, optim)
    strat = _strategy(env, st, optim, seq, dtype)
    strat.weights = strat.shard_from_dense(dense_tables(seed))
    strat.shard_opt_from_tables(opt_tables(optim, seed + 1))
    ids, lengths, w = global_batch(seed + 2, not seq and weighted(st),
                                   SEQ_L if seq else L)
    sb = _batch(ids, lengths, w, rank, n)
    before = tracing.counts()
    fwd = strat(sb)
    _calls(prefix + "/fwd", before, out)
    out[f"{prefix}/forward"] = fwd.float().numpy()
    d = cotangent(seed + 3, (len(ROWS), B, SEQ_L, D) if seq
                  else (len(ROWS), B, D))
    before = tracing.counts()
    with torch.no_grad():
        strat.update(sb, torch.as_tensor(_rows(d, rank, n)), FUSED_LR)
    _calls(prefix + "/upd", before, out)
    _state_out(prefix, strat, out)


class _Largest(TorchDispatchMode):
    """Records the numel of the largest tensor any op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


def run_load_case(env, st: str, optim: str, out: dict) -> None:
    """init_weights, shard_from_dense and shard_opt_from_tables on this
    rank, watched for the largest tensor they make."""
    from torchrec_tpu_torch.parallel import strategies

    prefix = f"load/{st}/{optim}"
    seed = case_seed("load", st, optim)
    strat = _strategy(env, st, optim, seq=False)
    chunk, strategies.INIT_CHUNK_ROWS = strategies.INIT_CHUNK_ROWS, INIT_CHUNK
    try:
        with _Largest() as seen:
            drawn = strat.init_weights(
                torch.Generator().manual_seed(INIT_SEED))
            strat.weights = strat.shard_from_dense(dense_tables(seed))
            strat.shard_opt_from_tables(opt_tables(optim, seed + 1))
    finally:
        strategies.INIT_CHUNK_ROWS = chunk
    out[f"{prefix}/largest"] = np.asarray(seen.numel)
    out[f"{prefix}/local"] = np.asarray(math.prod(strat.local_shape()))
    out[f"{prefix}/global"] = np.asarray(math.prod(strat.weights_shape()))
    out[f"{prefix}/weights"] = strat.weights.numpy()
    for name in ("momentum1", "momentum2"):
        m = getattr(strat, name)
        if m is not None:
            out[f"{prefix}/{name}"] = m.numpy()
    for name, t in strat.unshard_to_dense(drawn).items():
        out[f"{prefix}/init/{name}"] = t


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def build_port_dmp(env, optim: str, plan_types=MIXED):
    """DLRMTrain over the four DLRM tables, each sharded as `plan_types`
    says (a TABLE_WISE one on rank 1)."""
    from torchrec_tpu_torch.models import DLRM, DLRMTrain
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
        PoolingType,
    )
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    tables = [EmbeddingBagConfig(
        num_embeddings=r, embedding_dim=D, name=f"t{i}",
        feature_names=[f"f{i}"],
        pooling=PoolingType.MEAN if i == 1 else PoolingType.SUM)
        for i, r in enumerate(DLRM_ROWS)]
    plan = ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
        ShardingType[s],
        ranks=[dmp_tw_rank(env.world_size)] if s == "TABLE_WISE" else None)
        for t, s in zip(tables, plan_types)}})
    return DistributedModelParallel(
        DLRMTrain(DLRM(EmbeddingBagCollection(tables, max_feature_length=L,
                                              device="meta"),
                       DENSE_IN, (16, D), (8, 1), device="meta")),
        env=env, plan=plan, fused_optim=EmbOptimType[optim],
        fused_params={"learning_rate": FUSED_LR},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR))


def _kjt(ids, lengths, rank, n):
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    values, lens = jagged(_rows(ids, rank, n), _rows(lengths, rank, n))
    return KeyedJaggedTensor.from_lengths(
        [f"f{i}" for i in range(len(DLRM_ROWS))], values, lens)


def run_dmp_case(env, optim: str, init_dir: pathlib.Path, out: dict) -> None:
    from torchrec_tpu_torch.utils import tracing
    from torchrec_tpu_torch.utils.jax_bridge import (
        fused_optimizer_state,
        load_jax_weights,
    )

    rank, n = env.rank, env.world_size
    init = dict(np.load(init_dir / "dlrm_init.npz"))
    dense = _unflatten({k[len("dense/"):]: v for k, v in init.items()
                        if k.startswith("dense/")})
    tables = {k[len("table/"):]: v for k, v in init.items()
              if k.startswith("table/")}
    dmp = build_port_dmp(env, optim)
    load_jax_weights(dmp, dense, tables)
    prefix = f"dmp/{optim}"
    ids, lengths, dense_x, labels = dlrm_request(case_seed("dmp", "eval"))
    before = tracing.counts()
    _, (_, logits, _) = dmp.make_eval_fn()(
        torch.as_tensor(_rows(dense_x, rank, n, 0)),
        _kjt(ids, lengths, rank, n),
        torch.as_tensor(_rows(labels, rank, n, 0)))
    _calls(prefix + "/eval", before, out)
    out[f"{prefix}/eval_logits"] = logits.numpy()
    step = dmp.make_train_step()
    for s in range(STEPS):
        ids, lengths, dense_x, labels = dlrm_request(case_seed("dmp", str(s)))
        before = tracing.counts()
        loss, (_, logits, _) = step(
            torch.as_tensor(_rows(dense_x, rank, n, 0)),
            _kjt(ids, lengths, rank, n),
            torch.as_tensor(_rows(labels, rank, n, 0)))
        _calls(f"{prefix}/step{s}", before, out)
        out[f"{prefix}/loss{s}"] = loss.numpy()
        out[f"{prefix}/logits{s}"] = logits.detach().numpy()
    for name, p in dmp.module.named_parameters():
        out[f"{prefix}/param/{name}"] = p.detach().numpy()
    for name, t in dmp.sharded_ebcs[PORT_KEY].unshard_to_dense().items():
        out[f"{prefix}/table/{name}"] = t
    for name, entry in fused_optimizer_state(dmp).items():
        for tag, v in entry.items():
            out[f"{prefix}/opt/{name}/{tag}"] = np.asarray(v)


def main(rank: int, n: int, out_dir: str, init_file: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank, world_size=n,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    from torchrec_tpu_torch.modules.embedding_configs import DataType
    from torchrec_tpu_torch.parallel import ShardingEnv

    env = ShardingEnv.from_process_group(dist.group.WORLD, "cpu")
    assert (env.rank, env.world_size) == (rank, n)
    out: dict = {}
    for st in POOLED:
        for optim in POOLED_OPTIMS:
            run_strategy_case(env, "pooled", st, optim, out)
    for st in SEQUENCE:
        for optim in SEQUENCE_OPTIMS:
            run_strategy_case(env, "sequence", st, optim, out)
    for optim in ("EXACT_SGD", "ROWWISE_ADAGRAD"):
        run_strategy_case(env, "bf16", "ROW_WISE", optim, out,
                          dtype=DataType.BF16)
    for optim in DMP_OPTIMS:
        run_dmp_case(env, optim, pathlib.Path(init_file).parent, out)
    for st in POOLED:
        for optim in LOAD_OPTIMS:
            run_load_case(env, st, optim, out)
    out["jax_imported"] = np.asarray("jax" in sys.modules)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
