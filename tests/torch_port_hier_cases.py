"""The port's side of tests/test_torch_port_hierarchical.py: one rank of a
gloo process group on the CPU.

Run as a script, one process per rank:

    python tests/torch_port_hier_cases.py RANK WORLD OUT_DIR INIT

INIT is a file for the group's rendezvous, or "env" to start the group
with `ShardingEnv.from_distributed(device="cpu")` from torchrun's
variables (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, LOCAL_WORLD_SIZE).
Each rank runs the cases below for every local size of CONFIGS at its
world size, all on the one group (the envs differ in `local_size` only),
and writes its outputs to OUT_DIR/rank<RANK>.npz, keyed
"n<N>l<LC>/<case>/<what>". The test compares them with the JAX package on
`jax.devices()[:N]` with the same local size. This module imports torch,
numpy and the port only, never JAX: the test imports it for the seeded
inputs it shares with the ranks.

Cases (three tables of 50, 131 and 77 rows, D = 16, table 1 read by two
features and pooled by MEAN, table i on host i % H):
- pooled/<st>/<optim>/<routing>: TABLE_ROW_WISE and TABLE_COLUMN_WISE
  under every optimizer and both input routings, with per-sample weights:
  loaded from seeded tables and optimizer state (TWCW's rowwise state
  "cwrow", one row space per column shard), the forward, one update, the
  rank's buffers, the unsharded tables and optimizer state, the input
  dist, the collective calls;
- sequence/TABLE_ROW_WISE/<optim>/<routing>: the same unpooled (L = 4);
- dist/<kind>/<st>: a strategy's `forward_from_dist` / `update_from_dist`
  on its `input_dist` against its `forward` / `update`, for every strategy
  with an input dist;
- load/<st>: `init_weights`, `shard_from_dense` and `shard_opt_from_tables`
  watched for the largest tensor any op makes;
- groups: the env's subgroups' ranks and an all_gather of the ranks over
  each;
- dmp/<driver>: a DLRMTrain DMP (four tables: DATA_PARALLEL,
  TABLE_ROW_WISE, TABLE_COLUMN_WISE, ROW_WISE) from INIT_DIR/dlrm_init.npz
  trained STEPS steps by `make_prefetched_train_step` ("a2a" routing) and
  by `SparseDistPipeline` ("allgather"), and `make_train_step` for the
  collective count: losses, dense parameters, tables, calls per step;
- fp (world size 2): a position-weighted DLRM (ROW_WISE, TABLE_WISE,
  TABLE_ROW_WISE, TABLE_COLUMN_WISE) from fp_init.npz trained STEPS steps;
- quant (world size 4): the sharded quantized EBC over `from_local(4)`
  with explicit table ranks (rank 0 holds none): its packed bytes and
  pooled values.
"""

from __future__ import annotations

import datetime
import math
import os
import pathlib
import sys
import warnings

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

ROWS = (50, 131, 77)
FEAT_TABLE = (0, 1, 1, 2)  # the table each feature reads
FEATS = tuple(f"f{i}" for i in range(len(FEAT_TABLE)))
D, B, L, SEQ_L = 16, 8, 3, 4
# (world size, local size)
CONFIGS = ((4, 1), (4, 2), (4, 4), (2, 2))
HIER = ("TABLE_ROW_WISE", "TABLE_COLUMN_WISE")
OPTIMS = ("SGD", "EXACT_SGD", "ADAGRAD", "ROWWISE_ADAGRAD", "ADAM",
          "PARTIAL_ROWWISE_ADAM", "LAMB", "PARTIAL_ROWWISE_LAMB", "LARS_SGD")
ROUTINGS = ("allgather", "a2a")
# strategies with an input dist, pooled and sequence
DIST_CASES = (("pooled", "ROW_WISE"), ("pooled", "TABLE_WISE"),
              ("pooled", "COLUMN_WISE"), ("pooled", "TABLE_ROW_WISE"),
              ("pooled", "TABLE_COLUMN_WISE"), ("sequence", "ROW_WISE"),
              ("sequence", "TABLE_WISE"), ("sequence", "TABLE_ROW_WISE"))
FUSED_LR, DENSE_LR, STEPS, START_STEP = 0.1, 0.05, 3, 4
INIT_SEED, INIT_CHUNK = 7, 32
# the DMP cases: four tables, one feature each
DLRM_ROWS = ROWS + (20,)
DLRM_PLAN = ("DATA_PARALLEL", "TABLE_ROW_WISE", "TABLE_COLUMN_WISE",
             "ROW_WISE")
DENSE_IN = 5
PORT_KEY = "dlrm/sparse_arch/embedding_bag_collection"
# the position-weighted DLRM: four tables of 50 rows, D = 8, L = 4
FP_ROWS, FP_D, FP_L, FP_B = 50, 8, 4, 16
FP_PLAN = ("ROW_WISE", "TABLE_WISE", "TABLE_ROW_WISE", "TABLE_COLUMN_WISE")
FP_MAX_LENGTHS = {"f1": 2, "f2": 6, "f3": 4}
# the quantized module: table ranks of its four tables at world size 4
QUANT_RANKS = {"t0": 3, "t1": 1, "t2": 1, "t3": 2}
QUANT_L = 1
TIMEOUT_S = 120


def tag(n: int, lc: int) -> str:
    return f"n{n}l{lc}"


def host_of(i: int, hosts: int) -> int:
    return i % hosts


def case_seed(*parts: str) -> int:
    """A seed per case, the same in every process (str hash is salted)."""
    return sum((i + 1) * ord(c) for i, c in enumerate("/".join(parts)))


def dense_tables(seed: int, rows=ROWS, dim=D) -> dict:
    rng = np.random.RandomState(seed)
    return {f"t{i}": (rng.randn(r, dim) * 0.1).astype(np.float32)
            for i, r in enumerate(rows)}


def global_batch(seed: int, weighted: bool, length: int = L,
                 feat_rows=tuple(ROWS[t] for t in FEAT_TABLE),
                 batch: int = B):
    """(ids [F, B, L], lengths [F, B], weights or None) of the global
    batch: ids in each feature's table range, lengths 0..L; the batch's
    halves differ."""
    rng = np.random.RandomState(seed)
    ids = np.stack([rng.randint(0, r, size=(batch, length))
                    for r in feat_rows]).astype(np.int32)
    lengths = rng.randint(0, length + 1,
                          size=(len(feat_rows), batch)).astype(np.int32)
    w = (rng.rand(len(feat_rows), batch, length).astype(np.float32) + 0.5
         if weighted else None)
    return ids, lengths, w


def cotangent(seed: int, shape) -> np.ndarray:
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def opt_tables(optim: str, seed: int, shards: int = 1) -> dict:
    """Seeded per-table optimizer state in the canonical form, step
    START_STEP; a rowwise momentum in the row space of `shards` column
    shards ("cwrow" [S, R] when S > 1)."""
    from torchrec_tpu_torch.ops.fused_update import (
        EmbOptimType,
        fused_state_shapes,
    )

    rng = np.random.RandomState(seed)
    out = {}
    for i, r in enumerate(ROWS):
        entry = {"step": np.asarray(START_STEP, np.int32)}
        for name, kind in zip(("m1", "m2"),
                              fused_state_shapes(EmbOptimType[optim])):
            if kind == "full":
                entry[f"{name}__full"] = (rng.rand(r, D) * 0.01).astype(
                    np.float32)
            elif kind == "row" and shards > 1:
                entry[f"{name}__cwrow"] = (rng.rand(shards, r) * 0.01
                                           ).astype(np.float32)
            elif kind == "row":
                entry[f"{name}__row"] = (rng.rand(r) * 0.01).astype(
                    np.float32)
        out[f"t{i}"] = entry
    return out


def case_inputs(kind: str, st: str, optim: str, lc: int):
    """(tables, optimizer state, ids, lengths, weights, cotangent) of a
    strategy case: the tables and the batch depend on the strategy only,
    the optimizer state on the optimizer too."""
    seq = kind == "sequence"
    seed = case_seed(kind, st)
    ids, lengths, w = global_batch(seed + 2, not seq, SEQ_L if seq else L)
    d = cotangent(seed + 3, (len(FEATS), B, SEQ_L, D) if seq
                  else (len(FEATS), B, D))
    shards = lc if st == "TABLE_COLUMN_WISE" else 1
    return (dense_tables(seed), opt_tables(optim, case_seed(optim) + seed,
                                           shards), ids, lengths, w, d)


def jagged(ids: np.ndarray, lengths: np.ndarray):
    """KJT values and lengths of a padded [F, B, L] batch."""
    values = np.concatenate([ids[f, b, :lengths[f, b]]
                             for f in range(ids.shape[0])
                             for b in range(ids.shape[1])]).astype(np.int32)
    return values, lengths.reshape(-1).astype(np.int32)


def dlrm_request(seed: int, rows=DLRM_ROWS, batch: int = B,
                 length: int = L):
    """(ids, lengths, dense [B, 5], labels [B]) of a global DLRM batch."""
    ids, lengths, _ = global_batch(seed, False, length, rows, batch)
    rng = np.random.RandomState(seed + 1)
    dense = rng.randn(batch, DENSE_IN).astype(np.float32)
    labels = rng.randint(0, 2, size=batch).astype(np.float32)
    return ids, lengths, dense, labels


def quant_tables():
    return dense_tables(case_seed("quant"), DLRM_ROWS)


# -- the ranks' side ---------------------------------------------------------


def _rows(x: np.ndarray, rank: int, n: int, axis: int = 1) -> np.ndarray:
    b = x.shape[axis] // n
    return np.take(x, np.arange(rank * b, (rank + 1) * b), axis=axis)


def _configs(seq: bool, rows=ROWS, feat_table=FEAT_TABLE, dim=D,
             mean: bool = True):
    from torchrec_tpu_torch.modules import EmbeddingBagConfig, EmbeddingConfig
    from torchrec_tpu_torch.modules.embedding_configs import PoolingType

    feats = [[f"f{f}" for f, t in enumerate(feat_table) if t == i]
             for i in range(len(rows))]
    if seq:
        return [EmbeddingConfig(num_embeddings=r, embedding_dim=dim,
                                name=f"t{i}", feature_names=feats[i])
                for i, r in enumerate(rows)]
    return [EmbeddingBagConfig(
        num_embeddings=r, embedding_dim=dim, name=f"t{i}",
        feature_names=feats[i],
        pooling=PoolingType.MEAN if mean and i == 1 else PoolingType.SUM)
        for i, r in enumerate(rows)]


def _strategy(env, kind: str, st: str, optim: str, routing="allgather"):
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

    seq = kind == "sequence"
    cfgs = _configs(seq)
    plan = {c.name: ParameterSharding(
        ShardingType[st], ranks=[(i + 1) % env.world_size]
        if st == "TABLE_WISE" else None,
        host=host_of(i, env.num_hosts)) for i, c in enumerate(cfgs)}
    (meta,) = group_tables(cfgs, embedding_names_by_table(cfgs), plan,
                           is_weighted=not seq)
    create = (create_sequence_sharding_strategy if seq
              else create_sharding_strategy)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # _convert_rowspace's
        return create(env, meta, EmbOptimType[optim],
                      {"input_routing": routing})


def _batch(ids, lengths, w, rank, n):
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    return PaddedSparseBatch(
        ids=torch.as_tensor(_rows(ids, rank, n)),
        lengths=torch.as_tensor(_rows(lengths, rank, n)),
        keys=FEATS,
        weights=None if w is None else torch.as_tensor(_rows(w, rank, n)))


def _loaded(env, kind, st, optim, routing="allgather"):
    strat = _strategy(env, kind, st, optim, routing)
    tables, opt, ids, lengths, w, d = case_inputs(kind, st, optim,
                                                  env.local_size)
    strat.weights = strat.shard_from_dense(tables)
    strat.shard_opt_from_tables(opt)
    sb = _batch(ids, lengths, w, env.rank, env.world_size)
    return strat, sb, torch.as_tensor(_rows(d, env.rank, env.world_size))


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
        for key, v in entry.items():
            out[f"{prefix}/opt/{name}/{key}"] = np.asarray(v)


def _calls(prefix: str, before: dict, out: dict) -> None:
    from torchrec_tpu_torch.utils import tracing

    for k, v in tracing.counts().items():
        if k.startswith("comm."):
            out[f"{prefix}/calls/{k[5:]}"] = np.asarray(v - before.get(k, 0))


def run_strategy_case(env, kind, st, optim, routing, out, prefix):
    from torchrec_tpu_torch.utils import tracing

    strat, sb, d = _loaded(env, kind, st, optim, routing)
    out[f"{prefix}/loaded"] = strat.weights.numpy().copy()
    dist_ = strat.input_dist(sb)
    for what, t in zip(("ids", "lengths", "weights"), dist_):
        if t is not None:
            out[f"{prefix}/dist/{what}"] = t.numpy()
    before = tracing.counts()
    fwd = strat(sb)
    _calls(prefix + "/fwd", before, out)
    out[f"{prefix}/forward"] = fwd.numpy()
    before = tracing.counts()
    with torch.no_grad():
        strat.update(sb, d, FUSED_LR)
    _calls(prefix + "/upd", before, out)
    _state_out(prefix, strat, out)


def _same(a, b) -> bool:
    return a is b or (a is not None and b is not None
                      and torch.equal(a, b))


def run_dist_case(env, kind, st, out, prefix):
    """forward / update against forward_from_dist / update_from_dist on
    the input dist, from one load: equal bit for bit."""
    optim = "ROWWISE_ADAGRAD"
    a, sb, d = _loaded(env, kind, st, optim)
    b, _, _ = _loaded(env, kind, st, optim)
    assert a.supports_input_dist
    with torch.no_grad():
        fa = a(sb)
        a.update(sb, d, FUSED_LR)
        dist_ = b.input_dist(sb)
        fb = b.forward_from_dist(dist_)
        b.update_from_dist(dist_, d, FUSED_LR)
    out[f"{prefix}/equal"] = np.asarray(
        torch.equal(fa, fb) and all(_same(getattr(a, k), getattr(b, k))
                                    for k in ("weights", "momentum1",
                                              "momentum2", "step")))


class _Largest(TorchDispatchMode):
    """Records the numel of the largest tensor any op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        result = func(*args, **(kwargs or {}))
        for t in tree_leaves(result):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return result


def run_load_case(env, st, out, prefix):
    from torchrec_tpu_torch.parallel import strategies

    optim = "ROWWISE_ADAGRAD"
    strat = _strategy(env, "pooled", st, optim)
    tables, opt, *_ = case_inputs("pooled", st, optim, env.local_size)
    chunk, strategies.INIT_CHUNK_ROWS = strategies.INIT_CHUNK_ROWS, INIT_CHUNK
    try:
        with _Largest() as seen:
            drawn = strat.init_weights(
                torch.Generator().manual_seed(INIT_SEED))
            strat.weights = strat.shard_from_dense(tables)
            strat.shard_opt_from_tables(opt)
    finally:
        strategies.INIT_CHUNK_ROWS = chunk
    out[f"{prefix}/largest"] = np.asarray(seen.numel)
    out[f"{prefix}/local"] = np.asarray(math.prod(strat.local_shape()))
    out[f"{prefix}/global"] = np.asarray(math.prod(strat.weights_shape()))
    out[f"{prefix}/weights"] = strat.weights.numpy()
    out[f"{prefix}/momentum1"] = strat.momentum1.numpy()
    for name, t in strat.unshard_to_dense(drawn).items():
        out[f"{prefix}/init/{name}"] = t


def run_groups_case(env, out, prefix):
    from torchrec_tpu_torch.parallel import comm

    me = torch.tensor([env.rank])
    for what, group in zip(("intra", "cross"), env.subgroups()):
        out[f"{prefix}/{what}/ranks"] = np.asarray(
            dist.get_process_group_ranks(group))
        out[f"{prefix}/{what}/gathered"] = comm.all_gather(
            env, me, 0, group=group).numpy()
        out[f"{prefix}/{what}/stacked"] = comm.all_gather(
            env, me, 0, tiled=False, group=group).numpy()


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for k, v in flat.items():
        node = tree
        parts = k.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def _init(path: pathlib.Path):
    init = dict(np.load(path))
    dense = _unflatten({k[len("dense/"):]: v for k, v in init.items()
                        if k.startswith("dense/")})
    tables = {k[len("table/"):]: v for k, v in init.items()
              if k.startswith("table/")}
    return dense, tables


def build_port_dmp(env, optim: str, routing: str = "allgather"):
    """DLRMTrain over the four DLRM tables under DLRM_PLAN."""
    from torchrec_tpu_torch.models import DLRM, DLRMTrain
    from torchrec_tpu_torch.modules import EmbeddingBagCollection
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    tables = _configs(False, DLRM_ROWS, tuple(range(len(DLRM_ROWS))))
    plan = ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
        ShardingType[s], host=host_of(i, env.num_hosts))
        for i, (t, s) in enumerate(zip(tables, DLRM_PLAN))}})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)  # flat a2a fallback
        return DistributedModelParallel(
            DLRMTrain(DLRM(EmbeddingBagCollection(
                tables, max_feature_length=L, device="meta"),
                DENSE_IN, (16, D), (8, 1), device="meta")),
            env=env, plan=plan, fused_optim=EmbOptimType[optim],
            fused_params={"learning_rate": FUSED_LR,
                          "input_routing": routing},
            dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR))


def _kjt(ids, lengths, rank, n):
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    values, lens = jagged(_rows(ids, rank, n), _rows(lengths, rank, n))
    return KeyedJaggedTensor.from_lengths(
        [f"f{i}" for i in range(ids.shape[0])], values, lens)


def _dmp_args(env, seed):
    ids, lengths, dense, labels = dlrm_request(seed)
    r, n = env.rank, env.world_size
    return (torch.as_tensor(_rows(dense, r, n, 0)), _kjt(ids, lengths, r, n),
            torch.as_tensor(_rows(labels, r, n, 0)))


def _dmp_out(prefix, dmp, out):
    for name, p in dmp.module.named_parameters():
        out[f"{prefix}/param/{name}"] = p.detach().numpy()
    for name, t in dmp.sharded_ebcs[PORT_KEY].unshard_to_dense().items():
        out[f"{prefix}/table/{name}"] = t


def run_dmp_case(env, init_dir: pathlib.Path, out, prefix):
    """The same STEPS batches through make_train_step, the prefetched step
    (a2a routing) and SparseDistPipeline (allgather), each DMP from the
    JAX init."""
    from torchrec_tpu_torch.parallel.train_pipeline import (
        SparseDistPipeline,
    )
    from torchrec_tpu_torch.utils import tracing
    from torchrec_tpu_torch.utils.jax_bridge import load_jax_weights

    dense, tables = _init(init_dir / "dlrm_init.npz")
    batches = [_dmp_args(env, case_seed("dmp", str(s)))
               for s in range(STEPS)]
    for driver, routing in (("train_step", "allgather"),
                            ("prefetched", "a2a"),
                            ("pipeline", "allgather")):
        p = f"{prefix}/{driver}"
        dmp = build_port_dmp(env, "ROWWISE_ADAGRAD", routing)
        load_jax_weights(dmp, dense, tables)
        if driver == "train_step":
            step = dmp.make_train_step()
            run = (step(*b) for b in batches)
        elif driver == "prefetched":
            step = dmp.make_prefetched_train_step()
            dists = [dmp.input_dist(batches[0][1])]

            def prefetched(i, b):
                loss, aux, dists[0] = step(
                    dists[0], batches[min(i + 1, STEPS - 1)][1], *b)
                return loss, aux

            run = (prefetched(i, b) for i, b in enumerate(batches))
        else:
            pipe = SparseDistPipeline(dmp, device="cpu")
            it = iter(batches)
            run = (pipe.progress(it) for _ in batches)
        for s in range(STEPS):
            before = tracing.counts()
            loss, _ = next(run)
            _calls(f"{p}/step{s}", before, out)
            out[f"{p}/loss{s}"] = loss.numpy()
        _dmp_out(p, dmp, out)


def build_fp_dmp(env):
    """The position-weighted DLRMTrain under FP_PLAN, EXACT_SGD."""
    from torchrec_tpu_torch.models import DLRM, DLRMTrain
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
        FeatureProcessedEmbeddingBagCollection,
        PositionWeightedModule,
    )
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingPlan,
        ShardingType,
    )

    tables = [EmbeddingBagConfig(num_embeddings=FP_ROWS, embedding_dim=FP_D,
                                 name=f"t{i}", feature_names=[f"f{i}"])
              for i in range(len(FP_PLAN))]
    fp = FeatureProcessedEmbeddingBagCollection(
        EmbeddingBagCollection(tables, is_weighted=True,
                               max_feature_length=FP_L, device="meta"),
        PositionWeightedModule(FP_MAX_LENGTHS, device="meta"))
    plan = ShardingPlan({PORT_KEY: {t.name: ParameterSharding(
        ShardingType[s], ranks=[1] if s == "TABLE_WISE" else None, host=0)
        for t, s in zip(tables, FP_PLAN)}})
    return DistributedModelParallel(
        DLRMTrain(DLRM(fp, DENSE_IN, (FP_D,), (8, 1), device="meta")),
        env=env, plan=plan, fused_optim=EmbOptimType.EXACT_SGD,
        fused_params={"learning_rate": FUSED_LR},
        dense_optimizer=lambda p: torch.optim.SGD(p, lr=DENSE_LR))


def fp_request(seed: int):
    return dlrm_request(seed, (FP_ROWS,) * len(FP_PLAN), FP_B, FP_L)


def run_fp_case(env, init_dir: pathlib.Path, out, prefix):
    from torchrec_tpu_torch.utils.jax_bridge import load_jax_weights

    dense, tables = _init(init_dir / "fp_init.npz")
    dmp = build_fp_dmp(env)
    load_jax_weights(dmp, dense, tables)
    step = dmp.make_train_step()
    r, n = env.rank, env.world_size
    for s in range(STEPS):
        ids, lengths, dense_x, labels = fp_request(case_seed("fp", str(s)))
        loss, _ = step(torch.as_tensor(_rows(dense_x, r, n, 0)),
                       _kjt(ids, lengths, r, n),
                       torch.as_tensor(_rows(labels, r, n, 0)))
        out[f"{prefix}/loss{s}"] = loss.numpy()
    _dmp_out(prefix, dmp, out)


def run_quant_case(out, prefix):
    from torchrec_tpu_torch.modules.embedding_configs import DataType
    from torchrec_tpu_torch.parallel import ShardingEnv
    from torchrec_tpu_torch.parallel.quant_sharded import (
        ShardedQuantEmbeddingBagCollection,
    )
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    env = ShardingEnv.from_local(4, "cpu")
    # SUM pooling: bit for bit with JAX
    cfgs = _configs(False, DLRM_ROWS, tuple(range(len(DLRM_ROWS))),
                    mean=False)
    ids, lengths, w = global_batch(case_seed("quant", "batch"), True,
                                   QUANT_L, DLRM_ROWS)
    sb = PaddedSparseBatch(ids=torch.as_tensor(ids),
                           lengths=torch.as_tensor(lengths),
                           keys=tuple(f"f{i}" for i in range(4)),
                           weights=torch.as_tensor(w))
    for dtype in ("INT8", "INT4"):
        sq = ShardedQuantEmbeddingBagCollection.from_float(
            env, cfgs, quant_tables(), DataType[dtype],
            table_ranks=QUANT_RANKS, is_weighted=True,
            max_feature_length=QUANT_L)
        for part in ("data", "scale", "shift"):
            out[f"{prefix}/{dtype}/{part}"] = getattr(sq, part).numpy()
        out[f"{prefix}/{dtype}/values"] = sq(sb).values.numpy()


def run_config(env, n, lc, init_dir, out):
    t = tag(n, lc)
    run_groups_case(env, out, f"{t}/groups")
    for st in HIER:
        for optim in OPTIMS:
            for routing in ROUTINGS:
                run_strategy_case(env, "pooled", st, optim, routing, out,
                                  f"{t}/pooled/{st}/{optim}/{routing}")
        run_load_case(env, st, out, f"{t}/load/{st}")
    for optim in OPTIMS:
        for routing in ROUTINGS:
            run_strategy_case(
                env, "sequence", "TABLE_ROW_WISE", optim, routing, out,
                f"{t}/sequence/TABLE_ROW_WISE/{optim}/{routing}")
    for kind, st in DIST_CASES:
        run_dist_case(env, kind, st, out, f"{t}/dist/{kind}/{st}")
    run_dmp_case(env, init_dir, out, f"{t}/dmp")


def main(rank: int, n: int, out_dir: str, init: str) -> None:
    torch.set_num_threads(1)
    from torchrec_tpu_torch.parallel import ShardingEnv

    if init == "env":
        world = ShardingEnv.from_distributed(device="cpu")
    else:
        dist.init_process_group(
            "gloo", init_method=f"file://{init}", rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        world = ShardingEnv.from_process_group(dist.group.WORLD, "cpu")
    assert (world.rank, world.world_size) == (rank, n)
    out: dict = {"local_size": np.asarray(world.local_size)}
    init_dir = pathlib.Path(out_dir)
    for cn, lc in CONFIGS:
        if cn == n:
            env = ShardingEnv.from_process_group(dist.group.WORLD, "cpu",
                                                 local_size=lc)
            run_config(env, n, lc, init_dir, out)
    if n == 2:
        run_fp_case(world, init_dir, out, "fp")
    if n == 4:
        run_quant_case(out, "quant")
    out["jax_imported"] = np.asarray("jax" in sys.modules)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
