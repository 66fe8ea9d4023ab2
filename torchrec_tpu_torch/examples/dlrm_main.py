"""DLRM training CLI: the port's entry point for training on the card.

Counterpart of examples/dlrm_main.py, flag for flag, less the TPU's
`--tpu_gen` and `--coordinator_address`, plus `--device` (default
`cuda`; pass `--device cpu` to run on the CPU, which it refuses
otherwise). One process drives one device; `--multihost` runs one
process a rank under torchrun (`ShardingEnv.from_distributed()`, NCCL on
cards, gloo with `--device cpu`), and `--batch_size` is then each rank's
batch, the reference CLI's meaning.

The run: the tables planned by the sharding planner on the H100's spec
(its stats printed), the DMP under ROWWISE_ADAGRAD with the step
function `--lr_change_point` as its host-side lr schedule and dense SGD,
the tables drawn on the device by the DMP's `init`; then training from
one of three sources:

* `--synthetic`: RandomRecDataset batches drawn on the card;
* `--synthetic_criteo`: the Criteo-Kaggle-calibrated stream, drawn on the
  card (its validation stream on the host, one ground truth);
* `--in_memory_binary_criteo_path DIR`: the `*_dense/_sparse/_labels.npy`
  days through InMemoryBinaryCriteoIterDataPipe (rows hashed to the
  tables, pinned batches), driven by `--train_pipeline base`
  (TrainPipeline) or `sparse_dist` (SparseDistPipeline).

The card-made streams take one warm-up step outside the timed window.
Each epoch ends with validation (AUROC and accuracy from utils/metrics).
`--save_dir` writes the reshardable checkpoint (utils/checkpoint),
`--package_dir` the int8 serving package that dlrm_predict serves.

Usage:
  python -m torchrec_tpu_torch.examples.dlrm_main --synthetic_criteo \\
      --max_ind_range 10131227 --batch_size 8192 --num_batches 50
  python -m torchrec_tpu_torch.examples.dlrm_main \\
      --in_memory_binary_criteo_path DIR --batch_size 8192 \\
      --num_embeddings_per_feature 1460,583,... --train_pipeline sparse_dist
"""

from __future__ import annotations

import argparse
import glob
import itertools
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np

# the DMP's module key of the EBC inside DLRMTrain
EBC_KEY = "dlrm/sparse_arch/embedding_bag_collection"


def parse_args(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description="torchrec_tpu_torch DLRM")
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--batch_size", type=int, default=4096)
    p.add_argument("--num_batches", type=int, default=100,
                   help="synthetic batches per epoch")
    p.add_argument("--embedding_dim", type=int, default=64)
    p.add_argument("--dense_arch_layer_sizes", type=str, default="512,256,64")
    p.add_argument("--over_arch_layer_sizes", type=str,
                   default="512,512,256,1")
    p.add_argument("--num_embeddings", type=int, default=100_000)
    p.add_argument("--num_embeddings_per_feature", type=str, default=None)
    p.add_argument("--learning_rate", type=float, default=1.0)
    p.add_argument("--dense_learning_rate", type=float, default=0.1)
    p.add_argument("--lr_change_point", type=int, default=None,
                   help="step at which the embedding lr drops")
    p.add_argument("--lr_after_change_point", type=float, default=None)
    p.add_argument("--eps", type=float, default=1e-8)
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_criteo", action="store_true",
                   help="Criteo-Kaggle-calibrated synthetic stream: "
                        "published per-feature cardinalities, Zipf ids, "
                        "logistic ground truth at the published CTR")
    p.add_argument("--max_ind_range", type=int, default=1_000_000,
                   help="cap per-feature cardinality")
    p.add_argument("--zipf_a", type=float, default=1.05)
    p.add_argument("--in_memory_binary_criteo_path", type=str, default=None)
    p.add_argument("--undersampled_rate", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dense_dtype", type=str, default="fp32",
                   choices=["fp32", "bf16"],
                   help="compute dtype of the dense arches")
    p.add_argument("--shuffle_batches", action="store_true")
    p.add_argument("--mmap_mode", action="store_true",
                   help="memory-map the Criteo npy files instead of "
                        "loading them into RAM")
    p.add_argument("--validation_freq_within_epoch", type=int, default=None)
    p.add_argument("--train_pipeline", type=str, default="base",
                   choices=["base", "sparse_dist"],
                   help="loader-path pipeline: 'sparse_dist' computes batch "
                        "i+1's sparse input dist inside batch i's step")
    p.add_argument("--save_dir", type=str, default=None,
                   help="write a reshardable checkpoint after training")
    p.add_argument("--package_dir", type=str, default=None,
                   help="export a quantized int8 serving package")
    p.add_argument("--multihost", action="store_true",
                   help="one process a rank under torchrun "
                        "(ShardingEnv.from_distributed)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the current card, or cuda:LOCAL_RANK "
                        "with --multihost) or 'cpu'")
    return p.parse_args(argv)


def _min_over_ranks(env, n: int) -> int:
    """The least `n` over the env's ranks (every rank calls it)."""
    if env.group is None:
        return n
    import torch
    import torch.distributed as dist

    t = torch.tensor([n], dtype=torch.int64, device=env.device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN, group=env.group)
    return int(t.item())


def _mean_over_ranks(env, x: float) -> float:
    if env.group is None:
        return x
    import torch
    import torch.distributed as dist

    t = torch.tensor([x], dtype=torch.float64, device=env.device)
    dist.all_reduce(t, group=env.group)
    return float(t.item()) / env.world_size


def _gather(env, arr: np.ndarray) -> np.ndarray:
    """Every rank's array, concatenated in rank order."""
    if env.group is None:
        return arr
    import torch.distributed as dist

    out: List[Optional[np.ndarray]] = [None] * env.world_size
    dist.all_gather_object(out, arr, group=env.group)
    return np.concatenate(out)


def make_env(args):
    """One device (`--device`), or with `--multihost` the default
    process group started from torchrun's variables."""
    from torchrec_tpu_torch.parallel import ShardingEnv

    # "cuda" is the current card: resolve_device raises without one
    device = None if args.device == "cuda" else args.device
    if not args.multihost:
        return ShardingEnv(device)
    env = ShardingEnv.from_distributed(device=device)
    print(f"multihost: rank {env.rank}/{env.world_size} up, "
          f"{env.num_hosts} hosts x {env.local_size} devices")
    return env


def table_rows(args) -> List[int]:
    """Each feature's table rows, as the flags give them."""
    from torchrec_tpu_torch.datasets.criteo import CAT_FEATURE_COUNT

    if args.num_embeddings_per_feature:
        return [int(x) for x in args.num_embeddings_per_feature.split(",")]
    if args.synthetic_criteo:
        from torchrec_tpu_torch.datasets.synthetic_criteo import (
            CRITEO_KAGGLE_CARDINALITIES,
        )

        return [min(c, args.max_ind_range)
                for c in CRITEO_KAGGLE_CARDINALITIES]
    return [args.num_embeddings] * CAT_FEATURE_COUNT


def build_dmp(args, env, rows: Sequence[int]):
    """The DLRMTrain DMP, planned by the sharding planner (its stats
    printed on rank 0), its tables drawn on the device by `init(seed)`."""
    import torch

    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        INT_FEATURE_COUNT,
    )
    from torchrec_tpu_torch.models import DLRM, DLRMTrain
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import DistributedModelParallel
    from torchrec_tpu_torch.planner import EmbeddingShardingPlanner, Topology

    keys = DEFAULT_CAT_NAMES[: len(rows)]
    tables = tuple(
        EmbeddingBagConfig(num_embeddings=rows[i],
                           embedding_dim=args.embedding_dim,
                           name=f"t_{keys[i]}", feature_names=[keys[i]])
        for i in range(len(keys))
    )
    dense_sizes = tuple(int(x) for x in args.dense_arch_layer_sizes.split(","))
    over_sizes = tuple(int(x) for x in args.over_arch_layer_sizes.split(","))
    # built on "meta": the DMP allocates the dense part on the device and
    # init() draws the tables there, never through host memory
    model = DLRMTrain(DLRM(
        EmbeddingBagCollection(tables, max_feature_length=1, device="meta"),
        dense_in_features=INT_FEATURE_COUNT,
        dense_arch_layer_sizes=dense_sizes,
        over_arch_layer_sizes=over_sizes,
        dense_dtype=torch.bfloat16 if args.dense_dtype == "bf16" else None,
        device="meta",
    ))
    topo = Topology(world_size=env.world_size,
                    local_world_size=env.local_size,
                    batch_size=args.batch_size)
    planner = EmbeddingShardingPlanner(topo)
    plan = planner.plan(tables, module_path=EBC_KEY)
    if planner.last_stats and env.rank == 0:
        print(planner.last_stats)
    fused = {"learning_rate": args.learning_rate, "eps": args.eps}
    if args.lr_change_point is not None:
        change, before, after = (args.lr_change_point, args.learning_rate,
                                 args.lr_after_change_point)
        fused["lr_schedule"] = lambda step: before if step < change else after
    return DistributedModelParallel(
        model,
        env=env,
        plan=plan,
        fused_optim=EmbOptimType.ROWWISE_ADAGRAD,
        fused_params=fused,
        dense_optimizer=lambda p: torch.optim.SGD(
            p, lr=args.dense_learning_rate),
    ).init(args.seed)


def make_loader(args, stage: str, env, rows: Sequence[int]):
    """The train or validation stream of the flags' data source. Rank 0
    draws JAX's seeds, the other ranks their own streams; the in-memory
    loader gives each rank its share of the rows."""
    from torchrec_tpu_torch.datasets.criteo import (
        DEFAULT_CAT_NAMES,
        INT_FEATURE_COUNT,
        InMemoryBinaryCriteoIterDataPipe,
    )
    from torchrec_tpu_torch.datasets.random import RandomRecDataset

    train = stage == "train"
    keys = DEFAULT_CAT_NAMES[: len(rows)]
    rank_seed = 1_000_003 * env.rank
    if args.in_memory_binary_criteo_path:
        paths = [sorted(glob.glob(os.path.join(
            args.in_memory_binary_criteo_path, f"*_{kind}.npy")))
            for kind in ("dense", "sparse", "labels")]
        return InMemoryBinaryCriteoIterDataPipe(
            *paths,
            batch_size=args.batch_size,
            rank=env.rank,
            world_size=env.world_size,
            hashes=rows,
            shuffle_batches=args.shuffle_batches and train,
            seed=args.seed,
            mmap_mode=args.mmap_mode,
            undersampling_rate=args.undersampled_rate if train else None,
            pin_memory=env.device.type == "cuda",
        )
    if args.synthetic_criteo:
        from torchrec_tpu_torch.datasets.synthetic_criteo import (
            SyntheticCriteoDataset,
        )

        return SyntheticCriteoDataset(
            batch_size=args.batch_size,
            cardinalities=rows,
            keys=keys,
            zipf_a=args.zipf_a,
            num_batches=(args.num_batches if train
                         else max(args.num_batches // 10, 4)),
            manual_seed=args.seed + (0 if train else 7919) + rank_seed,
        )
    return RandomRecDataset(
        keys=keys,
        batch_size=args.batch_size,
        hash_sizes=rows,
        ids_per_feature=1,
        num_dense=INT_FEATURE_COUNT,
        num_batches=args.num_batches,
        manual_seed=args.seed + (0 if train else 1) + rank_seed,
        on_device=True,
        device=env.device,
    )


def validate(dmp, loader, env) -> dict:
    """AUROC and accuracy of the DMP's predictions over the loader's
    batches (as many on every rank: the least rank's count), gathered
    over the ranks; `batches` is this rank's count."""
    import torch

    from torchrec_tpu_torch.utils.metrics import accuracy, auroc

    eval_fn = dmp.make_eval_fn()
    n_val = _min_over_ranks(env, len(loader))
    scores, labels = [], []
    for batch in itertools.islice(loader, n_val):
        batch = batch.to(env.device, non_blocking=True)
        _, (_, logits, lab) = eval_fn(*batch.batch_args())
        scores.append(torch.sigmoid(logits))
        labels.append(lab)
    s = _gather(env, torch.cat(scores).float().cpu().numpy())
    y = _gather(env, torch.cat(labels).float().cpu().numpy())
    return {"auroc": auroc(s, y), "accuracy": accuracy(s, y),
            "batches": n_val}


def main(argv: Optional[List[str]] = None) -> dict:
    """Train (and validate, save, package) as the flags say. Returns
    JAX's dict, `auroc`, `accuracy` and `throughput` (examples/s over all
    ranks), with `loss` (the last step's, averaged over the ranks),
    `steps` (train steps, the warm-up included), `eval_batches` (per
    rank) and `groups` (the sharded EBC's sharding groups)."""
    args = parse_args(argv if argv is not None else sys.argv[1:])

    import torch

    from torchrec_tpu_torch.datasets.random import step_seed
    from torchrec_tpu_torch.parallel.train_pipeline import (
        SparseDistPipeline,
        TrainPipeline,
    )

    env = make_env(args)
    rank = env.rank
    rows = table_rows(args)
    dmp = build_dmp(args, env, rows)
    groups = len(dmp.sharded_ebcs[EBC_KEY].strategies)
    eval_batches = 0

    def run_validation(tag: str) -> dict:
        nonlocal eval_batches
        res = validate(dmp, make_loader(args, "val", env, rows), env)
        eval_batches += res.pop("batches")
        if rank == 0:
            print(f"{tag}: val AUROC {res['auroc']:.5f} "
                  f"accuracy {res['accuracy']:.5f}")
        return res

    def sync() -> None:
        if env.device.type == "cuda":
            torch.cuda.synchronize(env.device)

    synthetic = args.synthetic or args.synthetic_criteo
    step = dmp.make_train_step()
    steps = 0
    if synthetic:
        gen = make_loader(args, "train", env, rows).device_batch_fn(
            env.device)
        # the warm-up step outside the timed window
        step(*gen(step_seed(args.seed - 1, rank)).batch_args())
        steps += 1
        sync()
    else:
        loader = make_loader(args, "train", env, rows)
        n_train = _min_over_ranks(env, len(loader))
        # one pipeline across epochs, as JAX's
        pipe = (SparseDistPipeline(dmp, device=env.device)
                if args.train_pipeline == "sparse_dist"
                else TrainPipeline(step, device=env.device))

    vfreq = args.validation_freq_within_epoch
    results: dict = {}
    loss = None
    for epoch in range(args.epochs):
        n, losses = 0, []
        t0 = time.perf_counter()
        if synthetic:
            for _ in range(args.num_batches):
                batch = gen(step_seed(args.seed + 17 * epoch, dmp.step,
                                      rank))
                loss, _ = step(*batch.batch_args())
                n += 1
                if n % 50 == 0:
                    losses.append(float(loss))
                if vfreq and n % vfreq == 0:
                    run_validation(f"epoch {epoch} it {n}")
        else:
            it = (b.batch_args() for b in itertools.islice(loader, n_train))
            while True:
                try:
                    loss, _ = pipe.progress(it)
                except StopIteration:
                    break
                n += 1
                if n % 50 == 0:
                    losses.append(float(loss))
                if vfreq and n % vfreq == 0:
                    run_validation(f"epoch {epoch} it {n}")
        sync()
        dt = time.perf_counter() - t0
        steps += n
        throughput = n * args.batch_size * env.world_size / dt
        if rank == 0:
            print(f"epoch {epoch}: {n} it, {throughput:,.0f} examples/s, "
                  f"loss tail "
                  f"{losses[-3:] if losses else [float(loss)]}")
        results = run_validation(f"epoch {epoch}")
        results["throughput"] = throughput
    results.update(loss=_mean_over_ranks(env, float(loss)), steps=steps,
                   eval_batches=eval_batches, groups=groups)

    if args.save_dir:
        from torchrec_tpu_torch.utils.checkpoint import save_reshardable

        save_reshardable(args.save_dir, dmp)
        if rank == 0:
            print(f"checkpoint written to {args.save_dir}")

    if args.package_dir:
        from torchrec_tpu_torch.inference import quantize_embeddings
        from torchrec_tpu_torch.modules.embedding_configs import DataType

        pm = quantize_embeddings(dmp, DataType.INT8, device=env.device)
        if rank == 0:
            pm.save(args.package_dir)
            print(f"serving package written to {args.package_dir}")
    return results


if __name__ == "__main__":
    main()
