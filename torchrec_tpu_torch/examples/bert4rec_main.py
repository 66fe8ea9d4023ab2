"""BERT4Rec training CLI: the port's entry point for the sequence model.

Counterpart of examples/bert4rec_main.py, flag for flag, plus `--device`
(default `cuda`; pass `--device cpu` to run on the CPU, which it refuses
otherwise). Masked-LM (cloze) training of BERT4Rec over item sequences,
then leave-one-out HR@10 and NDCG@10 (utils/metrics) on up to 256 users.
`--mode dmp` shards the item table ROW_WISE (its lookups and updates
through the routed gather and the fused rowwise Adagrad), `--mode dp`
replicates it (DATA_PARALLEL); the dense part steps under Adam.

The sequences: `--movielens_dir` (ratings.csv, per-user and time-ordered),
`--synthetic_ml1m` (ML-1M-shaped: 6,040 users, a 3,706-item vocab, Zipf
popularity inside 64 latent genres, the published length distribution)
or `--synthetic` (shifted arithmetic sequences), all drawn on the host
from `np.random.RandomState(seed)` in JAX's order. The padded pool is
copied to the device once; each train batch is sampled and masked there
from a `torch.Generator` re-seeded from (seed, epoch, step), one warm-up
step outside the timed window.

Usage:
  python -m torchrec_tpu_torch.examples.bert4rec_main --synthetic_ml1m \\
      --num_batches 50 [--mode dp]
"""

from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from typing import List, Optional

import numpy as np

EC_KEY = "model/ec"


def parse_args(argv):
    p = argparse.ArgumentParser(description="torchrec_tpu_torch BERT4Rec")
    p.add_argument("--movielens_dir", type=str, default=None)
    p.add_argument("--dataset_name", type=str, default="ml-1m")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_ml1m", action="store_true",
                   help="ML-1M-calibrated synthetic sequences: 6040 "
                        "users, 3706-item vocab, Zipf item popularity, "
                        "the published per-user length distribution "
                        "(min 20, mean ~165), and genre-structured "
                        "transitions a sequence model can learn")
    p.add_argument("--mode", choices=["dmp", "dp"], default="dmp",
                   help="shard the item table (dmp) or replicate it (dp)")
    p.add_argument("--max_len", type=int, default=64)
    p.add_argument("--emb_dim", type=int, default=64)
    p.add_argument("--nhead", type=int, default=2)
    p.add_argument("--num_layers", type=int, default=2)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--num_batches", type=int, default=100)
    p.add_argument("--epochs", type=int, default=1)
    p.add_argument("--mask_prob", type=float, default=0.2)
    p.add_argument("--lr", type=float, default=0.001)
    p.add_argument("--emb_lr", type=float, default=0.01)
    p.add_argument("--vocab_size", type=int, default=2000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the current card) or 'cpu'")
    return p.parse_args(argv)


def load_movielens_sequences(root: str) -> List[List[int]]:
    """Per-user chronological item sequences, the movies re-numbered
    from 1 in order of first appearance (0 is the pad); users with fewer
    than 5 ratings are dropped."""
    from torchrec_tpu_torch.datasets.movielens import _ratings

    per_user = defaultdict(list)
    for row in _ratings(root):
        per_user[row["userId"]].append((row["timestamp"], row["movieId"]))
    seqs = []
    remap = {}
    for user, items in per_user.items():
        items.sort()
        seq = []
        for _, m in items:
            if m not in remap:
                remap[m] = len(remap) + 1  # 0 is pad
            seq.append(remap[m])
        if len(seq) >= 5:
            seqs.append(seq)
    return seqs


def synthetic_ml1m_sequences(rng: np.random.RandomState):
    """(sequences, vocab): ML-1M-shaped histories, 6040 users over 3706
    items; items carry a latent genre, users watch a small genre mixture
    with Zipf-popular items inside each."""
    from torchrec_tpu_torch.datasets.synthetic_criteo import zipf_ids

    n_users, n_items, n_genres = 6040, 3706, 64
    vocab = n_items + 2  # + pad(0) + mask
    g_of_item = zipf_ids(rng, n_genres, (n_items,), a=1.1)
    items_by_genre = [
        np.where(g_of_item == g)[0] + 1 for g in range(n_genres)
    ]
    items_by_genre = [
        it if len(it) else np.asarray([1]) for it in items_by_genre
    ]
    seqs = []
    for _ in range(n_users):
        # published per-user count distribution: min 20, mean ~165
        n = int(np.clip(rng.lognormal(4.56, 0.95), 20, 1000))
        genres = zipf_ids(rng, n_genres, (3,), a=1.1)
        cur = genres[rng.randint(3)]
        s = []
        for _ in range(n):
            if rng.rand() < 0.2:
                cur = genres[rng.randint(3)]
            pool = items_by_genre[cur]
            s.append(int(pool[zipf_ids(rng, len(pool), (1,), 1.05)[0]]))
        seqs.append(s)
    return seqs, vocab


def main(argv: Optional[List[str]] = None) -> dict:
    """Train and evaluate as the flags say. Returns JAX's dict, `hr@10`
    and `ndcg@10`, with `throughput` (sequences/s), `loss` (the last
    step's) and `steps` (train steps, the warm-up included)."""
    args = parse_args(argv if argv is not None else sys.argv[1:])

    import torch
    import torch.nn.functional as F

    from torchrec_tpu_torch.datasets.random import step_seed
    from torchrec_tpu_torch.models import (
        BERT4Rec,
        BERT4RecTrain,
        make_item_embedding_collection,
    )
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingEnv,
        ShardingPlan,
        ShardingType,
    )
    from torchrec_tpu_torch.sparse import PaddedSparseBatch
    from torchrec_tpu_torch.utils.metrics import hr_at_k, ndcg_at_k

    # "cuda" is the current card: ShardingEnv raises without one
    env = ShardingEnv(None if args.device == "cuda" else args.device)
    dev = env.device
    rng = np.random.RandomState(args.seed)
    L = args.max_len

    if args.movielens_dir:
        seqs = load_movielens_sequences(args.movielens_dir)
        vocab = max(max(s) for s in seqs) + 2  # + pad + mask
    elif args.synthetic_ml1m:
        seqs, vocab = synthetic_ml1m_sequences(rng)
    else:
        # synthetic: shifted arithmetic sequences (learnable)
        vocab = args.vocab_size
        seqs = [
            list((np.arange(rng.randint(8, 2 * L)) * (1 + i % 3)
                  + rng.randint(1, vocab - 2)) % (vocab - 2) + 1)
            for i in range(512)
        ]
    MASK = vocab - 1
    B = args.batch_size

    def pad_seq(s):
        s = list(s[-L:])
        return [0] * (L - len(s)) + s

    stype = (ShardingType.ROW_WISE if args.mode == "dmp"
             else ShardingType.DATA_PARALLEL)
    model = BERT4RecTrain(BERT4Rec(
        vocab, L, args.emb_dim, args.nhead, args.num_layers, dropout=0.0,
        ec=make_item_embedding_collection(vocab, args.emb_dim, L,
                                          device="meta"),
        device="meta"))
    dmp = DistributedModelParallel(
        model,
        env=env,
        plan=ShardingPlan({EC_KEY: {
            "item_embedding": ParameterSharding(stype)}}),
        fused_params={"learning_rate": args.emb_lr},
        dense_optimizer=lambda p: torch.optim.Adam(p, lr=args.lr),
    ).init(args.seed)
    step = dmp.make_train_step()
    eval_fn = dmp.make_eval_fn()

    # the padded training pool on the device, once; each batch sampled
    # and masked there
    pool = torch.from_numpy(np.asarray(
        [pad_seq(s[:-1]) for s in seqs], np.int32)).to(dev)  # [n_seq, L]
    n_seq = pool.shape[0]
    lengths = torch.full((1, B), L, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev)

    def train_batch(seed: int):
        g.manual_seed(seed)
        s = pool[torch.randint(0, n_seq, (B,), generator=g, device=dev)]
        valid = s > 0
        m = (torch.rand((B, L), generator=g, device=dev)
             < args.mask_prob) & valid
        # at least one masked position per row: the last valid one
        lastv = L - 1 - torch.argmax(valid.flip(1).to(torch.int32), dim=1)
        force = (~m.any(dim=1))[:, None] & valid
        m = m | (F.one_hot(lastv, L).bool() & force)
        labels = torch.where(m, s, torch.zeros_like(s))
        ids = torch.where(m, torch.full_like(s, MASK), s)
        return (PaddedSparseBatch(ids=ids[None], lengths=lengths,
                                  keys=("item",)), labels)

    def eval_batch(idx):
        """Leave-one-out: the last item masked, to be ranked."""
        rows, targets = [], []
        for i in idx:
            s = np.asarray(pad_seq(seqs[i]), np.int32)
            last = np.where(s > 0)[0][-1]
            targets.append(int(s[last]))
            s[last] = MASK
            rows.append(s)
        ids = np.stack(rows)
        sb = PaddedSparseBatch(
            ids=torch.from_numpy(ids[None]).to(dev),
            lengths=torch.full((1, len(idx)), L, dtype=torch.int32,
                               device=dev),
            keys=("item",))
        return sb, np.asarray(targets), ids

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    step(*train_batch(step_seed(args.seed + 99, 0)))  # the warm-up
    steps = 1
    sync()

    results: dict = {}
    zeros = torch.zeros((B, L), dtype=torch.int32, device=dev)
    for epoch in range(args.epochs):
        t0 = time.perf_counter()
        loss = None
        for _ in range(args.num_batches):
            loss, _ = step(*train_batch(
                step_seed(args.seed + 31 * epoch, dmp.step)))
        sync()
        dt = time.perf_counter() - t0
        steps += args.num_batches
        throughput = args.num_batches * B / dt
        print(f"epoch {epoch} ({args.mode}): {throughput:,.0f} seq/s, "
              f"loss {float(loss):.4f}")

        n_eval = min(len(seqs), 256)
        hrs, ndcgs = [], []
        for lo in range(0, n_eval - B + 1, B):
            sbe, targets, ids = eval_batch(range(lo, lo + B))
            _, (_, logits) = eval_fn(sbe, zeros)
            # score at each row's masked (last valid) position
            pos = torch.from_numpy(
                np.asarray([np.where(r == MASK)[0][-1] for r in ids]))
            scores = logits[torch.arange(B), pos.to(dev)].float().cpu()
            hrs.append(hr_at_k(scores, targets, 10))
            ndcgs.append(ndcg_at_k(scores, targets, 10))
        results = {
            "hr@10": float(np.mean(hrs)),
            "ndcg@10": float(np.mean(ndcgs)),
            "throughput": throughput,
            "loss": float(loss),
        }
        print(f"epoch {epoch}: HR@10 {results['hr@10']:.4f} "
              f"NDCG@10 {results['ndcg@10']:.4f}")
    results["steps"] = steps
    return results


if __name__ == "__main__":
    main()
