"""DLRM serving CLI: load a quantized package and serve predictions.

Counterpart of examples/dlrm_predict.py: the package that
`dlrm_main --package_dir` wrote (arrays.npz + manifest.json) is loaded
onto a scaffold DMP built on `meta` (`PredictModule.load`), sharded over
the inference env with `shard_quantized` (each table whole on one rank,
as the planner places it; `ShardingEnv.from_local(world_size)`, so a
world size above 1 runs one process a rank under torchrun) and served:

* directly: `--num_requests` requests of `--batch_size` examples, each
  made on the host, copied to the device and answered back to the host;
* `--serve_batching`: ragged client requests through the micro-batching
  queue (BatchingPredictServer), padded to the server batch;
* `--serve_native`: the C++ batching queue and its TCP front
  (NativePredictServer, csrc/serving_queue.cpp), eight client threads
  over localhost on `--serve_port` (0: an ephemeral port).

Each request launches the quantized lookup Kq (csrc/quant_lookup.cu) of
the sharded quantized EBC. `--device` as in dlrm_main (default `cuda`).

Usage:
  python -m torchrec_tpu_torch.examples.dlrm_main --synthetic \\
      --num_batches 50 --package_dir PKG
  python -m torchrec_tpu_torch.examples.dlrm_predict --package_dir PKG \\
      --batch_size 256 --num_requests 20 [--serve_batching|--serve_native]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
import zipfile
from typing import List, Optional

import numpy as np

# the DMP's module key of the EBC inside DLRMTrain
EBC_KEY = "dlrm/sparse_arch/embedding_bag_collection"
# every server future and TCP answer
TIMEOUT_S = 120.0


@dataclasses.dataclass
class DLRMModelConfig:
    """The served model's geometry."""

    dense_arch_layer_sizes: List[int]
    dense_in_features: int
    embedding_dim: int
    id_list_features_keys: List[str]
    num_embeddings_per_feature: List[int]
    over_arch_layer_sizes: List[int]


def parse_args(argv):
    p = argparse.ArgumentParser(description="torchrec_tpu_torch DLRM serving")
    p.add_argument("--package_dir", type=str, required=True)
    p.add_argument("--world_size", type=int, default=1,
                   help="inference ranks (ShardingEnv.from_local)")
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--num_requests", type=int, default=10)
    p.add_argument("--embedding_dim", type=int, default=64)
    p.add_argument("--dense_arch_layer_sizes", type=str,
                   default="512,256,64")
    p.add_argument("--over_arch_layer_sizes", type=str,
                   default="512,512,256,1")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--serve_batching", action="store_true",
                   help="serve ragged client requests through the "
                        "micro-batching queue (BatchingPredictServer)")
    p.add_argument("--serve_native", action="store_true",
                   help="serve through the C++ batching queue and its TCP "
                        "front (csrc/serving_queue.cpp)")
    p.add_argument("--serve_port", type=int, default=0,
                   help="TCP port for --serve_native (0 = ephemeral)")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (the current card) or 'cpu'")
    return p.parse_args(argv)


def make_predict_factory(config: DLRMModelConfig, package_dir: str,
                         world_size: int, device=None):
    """The serving stack: the model's scaffold on `meta` ->
    PredictModule.load -> shard_quantized over the inference env."""
    from torchrec_tpu_torch.inference import (
        PredictFactory,
        PredictModule,
        shard_quantized,
    )
    from torchrec_tpu_torch.models import DLRM, DLRMTrain
    from torchrec_tpu_torch.modules import (
        EmbeddingBagCollection,
        EmbeddingBagConfig,
    )
    from torchrec_tpu_torch.parallel import (
        DistributedModelParallel,
        ParameterSharding,
        ShardingEnv,
        ShardingPlan,
        ShardingType,
    )

    tables = tuple(
        EmbeddingBagConfig(
            num_embeddings=config.num_embeddings_per_feature[i],
            embedding_dim=config.embedding_dim,
            name=f"t_{key}",
            feature_names=[key],
        )
        for i, key in enumerate(config.id_list_features_keys)
    )
    model = DLRMTrain(DLRM(
        EmbeddingBagCollection(tables, max_feature_length=1, device="meta"),
        dense_in_features=config.dense_in_features,
        dense_arch_layer_sizes=tuple(config.dense_arch_layer_sizes),
        over_arch_layer_sizes=tuple(config.over_arch_layer_sizes),
        device="meta",
    ))
    env = ShardingEnv.from_local(world_size, device=device)
    # scaffolding only: its module tree and table configs, on meta
    scaffold = DistributedModelParallel(
        model, device="meta",
        plan=ShardingPlan({EBC_KEY: {
            t.name: ParameterSharding(ShardingType.TABLE_WISE, ranks=[0])
            for t in tables}}))

    class DLRMPredictFactory(PredictFactory):
        """Loads and shards the package."""

        def create_predict_module(self):
            pm = PredictModule.load(package_dir, scaffold, env.device)
            return shard_quantized(pm, env)

        def batching_metadata(self):
            meta = {k: "sparse" for k in config.id_list_features_keys}
            meta["float_features"] = "dense"
            return meta

        def result_metadata(self):
            return "dense"

    return DLRMPredictFactory()


def _npz_shape(path: str, key: str) -> tuple:
    """The shape of one array of an `.npz`, read from its header alone."""
    with zipfile.ZipFile(path) as z, z.open(key + ".npy") as f:
        read = (np.lib.format.read_array_header_1_0
                if np.lib.format.read_magic(f) == (1, 0)
                else np.lib.format.read_array_header_2_0)
        shape, _, _ = read(f)
    return shape


def _summary(ms: List[float]) -> dict:
    ms = np.asarray(ms, np.float64)
    return {"p50_ms": float(np.percentile(ms, 50)),
            "p99_ms": float(np.percentile(ms, 99)),
            "mean_ms": float(ms.mean())}


def main(argv: Optional[List[str]] = None) -> dict:
    """Serve as the flags say. Returns JAX's dict, `qps` and
    `predictions_per_sec`, with `latency` (p50, p99 and mean request ms,
    host clock, result on the host), `requests` and `last` = (dense [n,
    13], ids [F, n, 1], logits [n]) of the last request, each on the host
    (n the request's examples: `--batch_size` served directly, fewer
    through a server)."""
    args = parse_args(argv if argv is not None else sys.argv[1:])

    import torch

    from torchrec_tpu_torch.datasets.criteo import INT_FEATURE_COUNT
    from torchrec_tpu_torch.sparse import PaddedSparseBatch
    from torchrec_tpu_torch.utils.device import resolve_device

    # "cuda" is the current card: resolve_device raises without one
    device = resolve_device(None if args.device == "cuda" else args.device)

    with open(os.path.join(args.package_dir, "manifest.json")) as f:
        manifest = json.load(f)
    ebc_key, tabs = next(iter(manifest["quant"].items()))
    keys = [name[len("t_"):] for name in tabs]
    rows = [_npz_shape(os.path.join(args.package_dir, "arrays.npz"),
                       f"quant/{ebc_key}/{name}/data")[0] for name in tabs]

    config = DLRMModelConfig(
        dense_arch_layer_sizes=[
            int(x) for x in args.dense_arch_layer_sizes.split(",")],
        dense_in_features=INT_FEATURE_COUNT,
        embedding_dim=args.embedding_dim,
        id_list_features_keys=keys,
        num_embeddings_per_feature=rows,
        over_arch_layer_sizes=[
            int(x) for x in args.over_arch_layer_sizes.split(",")],
    )
    factory = make_predict_factory(config, args.package_dir,
                                   args.world_size, device)
    module = factory.create_predict_module()
    dev = module.device
    print("batching metadata:", factory.batching_metadata())

    rng = np.random.RandomState(args.seed)
    B, F = args.batch_size, len(keys)
    lengths = torch.ones((F, B), dtype=torch.int32, device=dev)
    zero_labels = torch.zeros((B,), dtype=torch.float32, device=dev)

    def logits_of(dense: np.ndarray, ids: np.ndarray) -> torch.Tensor:
        """One server batch (dense [B, 13], ids [F, B, 1] on the host)
        through the module; the logits stay on the device."""
        sb = PaddedSparseBatch(ids=torch.from_numpy(ids).to(dev),
                               lengths=lengths, keys=tuple(keys))
        _, (_, logits, _) = module.predict(torch.from_numpy(dense).to(dev),
                                           sb, zero_labels)
        return logits

    def request():
        ids = np.stack([rng.randint(0, rows[i], B) for i in range(F)])
        dense = rng.randn(B, INT_FEATURE_COUNT).astype(np.float32)
        return dense, ids[:, :, None].astype(np.int32)

    def ragged():
        nr = rng.randint(1, max(2, B // 4))
        return (rng.randn(nr, INT_FEATURE_COUNT).astype(np.float32),
                np.stack([rng.randint(0, rows[i], (nr, 1))
                          for i in range(F)]).astype(np.int32))

    if args.serve_native:
        from torchrec_tpu_torch.inference.native_batching import (
            NativePredictServer,
            PredictClient,
        )

        srv = NativePredictServer(logits_of, B, INT_FEATURE_COUNT, F, 1,
                                  max_latency_s=0.002, device=dev)
        try:
            port = srv.serve_tcp(args.serve_port)
            print(f"native TCP predict server on 127.0.0.1:{port}")
            cli = PredictClient(port, timeout_s=TIMEOUT_S)
            warm = cli.predict(*ragged())  # the first batch's warm-up
            cli.close()
            reqs = [ragged() for _ in range(args.num_requests)]
            counts: List[int] = []
            latencies: List[float] = []
            answers: dict = {}
            lock = threading.Lock()

            def client(lo, hi):
                c = PredictClient(port, timeout_s=TIMEOUT_S)
                got, ms = 0, []
                for i in range(lo, hi):
                    t = time.perf_counter()
                    out = c.predict(*reqs[i])
                    ms.append((time.perf_counter() - t) * 1e3)
                    got += out.shape[0]
                    if i == args.num_requests - 1:
                        answers[i] = out
                c.close()
                with lock:
                    counts.append(got)
                    latencies.extend(ms)

            n_cli = min(8, args.num_requests)
            per = args.num_requests // n_cli
            t0 = time.perf_counter()
            ts = [threading.Thread(target=client, args=(
                k * per, (k + 1) * per if k < n_cli - 1
                else args.num_requests)) for k in range(n_cli)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(TIMEOUT_S)
            dt = time.perf_counter() - t0
            if any(t.is_alive() for t in ts) or len(counts) != n_cli:
                raise RuntimeError("a native serving client did not finish")
        finally:
            srv.stop()
        n = sum(counts)
        qps = args.num_requests / dt
        lat = _summary(latencies)
        print(f"native-served {args.num_requests} ragged TCP requests "
              f"(server batch {B}): {qps:.1f} req/s, "
              f"{n / dt:,.0f} predictions/s, p50 {lat['p50_ms']:.3f} ms, "
              f"warm_n={warm.shape[0]}")
        last = torch.tensor(answers[args.num_requests - 1]).reshape(-1)
        return {"qps": qps, "predictions_per_sec": n / dt, "latency": lat,
                "requests": args.num_requests, "last": (*reqs[-1], last)}

    if args.serve_batching:
        from torchrec_tpu_torch.inference.batching import (
            BatchingPredictServer,
            make_dlrm_collate,
        )

        def predict_logits(dense, sb, labels):
            _, (_, logits, _) = module.predict(dense, sb, labels)
            return logits

        srv = BatchingPredictServer(
            predict_logits, make_dlrm_collate(keys, dev), B,
            n_examples=lambda r: r[0].shape[0], max_latency_s=0.002,
        )
        try:
            warm = srv.predict(ragged(), timeout=TIMEOUT_S)
            reqs = [ragged() for _ in range(args.num_requests)]
            done_at: dict = {}

            def stamp(i):
                return lambda _f: done_at.__setitem__(i, time.perf_counter())

            t0 = time.perf_counter()
            futs = []
            for i, r in enumerate(reqs):
                f = srv.submit(r)
                f.add_done_callback(stamp(i))
                futs.append((time.perf_counter(), f))
            n = sum(f.result(timeout=TIMEOUT_S).shape[0] for _, f in futs)
            dt = time.perf_counter() - t0
        finally:
            srv.stop()
        last = futs[-1][1].result().reshape(-1).cpu()
        qps = args.num_requests / dt
        lat = _summary([(done_at[i] - t) * 1e3
                        for i, (t, _) in enumerate(futs)])
        print(f"micro-batched {args.num_requests} ragged requests "
              f"(server batch {B}): {qps:.1f} req/s, "
              f"{n / dt:,.0f} predictions/s, p50 {lat['p50_ms']:.3f} ms, "
              f"warm_n={warm.shape[0]}")
        return {"qps": qps, "predictions_per_sec": n / dt, "latency": lat,
                "requests": args.num_requests, "last": (*reqs[-1], last)}

    logits_of(*request()).cpu()  # warm-up
    latencies, n = [], 0
    t0 = time.perf_counter()
    for _ in range(args.num_requests):
        t = time.perf_counter()
        dense, ids = request()
        logits = logits_of(dense, ids).cpu()
        latencies.append((time.perf_counter() - t) * 1e3)
        n += B
    dt = time.perf_counter() - t0
    qps = args.num_requests / dt
    lat = _summary(latencies)
    print(f"served {args.num_requests} requests x B={B} over "
          f"{args.world_size} devices: {qps:.1f} req/s, "
          f"{n / dt:,.0f} predictions/s, p50 {lat['p50_ms']:.3f} ms, "
          f"p_mean={float(torch.sigmoid(logits).mean()):.4f}")
    return {"qps": qps, "predictions_per_sec": n / dt, "latency": lat,
            "requests": args.num_requests, "last": (dense, ids, logits)}


if __name__ == "__main__":
    main()
