"""Nearline batch scoring with the quantized package: chunks of candidates
scored by the program's ShardedPredictModule, `in_flight` chunks at a
time, from a pool of chunks made on the card from the seed and kept in
pinned host memory.

Traffic parameters: `batch` (candidates a chunk), `ids_per_feature` (an
int or a list of F lengths, as for training: `inputs.make_batch`),
`zipf_a`, `pool` (distinct chunks), `bits` (the package's integer width),
`in_flight`, `warmup_chunks`, `sample_every` (about one chunk in this
many keeps its scores for the comparison, drawn from the seed; the first
chunk always).

Each chunk's inputs are copied from pinned host memory to the card, its
scores back into pinned host memory, and a CUDA event recorded after
them; a completion thread waits on each chunk's event in order and stamps
the host clock. A chunk's latency runs from its issue (before its copy
in) to that stamp. The window ends when every chunk issued in it has
been stamped (or a minute has passed, and the rest count as failed).

The configuration, program and reference modules are those of training
(`drivers/train.py`): the program module's `sparse_batch` and `KERNELS`
and the reference's `linear_biases` are taken here too.
"""

from __future__ import annotations

import gc
import queue
import sys
import threading
import time
from typing import Dict, List

import torch

from gpubench import check, inputs, trace, work
from gpubench.drivers.train import (
    batch_form,
    build_kernels,
    mark,
    slices,
    sync,
)
from gpubench.programs import common as prog_common
from gpubench.reference import common as ref_common
from gpubench.reference import score as ref_score
from gpubench.result import Result, Run

WAIT_S = 60.0  # past the window's close, for the last chunks
QUANT_SPAN = "## gpubench_quant_lookup ##"


class _Done:
    """A chunk's completion marker: a blocking CUDA event on the card; on
    the CPU the work is done when issued."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.ev = torch.cuda.Event(blocking=True) if self.cuda else None

    def record(self):
        if self.cuda:
            self.ev.record()

    def wait(self):
        if self.cuda:
            self.ev.synchronize()


def make_pool(r: Run) -> List[Dict[str, torch.Tensor]]:
    """The chunks on the host (pinned on a card): dense, ids, lengths."""
    pin = torch.device(r.device).type == "cuda"
    return [{k: (v.cpu().pin_memory() if pin else v.cpu())
             for k, v in b.items() if k != "labels"}
            for b in inputs.make_pool(r.cfg["num_embeddings_per_feature"],
                                      r.traffic, r.seed, r.device)]


def build_predictor(r: Run):
    """The float DMP loaded with the seed's weights, quantized by
    `quantize_embeddings` and sharded by `shard_quantized`, as
    dlrm_predict's direct route serves it; the float model is freed."""
    from torchrec_tpu_torch.inference import (
        quantize_embeddings,
        shard_quantized,
    )
    from torchrec_tpu_torch.modules.embedding_configs import DataType

    cfg = r.cfg
    dmp = prog_common.build_dmp(cfg, r.program.model(cfg, train=False),
                                r.device)
    prog_common.load_weights(dmp, r.program.linears(dmp.module), cfg,
                             r.model.linear_shapes(cfg), r.seed,
                             ref_common.linear_biases(r.model, cfg))
    sync(r.device)
    mark(r, "float model")
    dtype = {8: DataType.INT8, 4: DataType.INT4}[r.traffic["bits"]]
    spm = shard_quantized(quantize_embeddings(dmp, dtype, device=r.device))
    del dmp
    gc.collect()
    if torch.device(r.device).type == "cuda":
        torch.cuda.empty_cache()
    return spm


def span_hooks(spm) -> list:
    """A `QUANT_SPAN` profiler span around every quantized lookup module's
    forward, opened and closed by forward hooks."""
    from torchrec_tpu_torch.parallel.quant_sharded import (
        ShardedQuantEmbeddingBagCollection,
    )

    handles = []
    for m in spm.modules():
        if isinstance(m, ShardedQuantEmbeddingBagCollection):
            open_spans = []

            def pre(mod, args, open_spans=open_spans):
                rf = torch.profiler.record_function(QUANT_SPAN)
                rf.__enter__()
                open_spans.append(rf)

            def post(mod, args, out, open_spans=open_spans):
                open_spans.pop().__exit__(None, None, None)

            handles += [m.register_forward_pre_hook(pre),
                        m.register_forward_hook(post)]
    return handles


class Scorer:
    """Issues chunks through the predict module; `in_flight` device slots,
    each with its inputs on the card and its scores in pinned memory."""

    def __init__(self, r: Run, spm, pool):
        self.r, self.spm, self.pool = r, spm, pool
        self.sparse_batch = batch_form(r.program)
        tr = r.traffic
        pin = torch.device(r.device).type == "cuda"
        self.slots = []
        for _ in range(tr["in_flight"]):
            dev = {k: torch.empty_like(v, device=r.device)
                   for k, v in pool[0].items()}
            out = torch.empty((tr["batch"],), dtype=torch.float32)
            self.slots.append((dev, out.pin_memory() if pin else out))
        self.sem = threading.Semaphore(tr["in_flight"])
        self.queue: "queue.Queue" = queue.Queue()
        self.keep = set()
        self.kept: Dict[int, torch.Tensor] = {}
        self.done_at: Dict[int, float] = {}
        self.host: List[float] = []

    def _complete(self):
        while True:
            item = self.queue.get()
            if item is None:
                return
            i, s, done = item
            done.wait()
            self.done_at[i] = time.perf_counter()
            if i in self.keep:
                self.kept[i] = self.slots[s][1].clone()
            self.sem.release()

    def issue(self, i: int) -> float:
        """Issue chunk i; returns its issue time."""
        self.sem.acquire()
        t = time.perf_counter()
        s = i % len(self.slots)
        dev, out = self.slots[s]
        src = self.pool[i % len(self.pool)]
        for k, v in src.items():
            dev[k].copy_(v, non_blocking=True)
        h0 = time.perf_counter()
        logits = self.spm.predict(dev["dense"],
                                  self.sparse_batch(self.r.cfg, dev))
        self.host.append(time.perf_counter() - h0)
        out.copy_(self.r.program.scores(logits), non_blocking=True)
        done = _Done(self.r.device)
        done.record()
        self.queue.put((i, s, done))
        return t

    def start(self):
        self.thread = threading.Thread(target=self._complete, daemon=True)
        self.thread.start()

    def stop(self) -> bool:
        """End the completion thread; False if it did not end in time."""
        self.queue.put(None)
        self.thread.join(WAIT_S)
        return not self.thread.is_alive()


def _sample(r: Run, i: int) -> bool:
    return inputs.sub_seed(r.seed, inputs.SAMPLE, -1, i) % r.traffic[
        "sample_every"] == 0


def run(r: Run, wrap_predict=None) -> Result:
    tr = r.traffic
    mark(r, "imports")
    compile_s = (build_kernels(("tbe_lookup", "quant_lookup"), r.program)
                 if torch.device(r.device).type == "cuda" else 0.0)
    mark(r, "kernels")
    pool = make_pool(r)
    mark(r, "inputs")
    spm = build_predictor(r)
    mark(r, "program")
    if wrap_predict is not None:
        spm.predict = wrap_predict(spm.predict)
    hooks = span_hooks(spm) if r.trace else []
    sc = Scorer(r, spm, pool)
    sc.start()
    for i in range(tr["warmup_chunks"]):
        sc.issue(-1 - i)
    sync(r.device)
    while len(sc.done_at) < tr["warmup_chunks"]:
        time.sleep(0.001)
    sc.done_at.clear()
    sc.host.clear()
    setup_s = r.clock()
    mark(r, "warm-up")
    issued: Dict[int, float] = {}
    with trace.captured(r.trace) as traced:
        with trace.window():
            t0 = time.perf_counter()
            i = 0
            while True:
                if i == 0 or _sample(r, i):
                    sc.keep.add(i)
                issued[i] = sc.issue(i)
                i += 1
                if time.perf_counter() - t0 >= r.seconds:
                    break
            deadline = time.perf_counter() + WAIT_S
            while (len(sc.done_at) < len(issued)
                   and time.perf_counter() < deadline):
                time.sleep(0.0005)
            t1 = max(sc.done_at.values(), default=t0)
    stopped = sc.stop()
    for h in hooks:
        h.remove()
    done = [j for j in issued if j in sc.done_at]
    latencies = [sc.done_at[j] - issued[j] for j in done]
    slices([sc.done_at[j] - t0 for j in done], "chunks")
    peak = (torch.cuda.max_memory_allocated(r.device)
            if torch.device(r.device).type == "cuda" else 0)
    kept, host = dict(sc.kept), list(sc.host)
    del sc, spm
    gc.collect()
    if torch.device(r.device).type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    numbers = {"score_gap": _score_gap(r, pool, kept, r.traffic["bits"])}
    print(f"gpubench: reference {time.perf_counter() - t_ref:.3f} s",
          file=sys.stderr)
    if not stopped:
        numbers["score_gap"] = float("inf")
    F = len(r.cfg["num_embeddings_per_feature"])
    B, D = tr["batch"], r.cfg["embedding_dim"]
    ids = inputs.ids_per_example(F, tr["ids_per_feature"])
    per = [work.distinct_rows(c["ids"], c["lengths"]) for c in pool]
    qbytes = sum(work.quant_lookup_bytes(per[j % len(pool)], F, B, ids, D,
                                         tr["bits"]) for j in done)
    return Result(
        setup_s=setup_s, compile_s=compile_s,
        window_s=traced[0].window_s if traced else t1 - t0,
        attempted=len(issued), failed=len(issued) - len(done),
        work=len(done) * B,
        flops_per_item=r.model.flops_per_example(r.cfg, train=False),
        host_s=host,
        bytes={"quant_lookup": qbytes}, numbers=numbers,
        memory_peak_bytes=peak, latencies_s=latencies,
        reduced=traced[0] if traced else None)


def _score_gap(r: Run, pool, kept: Dict[int, torch.Tensor],
               bits: int) -> float:
    """The kept scores against the reference's, chunk by chunk."""
    idx = sorted(kept)
    entries = sorted({j % len(pool) for j in idx})
    batches = [{k: v.to(r.device) for k, v in pool[p].items()}
               for p in entries]
    ref = dict(zip(entries, ref_score.scores(r.cfg, r.model, r.seed,
                                             batches, bits)))
    return check.score_gap([kept[j] for j in idx],
                           [ref[j % len(pool)] for j in idx])


# what `reference_numbers` puts in the program's place (gpubench.readings)
REFERENCE_KINDS = ("control", "tf32")


def reference_numbers(r: Run, kind: str) -> dict:
    """The reference in the program's place one precision lower, against
    the reference, on every chunk of the pool: "control", the tables at
    half the package's bits (int4 for int8); "tf32", the package's bits
    with the dense model's products in TF32. No program runs."""
    if kind not in REFERENCE_KINDS:
        raise ValueError(f"no reference reading {kind!r} for scoring")
    batches = [{k: v.to(r.device) for k, v in c.items()}
               for c in make_pool(r)]
    bits = r.traffic["bits"]
    ref = ref_score.scores(r.cfg, r.model, r.seed, batches, bits)
    low = (ref_score.scores(r.cfg, r.model, r.seed, batches, bits // 2)
           if kind == "control" else
           ref_score.scores(r.cfg, r.model, r.seed, batches, bits,
                            precision="tf32"))
    return {"score_gap": check.score_gap(low, ref)}
