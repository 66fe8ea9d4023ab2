"""Serving-side request micro-batcher.

Counterpart of torchrec_tpu/inference/batching.py. Requests are coalesced
into a fixed server batch B: the worker launches as soon as B examples
are waiting, or when `max_latency_s` has passed since the oldest pending
request (a partial batch, padded by the collate). Each request contributes
`n_examples(request)` rows; the responses are sliced back out of every
output tensor along dim 0 and delivered through futures. Every output
tensor is moved to the CPU first: that copy is the point where the worker
waits for the card.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

import numpy as np
import torch

from torchrec_tpu_torch.sparse.jagged import PaddedSparseBatch
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


@dataclass
class _Pending:
    request: Any
    n: int
    future: Future
    t_enqueue: float


def tree_map(fn: Callable, tree: Any) -> Any:
    """`fn` on every tensor of nested tuples, lists and dicts."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return tree


class BatchingPredictServer:
    """Micro-batching front for a predict callable.

    predict_fn:    (*args) -> tensors (nested tuples / lists / dicts) with
                   leading batch dim B
    collate:       (requests, batch_size) -> args for predict_fn,
                   padded to EXACTLY batch_size examples
    n_examples:    request -> number of examples it contributes
    batch_size:    the server batch B
    max_latency_s: flush deadline for partial batches
    """

    def __init__(
        self,
        predict_fn: Callable,
        collate: Callable[[Sequence[Any], int], tuple],
        batch_size: int,
        n_examples: Callable[[Any], int] = lambda r: 1,
        max_latency_s: float = 0.005,
    ):
        self._predict = predict_fn
        self._collate = collate
        self._B = batch_size
        self._n_of = n_examples
        self._deadline = max_latency_s
        self._lock = threading.Condition()
        self._queue: List[_Pending] = []
        self._stopped = False
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- client side -------------------------------------------------------

    def submit(self, request: Any) -> Future:
        n = self._n_of(request)
        if n > self._B:
            raise ValueError(
                f"request with {n} examples exceeds server batch {self._B}"
            )
        f: Future = Future()
        with self._lock:
            if self._stopped:
                raise RuntimeError("server stopped")
            self._queue.append(_Pending(request, n, f, time.monotonic()))
            self._lock.notify()
        return f

    def predict(self, request: Any, timeout: Optional[float] = None):
        """Synchronous convenience wrapper."""
        return self.submit(request).result(timeout)

    def stop(self) -> None:
        with self._lock:
            self._stopped = True
            self._lock.notify()
        self._worker.join(timeout=5)

    # -- worker ------------------------------------------------------------

    def _take_batch(self) -> Optional[List[_Pending]]:
        """Wait until >= B examples are pending or the oldest request
        ages past the deadline; pop a prefix fitting the batch."""
        with self._lock:
            while not self._stopped:
                total = sum(p.n for p in self._queue)
                if total >= self._B:
                    break
                if self._queue:
                    age = time.monotonic() - self._queue[0].t_enqueue
                    if age >= self._deadline:
                        break
                    self._lock.wait(self._deadline - age)
                else:
                    self._lock.wait()
            if self._stopped and not self._queue:
                return None
            batch, used = [], 0
            while self._queue and used + self._queue[0].n <= self._B:
                p = self._queue.pop(0)
                batch.append(p)
                used += p.n
            return batch

    def _run(self) -> None:
        while True:
            batch = self._take_batch()
            if batch is None:
                return
            try:
                args = self._collate([p.request for p in batch], self._B)
                out = tree_map(lambda t: t.cpu(), self._predict(*args))
                off = 0
                for p in batch:
                    sl = tree_map(
                        lambda a, o=off, n=p.n: a[o:o + n]
                        if a.dim() >= 1 else a,
                        out,
                    )
                    # a client may have cancelled (e.g. result() timed
                    # out); that must not poison the rest of the batch
                    if not p.future.cancelled():
                        p.future.set_result(sl)
                    off += p.n
            except Exception as e:  # noqa: BLE001 - delivered per future
                for p in batch:
                    if not p.future.done() and not p.future.cancelled():
                        p.future.set_exception(e)


def make_dlrm_collate(keys: Sequence[str],
                      device: DeviceLike = None) -> Callable:
    """Collate for DLRM requests `(dense [n, d], ids [F, n, L])` (numpy)
    -> the server's `(dense [B, d], PaddedSparseBatch, labels [B])` on
    `device` (the predict module's; default the current CUDA card). The
    padded tail repeats example 0; its results are discarded by the demux.
    `keys` are the model's sparse feature names in EBC order."""
    keys = tuple(keys)
    dev = resolve_device(device)

    def collate(requests: Sequence[Any], batch_size: int) -> tuple:
        denses, ids = zip(*requests)
        F, _, L = ids[0].shape
        assert F == len(keys), (F, keys)
        dense = np.concatenate(denses, axis=0)
        id_cat = np.concatenate(ids, axis=1)
        n = dense.shape[0]
        if n < batch_size:
            pad = batch_size - n
            dense = np.concatenate(
                [dense, np.repeat(dense[:1], pad, axis=0)], axis=0
            )
            id_cat = np.concatenate(
                [id_cat, np.repeat(id_cat[:, :1], pad, axis=1)], axis=1
            )
        sb = PaddedSparseBatch(
            ids=torch.from_numpy(id_cat.astype(np.int32)).to(dev),
            lengths=torch.full((F, batch_size), L, dtype=torch.int32,
                               device=dev),
            keys=keys,
        )
        labels = torch.zeros((batch_size,), dtype=torch.float32, device=dev)
        return (torch.from_numpy(dense.astype(np.float32)).to(dev), sb,
                labels)

    return collate
