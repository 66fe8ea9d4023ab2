"""Training and evaluation loops with batches copied ahead of their step.

Counterpart of torchrec_tpu/parallel/train_pipeline.py. The JAX pipeline
keeps a few batches in flight through `jax.device_put` on a thread pool;
here a batch's host-to-device copy runs on a side CUDA stream, from pinned
memory, `prefetch_depth` batches ahead of the step, so that the copies
overlap the steps before them. The compute stream waits on the copy's
event before it reads a batch, and `record_stream` tells the caching
allocator that the compute stream uses the batch's memory. On the CPU
there is no stream and no copy: a batch is used as it comes.

A batch is a tensor, a KeyedJaggedTensor or PaddedSparseBatch, or a tuple
or list of such (the train step's arguments); host tensors that are not
pinned are pinned first.

    TrainPipeline       train_step(*batch) -> (loss, aux), one batch a
                        `progress(it)` (DistributedModelParallel
                        .make_train_step's step);
    SparseDistPipeline  the DMP's prefetched step: batch i's step takes
                        the input dist computed at the end of step i - 1
                        and computes batch i + 1's, primed with batch 0's
                        (JAX's three-stage pipeline); modules with no dist
                        (feature processors, towers, UVM tables) gather in
                        the step. JAX's raises for a UVM plan, through the
                        prefetched step's refusal; this one takes it;
    EvalPipeline        eval_step(*batch) -> output, the same prefetch.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Any, Callable, Iterator, List, Optional

import torch

from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


def _map_tensors(x: Any, fn: Callable[[torch.Tensor], Any]) -> Any:
    """x with fn applied to each tensor it holds (in tuples, lists, dicts
    and dataclasses such as the sparse batches)."""
    if isinstance(x, torch.Tensor):
        return fn(x)
    if isinstance(x, (tuple, list)):
        return type(x)(_map_tensors(v, fn) for v in x)
    if isinstance(x, dict):
        return {k: _map_tensors(v, fn) for k, v in x.items()}
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{
            f.name: _map_tensors(getattr(x, f.name), fn)
            for f in dataclasses.fields(x) if f.init})
    return x


def _as_args(batch: Any) -> tuple:
    return tuple(batch) if isinstance(batch, (tuple, list)) else (batch,)


class TrainPipeline:
    """Iterator-driven train loop with `prefetch_depth` batches copied
    ahead on a side stream.

    train_step: (*batch) -> (loss, aux). `progress(it)` takes the next
    batch of the iterator `it`, runs one step and returns (loss, aux),
    raising StopIteration when `it` is exhausted. device: where the steps
    run (default: the current CUDA card; raises without one unless
    device="cpu" is passed).
    """

    def __init__(self, train_step: Callable, prefetch_depth: int = 3,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._step = train_step
        self._depth = max(1, prefetch_depth)
        # entries [batch, copy event or None once the compute stream waits]
        self._queue: collections.deque = collections.deque()
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def _copy(self, batch: Any) -> List:
        """Start batch's copy to the device on the side stream."""
        if self._stream is None:
            return [batch, None]

        def to_device(t: torch.Tensor) -> torch.Tensor:
            if t.device.type == "cpu" and not t.is_pinned():
                t = t.pin_memory()
            return t.to(self.device, non_blocking=True)

        with torch.cuda.stream(self._stream):
            batch = _map_tensors(batch, to_device)
            event = torch.cuda.Event()
            event.record(self._stream)
        return [batch, event]

    def _fill(self, it: Iterator) -> None:
        # next(it) stays on the caller's thread (iterator order)
        while len(self._queue) < self._depth:
            try:
                batch = next(it)
            except StopIteration:
                return
            self._queue.append(self._copy(batch))

    def _ready(self, entry: List) -> Any:
        """The entry's batch, once the compute stream waits for its copy
        and the allocator knows the compute stream uses it."""
        if entry[1] is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(entry[1])
            _map_tensors(entry[0], lambda t: t.record_stream(stream))
            entry[1] = None
        return entry[0]

    def _next_batch(self, it: Iterator) -> tuple:
        self._fill(it)
        if not self._queue:
            raise StopIteration
        batch = self._ready(self._queue.popleft())
        self._fill(it)
        return _as_args(batch)

    def progress(self, it: Iterator):
        return self._step(*self._next_batch(it))


class EvalPipeline(TrainPipeline):
    """The same prefetch for evaluation: `progress(it)` returns
    eval_step(*batch)."""

    def __init__(self, eval_step: Callable, prefetch_depth: int = 2,
                 device: DeviceLike = None):
        super().__init__(eval_step, prefetch_depth, device)


class SparseDistPipeline(TrainPipeline):
    """Three stages: batch i + 1 copied ahead, its sparse input dist
    computed at the end of batch i's step (`make_prefetched_train_step`),
    batch i's step on the dist computed before it. The first batch's dist
    is computed before its step; on the last batch the step computes the
    last batch's dist again, and an exhausted iterator drops it, so that a
    new iterator starts from its own first batch. Numerics equal
    `make_train_step`'s. device: the DMP's (default: the current CUDA
    card, as `TrainPipeline` takes it; raises if it is not the DMP's)."""

    def __init__(self, dmp, loss_fn: Optional[Callable] = None,
                 prefetch_depth: int = 3, device: DeviceLike = None):
        # batch i + 1 must be on the device for step i to dist it
        super().__init__(dmp._prefetched_step(loss_fn),
                         max(2, prefetch_depth), device)
        if self.device != dmp.env.device:
            raise ValueError(f"pipeline on {self.device}, DMP on "
                             f"{dmp.env.device}")
        self._dmp = dmp
        self._dists = None

    def progress(self, it: Iterator):
        try:
            args = self._next_batch(it)
        except StopIteration:
            self._dists = None  # the exhausted iterator's last dist
            raise
        sparse = self._dmp._sparse_arg(args)
        if self._dists is None:
            self._dists = self._dmp.input_dist(sparse)
        next_sparse = (self._dmp._sparse_arg(_as_args(
            self._ready(self._queue[0]))) if self._queue else sparse)
        loss, aux, self._dists = self._step(self._dists, next_sparse, *args)
        return loss, aux
