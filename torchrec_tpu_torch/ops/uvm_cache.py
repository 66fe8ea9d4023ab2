"""Host-resident embedding tables with an LRU row cache on the device.

Counterpart of torchrec_tpu/ops/uvm_cache.py (`UvmCachedEmbedding`), the
FUSED_UVM_CACHING compute kernel's building block. A table too large for
the card lives in pinned host memory, with its optimizer momenta beside
it; a [cache_rows, D] cache of its rows (and their momenta) lives on the
device, and the host keeps the cache's directory:

* `prepare(ids)`, per step on the host: the batch's unique ids that are
  resident are hits, the others misses; the misses take free slots in
  order, then the least recently used occupied slots, whose dirty rows
  and momenta are first written back to the host table; the missed rows
  are gathered on the host into a pinned staging buffer, copied to the
  device without blocking and written into their slots by K2
  `scatter_rows_write`. Returns the slot of every id.
* `lookup_pooled` is K1 on the cache; `update` is `apply_fused_update`
  on the cache (K3, the fused K4, K6 or K7 by optimizer) and marks the
  touched slots dirty.
* eviction and `flush` read the dirty slots back with K8 `gather_rows`
  into pinned memory and scatter them into the host table.

The directory follows the JAX class call for call, so that the slot ids
and `cache_stats` equal JAX's, but keeps it in numpy arrays instead of a
dict and Python lists: `slot_of` is an int32 [R] array (-1 where a row is
not resident) and the occupied slots are `np.nonzero(row_in_slot >= 0)`,
in ascending slot order as JAX's list comprehension builds them, sorted
by the same `np.argsort` on the same `last_use` array. Free slots are
taken in JAX's `_free.pop()` order, which is ascending: a slot returns to
the free list only through `invalidate`, so the list is always the range
[next_free, C). Hits and misses count each unique id once per `prepare`;
a train step prepares twice (its forward and its update), as JAX's does.

Ids must lie in [0, R): JAX's dict takes any key and numpy's indexing
then wraps a negative id or raises for one past R, where this class
raises for both.

The table and its host momenta are pinned host memory when the cache is
on a CUDA card: torch CPU tensors, used through numpy views, allocated at
their size and page-locked with `cudaHostRegister` (torch's
`pin_memory=True` allocator rounds every block up to a power of two,
which would take 32 GiB for a 20.5 GB table); the staging buffers come
from that allocator. Pinning that fails raises; nothing falls back to
pageable memory. On the
CPU they are ordinary CPU tensors and K1, K2 and K8 take their plain
versions, as every path does there.
"""

from __future__ import annotations

import weakref
from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from torchrec_tpu_torch.ops.embedding import PoolingMode, embedding_bag_lookup
from torchrec_tpu_torch.ops.fused_update import (
    EmbOptimType,
    FusedOptimizerState,
    apply_fused_update,
    fused_state_shapes,
)
from torchrec_tpu_torch.ops.fused_update_kernels import scatter_rows_write
from torchrec_tpu_torch.ops.gather_rows import gather_rows_forward
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

HostArray = Union[np.ndarray, torch.Tensor]


def host_tensor(shape: Tuple[int, ...], device: torch.device,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """A CPU tensor of exactly `shape`, page-locked with one
    cudaHostRegister when `device` is a CUDA card (a copy may not span two
    registrations), its pages touched first by a multi-threaded zero_();
    unregistered when the tensor is freed. Raises where it cannot pin.
    Zeroed on the card, uninitialised on the CPU."""
    t = torch.empty(shape, dtype=dtype)
    nbytes = t.numel() * t.element_size()
    if device.type != "cuda" or not nbytes:
        return t
    t.zero_()
    cudart = torch.cuda.cudart()
    err = cudart.cudaHostRegister(t.data_ptr(), nbytes, 0)
    if int(err) != 0:
        raise RuntimeError(f"cudaHostRegister of {nbytes} bytes failed: "
                           f"{err}")
    weakref.finalize(t, cudart.cudaHostUnregister, t.data_ptr())
    return t


def _staging(shape: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """A staging buffer: pinned by torch's caching host allocator on a
    card (small blocks, reused), a plain CPU tensor on the CPU."""
    return torch.empty(shape, dtype=torch.float32,
                       pin_memory=device.type == "cuda")


def _host_ints(x: HostArray, name: str) -> np.ndarray:
    """A host array or CPU tensor as numpy; a device tensor raises."""
    if isinstance(x, torch.Tensor):
        if x.device.type != "cpu":
            raise ValueError(f"{name} must be on the host (the slot ids "
                             f"prepare returned), got a {x.device} tensor")
        return x.numpy()
    return np.asarray(x)


class UvmCachedEmbedding:
    """An LRU row cache on `device` for one host-resident [R, D] float32
    table, under the fused optimizer `optim` (every EmbOptimType, its
    momenta kept on the host beside the table as `fused_state_shapes`
    gives them and cached with their rows).

    table: [R, D] float32, a numpy array or a CPU tensor. A CPU tensor
    that is already where this class keeps tables (pinned for a card) is
    adopted, not copied; anything else is copied. The host table changes
    in place on eviction and flush. cache_rows: the cache's capacity C,
    at least one batch's unique ids. device: where the cache lives
    (default: the current CUDA card; raises without one unless
    device="cpu" is passed).
    """

    def __init__(
        self,
        table: HostArray,
        cache_rows: int,
        optim: EmbOptimType = EmbOptimType.ROWWISE_ADAGRAD,
        optim_kwargs: Optional[dict] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.optim = optim
        self.optim_kwargs = dict(optim_kwargs or {})
        self.table = self._adopt(table)
        R, D = self.table.shape
        self.R, self.D, self.C = R, D, int(cache_rows)
        k1, k2 = fused_state_shapes(optim)

        def host(kind):
            if kind == "none":
                return None
            t = host_tensor((R,) if kind == "row" else (R, D), self.device)
            return t.zero_()

        def dev(kind):
            if kind == "none":
                return None
            return torch.zeros((self.C,) if kind == "row" else (self.C, D),
                               dtype=torch.float32, device=self.device)

        self.host_momentum1 = host(k1)
        self.host_momentum2 = host(k2)
        self.cache_w = torch.zeros((self.C, D), dtype=torch.float32,
                                   device=self.device)
        self.cache_m1 = dev(k1)
        self.cache_m2 = dev(k2)
        self.step = torch.zeros((), dtype=torch.int32, device=self.device)
        # the host directory
        self.slot_of = np.full((R,), -1, np.int32)
        self.row_in_slot = np.full((self.C,), -1, np.int64)
        self.dirty = np.zeros((self.C,), bool)
        self.last_use = np.zeros((self.C,), np.int64)
        self._clock = 0
        self._next_free = 0  # JAX's _free is the range [next_free, C)
        self.hits = 0
        self.misses = 0
        # pinned staging buffers, grown on demand, and the event of the
        # last copy out of the staging buffer
        self._stage: Dict[str, torch.Tensor] = {}
        self._staged: Optional[torch.cuda.Event] = None

    def _adopt(self, table: HostArray) -> torch.Tensor:
        pinned = self.device.type == "cuda"
        if (isinstance(table, torch.Tensor) and table.device.type == "cpu"
                and table.dtype == torch.float32 and table.dim() == 2
                and table.is_contiguous() and table.is_pinned() == pinned):
            return table
        src = torch.as_tensor(np.asarray(table, np.float32)
                              if not isinstance(table, torch.Tensor)
                              else table.detach().float().cpu())
        if src.dim() != 2:
            raise ValueError(f"table must be [R, D], got {tuple(src.shape)}")
        out = host_tensor(tuple(src.shape), self.device)
        out.copy_(src)
        return out

    def _momentum_pairs(self):
        """(host momentum, cache attribute name) of each momentum kept."""
        return [(h, a) for h, a in ((self.host_momentum1, "cache_m1"),
                                    (self.host_momentum2, "cache_m2"))
                if h is not None]

    def _buffer(self, name: str, shape: Tuple[int, ...]) -> torch.Tensor:
        """A staging buffer of shape[0] >= 1 rows, grown to the next power
        of two rows (at most the cache's) when too small."""
        buf = self._stage.get(name)
        if buf is None or buf.shape[0] < shape[0]:
            rows = max(min(1 << (shape[0] - 1).bit_length(), self.C), shape[0])
            buf = self._stage[name] = _staging((rows, *shape[1:]),
                                               self.device)
        return buf[:shape[0]]

    # -- host side: the directory --------------------------------------------

    def prepare(self, ids: HostArray) -> np.ndarray:
        """Make every id resident; return the slot of each (int32, the
        shape of `ids`). `ids` are host ids (numpy or a CPU tensor)."""
        ids = _host_ints(ids, "ids")
        shape = ids.shape
        ids = ids.reshape(-1)
        uniq = np.unique(ids)
        self._clock += 1
        if uniq.size > self.C:
            raise ValueError(
                f"batch touches {uniq.size} unique rows > cache_rows {self.C}")
        if uniq.size and (uniq[0] < 0 or uniq[-1] >= self.R):
            raise ValueError(f"ids outside [0, {self.R}): "
                             f"{int(uniq[0])}..{int(uniq[-1])}")
        slots = self.slot_of[uniq]
        hit = slots >= 0
        miss = uniq[~hit]
        self.hits += int(hit.sum())
        self.misses += int(miss.size)
        # this batch's resident rows are stamped before any eviction
        self.last_use[slots[hit]] = self._clock
        if miss.size:
            new = self._allocate(miss.size)
            self._stage_rows(miss, new)
            self.slot_of[miss] = new
            self.row_in_slot[new] = miss
        out = self.slot_of[ids]
        self.last_use[self.slot_of[uniq]] = self._clock
        return out.reshape(shape)

    def _allocate(self, n: int) -> np.ndarray:
        take = min(n, self.C - self._next_free)
        slots = np.arange(self._next_free, self._next_free + take,
                          dtype=np.int64)
        self._next_free += take
        need = n - take
        if need:
            # the LRU `need` occupied slots, JAX's order: ascending slots
            # sorted by last use with the same argsort
            occupied = np.nonzero(self.row_in_slot >= 0)[0]
            order = occupied[np.argsort(self.last_use[occupied])]
            victims = order[:need]
            self._evict(victims)
            slots = np.concatenate([slots, victims])
        return slots

    def _evict(self, victims: np.ndarray) -> None:
        dirty_v = victims[self.dirty[victims]]
        if dirty_v.size:
            self._sync_back(dirty_v)
        self.slot_of[self.row_in_slot[victims]] = -1
        self.row_in_slot[victims] = -1
        self.dirty[victims] = False

    # -- host <-> device ------------------------------------------------------

    def _device_ids(self, slots: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(slots.astype(np.int32)).to(
            self.device, non_blocking=False)

    def _stage_rows(self, rows: np.ndarray, slots: np.ndarray) -> None:
        """Host rows `rows` (and their momenta) into cache slots `slots`:
        a host gather into pinned buffers, an asynchronous copy, K2 (a
        rowwise momentum through index_copy_)."""
        if self._staged is not None:
            self._staged.synchronize()  # the buffers' last copy is done
        n = rows.size
        sl = self._device_ids(slots)
        copies = []
        for name, host, cache in (("w", self.table, self.cache_w),
                                  *[(a, h, getattr(self, a))
                                    for h, a in self._momentum_pairs()]):
            buf = self._buffer(name, (n, *host.shape[1:]))
            np.take(host.numpy(), rows, axis=0, out=buf.numpy())
            copies.append((buf.to(self.device, non_blocking=True), cache))
        if self.device.type == "cuda":
            self._staged = torch.cuda.Event()
            self._staged.record()
        for src, cache in copies:
            if cache.dim() == 2:
                scatter_rows_write(cache, sl, src)
            else:
                cache.index_copy_(0, sl.long(), src)

    def _sync_back(self, slots: np.ndarray) -> None:
        """The cache rows (and momenta) of `slots` into the host table at
        their rows: K8 into pinned buffers, then a host scatter."""
        sl = self._device_ids(slots)
        rows = self.row_in_slot[slots]
        outs = []
        for name, host, cache in (("back_w", self.table, self.cache_w),
                                  *[("back_" + a, h, getattr(self, a))
                                    for h, a in self._momentum_pairs()]):
            got = gather_rows_forward(
                cache if cache.dim() == 2 else cache[:, None], sl)
            buf = self._buffer(name, (slots.size, *host.shape[1:]))
            buf.copy_(got.reshape(buf.shape), non_blocking=True)
            outs.append((host, buf))
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        for host, buf in outs:
            host.numpy()[rows] = buf.numpy()

    def flush(self) -> None:
        """Write every dirty row (and its momenta) back to the host."""
        occ = np.nonzero(self.dirty)[0]
        if occ.size:
            self._sync_back(occ)
            self.dirty[occ] = False

    def invalidate(self, flush: bool = True) -> None:
        """Flush (unless `flush` is False: the cache's changes are then
        lost), then drop all residency: needed after the host table or
        momenta change directly, else resident rows go stale."""
        if flush:
            self.flush()
        occ = np.nonzero(self.row_in_slot >= 0)[0]
        self.slot_of[self.row_in_slot[occ]] = -1
        self.row_in_slot[:] = -1
        self.dirty[:] = False
        self.last_use[:] = 0
        self._next_free = 0

    # -- device side: the kernels on the cache --------------------------------

    def lookup_pooled(self, slot_ids: torch.Tensor, lengths: torch.Tensor,
                      coeff: Optional[torch.Tensor] = None) -> torch.Tensor:
        """SUM-pooled lookup on the cache (K1): slot_ids [B, L] and
        lengths [B] on the device, optional per-sample weights [B, L]."""
        return embedding_bag_lookup(self.cache_w, slot_ids, lengths,
                                    PoolingMode.SUM, coeff)

    @torch.no_grad()
    def update(self, flat_slot_ids: HostArray, row_grads: torch.Tensor,
               valid: HostArray, learning_rate: float) -> None:
        """One fused optimizer step on the cached rows; marks them dirty.
        flat_slot_ids [N] and valid [N] are host arrays (the slot ids
        `prepare` returned; the touched slots are taken from them, not
        copied back from the device); row_grads [N, D] is on the device."""
        slots = _host_ints(flat_slot_ids, "flat_slot_ids").reshape(-1)
        ok = _host_ints(valid, "valid").reshape(-1).astype(bool)
        opt = FusedOptimizerState(momentum1=self.cache_m1,
                                  momentum2=self.cache_m2, step=self.step,
                                  optim=self.optim)
        apply_fused_update(
            self.cache_w, opt, self._device_ids(slots),
            row_grads.to(self.device),
            torch.from_numpy(ok).to(self.device), learning_rate,
            **self.optim_kwargs)
        self.dirty[np.unique(slots[ok])] = True
