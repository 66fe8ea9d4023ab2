"""Random recommendation batches.

Counterpart of torchrec_tpu/datasets/random.py. The host path draws from
`np.random.RandomState(manual_seed)` in JAX's order, so its batches are
JAX's bit for bit, with uniform or Zipf ids. The device path
(`on_device=True`, `device_batch_fn()`) draws each batch on the card from
a `torch.Generator` on the device, re-seeded for every batch from the
seed and the batch's counters (`step_seed`), so that nothing is copied
from the host and every batch can be drawn again. Its Zipf inverse CDF
runs in float32, as JAX's device path does without x64, and its draws are
torch's, not JAX's: the two streams share their distributions, not their
values.
"""

from __future__ import annotations

from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch

from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.sparse import PaddedSparseBatch
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

# ids drawn uniformly on the card: a 62-bit integer modulo the table's
# rows, whose bias (rows / 2^62) is far below any test's resolution
_UNIFORM_BITS = 62


def step_seed(*parts: int) -> int:
    """A 63-bit generator seed from integers (a base seed, an epoch, a
    step), each tuple its own independent stream."""
    words = np.random.SeedSequence(
        [int(p) & 0xFFFFFFFF for p in parts]).generate_state(2, np.uint32)
    return (int(words[0]) << 31) ^ int(words[1])


def zipf_inverse_cdf(u: torch.Tensor, n: torch.Tensor,
                     a: float) -> torch.Tensor:
    """Bounded power-law ranks in [1, n] from uniforms u, in u's dtype:
    the closed-form inverse CDF of the continuous Zipf(a) truncated at n
    (a == 1 takes the log-space form, where 1 / (1 - a) diverges)."""
    if abs(a - 1.0) < 1e-6:
        return torch.pow(n, u)
    t = 1.0 - a
    return torch.pow(u * (torch.pow(n, t) - 1.0) + 1.0, 1.0 / t)


def uniform_open(shape, generator: torch.Generator,
                 device: torch.device, low: float = 1e-7) -> torch.Tensor:
    """f32 uniforms in [low, 1), JAX's `uniform(minval=low)`."""
    u = torch.rand(shape, generator=generator, device=device)
    return low + (1.0 - low) * u


class RandomRecDataset:
    """A stream of random Batches.

    keys: sparse feature names; hash_sizes: id range per feature (or one
    hash_size for all); ids_per_feature: L, with lengths uniform in
    [min_ids_per_feature, L]; num_dense: dense width; zipf_a: Zipf ids
    (duplicate-rich, Criteo-like) instead of uniform ones. on_device:
    draw the batches on `device` (default: the current CUDA card; raises
    without one unless device="cpu" is passed) instead of on the host.
    """

    def __init__(
        self,
        keys: Sequence[str],
        batch_size: int,
        hash_size: Optional[int] = None,
        hash_sizes: Optional[Sequence[int]] = None,
        ids_per_feature: int = 2,
        num_dense: int = 13,
        manual_seed: Optional[int] = None,
        num_batches: Optional[int] = None,
        min_ids_per_feature: Optional[int] = None,
        on_device: bool = False,
        zipf_a: Optional[float] = None,
        device: DeviceLike = None,
    ):
        if hash_sizes is None:
            hash_sizes = [hash_size or 100] * len(keys)
        assert len(hash_sizes) == len(keys)
        self.keys = tuple(keys)
        self.batch_size = batch_size
        self.hash_sizes = list(hash_sizes)
        self.L = ids_per_feature
        self.min_L = (
            ids_per_feature if min_ids_per_feature is None
            else min_ids_per_feature
        )
        self.num_dense = num_dense
        self.num_batches = num_batches
        self._seed = manual_seed if manual_seed is not None else 0
        self.on_device = on_device
        self.zipf_a = zipf_a
        self.device = resolve_device(device) if on_device else None

    def _batch(self, rng: np.random.RandomState) -> Batch:
        F, B, L = len(self.keys), self.batch_size, self.L
        lengths = rng.randint(self.min_L, L + 1, size=(F, B)).astype(np.int32)
        if self.zipf_a is not None:
            from torchrec_tpu_torch.datasets.synthetic_criteo import zipf_ids

            ids = np.stack(
                [
                    zipf_ids(rng, self.hash_sizes[f], (B, L), self.zipf_a)
                    for f in range(F)
                ]
            ).astype(np.int32)
        else:
            ids = np.stack(
                [
                    rng.randint(0, self.hash_sizes[f], size=(B, L))
                    for f in range(F)
                ]
            ).astype(np.int32)
        dense = rng.randn(B, self.num_dense).astype(np.float32)
        labels = rng.randint(0, 2, size=(B,)).astype(np.float32)
        sb = PaddedSparseBatch(ids=torch.from_numpy(ids),
                               lengths=torch.from_numpy(lengths),
                               keys=self.keys)
        return Batch(dense_features=torch.from_numpy(dense),
                     sparse_features=sb, labels=torch.from_numpy(labels))

    def device_batch_fn(self, device: DeviceLike = None
                        ) -> Callable[[int], Batch]:
        """seed -> Batch drawn on `device` (default: the dataset's, else
        the current CUDA card) from one generator re-seeded with `seed`
        (`step_seed(...)` of the run's counters): the same seed gives the
        same batch."""
        dev = resolve_device(device or self.device)
        F, B, L = len(self.keys), self.batch_size, self.L
        hashes = torch.as_tensor(self.hash_sizes, dtype=torch.int64,
                                 device=dev)[:, None, None]
        hashes_f = hashes.float()
        g = torch.Generator(device=dev)
        zipf_a = self.zipf_a

        def gen(seed: int) -> Batch:
            g.manual_seed(seed)
            lengths = torch.randint(self.min_L, L + 1, (F, B), generator=g,
                                    device=dev, dtype=torch.int32)
            if zipf_a is not None:
                k = zipf_inverse_cdf(uniform_open((F, B, L), g, dev),
                                     hashes_f, zipf_a)
                ids = torch.minimum(torch.clamp(k.to(torch.int64) - 1, min=0),
                                    hashes - 1)
            else:
                ids = torch.randint(0, 2 ** _UNIFORM_BITS, (F, B, L),
                                    generator=g, device=dev,
                                    dtype=torch.int64) % hashes
            dense = torch.randn((B, self.num_dense), generator=g, device=dev)
            labels = (torch.rand((B,), generator=g, device=dev)
                      < 0.5).float()
            sb = PaddedSparseBatch(ids=ids.to(torch.int32), lengths=lengths,
                                   keys=self.keys)
            return Batch(dense_features=dense, sparse_features=sb,
                         labels=labels)

        return gen

    def __iter__(self) -> Iterator[Batch]:
        n = 0
        if self.on_device:
            gen = self.device_batch_fn()
            while self.num_batches is None or n < self.num_batches:
                yield gen(step_seed(self._seed, n))
                n += 1
            return
        rng = np.random.RandomState(self._seed)
        while self.num_batches is None or n < self.num_batches:
            yield self._batch(rng)
            n += 1

    def __len__(self) -> int:
        if self.num_batches is None:
            raise TypeError("infinite dataset")
        return self.num_batches
