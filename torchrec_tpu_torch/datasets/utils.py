"""Dataset utilities: the Batch container, train / validation splits and
the concatenation of several readers.

Counterpart of torchrec_tpu/datasets/utils.py. The JAX `Batch` is a
pytree that `jax.device_put` moves; here it is a dataclass of tensors
with a `to(device, non_blocking=)`, and the port's train pipeline copies
it as it copies any dataclass of tensors. `batch_args()` gives the train
step's arguments, (dense, sparse, labels).
"""

from __future__ import annotations

import dataclasses
import random
from typing import Iterator, Tuple

import torch

from torchrec_tpu_torch.sparse import PaddedSparseBatch
from torchrec_tpu_torch.utils.device import DeviceLike


@dataclasses.dataclass
class Batch:
    """Dense features [B, d] f32, the sparse id features as a
    PaddedSparseBatch [F, B, L] and labels [B] f32."""

    dense_features: torch.Tensor
    sparse_features: PaddedSparseBatch
    labels: torch.Tensor

    @property
    def batch_size(self) -> int:
        return self.dense_features.shape[0]

    def to(self, device: DeviceLike, non_blocking: bool = False) -> "Batch":
        """The batch on `device`; a copy from pinned host memory with
        `non_blocking` runs asynchronously to the host."""

        def move(t):
            return None if t is None else t.to(device,
                                               non_blocking=non_blocking)

        sb = self.sparse_features
        return Batch(
            dense_features=move(self.dense_features),
            sparse_features=dataclasses.replace(
                sb, ids=move(sb.ids), lengths=move(sb.lengths),
                weights=move(sb.weights)),
            labels=move(self.labels),
        )

    def batch_args(self) -> Tuple[torch.Tensor, PaddedSparseBatch,
                                  torch.Tensor]:
        """(dense, sparse, labels): DLRMTrain's arguments."""
        return self.dense_features, self.sparse_features, self.labels


def train_filter(
    key_fn, train_perc: float, decimal_places: int, idx: int
) -> bool:
    """Deterministic train-split membership by index hashing."""
    return (key_fn(idx) % 10**decimal_places) < round(
        train_perc * 10**decimal_places
    )


def val_filter(key_fn, train_perc: float, decimal_places: int,
               idx: int) -> bool:
    """The complement of `train_filter`."""
    return not train_filter(key_fn, train_perc, decimal_places, idx)


def rand_split_train_val(
    iterable, train_perc: float, random_seed: int = 0
) -> Tuple[Iterator, Iterator]:
    """Split an iterable into train / validation streams, each item drawn
    to one side by `random.Random(random_seed)` in order (JAX's draws)."""
    if not 0.0 < train_perc < 1.0:
        raise ValueError("train_perc must be in (0.0, 1.0)")

    def gen(want_train: bool):
        rng = random.Random(random_seed)
        for item in iterable:
            is_train = rng.random() < train_perc
            if is_train == want_train:
                yield item

    return gen(True), gen(False)


class ParallelReadConcat:
    """Concatenation of several iterator factories, one after another."""

    def __init__(self, *factories):
        self._factories = factories

    def __iter__(self):
        for factory in self._factories:
            yield from factory()
