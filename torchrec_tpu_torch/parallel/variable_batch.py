"""Variable batches: a batch size per rank, carried through every strategy
as data.

Counterpart of torchrec_tpu/parallel/variable_batch.py. Each rank's part
of the global batch is padded to one budget, `batch_size` rows, and the
true sizes travel beside it:

* `VariableBatch.from_ragged` builds the padded global batch. Pad rows
  have zero sparse lengths, so they look up nothing, pool to zeros and
  take exactly zero gradient through the masked pooling, and an example
  mask of 0.
* `masked_mean` and `masked_bce_with_logits` reduce over the real rows
  only, so the pad rows do not bias training: a step on the padded batch
  equals the step on the real rows alone. At world size n they take the
  global batch's count of real rows (`rank_count`), as JAX's mean over
  the global batch does.
* The strategies need nothing more: each of them (DATA_PARALLEL,
  ROW_WISE, TABLE_WISE, COLUMN_WISE, the hierarchical ones and the
  sequence ones) pools and updates through the token mask, which is 0 on
  the pad rows (tests/test_torch_port_variable_batch.py holds them to
  JAX at per-rank sizes [3, 1, 4, 2]).

At world size n, rank r feeds rows [r B_pad, (r + 1) B_pad) of the padded
global batch, its own part and its padding.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from torchrec_tpu_torch.sparse.jagged import PaddedSparseBatch
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device


def _rows(x) -> torch.Tensor:
    """A part (numpy or torch) as a CPU tensor."""
    return torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                           else x).cpu()


@dataclasses.dataclass
class VariableBatch:
    """A padded global batch with each rank's true batch size.

    sparse: PaddedSparseBatch [F, n * B_pad, L]; dense: [n * B_pad, d]
    (zeros on pad rows) or None; labels: [n * B_pad] or None;
    example_mask: [n * B_pad] f32, 1.0 on real rows;
    batch_size_per_device: [n] int32.
    """

    sparse: PaddedSparseBatch
    dense: Optional[torch.Tensor]
    labels: Optional[torch.Tensor]
    example_mask: torch.Tensor
    batch_size_per_device: torch.Tensor

    @property
    def padded_batch_per_device(self) -> int:
        return (self.example_mask.shape[0]
                // self.batch_size_per_device.shape[0])

    def rank_count(self, world_size: int) -> float:
        """The real rows of the global batch over `world_size`: the
        `count` of `masked_mean` on each of `world_size` ranks."""
        return max(int(self.batch_size_per_device.sum()), 1) / world_size

    @staticmethod
    def from_ragged(
        sparse_parts: Sequence[PaddedSparseBatch],
        dense_parts: Optional[Sequence] = None,
        label_parts: Optional[Sequence] = None,
        batch_size: Optional[int] = None,
        device: DeviceLike = None,
    ) -> "VariableBatch":
        """The padded global batch of one ragged part per rank, each part
        padded to `batch_size` rows (default: the largest part), on
        `device` (default: the current CUDA card; pass device="cpu" for
        the CPU)."""
        dev = resolve_device(device)
        n = len(sparse_parts)
        sizes = [p.batch_size for p in sparse_parts]
        B_pad = int(batch_size if batch_size is not None else max(sizes))
        if any(s > B_pad for s in sizes):
            raise ValueError(f"device batch {max(sizes)} exceeds budget "
                             f"{B_pad}")
        keys = sparse_parts[0].keys
        F = sparse_parts[0].num_keys
        L = sparse_parts[0].max_length
        ids = torch.zeros((F, n * B_pad, L), dtype=torch.int32)
        lengths = torch.zeros((F, n * B_pad), dtype=torch.int32)
        has_w = sparse_parts[0].weights is not None
        weights = (torch.zeros((F, n * B_pad, L), dtype=torch.float32)
                   if has_w else None)
        mask = torch.zeros((n * B_pad,), dtype=torch.float32)
        for d, p in enumerate(sparse_parts):
            if p.keys != keys or p.max_length != L:
                raise ValueError("sparse parts must share keys and "
                                 "max_length")
            lo, b = d * B_pad, sizes[d]
            ids[:, lo:lo + b] = _rows(p.ids)
            lengths[:, lo:lo + b] = _rows(p.lengths)
            if has_w:
                weights[:, lo:lo + b] = _rows(p.weights)
            mask[lo:lo + b] = 1.0

        def padded(parts):
            if parts is None:
                return None
            first = _rows(parts[0])
            out = torch.zeros((n * B_pad, *first.shape[1:]),
                              dtype=first.dtype)
            for d, part in enumerate(parts):
                out[d * B_pad:d * B_pad + sizes[d]] = _rows(part)
            return out.to(dev)

        sb = PaddedSparseBatch(
            ids=ids.to(dev), lengths=lengths.to(dev), keys=tuple(keys),
            weights=None if weights is None else weights.to(dev))
        return VariableBatch(
            sparse=sb, dense=padded(dense_parts), labels=padded(label_parts),
            example_mask=mask.to(dev),
            batch_size_per_device=torch.as_tensor(sizes, dtype=torch.int32,
                                                  device=dev))


def masked_mean(values: torch.Tensor, example_mask: torch.Tensor,
                count: Optional[float] = None) -> torch.Tensor:
    """Mean over the real examples only (pad rows excluded): the sum over
    the real rows divided by `count`, by default their number (at least
    1), as in JAX.

    At world size n each rank holds a slice of the global batch and the
    DMP averages the ranks' gradients; JAX takes the mean over the global
    batch's real rows. Pass count = `VariableBatch.rank_count(n)` (their
    number / n) on every rank: the mean of the ranks' losses, and of their
    gradients, is then JAX's."""
    m = example_mask.to(values.dtype)
    denom = torch.clamp(torch.sum(m), min=1.0) if count is None else count
    return torch.sum(values * m) / denom


def masked_bce_with_logits(logits: torch.Tensor, labels: torch.Tensor,
                           example_mask: torch.Tensor,
                           count: Optional[float] = None) -> torch.Tensor:
    """BCE with logits averaged over the real examples: the variable-batch
    loss, whose gradient on a pad row is exactly zero. `count` as in
    `masked_mean`."""
    z = logits.reshape(-1)
    y = labels.to(z.dtype).reshape(-1)
    # at z = 0 (a row that looks nothing up has z = bias, 0 at init) the
    # gradient is JAX's: jnp.maximum splits it, as torch.maximum does, and
    # jnp.abs takes the slope +1, as this where does (torch.abs takes 0)
    abs_z = torch.where(z >= 0, z, -z)
    per = torch.maximum(z, z.new_zeros(())) - z * y + torch.log1p(
        torch.exp(-abs_z))
    return masked_mean(per, example_mask, count)
