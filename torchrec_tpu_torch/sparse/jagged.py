"""Sparse batch data structures: JaggedTensor, KeyedJaggedTensor,
PaddedSparseBatch and KeyedTensor.

Counterpart of torchrec_tpu/sparse/jagged.py. The layouts are the same:
`values` plus per-(feature, row) `lengths` in feature-major order for the
jagged form, and the dense [F, B, L] ids + [F, B] lengths of
`PaddedSparseBatch`, which every lookup takes. All ops run on the device
the tensors are on. `permute`, `split` and `concat` of KeyedJaggedTensor
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

TensorLike = Union[torch.Tensor, np.ndarray, Sequence[int]]


def lengths_to_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """[N] lengths -> [N+1] complete-cumsum offsets."""
    zero = torch.zeros((1,), dtype=lengths.dtype, device=lengths.device)
    return torch.cat([zero, torch.cumsum(lengths, 0).to(lengths.dtype)])


def offsets_to_lengths(offsets: torch.Tensor) -> torch.Tensor:
    """[N+1] offsets -> [N] lengths."""
    return offsets[1:] - offsets[:-1]


def _first_slot_if_empty(t: torch.Tensor) -> torch.Tensor:
    # an all-empty batch has no values: gather from one dummy slot (every
    # slot is masked afterwards)
    return t if t.shape[0] else torch.zeros((1,), dtype=t.dtype, device=t.device)


@dataclasses.dataclass
class JaggedTensor:
    """Variable-length values with per-row lengths.

    values: [N] (or [N, D]); lengths: [B]; weights: optional, parallel to
    values.
    """

    values: torch.Tensor
    lengths: torch.Tensor
    weights: Optional[torch.Tensor] = None

    @property
    def offsets(self) -> torch.Tensor:
        return lengths_to_offsets(self.lengths)

    def to_dense(self) -> List[torch.Tensor]:
        """List of per-row value tensors."""
        offs = self.offsets.tolist()
        return [self.values[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]


@dataclasses.dataclass
class KeyedJaggedTensor:
    """Multi-feature jagged batch in feature-major [F x B x jagged-L] layout.

    values: [N] ids; lengths: [F * B] feature-major counts; keys: feature
    names; stride: batch size B; weights: optional [N].
    """

    values: torch.Tensor
    lengths: torch.Tensor
    keys: Tuple[str, ...]
    stride: int
    weights: Optional[torch.Tensor] = None

    @staticmethod
    def from_lengths(
        keys: Sequence[str],
        values: TensorLike,
        lengths: TensorLike,
        weights: Optional[TensorLike] = None,
        stride: Optional[int] = None,
    ) -> "KeyedJaggedTensor":
        lengths = torch.as_tensor(lengths, dtype=torch.int32)
        if stride is None:
            if lengths.shape[0] % len(keys):
                raise ValueError(
                    f"{lengths.shape[0]} lengths do not split into "
                    f"{len(keys)} keys"
                )
            stride = lengths.shape[0] // len(keys)
        return KeyedJaggedTensor(
            values=torch.as_tensor(values),
            lengths=lengths,
            keys=tuple(keys),
            stride=stride,
            weights=None if weights is None else torch.as_tensor(weights),
        )

    @staticmethod
    def from_offsets(
        keys: Sequence[str],
        values: TensorLike,
        offsets: TensorLike,
        weights: Optional[TensorLike] = None,
    ) -> "KeyedJaggedTensor":
        return KeyedJaggedTensor.from_lengths(
            keys, values, offsets_to_lengths(torch.as_tensor(offsets)), weights
        )

    @property
    def offsets(self) -> torch.Tensor:
        return lengths_to_offsets(self.lengths)

    def length_per_key(self) -> torch.Tensor:
        """[F] number of values for each key."""
        return self.lengths.reshape(len(self.keys), self.stride).sum(dim=1)

    def offset_per_key(self) -> torch.Tensor:
        """[F+1] value offsets per key."""
        return lengths_to_offsets(self.length_per_key())

    def to(self, device) -> "KeyedJaggedTensor":
        return dataclasses.replace(
            self,
            values=self.values.to(device),
            lengths=self.lengths.to(device),
            weights=None if self.weights is None else self.weights.to(device),
        )

    def to_padded(self, max_length: int, pad_id: int = 0) -> "PaddedSparseBatch":
        """Jagged -> dense [F, B, L] compute layout, on the values' device.

        Ids beyond a row's length are `pad_id` with length-mask 0. Rows
        longer than max_length are truncated.
        """
        F, B, L = len(self.keys), self.stride, max_length
        dev = self.values.device
        lengths = self.lengths.to(dev)
        offsets = lengths_to_offsets(lengths.long())
        col = torch.arange(L, device=dev)
        base = offsets[: F * B][:, None] + col[None, :]  # [F*B, L]
        src = base.clamp(0, max(self.values.shape[0] - 1, 0)).reshape(-1)
        valid = col[None, :] < lengths.clamp(max=L)[:, None]
        ids = _first_slot_if_empty(self.values)[src].reshape(F * B, L)
        ids = torch.where(valid, ids, pad_id)
        weights = None
        if self.weights is not None:
            w = _first_slot_if_empty(self.weights)[src].reshape(F * B, L)
            weights = torch.where(valid, w, 0.0).reshape(F, B, L)
        return PaddedSparseBatch(
            ids=ids.reshape(F, B, L).to(torch.int32),
            lengths=lengths.clamp(max=L).reshape(F, B).to(torch.int32),
            keys=self.keys,
            weights=weights,
        )

    def __getitem__(self, key: str) -> JaggedTensor:
        """Single-feature jagged view."""
        f = self.keys.index(key)
        offs = self.offset_per_key().tolist()
        v0, v1 = offs[f], offs[f + 1]
        w = self.weights
        return JaggedTensor(
            values=self.values[v0:v1],
            lengths=self.lengths[f * self.stride:(f + 1) * self.stride],
            weights=None if w is None else w[v0:v1],
        )

    def to_dict(self) -> Dict[str, JaggedTensor]:
        return {k: self[k] for k in self.keys}


@dataclasses.dataclass
class PaddedSparseBatch:
    """Dense [F, B, L] id layout with a length mask: the input of every
    lookup.

    ids: [F, B, L] int32; lengths: [F, B] int32; keys: feature names;
    weights: optional [F, B, L] float per-sample weights.
    """

    ids: torch.Tensor
    lengths: torch.Tensor
    keys: Tuple[str, ...]
    weights: Optional[torch.Tensor] = None

    def mask(self) -> torch.Tensor:
        """[F, B, L] bool validity mask."""
        col = torch.arange(self.ids.shape[2], device=self.ids.device)
        return col[None, None, :] < self.lengths[:, :, None]

    def select_features(
        self, feature_indices: Sequence[int]
    ) -> "PaddedSparseBatch":
        """Static feature subset / permutation; the identity is free."""
        idx = list(feature_indices)
        if idx == list(range(len(self.keys))):
            return self
        sel = torch.as_tensor(idx, dtype=torch.long, device=self.ids.device)
        return PaddedSparseBatch(
            ids=self.ids[sel],
            lengths=self.lengths[sel],
            keys=tuple(self.keys[i] for i in idx),
            weights=None if self.weights is None else self.weights[sel],
        )


@dataclasses.dataclass
class KeyedTensor:
    """Dense tensors concatenated along the last dim, addressable by key.

    values: [B, sum(length_per_key)], the pooled-embedding output.
    """

    values: torch.Tensor
    keys: Tuple[str, ...]
    length_per_key: Tuple[int, ...]

    @staticmethod
    def from_tensor_list(
        keys: Sequence[str], tensors: Sequence[torch.Tensor]
    ) -> "KeyedTensor":
        return KeyedTensor(
            values=torch.cat(list(tensors), dim=1),
            keys=tuple(keys),
            length_per_key=tuple(int(t.shape[1]) for t in tensors),
        )

    def _offsets(self) -> List[int]:
        offs = [0]
        for n in self.length_per_key:
            offs.append(offs[-1] + n)
        return offs

    def __getitem__(self, key: str) -> torch.Tensor:
        i = self.keys.index(key)
        offs = self._offsets()
        return self.values[:, offs[i]:offs[i + 1]]

    def to_dict(self) -> Dict[str, torch.Tensor]:
        offs = self._offsets()
        return {
            k: self.values[:, offs[i]:offs[i + 1]]
            for i, k in enumerate(self.keys)
        }
