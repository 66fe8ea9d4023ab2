"""Sparse batch data structures: JaggedTensor, KeyedJaggedTensor,
PaddedSparseBatch and KeyedTensor.

Counterpart of torchrec_tpu/sparse/jagged.py. The layouts are the same:
`values` plus per-(feature, row) `lengths` in feature-major order for the
jagged form, and the dense [F, B, L] ids + [F, B] lengths of
`PaddedSparseBatch`, which every lookup takes. All ops run on the device
the tensors are on, and keep the JAX package's static totals: the
compactions of `JaggedTensor.from_dense_lengths` and
`PaddedSparseBatch.to_kjt` keep every slot (valid ones first, the slack
after them), and `jagged_permute_indices` reads slot 0 past the real
total. The operations the JAX package runs eagerly on the host (`split`,
`from_dense`, `to_dense`, `__getitem__`) are plain slicing here, on the
tensors' own device.
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


def _searchsorted_right(offsets: torch.Tensor,
                        pos: torch.Tensor) -> torch.Tensor:
    """numpy's searchsorted(side="right") of `pos` in `offsets`."""
    return torch.searchsorted(offsets, pos.to(offsets.dtype), right=True)


def jagged_segment_ids(lengths: torch.Tensor, total: int) -> torch.Tensor:
    """Segment id of each of `total` value slots given segment `lengths`;
    slots past sum(lengths) get len(lengths), a padding segment. int32."""
    offsets = lengths_to_offsets(lengths)
    pos = torch.arange(total, device=lengths.device)
    seg = _searchsorted_right(offsets, pos) - 1
    pad = torch.full_like(seg, lengths.shape[0])
    return torch.where(pos < offsets[-1], seg, pad).to(torch.int32)


def jagged_permute_indices(in_lengths: torch.Tensor, perm: torch.Tensor,
                           total: int) -> torch.Tensor:
    """Gather indices of a segment-level permutation of jagged values:
    output segment s reads input segment perm[s]. Returns int32 `src` of
    shape [total] with `out_values = values[src]`; slots past the real
    total read slot 0."""
    perm = perm.to(in_lengths.device).long()
    in_offsets = lengths_to_offsets(in_lengths)
    out_offsets = lengths_to_offsets(in_lengths[perm])
    pos = torch.arange(total, device=in_lengths.device)
    seg = (_searchsorted_right(out_offsets, pos) - 1).clamp(
        0, perm.shape[0] - 1)
    src = in_offsets[perm[seg]] + (pos - out_offsets[seg])
    return torch.where(pos < out_offsets[-1], src,
                       torch.zeros_like(src)).to(torch.int32)


def _first_slot_if_empty(t: torch.Tensor) -> torch.Tensor:
    # an all-empty batch has no values: gather from one dummy slot (every
    # slot is masked afterwards)
    return t if t.shape[0] else torch.zeros((1,), dtype=t.dtype, device=t.device)


def _valid_first(valid: torch.Tensor) -> torch.Tensor:
    """The stable argsort of ~valid: the valid slots first, in order."""
    return torch.sort((~valid).to(torch.int8), stable=True).indices


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

    def lengths_or_none(self) -> Optional[torch.Tensor]:
        return self.lengths

    def weights_or_none(self) -> Optional[torch.Tensor]:
        return self.weights

    @staticmethod
    def empty(dtype: torch.dtype = torch.int32) -> "JaggedTensor":
        return JaggedTensor(values=torch.zeros((0,), dtype=dtype),
                            lengths=torch.zeros((0,), dtype=torch.int32))

    @staticmethod
    def from_dense_lengths(
        values: torch.Tensor, lengths: torch.Tensor,
        weights: Optional[torch.Tensor] = None,
    ) -> "JaggedTensor":
        """Dense [B, L(, D)] + lengths [B] -> jagged values of static size
        B*L: row b's first lengths[b] values at offsets[b], the rest of
        the slots after all the valid ones."""
        B, L = values.shape[0], values.shape[1]
        dev = values.device
        flat = values.reshape((B * L,) + tuple(values.shape[2:]))
        row = torch.arange(B, device=dev).repeat_interleave(L)
        col = torch.arange(L, device=dev).repeat(B)
        order = _valid_first(col < lengths.to(dev)[row])
        out_weights = None
        if weights is not None:
            out_weights = weights.reshape(
                (B * L,) + tuple(weights.shape[2:]))[order]
        return JaggedTensor(values=flat[order], lengths=lengths,
                            weights=out_weights)

    @staticmethod
    def from_dense(
        values: Sequence[TensorLike],
        weights: Optional[Sequence[TensorLike]] = None,
    ) -> "JaggedTensor":
        """From a list of per-row arrays (numpy or torch)."""
        lengths = torch.as_tensor([len(v) for v in values], dtype=torch.int32)
        vals = (torch.cat([torch.as_tensor(v) for v in values]) if values
                else torch.zeros((0,)))
        w = None
        if weights is not None:
            w = torch.cat([torch.as_tensor(x) for x in weights])
        return JaggedTensor(values=vals, lengths=lengths, weights=w)

    def to_padded_dense(self, desired_length: int,
                        padding_value: float = 0.0) -> torch.Tensor:
        """Jagged -> dense [B, desired_length(, D)]; rows longer than
        desired_length are truncated. Raises on values with no slot, as
        the JAX gather does."""
        B, L = self.lengths.shape[0], desired_length
        dev = self.values.device
        lengths = self.lengths.to(dev)
        row = torch.arange(B, device=dev).repeat_interleave(L)
        col = torch.arange(L, device=dev).repeat(B)
        src = (lengths_to_offsets(lengths.long())[row] + col).clamp(
            0, max(self.values.shape[0] - 1, 0))
        vals = self.values[src]
        valid = col < lengths[row]
        if vals.dim() > 1:
            valid = valid.reshape((-1,) + (1,) * (vals.dim() - 1))
        pad = torch.tensor(padding_value, dtype=vals.dtype, device=dev)
        out = torch.where(valid, vals, pad)
        return out.reshape((B, L) + tuple(self.values.shape[1:]))

    def to_dense(self) -> List[torch.Tensor]:
        """List of per-row value tensors."""
        offs = self.offsets.tolist()
        return [self.values[offs[i]:offs[i + 1]] for i in range(len(offs) - 1)]


@dataclasses.dataclass
class KeyedJaggedTensor:
    """Multi-feature jagged batch in feature-major [F x B x jagged-L] layout.

    values: [N] ids (N may exceed the real total: slack slots have length
    0); lengths: [F * B] feature-major counts; keys: feature names;
    stride: batch size B; weights: optional [N].
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

    @staticmethod
    def empty() -> "KeyedJaggedTensor":
        return KeyedJaggedTensor(values=torch.zeros((0,), dtype=torch.int32),
                                 lengths=torch.zeros((0,), dtype=torch.int32),
                                 keys=(), stride=0)

    @staticmethod
    def concat(kjts: Sequence["KeyedJaggedTensor"]) -> "KeyedJaggedTensor":
        """Concatenate along the feature axis; strides must match. Once
        any input has weights, one without contributes f32 zeros."""
        stride = kjts[0].stride
        if any(k.stride != stride for k in kjts):
            raise ValueError(f"strides differ: {[k.stride for k in kjts]}")
        weights = None
        if any(k.weights is not None for k in kjts):
            weights = torch.cat([
                k.weights if k.weights is not None
                else torch.zeros_like(k.values, dtype=torch.float32)
                for k in kjts])
        return KeyedJaggedTensor(
            values=torch.cat([k.values for k in kjts]),
            lengths=torch.cat([k.lengths for k in kjts]),
            keys=tuple(key for k in kjts for key in k.keys),
            stride=stride, weights=weights)

    @property
    def num_keys(self) -> int:
        return len(self.keys)

    @property
    def offsets(self) -> torch.Tensor:
        return lengths_to_offsets(self.lengths)

    def length_per_key(self) -> torch.Tensor:
        """[F] number of values for each key."""
        return self.lengths_matrix().sum(dim=1)

    def offset_per_key(self) -> torch.Tensor:
        """[F+1] value offsets per key."""
        return lengths_to_offsets(self.length_per_key())

    def lengths_matrix(self) -> torch.Tensor:
        """[F, B] view of lengths."""
        return self.lengths.reshape(len(self.keys), self.stride)

    def sync(self) -> "KeyedJaggedTensor":
        """No-op: no per-key totals are cached."""
        return self

    def to(self, device) -> "KeyedJaggedTensor":
        return dataclasses.replace(
            self,
            values=self.values.to(device),
            lengths=self.lengths.to(device),
            weights=None if self.weights is None else self.weights.to(device),
        )

    def permute(self, indices: Sequence[int]) -> "KeyedJaggedTensor":
        """Reorder (or subset) the features; values keep their static
        size N, slots past the real total reading slot 0."""
        B = self.stride
        seg_perm = (np.asarray(indices, np.int64)[:, None] * B
                    + np.arange(B)[None, :]).reshape(-1)
        seg = torch.as_tensor(seg_perm, device=self.lengths.device)
        src = jagged_permute_indices(self.lengths, seg,
                                     self.values.shape[0]).long()
        src = src.to(self.values.device)
        return KeyedJaggedTensor(
            values=self.values[src],
            lengths=self.lengths[seg],
            keys=tuple(self.keys[i] for i in indices),
            stride=B,
            weights=None if self.weights is None else self.weights[src],
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

    def split(self, segments: Sequence[int]) -> List["KeyedJaggedTensor"]:
        """Split into groups of `segments[i]` consecutive keys."""
        out: List[KeyedJaggedTensor] = []
        offs = self.offset_per_key().tolist()
        start = 0
        for n in segments:
            end = start + n
            v0, v1 = offs[start], offs[end]
            out.append(KeyedJaggedTensor(
                values=self.values[v0:v1],
                lengths=self.lengths[start * self.stride:end * self.stride],
                keys=self.keys[start:end],
                stride=self.stride,
                weights=None if self.weights is None
                else self.weights[v0:v1],
            ))
            start = end
        return out

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

    @property
    def num_keys(self) -> int:
        return len(self.keys)

    @property
    def batch_size(self) -> int:
        return self.ids.shape[1]

    @property
    def max_length(self) -> int:
        return self.ids.shape[2]

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

    def to_kjt(self) -> KeyedJaggedTensor:
        """Padded -> jagged with the static total F*B*L: the valid ids
        first, in feature-major order, the slack after them."""
        F, B, L = self.ids.shape
        flat_len = self.lengths.reshape(F * B)
        col = torch.arange(L, device=self.ids.device)
        order = _valid_first((col[None, :] < flat_len[:, None]).reshape(-1))
        return KeyedJaggedTensor(
            values=self.ids.reshape(-1)[order],
            lengths=flat_len,
            keys=self.keys,
            stride=B,
            weights=None if self.weights is None
            else self.weights.reshape(-1)[order],
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
        keys: Sequence[str], tensors: Sequence[torch.Tensor], dim: int = 1
    ) -> "KeyedTensor":
        """Only dim=1 is supported, as in the JAX package."""
        if dim != 1:
            raise ValueError(f"KeyedTensor concatenates along dim 1, not {dim}")
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

    @staticmethod
    def regroup(keyed_tensors: Sequence["KeyedTensor"],
                groups: Sequence[Sequence[str]]) -> List[torch.Tensor]:
        """The columns of several KeyedTensors, concatenated anew per group
        of keys."""
        lookup: Dict[str, torch.Tensor] = {}
        for kt in keyed_tensors:
            lookup.update(kt.to_dict())
        return [torch.cat([lookup[k] for k in g], dim=1) for g in groups]
