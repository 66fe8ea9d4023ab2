"""Feature processors: learned per-position weights before pooling.

Counterpart of torchrec_tpu/modules/feature_processor.py.
`PositionWeightedModule` gives slot l of feature f the weight
`position_weight_<f>[min(l, max_len_f - 1)]`, times the length mask, as the
batch's per-sample weights; `FeatureProcessedEmbeddingBagCollection` runs
it before a weighted EmbeddingBagCollection.

The JAX module creates `position_weight_<key>`, of shape (max(max_len, L),),
for each key of the first batch it sees, whose L it reads then. A torch
parameter must exist before the first forward (DistributedModelParallel
allocates it with `to_empty`), so the port's module is built for given
feature names and L by `build`, which the
FeatureProcessedEmbeddingBagCollection that receives it calls with its
EmbeddingBagCollection's features and `max_feature_length`. The shapes
are the JAX module's, so the weight bridge carries them by name. A key
missing from `max_feature_lengths` uses the batch's L, as in JAX.

Under DistributedModelParallel the processor stays a dense module beside
the sharded lookup, and its parameters take gradients through K1's VJP in
the per-sample weights (parallel/dmp.py).
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
    SparseInput,
    as_padded,
)
from torchrec_tpu_torch.sparse.jagged import KeyedTensor, PaddedSparseBatch
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

MaxLengths = Union[Mapping[str, int], Sequence[Tuple[str, int]]]


class PositionWeightedModule(nn.Module):
    """Learned position weights per feature.

    max_feature_lengths: feature name -> its number of positions. The
    parameters are created by `build`, on `device`.
    """

    def __init__(self, max_feature_lengths: MaxLengths,
                 device: DeviceLike = None):
        super().__init__()
        self.max_feature_lengths = dict(max_feature_lengths)
        self.device = resolve_device(device)
        self.feature_names: Tuple[str, ...] = ()
        self.max_length: Optional[int] = None

    def build(self, feature_names: Sequence[str],
              max_length: int) -> "PositionWeightedModule":
        """Create `position_weight_<key>` of shape (max(max_len, L),) per
        feature, L = max_length, initialised to ones."""
        if self.max_length is not None:
            raise ValueError("the position weights exist already")
        self.feature_names = tuple(feature_names)
        self.max_length = max_length
        for key in self.feature_names:
            n = max(self.max_feature_lengths.get(key, max_length), max_length)
            self.register_parameter(f"position_weight_{key}", nn.Parameter(
                torch.empty(n, device=self.device, dtype=torch.float32)))
        self.reset_parameters()
        return self

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """Ones, the JAX module's initializer."""
        for p in self.parameters(recurse=False):
            p.fill_(1.0)

    def forward(self, features: PaddedSparseBatch) -> PaddedSparseBatch:
        """The batch with weights [F, B, L]: each key's position weights,
        masked by its lengths."""
        if self.max_length is None:
            raise RuntimeError("PositionWeightedModule has no parameters "
                               "yet: call build()")
        _, B, L = features.ids.shape
        col = torch.arange(L, device=features.ids.device)
        weights = []
        for key in features.keys:
            pw = self.get_parameter(f"position_weight_{key}")
            pos = col.clamp(max=self.max_feature_lengths.get(key, L) - 1)
            weights.append(pw[pos][None, :].expand(B, L))
        w = torch.stack(weights)
        return dataclasses.replace(
            features, weights=w * features.mask().to(w.dtype))


class FeatureProcessedEmbeddingBagCollection(nn.Module):
    """A weighted EmbeddingBagCollection fed by a feature processor:
    forward is `embedding_bag_collection(feature_processor(batch))`.

    A PositionWeightedModule not built yet is built here for the
    collection's features and `max_feature_length`.
    """

    def __init__(self, embedding_bag_collection: EmbeddingBagCollection,
                 feature_processor: nn.Module):
        super().__init__()
        self.embedding_bag_collection = embedding_bag_collection
        self.feature_processor = feature_processor
        ebc = embedding_bag_collection
        if (isinstance(feature_processor, PositionWeightedModule)
                and feature_processor.max_length is None):
            names = [f for cfg in ebc.tables for f in cfg.feature_names]
            feature_processor.build(list(dict.fromkeys(names)),
                                    ebc.max_feature_length)

    @property
    def tables(self):
        return self.embedding_bag_collection.tables

    @property
    def is_weighted(self) -> bool:
        return True

    def forward(self, features: SparseInput) -> KeyedTensor:
        ebc = self.embedding_bag_collection
        return ebc(self.feature_processor(
            as_padded(features, ebc.max_feature_length)))
