"""SimpleDeepFMNN (ref torchrec/models/deepfm.py:219-345; Guo et al.,
"DeepFM", IJCAI 2017).

Counterpart of torchrec_tpu/models/deepfm.py: the dense features through
two Dense + ReLU layers to the tables' embedding_dim, the pooled
embeddings from the EBC, and an interaction that concatenates the dense
features, DeepFM's deep part (one Dense + ReLU of width
`deep_fm_dimension` over all of them flattened) and the factorization
machine's scalar; then one Dense and a sigmoid. The layers are flax-style
`Dense` (modules/dense.py); the deep part and the FM, each with its
concatenation, run under the spans `## deepfm_deep ##` and
`## deepfm_fm ##`, their backward under `## deepfm_deep.bwd ##` and
`## deepfm_fm.bwd ##` (utils/tracing.py). The EBC sits
at `sparse_arch.embedding_bag_collection`, so the DMP's plan key inside a
wrapper `m` is "m/sparse_arch/embedding_bag_collection", where the JAX
one is "m/embedding_bag_collection" (the flax field); `flax_names` maps
the flax names, and `inter_arch`'s flax `Dense_0` is the deep part's
layer.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from torchrec_tpu_torch.modules.deepfm import DeepFM, FactorizationMachine
from torchrec_tpu_torch.modules.dense import Dense
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
    SparseInput,
)
from torchrec_tpu_torch.sparse.jagged import KeyedTensor
from torchrec_tpu_torch.utils.device import DeviceLike
from torchrec_tpu_torch.utils.tracing import ModuleSpan

_DEEP_SPAN = ModuleSpan("deepfm_deep")
_FM_SPAN = ModuleSpan("deepfm_fm")


class _SparseArch(nn.Module):
    """The EBC, returning its pooled KeyedTensor."""

    def __init__(self, embedding_bag_collection: nn.Module):
        super().__init__()
        self.embedding_bag_collection = embedding_bag_collection

    def forward(self, features: SparseInput) -> KeyedTensor:
        return self.embedding_bag_collection(features)


class _DenseArch(nn.Module):
    """Dense in -> hidden -> embedding_dim, ReLU after each (ref
    models/deepfm.py:69-111)."""

    flax_names = {"Dense_0": "hidden", "Dense_1": "out"}

    def __init__(self, in_features: int, hidden_layer_size: int,
                 embedding_dim: int, device: DeviceLike = None):
        super().__init__()
        self.hidden = Dense(in_features, hidden_layer_size, device)
        self.out = Dense(hidden_layer_size, embedding_dim, device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.out(torch.relu(self.hidden(features))))


class FMInteractionArch(nn.Module):
    """dense ++ DeepFM(dense, sparse...) ++ FM(dense, sparse...), [B, D +
    deep_fm_dimension + 1] (ref models/deepfm.py:114-185). fm_in_features
    is the flattened width D + F * D the deep layer reads."""

    flax_names = {"Dense_0": "deep_fm.deep_module.0"}

    def __init__(self, fm_in_features: int,
                 sparse_feature_names: Sequence[str],
                 deep_fm_dimension: int, device: DeviceLike = None):
        super().__init__()
        self.sparse_feature_names = tuple(sparse_feature_names)
        self.deep_fm = DeepFM(nn.Sequential(
            Dense(fm_in_features, deep_fm_dimension, device), nn.ReLU()))
        self.fm = FactorizationMachine()

    def forward(self, dense_features: torch.Tensor,
                sparse_features: KeyedTensor) -> torch.Tensor:
        """The dense input beside the FM terms of the selected keys.

        Args:
            dense_features: [B, d] dense arch output.
            sparse_features: the pooled embeddings, one key a feature.
        """
        if not self.sparse_feature_names:
            return dense_features
        # one split, not a slice per key: a slice's backward writes its
        # gradient into a zero tensor of the pooled values' full width and
        # autograd adds those up, F full-width fills and adds a step; a
        # split's backward is one concatenation
        per_key = dict(zip(sparse_features.keys, torch.split(
            sparse_features.values, list(sparse_features.length_per_key),
            dim=1)))
        tensors = [dense_features, *(per_key[name] for name in
                                     self.sparse_feature_names)]
        deep = _DEEP_SPAN(self.deep_fm, tensors)
        fm = _FM_SPAN(self.fm, tensors)
        return torch.cat([dense_features, deep, fm], dim=1)


class _OverArch(nn.Module):
    """Dense -> 1, then sigmoid (ref models/deepfm.py:187-216)."""

    flax_names = {"Dense_0": "linear"}

    def __init__(self, in_features: int, device: DeviceLike = None):
        super().__init__()
        self.linear = Dense(in_features, 1, device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.linear(features))


class SimpleDeepFMNN(nn.Module):
    """All tables share one embedding_dim D. forward(dense [B,
    num_dense_features], sparse [F, B, L] batch) -> probabilities [B, 1]
    (the JAX docstring calls them logits; the last op is a sigmoid)."""

    flax_names = {"embedding_bag_collection":
                  "sparse_arch.embedding_bag_collection"}

    def __init__(self, num_dense_features: int,
                 embedding_bag_collection: EmbeddingBagCollection,
                 hidden_layer_size: int, deep_fm_dimension: int,
                 device: DeviceLike = None):
        super().__init__()
        tables = embedding_bag_collection.tables
        if not tables:
            raise ValueError("At least one embedding bag is required")
        if len({cfg.embedding_dim for cfg in tables}) != 1:
            raise ValueError(
                "All EmbeddingBagConfigs must have the same dimension")
        D = tables[0].embedding_dim
        names = [f for cfg in tables for f in cfg.feature_names]
        self.sparse_arch = _SparseArch(embedding_bag_collection)
        self.dense_arch = _DenseArch(num_dense_features, hidden_layer_size,
                                     D, device)
        self.inter_arch = FMInteractionArch(D + len(names) * D, names,
                                            deep_fm_dimension, device)
        self.over_arch = _OverArch(D + deep_fm_dimension + 1, device)

    def forward(self, dense_features: torch.Tensor,
                sparse_features: SparseInput) -> torch.Tensor:
        """Logits [B, 1].

        Args:
            dense_features: [B, num_dense_features].
            sparse_features: the [F, B, L] batch, padded or jagged.
        """
        embedded_dense = self.dense_arch(dense_features)
        embedded_sparse = self.sparse_arch(sparse_features)
        concatenated = self.inter_arch(embedded_dense, embedded_sparse)
        return self.over_arch(concatenated)
