"""Plain reference of torchrec's SimpleDeepFMNN (models/deepfm.py:219-345;
Guo et al., "DeepFM", IJCAI 2017): the dense features through two
Linear + ReLU layers to the embedding width D; the flattened
concatenation x of that vector and the F pooled embeddings [B, D + F D];
DeepFM's deep part, one Linear + ReLU of x to `deep_fm_dimension`; the
factorization machine's scalar 0.5 ((sum x)^2 - sum x^2); then one Linear
of [dense, deep, fm] and a sigmoid. Trained on the mean binary cross
entropy of the probabilities; scored by them."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from gpubench import work
from gpubench.reference.common import bce, linear


def linear_shapes(cfg: dict) -> List[Tuple[int, int]]:
    """(in, out): the dense arch's two layers, the deep layer, the over
    layer."""
    F = len(cfg["num_embeddings_per_feature"])
    D = cfg["embedding_dim"]
    H = cfg["hidden_layer_size"]
    deep = cfg["deep_fm_dimension"]
    return [(cfg["dense_in_features"], H), (H, D), (D + F * D, deep),
            (D + deep + 1, 1)]


def tiny_sizes(cfg: dict) -> dict:
    """The sizes a CPU test sets in place of the configuration's: narrow
    layers (the tests cap the tables)."""
    return {"hidden_layer_size": 16, "deep_fm_dimension": 16}


def forward(cfg: dict, linears: Sequence, dense: torch.Tensor,
            pooled: torch.Tensor, precision: str) -> torch.Tensor:
    """dense [B, 13], pooled [B, F, D] -> probabilities [B]."""
    (w0, b0), (w1, b1), (w2, b2), (w3, b3) = linears
    B = dense.shape[0]
    d = torch.relu(linear(torch.relu(linear(dense, w0, b0, precision)),
                          w1, b1, precision))
    x = torch.cat([d, pooled.reshape(B, -1)], dim=1)
    deep = torch.relu(linear(x, w2, b2, precision))
    fm = 0.5 * (torch.square(x.sum(dim=1, keepdim=True))
                - torch.square(x).sum(dim=1, keepdim=True))
    z = torch.cat([d, deep, fm], dim=1)
    return torch.sigmoid(linear(z, w3, b3, precision))[:, 0]


def loss(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return bce(out, labels)


def flops_per_example(cfg: dict, train: bool) -> int:
    """The linear layers (the first takes no input gradient) and the
    factorization machine over N = D + F D values: 3N forward (the sum,
    the squares, their sum), 2N backward."""
    F = len(cfg["num_embeddings_per_feature"])
    N = cfg["embedding_dim"] * (F + 1)
    fm = 3 * N + (2 * N if train else 0)
    return work.linear_flops(linear_shapes(cfg), train,
                             no_input_grad=(0,)) + fm
