"""Plain reference of MLPerf Training's DLRM-DCNv2 (recommendation_v2,
torchrec's DLRM_DCN; Wang et al., "DCN V2", arXiv:2008.13535), the
benchmark's own copy of the model's arithmetic: the dense arch (ReLU after
every layer) to the embedding width, its output and the F pooled
multi-hot embeddings concatenated to x0 [B, (F+1) D], dense first, a
low-rank cross net x_{l+1} = x0 * (W_l (V_l x_l) + b_l) + x_l whose V_l
have no bias, and the over arch (ReLU after every layer but the last) to
one logit. Trained on the mean binary cross entropy of the logits; the
training reference (`reference/train.py`) sums the pooling, totals the
rows' gradients and steps Adagrad element by element on the tables and
the dense layers. Departures from the published model: the learning rate
is constant (no warm-up or decay), and one card trains on its own batch
(no data-parallel gradient average, no model-parallel exchange)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from gpubench import work
from gpubench.reference.common import bce_with_logits, linear


def linear_shapes(cfg: dict) -> List[Tuple[int, int]]:
    """(in, out): the dense arch, then V_l and W_l of each cross layer,
    then the over arch."""
    N = (len(cfg["num_embeddings_per_feature"]) + 1) * cfg["embedding_dim"]
    r = cfg["dcn_low_rank_dim"]
    shapes, fi = [], cfg["dense_in_features"]
    for fo in cfg["dense_arch_layer_sizes"]:
        shapes.append((fi, fo))
        fi = fo
    shapes += [(N, r), (r, N)] * cfg["dcn_num_layers"]
    fi = N
    for fo in cfg["over_arch_layer_sizes"]:
        shapes.append((fi, fo))
        fi = fo
    return shapes


def linear_biases(cfg: dict) -> List[bool]:
    """Every layer has a bias but the cross net's V_l."""
    return [True] * len(cfg["dense_arch_layer_sizes"]) + (
        [False, True] * cfg["dcn_num_layers"]) + (
        [True] * len(cfg["over_arch_layer_sizes"]))


def tiny_sizes(cfg: dict) -> dict:
    """The CPU tests' widths: D = 8 (the dense arch ending there), rank 4,
    a narrow over arch; the layer counts and the ids a feature as
    stated."""
    return {"embedding_dim": 8, "dense_arch_layer_sizes": [16, 8],
            "dcn_low_rank_dim": 4, "over_arch_layer_sizes": [32, 16, 1]}


def forward(cfg: dict, linears: Sequence, dense: torch.Tensor,
            pooled: torch.Tensor, precision: str) -> torch.Tensor:
    """dense [B, 13], pooled [B, F, D] -> logits [B]."""
    n_dense = len(cfg["dense_arch_layer_sizes"])
    n_cross = 2 * cfg["dcn_num_layers"]
    x = dense
    for w, b in linears[:n_dense]:
        x = torch.relu(linear(x, w, b, precision))
    x0 = torch.cat([x, pooled.reshape(pooled.shape[0], -1)], dim=1)
    z = x0
    cross = linears[n_dense:n_dense + n_cross]
    for (v, _), (w, b) in zip(cross[0::2], cross[1::2]):
        z = x0 * linear(linear(z, v, None, precision), w, b, precision) + z
    over = linears[n_dense + n_cross:]
    for w, b in over[:-1]:
        z = torch.relu(linear(z, w, b, precision))
    w, b = over[-1]
    return linear(z, w, b, precision)[:, 0]


def loss(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return bce_with_logits(out, labels)


def flops_per_example(cfg: dict, train: bool) -> int:
    """The linear layers (the first takes no input gradient); the cross
    net's elementwise products are left out. At the published widths
    32,060,928 forward."""
    return work.linear_flops(linear_shapes(cfg), train, no_input_grad=(0,))
