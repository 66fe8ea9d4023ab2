"""Plain reference of DLRM (Naumov et al., arXiv:1906.00091; torchrec's
models/dlrm.py): a dense arch (ReLU after every layer) to the embedding
width, the pairwise dot products of the dense vector and the F pooled
embeddings (the upper triangle of their Gram matrix, row-major, without
the diagonal) beside the dense vector, and an over arch (ReLU after every
layer but the last) to one logit. Trained on the mean binary cross
entropy of the logits; scored by the logits."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from gpubench import work
from gpubench.reference.common import bce_with_logits, linear, mm


def linear_shapes(cfg: dict) -> List[Tuple[int, int]]:
    """(in, out) of every linear layer, dense arch then over arch."""
    F = len(cfg["num_embeddings_per_feature"])
    D = cfg["embedding_dim"]
    shapes, fi = [], cfg["dense_in_features"]
    for fo in cfg["dense_arch_layer_sizes"]:
        shapes.append((fi, fo))
        fi = fo
    fi = D + F * (F + 1) // 2
    for fo in cfg["over_arch_layer_sizes"]:
        shapes.append((fi, fo))
        fi = fo
    return shapes


def tiny_sizes(cfg: dict) -> dict:
    """The sizes a CPU test sets in place of the configuration's: narrow
    layers (the tests cap the tables)."""
    return {"embedding_dim": 8, "dense_arch_layer_sizes": [16, 8],
            "over_arch_layer_sizes": [16, 1]}


def forward(cfg: dict, linears: Sequence, dense: torch.Tensor,
            pooled: torch.Tensor, precision: str) -> torch.Tensor:
    """dense [B, 13], pooled [B, F, D] -> logits [B]."""
    n_dense = len(cfg["dense_arch_layer_sizes"])
    x = dense
    for w, b in linears[:n_dense]:
        x = torch.relu(linear(x, w, b, precision))
    F = pooled.shape[1]
    combined = torch.cat([x[:, None, :], pooled], dim=1)  # [B, F+1, D]
    gram = mm(combined, combined.transpose(1, 2), precision)
    iu, ju = torch.triu_indices(F + 1, F + 1, offset=1, device=x.device)
    z = torch.cat([x, gram[:, iu, ju]], dim=1)
    over = linears[n_dense:]
    for w, b in over[:-1]:
        z = torch.relu(linear(z, w, b, precision))
    w, b = over[-1]
    return linear(z, w, b, precision)[:, 0]


def loss(out: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return bce_with_logits(out, labels)


def flops_per_example(cfg: dict, train: bool) -> int:
    """The linear layers (the first takes no input gradient) and the
    [F+1, D] x [D, F+1] Gram product (its backward is two products)."""
    n = len(cfg["num_embeddings_per_feature"]) + 1
    gram = 2 * n * n * cfg["embedding_dim"] * (3 if train else 1)
    return work.linear_flops(linear_shapes(cfg), train,
                             no_input_grad=(0,)) + gram
