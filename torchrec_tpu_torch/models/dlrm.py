"""DLRM (Deep Learning Recommendation Model, arxiv 1906.00091) and
DLRM_DCN, the DLRM with a DCN-V2 cross net in place of its dot
interaction (arxiv 2008.13535).

Counterpart of torchrec_tpu/models/dlrm.py: SparseArch, DenseArch,
InteractionArch, OverArch, DLRM and the DLRMTrain loss wrapper. The
pairwise interaction is the upper triangle, in `np.triu_indices(F + 1,
k=1)` order, of each example's [F+1, D] x [D, F+1] Gram product; the JAX
package leaves it to XLA outside any Pallas kernel, and here it is one
hand-written CUDA kernel a direction (ops/dot_interaction.py), with its
plain PyTorch version on the CPU. Logits are always fp32. The dense arch,
the interaction and the over arch run under the spans `## dlrm_dense_arch ##`,
`## dlrm_interaction ##` and `## dlrm_over_arch ##`, their backward under
`## <name>.bwd ##` (utils/tracing.py).

DLRM_DCN (torchrec's `DLRM_DCN`, the model of MLPerf Training's DLRM-DCNv2
benchmark; the JAX package has none) shares SparseArch, DenseArch and
OverArch with DLRM; its InteractionDCNArch concatenates the dense arch's
output and the F pooled embeddings into x0 [B, (F+1) D], dense first, and
applies a LowRankCrossNet (modules/crossnet.py) to it, under the span
`## dlrm_crossnet ##` and its `.bwd`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingBagCollection,
    SparseInput,
)
from torchrec_tpu_torch.modules.crossnet import LowRankCrossNet
from torchrec_tpu_torch.modules.mlp import MLP, Perceptron
from torchrec_tpu_torch.ops.dot_interaction import dot_interaction
from torchrec_tpu_torch.utils.device import DeviceLike
from torchrec_tpu_torch.utils.tracing import ModuleSpan

# the dense parts' spans and their backward's (`## <name>.bwd ##`)
_DENSE_SPAN = ModuleSpan("dlrm_dense_arch")
_INTERACTION_SPAN = ModuleSpan("dlrm_interaction")
_OVER_SPAN = ModuleSpan("dlrm_over_arch")
_CROSSNET_SPAN = ModuleSpan("dlrm_crossnet")


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


class SparseArch(nn.Module):
    """EBC wrapper returning [B, F, D]."""

    def __init__(self, embedding_bag_collection: nn.Module):
        super().__init__()
        self.embedding_bag_collection = embedding_bag_collection

    def forward(self, features: SparseInput) -> torch.Tensor:
        kt = self.embedding_bag_collection(features)
        return kt.values.reshape(kt.values.shape[0], len(kt.keys), -1)


class DenseArch(nn.Module):
    """MLP over the dense input -> [B, D]."""

    flax_names = {"MLP_0": "mlp"}

    def __init__(
        self,
        in_features: int,
        layer_sizes: Sequence[int],
        dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        self.mlp = MLP(in_features, layer_sizes, dtype=dtype, device=device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.mlp(features)


class InteractionArch(nn.Module):
    """Pairwise dot interactions of (dense ++ sparse) features.

    Returns [B, D + F*(F+1)/2]: the dense features followed by the upper
    triangle (offset 1) of the (F+1) x (F+1) Gram matrix, row-major. With a
    compute `dtype` the inputs are rounded to it and the products are
    summed in fp32, as the JAX einsum's preferred_element_type does.
    """

    def __init__(self, num_sparse_features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_sparse_features = num_sparse_features
        self.dtype = dtype

    def forward(
        self, dense_features: torch.Tensor, sparse_features: torch.Tensor
    ) -> torch.Tensor:
        """The dense input beside the pairwise dot products.

        Args:
            dense_features: [B, D] dense arch output.
            sparse_features: [B, F, D] pooled embeddings.
        """
        F = self.num_sparse_features
        if F <= 0:
            return dense_features
        if self.dtype is None:
            return dot_interaction(dense_features, sparse_features)
        # the products of the inputs rounded to the compute dtype, beside
        # the dense input as it came
        out = dot_interaction(dense_features.to(self.dtype).float(),
                              sparse_features.to(self.dtype).float())
        return torch.cat([dense_features, out[:, dense_features.shape[1]:]],
                         dim=1)


class OverArch(nn.Module):
    """MLP + final linear head."""

    flax_names = {"MLP_0": "mlp"}

    def __init__(
        self,
        in_features: int,
        layer_sizes: Sequence[int],
        dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        if len(layer_sizes) <= 1:
            raise ValueError("OverArch must have multiple layers.")
        self.mlp = MLP(in_features, layer_sizes[:-1], dtype=dtype,
                       device=device)
        self.head = Perceptron(layer_sizes[-2], layer_sizes[-1],
                               activation=_identity, dtype=dtype,
                               device=device)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        return self.head(self.mlp(features))


class InteractionDCNArch(nn.Module):
    """DLRM_DCN's interaction (torchrec's InteractionDCNArch): the dense
    features and the F pooled embeddings concatenated into x0 [B, (F+1) D],
    dense first, through a cross net to [B, (F+1) D]."""

    def __init__(self, crossnet: nn.Module):
        super().__init__()
        self.crossnet = crossnet

    def forward(self, dense_features: torch.Tensor,
                sparse_features: torch.Tensor) -> torch.Tensor:
        """dense_features [B, D], sparse_features [B, F, D]."""
        x0 = torch.cat([dense_features, sparse_features.reshape(
            sparse_features.shape[0], -1)], dim=1)
        return self.crossnet(x0)


def _embedding_dim(embedding_bag_collection: EmbeddingBagCollection,
                   dense_arch_layer_sizes: Sequence[int]) -> Tuple[int, int]:
    """(D, F): the tables' one width, which the dense arch's last layer
    must equal, and the number of features."""
    tables = embedding_bag_collection.tables
    if not tables:
        raise ValueError("At least one embedding bag is required")
    dims = {cfg.embedding_dim for cfg in tables}
    if len(dims) != 1:
        raise ValueError(
            "All EmbeddingBagConfigs must have the same dimension"
        )
    embedding_dim = tables[0].embedding_dim
    if dense_arch_layer_sizes[-1] != embedding_dim:
        raise ValueError(
            f"embedding_dim {embedding_dim} must match dense arch output "
            f"{dense_arch_layer_sizes[-1]}"
        )
    return embedding_dim, sum(len(cfg.feature_names) for cfg in tables)


class DLRM(nn.Module):
    """All tables share one embedding_dim, which the dense arch's last
    layer must equal. `dense_dtype` is the compute dtype of the dense,
    interaction and over arches; parameters and logits stay fp32."""

    # the JAX DLRM holds its EBC (an FP-EBC's processor lives there) itself
    flax_names = {"embedding_bag_collection":
                  "sparse_arch.embedding_bag_collection"}

    def __init__(
        self,
        embedding_bag_collection: EmbeddingBagCollection,
        dense_in_features: int,
        dense_arch_layer_sizes: Sequence[int],
        over_arch_layer_sizes: Sequence[int],
        dense_dtype: Optional[torch.dtype] = None,
        device: DeviceLike = None,
    ):
        super().__init__()
        embedding_dim, num_features = _embedding_dim(
            embedding_bag_collection, dense_arch_layer_sizes)
        self.sparse_arch = SparseArch(embedding_bag_collection)
        self.dense_arch = DenseArch(dense_in_features, dense_arch_layer_sizes,
                                    dtype=dense_dtype, device=device)
        self.inter_arch = InteractionArch(num_features, dtype=dense_dtype)
        over_in = embedding_dim + num_features * (num_features + 1) // 2
        self.over_arch = OverArch(over_in, over_arch_layer_sizes,
                                  dtype=dense_dtype, device=device)

    def forward(
        self, dense_features: torch.Tensor, sparse_features: SparseInput
    ) -> torch.Tensor:
        """dense_features [B, d_in]; sparse_features the [F, B, L] batch.
        Returns fp32 logits [B, 1]."""
        embedded_dense = _DENSE_SPAN(self.dense_arch, dense_features)
        embedded_sparse = self.sparse_arch(sparse_features)
        concatenated = _INTERACTION_SPAN(self.inter_arch, embedded_dense,
                                         embedded_sparse)
        return _OVER_SPAN(self.over_arch, concatenated).float()


class DLRM_DCN(nn.Module):
    """DLRM with a low-rank DCN-V2 cross net in place of the dot
    interaction (torchrec's DLRM_DCN; the model of MLPerf Training's
    DLRM-DCNv2). The dense arch maps the dense input to the tables' one
    width D; x0 = [dense, F pooled embeddings] of width N = (F+1) D goes
    through `dcn_num_layers` crosses x_{l+1} = x0 * (W_l (V_l x_l) + b_l)
    + x_l, V_l [dcn_low_rank_dim, N] without a bias; the over arch maps N
    to the logit. Every parameter and the logits are fp32."""

    def __init__(
        self,
        embedding_bag_collection: EmbeddingBagCollection,
        dense_in_features: int,
        dense_arch_layer_sizes: Sequence[int],
        over_arch_layer_sizes: Sequence[int],
        dcn_num_layers: int,
        dcn_low_rank_dim: int,
        device: DeviceLike = None,
    ):
        super().__init__()
        embedding_dim, num_features = _embedding_dim(
            embedding_bag_collection, dense_arch_layer_sizes)
        width = (num_features + 1) * embedding_dim
        self.sparse_arch = SparseArch(embedding_bag_collection)
        self.dense_arch = DenseArch(dense_in_features, dense_arch_layer_sizes,
                                    device=device)
        self.inter_arch = InteractionDCNArch(LowRankCrossNet(
            width, dcn_num_layers, dcn_low_rank_dim, device=device))
        self.over_arch = OverArch(width, over_arch_layer_sizes, device=device)

    def forward(
        self, dense_features: torch.Tensor, sparse_features: SparseInput
    ) -> torch.Tensor:
        """dense_features [B, d_in]; sparse_features the batch, padded or
        jagged. Returns fp32 logits [B, 1]."""
        embedded_dense = _DENSE_SPAN(self.dense_arch, dense_features)
        embedded_sparse = self.sparse_arch(sparse_features)
        crossed = _CROSSNET_SPAN(self.inter_arch, embedded_dense,
                                 embedded_sparse)
        return _OVER_SPAN(self.over_arch, crossed).float()


class DLRMTrain(nn.Module):
    """DLRM (or DLRM_DCN) + BCE-with-logits loss (mean)."""

    def __init__(self, dlrm: nn.Module):
        super().__init__()
        self.dlrm = dlrm

    def forward(
        self,
        dense_features: torch.Tensor,
        sparse_features: SparseInput,
        labels: torch.Tensor,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """Returns (loss, (loss, logits, labels)).

        Args:
            dense_features: [B, d_in].
            sparse_features: the [F, B, L] batch, padded or jagged.
            labels: [B] in {0, 1}.
        """
        logits = self.dlrm(dense_features, sparse_features).squeeze(-1)
        labels = labels.to(logits.dtype)
        # JAX's gradient at a logit of 0: jnp.maximum splits it, as
        # torch.maximum does, and jnp.abs takes the slope +1 there
        abs_z = torch.where(logits >= 0, logits, -logits)
        loss = torch.mean(
            torch.maximum(logits, logits.new_zeros(())) - logits * labels
            + torch.log1p(torch.exp(-abs_z))
        )
        return loss, (loss, logits, labels)
