"""BERT4Rec sequence recommender (arxiv 1904.06690).

Counterpart of torchrec_tpu/models/bert4rec.py: `TransformerBlock`,
`HistoryArch`, `BERT4Rec`, `BERT4RecTrain` and
`make_item_embedding_collection`. The item table is an EmbeddingCollection
that DistributedModelParallel shards (plan key "model/ec" inside
BERT4RecTrain); the transformer is dense. Attention, LayerNorm and the
linear layers are plain PyTorch (`nn.Linear`, `torch.einsum`), as the JAX
package leaves them to XLA outside any Pallas kernel. They compute what
flax 0.12's layers compute:

* `Dense` is flax's `nn.Dense` as an `nn.Linear`; the attention's q/k/v
  and out `DenseGeneral` kernels [D, H, D/H] and [H, D/H, D] are
  `nn.Linear(D, D)` weights (utils/jax_bridge.py reshapes them). Kernels
  are drawn lecun_normal (a normal truncated at 2 sigma, scaled to
  variance 1/fan_in), biases are zero.
* `LayerNorm` (modules/activation.py) has epsilon 1e-6 (torch's default
  is 1e-5).
* The GELU is the tanh approximation, `jax.nn.gelu`'s default.
* Attention divides the query by sqrt(head dim) before the QK product and
  sets masked logits to finfo(float32).min, not -inf: a row whose keys
  are all masked (an all-pad sequence) gets a uniform softmax, not NaN.
* The positional parameter [L, D] is drawn normal(1.0).

Dropout with a rate above 0 and `deterministic=False` raises
NotImplementedError: the JAX DMP never passes a dropout rng, so its train
step runs deterministic too.

`flax_names` on a module maps the flax auto-names of its children to its
attributes, for the weight bridge.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from torchrec_tpu_torch.modules.activation import LayerNorm
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingCollection,
    SparseInput,
    as_padded,
)
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

# flax's variance_scaling: the std of a standard normal truncated to
# [-2, 2], by which the truncated draw is divided
_TRUNCATED_STD = 0.87962566103423978


def _check_dropout(rate: float, deterministic: bool) -> None:
    if rate > 0.0 and not deterministic:
        raise NotImplementedError(
            "dropout in training is not ported; pass deterministic=True "
            "(the JAX DMP's train step runs deterministic) or dropout=0.0"
        )


class Dense(nn.Linear):
    """flax `nn.Dense`: lecun_normal kernel, zero bias, fp32."""

    def __init__(self, in_features: int, out_features: int,
                 device: DeviceLike = None):
        super().__init__(in_features, out_features,
                         device=resolve_device(device), dtype=torch.float32)

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        std = (1.0 / self.in_features) ** 0.5 / _TRUNCATED_STD
        nn.init.trunc_normal_(self.weight, 0.0, std, -2.0 * std, 2.0 * std,
                              generator=generator)
        nn.init.zeros_(self.bias)


class MultiHeadDotProductAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention` for self-attention:
    softmax((q / sqrt(d)) k^T, masked) v over `num_heads` heads of
    qkv_features / num_heads, then the output projection back to the
    input width."""

    def __init__(self, num_heads: int, in_features: int, qkv_features: int,
                 device: DeviceLike = None):
        super().__init__()
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features {qkv_features} is not a "
                             f"multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.query = Dense(in_features, qkv_features, device)
        self.key = Dense(in_features, qkv_features, device)
        self.value = Dense(in_features, qkv_features, device)
        self.out = Dense(qkv_features, in_features, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        """x [B, L, D]; mask [B, 1, L, L] bool, True where a query may
        attend to a key. Returns [B, L, D]."""
        B, L, _ = x.shape
        H = self.num_heads

        def heads(t):
            return t.reshape(B, L, H, -1)

        q = heads(self.query(x))
        k, v = heads(self.key(x)), heads(self.value(x))
        q = q / math.sqrt(q.shape[-1])
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(mask, logits, torch.finfo(logits.dtype).min)
        attn = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v)
        return self.out(out.reshape(B, L, -1))


class TransformerBlock(nn.Module):
    """Pre-norm block: x + attn(norm(x)); x + ff(norm(x)), with a GELU
    feed-forward of width dim_ff."""

    flax_names = {
        "LayerNorm_0": "attn_norm",
        "MultiHeadDotProductAttention_0": "attention",
        "LayerNorm_1": "ff_norm",
        "Dense_0": "ff_in",
        "Dense_1": "ff_out",
    }

    def __init__(self, dim_model: int, num_heads: int, dim_ff: int,
                 dropout: float = 0.1, device: DeviceLike = None):
        super().__init__()
        self.dropout = dropout
        self.attn_norm = LayerNorm(dim_model, device)
        self.attention = MultiHeadDotProductAttention(
            num_heads, dim_model, dim_model, device)
        self.ff_norm = LayerNorm(dim_model, device)
        self.ff_in = Dense(dim_model, dim_ff, device)
        self.ff_out = Dense(dim_ff, dim_model, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        """x [B, L, D]; mask [B, 1, L, L] bool. Returns [B, L, D]."""
        _check_dropout(self.dropout, deterministic)
        x = x + self.attention(self.attn_norm(x), mask)
        h = F.gelu(self.ff_in(self.ff_norm(x)), approximate="tanh")
        return x + self.ff_out(h)


def make_item_embedding_collection(
    vocab_size: int, emb_dim: int, history_len: int,
    device: DeviceLike = None,
) -> EmbeddingCollection:
    """The item-embedding table BERT4Rec model-parallelizes."""
    return EmbeddingCollection(
        [EmbeddingConfig(num_embeddings=vocab_size, embedding_dim=emb_dim,
                         name="item_embedding", feature_names=["item"])],
        max_feature_length=history_len, device=device,
    )


class HistoryArch(nn.Module):
    """Item embedding (the EmbeddingCollection `ec`) + learned positional
    embedding + LayerNorm."""

    def __init__(self, vocab_size: int, history_len: int, emb_dim: int,
                 ec: nn.Module, dropout: float = 0.1,
                 device: DeviceLike = None):
        super().__init__()
        del vocab_size  # the EC knows the vocabulary
        dev = resolve_device(device)
        self.dropout = dropout
        self.ec = ec
        self.positional = nn.Parameter(
            torch.empty(history_len, emb_dim, device=dev, dtype=torch.float32))
        self.layernorm = LayerNorm(emb_dim, dev)

    @torch.no_grad()
    def reset_parameters(
        self, generator: Optional[torch.Generator] = None
    ) -> None:
        """The positional embedding from normal(1.0); the LayerNorm and
        the EC initialise themselves."""
        nn.init.normal_(self.positional, 0.0, 1.0, generator=generator)

    def forward(self, id_list_features: SparseInput,
                deterministic: bool = True) -> torch.Tensor:
        """Token embeddings [B, L, D]."""
        _check_dropout(self.dropout, deterministic)
        x = self.ec(id_list_features)["item"] + self.positional[None, :, :]
        return self.layernorm(x)


class BERT4Rec(nn.Module):
    """Item history -> per-position logits over the vocabulary. `ec` is
    registered before the history arch that also holds it, so its module
    path is "ec", as the flax field path is."""

    def __init__(self, vocab_size: int, max_len: int, emb_dim: int,
                 nhead: int, num_layers: int, dropout: float = 0.1,
                 ec: Optional[nn.Module] = None, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.max_len = max_len
        self.ec = ec if ec is not None else make_item_embedding_collection(
            vocab_size, emb_dim, max_len, dev)
        self.history = HistoryArch(vocab_size, max_len, emb_dim, self.ec,
                                   dropout, dev)
        self.blocks = nn.ModuleList(
            TransformerBlock(emb_dim, nhead, emb_dim * 4, dropout, dev)
            for _ in range(num_layers))
        # linear head instead of a tied-embedding matmul, as in JAX
        self.out = Dense(emb_dim, vocab_size, dev)
        self.flax_names = {f"block_{i}": f"blocks.{i}"
                           for i in range(num_layers)}

    def forward(self, input: SparseInput,
                deterministic: bool = True) -> torch.Tensor:
        """Per-position logits [B, L, vocab]; positions attend only to
        keys whose item id is > 0 (not padding)."""
        sb = as_padded(input, self.max_len)
        ids = sb.ids[sb.keys.index("item")]  # [B, L]
        B, L = ids.shape
        mask = (ids > 0)[:, None, None, :].expand(B, 1, L, L)
        x = self.history(sb, deterministic=deterministic)
        for block in self.blocks:
            x = block(x, mask, deterministic=deterministic)
        return self.out(x)


class BERT4RecTrain(nn.Module):
    """Masked-LM training wrapper: cross-entropy on the positions whose
    label is not `pad_id`."""

    def __init__(self, model: BERT4Rec, pad_id: int = 0):
        super().__init__()
        self.model = model
        self.pad_id = pad_id

    def forward(
        self, input: SparseInput, labels: torch.Tensor,
        deterministic: bool = True,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """labels [B, L]. Returns (loss, (loss, logits [B, L, vocab]))."""
        logits = self.model(input, deterministic=deterministic)
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(-1, labels[:, :, None].long())[:, :, 0]
        mask = (labels != self.pad_id).to(logits.dtype)
        loss = -(picked * mask).sum() / mask.sum().clamp(min=1.0)
        return loss, (loss, logits)
