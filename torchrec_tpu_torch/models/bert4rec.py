"""BERT4Rec sequence recommender (arxiv 1904.06690).

Counterpart of torchrec_tpu/models/bert4rec.py: `TransformerBlock`,
`HistoryArch`, `BERT4Rec`, `BERT4RecTrain` and
`make_item_embedding_collection`. The item table is an EmbeddingCollection
that DistributedModelParallel shards (plan key "model/ec" inside
BERT4RecTrain); the transformer is dense. Attention, LayerNorm and the
linear layers are plain PyTorch (`nn.Linear`, `torch.einsum`), as the JAX
package leaves them to XLA outside any Pallas kernel. They compute what
flax 0.12's layers compute:

* `Dense` (modules/dense.py) is flax's `nn.Dense` as an `nn.Linear`; the
  attention's q/k/v and out `DenseGeneral` kernels [D, H, D/H] and
  [H, D/H, D] are `nn.Linear(D, D)` weights (utils/jax_bridge.py
  reshapes them). Kernels are drawn lecun_normal (a normal truncated at 2
  sigma, scaled to variance 1/fan_in), biases are zero.
* `LayerNorm` (modules/activation.py) has epsilon 1e-6 (torch's default
  is 1e-5).
* The GELU is the tanh approximation, `jax.nn.gelu`'s default.
* Attention divides the query by sqrt(head dim) before the QK product and
  sets masked logits to finfo(float32).min, not -inf: a row whose keys
  are all masked (an all-pad sequence) gets a uniform softmax, not NaN.
* The positional parameter [L, D] is drawn normal(1.0).

Dropout runs where flax's does (after the history's LayerNorm, on the
attention weights, on each residual branch and after the feed-forward's
GELU) when `deterministic=False` and a `torch.Generator` is given; each
mask is drawn from that generator, and the kept values are scaled by
1/keep (flax's `nn.Dropout`). The attention mask is one [L, L] draw
shared by every batch row and head, as flax's `broadcast_dropout=True`
draws it; the others are drawn at full shape. torch's RNG is not JAX's,
so the masks differ from flax's draws; their distribution is the same.
The DMP's train step calls the model with its default
`deterministic=True`, as the JAX DMP, which passes no dropout rng, does.

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
from torchrec_tpu_torch.modules.dense import Dense
from torchrec_tpu_torch.modules.embedding_configs import EmbeddingConfig
from torchrec_tpu_torch.modules.embedding_modules import (
    EmbeddingCollection,
    SparseInput,
    as_padded,
)
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

def dropout(x: torch.Tensor, rate: float, deterministic: bool,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax `nn.Dropout`: x / keep where a draw from `generator` keeps it,
    0 elsewhere. No draw when deterministic or at rate 0; all zeros at
    rate 1."""
    if deterministic or rate == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout needs a torch.Generator when "
                         "deterministic=False")
    if rate == 1.0:
        return torch.zeros_like(x)
    keep_prob = 1.0 - rate
    keep = _keep_mask(x.shape, keep_prob, x.device, generator)
    return torch.where(keep, x / keep_prob, torch.zeros_like(x))


def _keep_mask(shape, keep_prob: float, device: torch.device,
               generator: torch.Generator) -> torch.Tensor:
    """Bernoulli(keep_prob) draws, True where kept."""
    return torch.rand(shape, device=device, generator=generator) < keep_prob


class MultiHeadDotProductAttention(nn.Module):
    """flax `nn.MultiHeadDotProductAttention` for self-attention:
    softmax((q / sqrt(d)) k^T, masked) v over `num_heads` heads of
    qkv_features / num_heads, then the output projection back to the
    input width."""

    def __init__(self, num_heads: int, in_features: int, qkv_features: int,
                 dropout_rate: float = 0.0, device: DeviceLike = None):
        super().__init__()
        self.dropout_rate = dropout_rate
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features {qkv_features} is not a "
                             f"multiple of num_heads {num_heads}")
        self.num_heads = num_heads
        self.query = Dense(in_features, qkv_features, device)
        self.key = Dense(in_features, qkv_features, device)
        self.value = Dense(in_features, qkv_features, device)
        self.out = Dense(qkv_features, in_features, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, L, D]; mask [B, 1, L, L] bool, True where a query may
        attend to a key. Returns [B, L, D]. Unless deterministic, the
        attention weights are dropped with one [L, L] mask for every batch
        row and head, kept ones scaled by 1/keep (flax multiplies by
        keep / keep_prob).

        Args:
            x, mask, deterministic: as above.
            generator: draws the dropout mask when not deterministic.
        """
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
        if not deterministic and self.dropout_rate > 0.0:
            if generator is None:
                raise ValueError("dropout needs a torch.Generator when "
                                 "deterministic=False")
            keep_prob = 1.0 - self.dropout_rate
            keep = _keep_mask((1, 1, L, L), keep_prob, x.device, generator)
            attn = attn * (keep.to(attn.dtype) / keep_prob)
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
            num_heads, dim_model, dim_model, dropout, device)
        self.ff_norm = LayerNorm(dim_model, device)
        self.ff_in = Dense(dim_model, dim_ff, device)
        self.ff_out = Dense(dim_ff, dim_model, device)

    def forward(self, x: torch.Tensor, mask: torch.Tensor,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [B, L, D]; mask [B, 1, L, L] bool. Returns [B, L, D]. Unless
        deterministic, drops from `generator` in flax's order: the
        attention weights, the attention branch, after the GELU and the
        feed-forward branch."""
        rate = self.dropout
        h = self.attention(self.attn_norm(x), mask, deterministic, generator)
        x = x + dropout(h, rate, deterministic, generator)
        h = F.gelu(self.ff_in(self.ff_norm(x)), approximate="tanh")
        h = self.ff_out(dropout(h, rate, deterministic, generator))
        return x + dropout(h, rate, deterministic, generator)


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
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Token embeddings [B, L, D], dropped after the LayerNorm unless
        deterministic.

        Args:
            id_list_features: the item ids, [1, B, L] padded or jagged.
            deterministic: no dropout.
            generator: draws the dropout mask when not deterministic.
        """
        x = self.ec(id_list_features)["item"] + self.positional[None, :, :]
        return dropout(self.layernorm(x), self.dropout, deterministic,
                       generator)


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

    def forward(self, input: SparseInput, deterministic: bool = True,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Per-position logits [B, L, vocab]; positions attend only to
        keys whose item id is > 0 (not padding).

        Args:
            input: the item ids, [1, B, L] padded or jagged.
            deterministic: no dropout.
            generator: draws the dropout masks when not deterministic.
        """
        sb = as_padded(input, self.max_len)
        ids = sb.ids[sb.keys.index("item")]  # [B, L]
        B, L = ids.shape
        mask = (ids > 0)[:, None, None, :].expand(B, 1, L, L)
        x = self.history(sb, deterministic, generator)
        for block in self.blocks:
            x = block(x, mask, deterministic, generator)
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
        generator: Optional[torch.Generator] = None,
    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Returns (loss, (loss, logits [B, L, vocab])).

        Args:
            input: the item ids, [1, B, L] padded or jagged.
            labels: [B, L], the masked positions' items, 0 elsewhere.
            deterministic: no dropout.
            generator: draws the dropout masks when not deterministic.
        """
        logits = self.model(input, deterministic, generator)
        logp = torch.log_softmax(logits, dim=-1)
        picked = logp.gather(-1, labels[:, :, None].long())[:, :, 0]
        mask = (labels != self.pad_id).to(logits.dtype)
        loss = -(picked * mask).sum() / mask.sum().clamp(min=1.0)
        return loss, (loss, logits)
