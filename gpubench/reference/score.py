"""The reference's scores of batches of candidates, from the seed: the
float tables drawn again (`gpubench.inputs`), the rows the batches read
quantized row by row to `bits` and dequantized (`common.quantize_rows`),
pooled, and the model's forward (`reference/<model>`) in f32. The
controls: `bits` 4 where the program serves int8, and `precision` "tf32"
at the program's bits."""

from __future__ import annotations

from typing import List, Sequence

import torch

from gpubench import inputs
from gpubench.reference import common


@torch.no_grad()
def scores(cfg: dict, model, seed: int, batches: Sequence[dict],
           bits: int, precision: str = "float32") -> List[torch.Tensor]:
    """One [B] score tensor for each batch (dense [B, 13], ids [F, B, L],
    lengths [F, B])."""
    common.fp32_matmul()
    device = batches[0]["dense"].device
    D = cfg["embedding_dim"]
    cards = cfg["num_embeddings_per_feature"]
    rows, rowsets = [], []
    for t, n in enumerate(cards):
        rowset = torch.unique(torch.cat([b["ids"][t].reshape(-1)
                                         for b in batches]).to(torch.int64))
        full = inputs.make_table(seed, t, n, D, device)
        codes, scale, shift = common.quantize_rows(full[rowset], bits)
        del full
        rows.append(common.dequantize_rows(codes, scale, shift))
        rowsets.append(rowset)
    shapes = model.linear_shapes(cfg)
    linears = inputs.make_linears(seed, shapes, device,
                                  common.linear_biases(model, cfg))
    out = []
    for b in batches:
        pooled = torch.stack([
            common.pool(rows[t], torch.searchsorted(
                rowsets[t], b["ids"][t].to(torch.int64)), b["lengths"][t])
            for t in range(len(cards))], dim=1)
        out.append(model.forward(cfg, linears, b["dense"], pooled,
                                 precision))
    return out
