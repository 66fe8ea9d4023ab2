"""A DLRM-DCNv2-shaped model through the port (torchrec's DLRM_DCN): the
dense arch, the pooled multi-hot embeddings beside it, a low-rank cross
net over their concatenation, the over arch; DLRMTrain's loss when
trained. Its batches reach the port as KeyedJaggedTensors."""

from __future__ import annotations

from typing import List

import torch

from gpubench.programs.common import feature_keys, tables


class TinyDCN(torch.nn.Module):
    def __init__(self, cfg: dict):
        from torchrec_tpu_torch.models import DenseArch, OverArch, SparseArch
        from torchrec_tpu_torch.modules import (
            EmbeddingBagCollection,
            LowRankCrossNet,
        )

        super().__init__()
        F, D = len(cfg["num_embeddings_per_feature"]), cfg["embedding_dim"]
        self.sparse_arch = SparseArch(EmbeddingBagCollection(
            tables(cfg), max_feature_length=max(cfg["multi_hot_sizes"]),
            device="meta"))
        self.dense_arch = DenseArch(cfg["dense_in_features"],
                                    cfg["dense_arch_layer_sizes"],
                                    device="meta")
        self.crossnet = LowRankCrossNet((F + 1) * D, cfg["dcn_num_layers"],
                                        cfg["dcn_low_rank_dim"],
                                        device="meta")
        self.over_arch = OverArch((F + 1) * D, cfg["over_arch_layer_sizes"],
                                  device="meta")

    def forward(self, dense, sparse):
        x = self.dense_arch(dense)
        e = self.sparse_arch(sparse)
        z = torch.cat([x, e.reshape(e.shape[0], -1)], dim=1)
        return self.over_arch(self.crossnet(z))


def model(cfg: dict, train: bool) -> torch.nn.Module:
    from torchrec_tpu_torch.models import DLRMTrain

    m = TinyDCN(cfg)
    return DLRMTrain(m) if train else m


def linears(module: torch.nn.Module) -> List[torch.nn.Linear]:
    """Dense arch, the cross net's V and W of each layer, over arch."""
    m = module.dlrm if hasattr(module, "dlrm") else module
    out = [p.linear for p in m.dense_arch.mlp.perceptrons]
    for v, w in zip(m.crossnet.V, m.crossnet.W):
        out += [v, w]
    out += [p.linear for p in m.over_arch.mlp.perceptrons]
    return out + [m.over_arch.head.linear]


def sparse_batch(cfg: dict, batch: dict):
    """The batch's real slots as a KeyedJaggedTensor."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    ids, lengths = batch["ids"], batch["lengths"]
    real = (torch.arange(ids.shape[2], device=ids.device)[None, None, :]
            < lengths[:, :, None])
    return KeyedJaggedTensor.from_lengths(keys=feature_keys(cfg),
                                          values=ids[real],
                                          lengths=lengths.reshape(-1))


def scores(out) -> torch.Tensor:
    return out.reshape(-1)
