"""MLPerf's DLRM-DCNv2 through the port: `models.DLRM_DCN` over an
EmbeddingBagCollection of the configuration's tables (DLRMTrain, its BCE
loss, when trained). Its batches reach the port as KeyedJaggedTensors of
their real ids, so the sharded EBC takes its jagged route."""

from __future__ import annotations

from typing import List

import torch

from gpubench.programs.common import feature_keys, tables


def model(cfg: dict, train: bool) -> torch.nn.Module:
    from torchrec_tpu_torch.models import DLRM_DCN, DLRMTrain
    from torchrec_tpu_torch.modules import EmbeddingBagCollection

    m = DLRM_DCN(EmbeddingBagCollection(
                     tables(cfg), max_feature_length=max(cfg["multi_hot_sizes"]),
                     device="meta"),
                 dense_in_features=cfg["dense_in_features"],
                 dense_arch_layer_sizes=cfg["dense_arch_layer_sizes"],
                 over_arch_layer_sizes=cfg["over_arch_layer_sizes"],
                 dcn_num_layers=cfg["dcn_num_layers"],
                 dcn_low_rank_dim=cfg["dcn_low_rank_dim"], device="meta")
    return DLRMTrain(m) if train else m


def linears(module: torch.nn.Module) -> List[torch.nn.Linear]:
    """The linear layers in the reference's order: dense arch, each cross
    layer's V and W, over arch, head."""
    m = module.dlrm if hasattr(module, "dlrm") else module
    out = [p.linear for p in m.dense_arch.mlp.perceptrons]
    crossnet = m.inter_arch.crossnet
    for v, w in zip(crossnet.V, crossnet.W):
        out += [v, w]
    out += [p.linear for p in m.over_arch.mlp.perceptrons]
    return out + [m.over_arch.head.linear]


def sparse_batch(cfg: dict, batch: dict):
    """The batch's real slots as a KeyedJaggedTensor (made once a pool
    batch, at set-up)."""
    from torchrec_tpu_torch.sparse import KeyedJaggedTensor

    ids, lengths = batch["ids"], batch["lengths"]
    real = (torch.arange(ids.shape[2], device=ids.device)[None, None, :]
            < lengths[:, :, None])
    return KeyedJaggedTensor.from_lengths(keys=feature_keys(cfg),
                                          values=ids[real].contiguous(),
                                          lengths=lengths.reshape(-1))


def scores(out) -> torch.Tensor:
    return out.reshape(-1)
