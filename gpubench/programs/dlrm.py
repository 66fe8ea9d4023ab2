"""The DLRM through the port: `models.DLRM` over an EmbeddingBagCollection
of the configuration's tables (DLRMTrain, its BCE loss, when trained)."""

from __future__ import annotations

from typing import List

import torch

from gpubench.programs.common import tables

# the interaction's kernel (ops/dot_interaction.py), built at set-up
KERNELS = ("dot_interaction",)


def model(cfg: dict, train: bool) -> torch.nn.Module:
    from torchrec_tpu_torch.models import DLRM, DLRMTrain
    from torchrec_tpu_torch.modules import EmbeddingBagCollection

    m = DLRM(EmbeddingBagCollection(tables(cfg), max_feature_length=1,
                                    device="meta"),
             dense_in_features=cfg["dense_in_features"],
             dense_arch_layer_sizes=cfg["dense_arch_layer_sizes"],
             over_arch_layer_sizes=cfg["over_arch_layer_sizes"],
             device="meta")
    return DLRMTrain(m) if train else m


def linears(module: torch.nn.Module) -> List[torch.nn.Linear]:
    """The linear layers in the reference's order: dense arch, over arch,
    head."""
    m = module.dlrm if hasattr(module, "dlrm") else module
    out = [p.linear for p in m.dense_arch.mlp.perceptrons]
    out += [p.linear for p in m.over_arch.mlp.perceptrons]
    return out + [m.over_arch.head.linear]


def scores(out) -> torch.Tensor:
    """The served model's output -> scores [B] (the logits)."""
    return out.reshape(-1)
