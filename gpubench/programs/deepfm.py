"""SimpleDeepFMNN through the port: `models.SimpleDeepFMNN` over an
EmbeddingBagCollection of the configuration's tables; trained on the
mean binary cross entropy of its probabilities."""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F

from gpubench.programs.common import tables


class DeepFMTrain(torch.nn.Module):
    """SimpleDeepFMNN and its loss: (loss, (loss, probabilities))."""

    def __init__(self, m: torch.nn.Module):
        super().__init__()
        self.m = m

    def forward(self, dense, sparse, labels):
        p = self.m(dense, sparse)[:, 0]
        loss = F.binary_cross_entropy(p, labels)
        return loss, (loss, p)


def model(cfg: dict, train: bool) -> torch.nn.Module:
    from torchrec_tpu_torch.models import SimpleDeepFMNN
    from torchrec_tpu_torch.modules import EmbeddingBagCollection

    m = SimpleDeepFMNN(cfg["dense_in_features"],
                       EmbeddingBagCollection(tables(cfg),
                                              max_feature_length=1,
                                              device="meta"),
                       cfg["hidden_layer_size"], cfg["deep_fm_dimension"],
                       device="meta")
    return DeepFMTrain(m) if train else m


def linears(module: torch.nn.Module) -> List[torch.nn.Linear]:
    """Dense arch (two), the deep layer, the over layer."""
    m = module.m if isinstance(module, DeepFMTrain) else module
    return [m.dense_arch.hidden, m.dense_arch.out,
            m.inter_arch.deep_fm.deep_module[0], m.over_arch.linear]


def scores(out) -> torch.Tensor:
    return out.reshape(-1)
