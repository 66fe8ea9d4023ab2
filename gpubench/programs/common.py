"""What the program builders share: the DistributedModelParallel a
configuration states, loaded with the benchmark's weights, and the
port's sparse batch of a benchmark batch (the default of a program module
that gives no `sparse_batch` of its own). Only the port's public API."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

from gpubench import inputs


def feature_keys(cfg: dict) -> List[str]:
    return [f"cat_{i}" for i in range(len(cfg["num_embeddings_per_feature"]))]


def tables(cfg: dict):
    from torchrec_tpu_torch.modules import EmbeddingBagConfig

    return tuple(
        EmbeddingBagConfig(num_embeddings=rows,
                           embedding_dim=cfg["embedding_dim"],
                           name=f"t_{key}", feature_names=[key])
        for rows, key in zip(cfg["num_embeddings_per_feature"],
                             feature_keys(cfg)))


def build_dmp(cfg: dict, module: torch.nn.Module, device):
    """The DMP over `module` (built on "meta") with the configuration's
    fused and dense optimizers and the DMP's default plan. The dense
    optimizer takes `dense_eps` where the configuration states it, and
    torch.optim's default otherwise."""
    from torchrec_tpu_torch.ops.fused_update import EmbOptimType
    from torchrec_tpu_torch.parallel import DistributedModelParallel

    fused = {"learning_rate": cfg["fused_learning_rate"],
             "eps": cfg["fused_eps"]}
    if cfg["fused_optimizer"] == "ADAM":
        fused.update(beta1=cfg["fused_beta1"], beta2=cfg["fused_beta2"])
    lr = cfg["dense_learning_rate"]
    eps = {"eps": cfg["dense_eps"]} if "dense_eps" in cfg else {}
    dense = {"SGD": lambda p: torch.optim.SGD(p, lr=lr),
             "ADAGRAD": lambda p: torch.optim.Adagrad(p, lr=lr, **eps),
             "ADAM": lambda p: torch.optim.Adam(p, lr=lr, **eps)}[
                 cfg["dense_optimizer"]]
    return DistributedModelParallel(
        module, fused_optim=EmbOptimType[cfg["fused_optimizer"]],
        fused_params=fused, dense_optimizer=dense, device=device)


@torch.no_grad()
def load_weights(dmp, linears: List[torch.nn.Linear], cfg: dict,
                 shapes, seed: int,
                 biases: Optional[Sequence[bool]] = None) -> None:
    """Draw the tables and the linear layers from the seed on the DMP's
    device and load them: tables through `load_tables` (which restarts
    the fused optimizer's state), layers into the modules in place.
    `biases` (all True where not given) says which layers have a bias;
    the program's layers have to agree."""
    device = dmp.env.device
    D = cfg["embedding_dim"]
    (key,) = dmp.sharded_ebcs
    drawn: Dict[str, torch.Tensor] = {
        f"t_{k}": inputs.make_table(seed, t, rows, D, device)
        for t, (rows, k) in enumerate(zip(cfg["num_embeddings_per_feature"],
                                          feature_keys(cfg)))}
    dmp.load_tables({key: drawn})
    del drawn
    drawn_linears = inputs.make_linears(seed, shapes, device, biases)
    if len(linears) != len(drawn_linears):
        raise ValueError(f"the program has {len(linears)} linear layers, "
                         f"the reference {len(drawn_linears)}")
    for i, (lin, (w, b)) in enumerate(zip(linears, drawn_linears)):
        if (lin.bias is None) != (b is None):
            raise ValueError(f"linear layer {i}: the program's bias and "
                             f"the reference's disagree")
        lin.weight.copy_(w)
        if b is not None:
            lin.bias.copy_(b)


def sparse_batch(cfg: dict, batch: dict):
    from torchrec_tpu_torch.sparse import PaddedSparseBatch

    return PaddedSparseBatch(ids=batch["ids"], lengths=batch["lengths"],
                             keys=tuple(feature_keys(cfg)))
