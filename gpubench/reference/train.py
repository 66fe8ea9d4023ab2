"""The reference's first three training steps, from the seed.

It draws the initial weights again from the seed (`gpubench.inputs`),
keeps of each table only the rows in its row set (the rows the checked
batches touch and a sample of rows they leave alone), and follows the
configuration's step: the model's forward and loss (`reference/<model>`),
autograd for the gradients, the embedding rows' gradients summed per row,
the fused optimizer on the touched rows and the dense optimizer on every
dense parameter (a layer's bias where `common.linear_biases` gives it
one). It reads what the comparison needs (`Readings`).
`half_batch` plants the fault "half of the batch left out, the mean taken
over the rest"; `precision` "tf32" is the control.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import torch

from gpubench import inputs
from gpubench.reference import common


@dataclasses.dataclass
class Readings:
    """Per step the loss; per leaf (a dense parameter `linear<i>.weight` /
    `.bias`, `dense_leaves`, or a table `table<t>` over its row set) the
    norm of the first step's gradient as the optimizer gets it, and the
    norm of the change after the checked steps."""

    losses: List[float]
    grad: Dict[str, float]
    change: Dict[str, float]


def dense_leaves(biases: Sequence[bool]) -> List[str]:
    """The dense parameters' names, layer by layer: `linear<i>.weight`,
    and `linear<i>.bias` where layer i has a bias."""
    return [f"linear{i}.{p}" for i, bias in enumerate(biases)
            for p in (("weight", "bias") if bias else ("weight",))]


def follow(cfg: dict, model, seed: int, batches: Sequence[dict],
           rowsets: Sequence[torch.Tensor], precision: str = "float32",
           half_batch: bool = False) -> Readings:
    device = batches[0]["dense"].device
    common.fp32_matmul()
    D = cfg["embedding_dim"]
    cards = cfg["num_embeddings_per_feature"]
    shapes = model.linear_shapes(cfg)
    biases = common.linear_biases(model, cfg)
    params = [t.clone() for wb in inputs.make_linears(seed, shapes, device,
                                                      biases)
              for t in wb if t is not None]
    start = [p.clone() for p in params]
    tables, tables0, m1, m2 = [], [], [], []
    for t, rows in enumerate(cards):
        full = inputs.make_table(seed, t, rows, D, device)
        tables.append(full[rowsets[t]].clone())
        del full
        tables0.append(tables[t].clone())
        U = rowsets[t].numel()
        full_state = cfg["fused_optimizer"] in ("ADAGRAD", "ADAM")
        m1.append(torch.zeros((U, D) if full_state else (U,),
                              device=device))
        m2.append(torch.zeros((U, D), device=device)
                  if cfg["fused_optimizer"] == "ADAM" else None)
    dense_m = [torch.zeros_like(p) for p in params]
    dense_v = [torch.zeros_like(p) for p in params]
    leaves = dense_leaves(biases)
    losses: List[float] = []
    grad: Dict[str, float] = {}
    for s, batch in enumerate(batches):
        n = batch["dense"].shape[0] // (2 if half_batch else 1)
        ids, lengths = batch["ids"][:, :n], batch["lengths"][:, :n]
        local = [torch.searchsorted(rowsets[t], ids[t].to(torch.int64))
                 for t in range(len(cards))]
        with torch.no_grad():
            pooled = torch.stack([common.pool(tables[t], local[t], lengths[t])
                                  for t in range(len(cards))], dim=1)
        pooled.requires_grad_(True)
        ps = [p.detach().requires_grad_(True) for p in params]
        it = iter(ps)
        linears = [(next(it), next(it) if bias else None) for bias in biases]
        out = model.forward(cfg, linears, batch["dense"][:n], pooled,
                            precision)
        loss = model.loss(out, batch["labels"][:n])
        loss.backward()
        losses.append(float(loss.detach()))
        with torch.no_grad():
            g_rows, touched = [], []
            for t in range(len(cards)):
                U = rowsets[t].numel()
                g_rows.append(common.row_totals(local[t], lengths[t],
                                                pooled.grad[:, t], U))
                ones = torch.ones((n, 1), device=device)
                touched.append(common.row_totals(
                    local[t], lengths[t], ones, U)[:, 0] > 0)
            if s == 0:
                grad = {name: float(p.grad.norm())
                        for name, p in zip(leaves, ps)}
                grad.update({f"table{t}": float(g.norm())
                             for t, g in enumerate(g_rows)})
            _dense_step(cfg, params, [p.grad for p in ps], dense_m, dense_v,
                        s + 1)
            for t in range(len(cards)):
                _fused_step(cfg, tables[t], m1[t], m2[t], g_rows[t],
                            touched[t], s + 1)
    change = {name: float((p - p0).norm())
              for name, p, p0 in zip(leaves, params, start)}
    change.update({f"table{t}": float((w - w0).norm())
                   for t, (w, w0) in enumerate(zip(tables, tables0))})
    return Readings(losses=losses, grad=grad, change=change)


def _dense_step(cfg, params, grads, m, v, step: int) -> None:
    """The dense optimizer as torch.optim's SGD, Adagrad or Adam with
    their defaults but `dense_learning_rate` and `dense_eps`. m holds
    Adagrad's sums of squares or Adam's first moments."""
    lr = cfg["dense_learning_rate"]
    if cfg["dense_optimizer"] == "SGD":
        for p, g in zip(params, grads):
            p -= lr * g
        return
    if cfg["dense_optimizer"] == "ADAGRAD":
        eps = cfg.get("dense_eps", 1e-10)  # torch.optim.Adagrad's default
        for p, g, s in zip(params, grads, m):
            s.addcmul_(g, g)
            p.addcdiv_(g, torch.sqrt(s) + eps, value=-lr)
        return
    if cfg["dense_optimizer"] != "ADAM":
        raise ValueError(f"no reference for {cfg['dense_optimizer']}")
    b1, b2 = 0.9, 0.999  # torch.optim.Adam's defaults
    eps = cfg.get("dense_eps", 1e-8)
    for p, g, mi, vi in zip(params, grads, m, v):
        mi.mul_(b1).add_((1.0 - b1) * g)
        vi.mul_(b2).add_((1.0 - b2) * g * g)
        m_hat = mi / (1.0 - b1 ** step)
        v_hat = vi / (1.0 - b2 ** step)
        p -= lr * m_hat / (torch.sqrt(v_hat) + eps)


def _fused_step(cfg, w, m1, m2, g, touched, step: int) -> None:
    lr, eps = cfg["fused_learning_rate"], cfg["fused_eps"]
    if cfg["fused_optimizer"] == "ROWWISE_ADAGRAD":
        common.rowwise_adagrad_(w, m1, g, touched, lr, eps)
    elif cfg["fused_optimizer"] == "ADAGRAD":
        common.adagrad_rows_(w, m1, g, touched, lr, eps)
    elif cfg["fused_optimizer"] == "ADAM":
        common.adam_rows_(w, m1, m2, g, touched, step, lr,
                          cfg["fused_beta1"], cfg["fused_beta2"], eps)
    else:
        raise ValueError(f"no reference for {cfg['fused_optimizer']}")
