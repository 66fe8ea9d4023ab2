"""A plain reference of MLPerf Training's DLRM-DCNv2 (recommendation_v2,
torchrec's DLRM_DCN; Wang et al., "DCN V2", arXiv:2008.13535), for the
tests of torchrec_tpu_torch.models.DLRM_DCN.

Plain torch in f32 with TF32 off; it imports neither JAX nor the port.
The model: each feature's multi-hot ids sum-pooled from its own table;
the dense arch (a linear layer and a ReLU a layer) to the tables' width
D; x0 = [dense arch output, the F pooled embeddings] of width (F+1) D,
dense first; a low-rank cross net x_{l+1} = x0 * (W_l (V_l x_l) + b_l) +
x_l, whose V_l have no bias; the over arch (a ReLU after every layer but
the last) to one logit; the mean binary cross entropy of the logits.
Autograd gives every gradient. The optimizers are Adagrad element by
element, m += g^2; w -= lr g / (sqrt(m) + eps), on the touched table rows
(FBGEMM's exact Adagrad, which the reference trains its tables with) and
on every dense parameter (torch.optim.Adagrad with no learning-rate decay
and a zero initial accumulator).

Departures from the published description, each for the tests' sake:
  * the tables and layers are what the caller gives (the reference
    initialises them itself);
  * a bag's ids are given as a jagged batch (values and per-bag lengths,
    feature-major), and any length is taken, where MLPerf draws a fixed
    number of ids a feature;
  * the learning rate is constant: no warm-up and no decay schedule;
  * one process, no model or data parallelism: the gradient is the mean
    loss's over the whole batch.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch

Linear = Tuple[torch.Tensor, Optional[torch.Tensor]]


def fp32_matmul() -> None:
    """TF32 off for matrix products."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass
class Params:
    """The model's parameters: one [R_f, D] table a feature; the dense
    arch's and the over arch's (weight [out, in], bias [out]) layers; each
    cross layer's (V [r, N], W [N, r], b [N])."""

    tables: List[torch.Tensor]
    dense: List[Linear]
    cross: List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]
    over: List[Linear]

    def dense_tensors(self) -> List[torch.Tensor]:
        """Every dense parameter in layer order: the dense arch's weight
        and bias, each cross layer's V, W and b, the over arch's weight
        and bias."""
        out: List[torch.Tensor] = []
        for w, b in self.dense:
            out += [w, b]
        for v, w, b in self.cross:
            out += [v, w, b]
        for w, b in self.over:
            out += [w, b]
        return out

    def clone(self) -> "Params":
        return Params(
            tables=[t.detach().clone() for t in self.tables],
            dense=[(w.detach().clone(), b.detach().clone())
                   for w, b in self.dense],
            cross=[(v.detach().clone(), w.detach().clone(),
                    b.detach().clone()) for v, w, b in self.cross],
            over=[(w.detach().clone(), b.detach().clone())
                  for w, b in self.over])


def linear(x: torch.Tensor, w: torch.Tensor,
           b: Optional[torch.Tensor]) -> torch.Tensor:
    y = x @ w.t()
    return y if b is None else y + b


def pool(table: torch.Tensor, values: torch.Tensor,
         lengths: torch.Tensor) -> torch.Tensor:
    """Sum pooling of one feature: values [n] ids of its B bags in order,
    lengths [B] -> [B, D]."""
    bags = torch.repeat_interleave(
        torch.arange(lengths.shape[0], device=values.device),
        lengths.long())
    out = torch.zeros((lengths.shape[0], table.shape[1]),
                      dtype=table.dtype, device=table.device)
    return out.index_add(0, bags, table[values.long()])


def pooled(tables: Sequence[torch.Tensor], values: torch.Tensor,
           lengths: torch.Tensor) -> torch.Tensor:
    """Every feature's pooling: values [N] feature-major, lengths [F * B]
    feature-major -> [B, F, D]."""
    F = len(tables)
    per = lengths.reshape(F, -1)
    counts = per.sum(dim=1).tolist()
    chunks = torch.split(values[:sum(counts)], counts)
    return torch.stack([pool(t, v, n) for t, v, n in
                        zip(tables, chunks, per)], dim=1)


def forward(p: Params, dense: torch.Tensor,
            emb: torch.Tensor) -> torch.Tensor:
    """dense [B, d_in], emb [B, F, D] pooled -> logits [B]."""
    x = dense
    for w, b in p.dense:
        x = torch.relu(linear(x, w, b))
    x0 = torch.cat([x, emb.reshape(emb.shape[0], -1)], dim=1)
    z = x0
    for v, w, b in p.cross:
        z = x0 * linear(linear(z, v, None), w, b) + z
    for w, b in p.over[:-1]:
        z = torch.relu(linear(z, w, b))
    w, b = p.over[-1]
    return linear(z, w, b)[:, 0]


def loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The mean binary cross entropy of the logits."""
    return torch.nn.functional.binary_cross_entropy_with_logits(
        logits, labels.to(logits.dtype))


@dataclasses.dataclass
class Step:
    """One batch's forward and gradients: the logits, the loss, each dense
    parameter's gradient (`Params.dense_tensors`' order) and each table's
    gradient [R_f, D]."""

    logits: torch.Tensor
    loss: torch.Tensor
    dense_grads: List[torch.Tensor]
    table_grads: List[torch.Tensor]


def gradients(p: Params, dense: torch.Tensor, values: torch.Tensor,
              lengths: torch.Tensor, labels: torch.Tensor) -> Step:
    """The forward, the loss and, by autograd, every gradient."""
    fp32_matmul()
    q = p.clone()
    leaves = q.tables + q.dense_tensors()
    for t in leaves:
        t.requires_grad_(True)
    logits = forward(q, dense, pooled(q.tables, values, lengths))
    out = loss(logits, labels)
    grads = torch.autograd.grad(out, leaves)
    F = len(q.tables)
    return Step(logits=logits.detach(), loss=out.detach(),
                dense_grads=list(grads[F:]), table_grads=list(grads[:F]))


@dataclasses.dataclass
class State:
    """Adagrad's sums of squares: one [R_f, D] a table, one a dense
    parameter (`Params.dense_tensors`' order)."""

    tables: List[torch.Tensor]
    dense: List[torch.Tensor]

    @staticmethod
    def zeros(p: Params) -> "State":
        return State(tables=[torch.zeros_like(t) for t in p.tables],
                     dense=[torch.zeros_like(t) for t in p.dense_tensors()])


def _adagrad_(w: torch.Tensor, m: torch.Tensor, g: torch.Tensor,
              lr: float, eps: float) -> None:
    m.addcmul_(g, g)
    w.addcdiv_(g, torch.sqrt(m) + eps, value=-lr)


def train_step(p: Params, state: State, dense: torch.Tensor,
               values: torch.Tensor, lengths: torch.Tensor,
               labels: torch.Tensor, lr: float, eps: float,
               dense_lr: float, dense_eps: float) -> Step:
    """One step in place: the gradients, then Adagrad on the rows a real
    id touched (the other rows and their state stay) and on every dense
    parameter."""
    s = gradients(p, dense, values, lengths, labels)
    with torch.no_grad():
        F = len(p.tables)
        per = lengths.reshape(F, -1).sum(dim=1).tolist()
        chunks = torch.split(values[:sum(per)], per)
        for t, m, g, ids in zip(p.tables, state.tables, s.table_grads,
                                chunks):
            rows = torch.unique(ids.long())
            w_rows, m_rows = t[rows], m[rows]
            _adagrad_(w_rows, m_rows, g[rows], lr, eps)
            t[rows] = w_rows
            m[rows] = m_rows
        for w, m, g in zip(p.dense_tensors(), state.dense, s.dense_grads):
            _adagrad_(w, m, g, dense_lr, dense_eps)
    return s
