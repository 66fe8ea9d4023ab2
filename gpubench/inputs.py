"""Inputs and weights made on the device from the run's seed.

A frozen copy of the port's card-side generator (datasets/random.py
`zipf_inverse_cdf`, `uniform_open`, `step_seed`; datasets/synthetic_criteo.py
`CRITEO_KAGGLE_CARDINALITIES` and its dense features), so that a change to
the program's copy cannot move the benchmark's inputs. Unlike the
program's copy, a feature's Zipf ranks are scattered over its table by a
permutation drawn from the seed, as hashed or value-ordered ids are: the
hot rows do not lie together at the table's start. Every tensor comes
from its own `torch.Generator` on the device, seeded by `sub_seed(seed,
tag, index)`, so any one table, layer or batch can be drawn again alone:
the reference redraws what it needs after the window. A traffic's
`ids_per_feature` is one int L for every feature, or a list of F fixed
lengths (multi-hot features of their own sizes, `make_batch`); a linear
layer may have no bias (`make_linears`).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# Kaggle DAC categorical cardinalities as published for the DLRM / MLPerf
# Kaggle configurations (datasets/synthetic_criteo.py)
CRITEO_KAGGLE_CARDINALITIES: Tuple[int, ...] = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572,
)
CRITEO_KAGGLE_CTR = 0.2562  # published DAC positive rate
DENSE_FEATURES = 13

# tags of the independent streams drawn from one run seed
TABLE, LINEAR, BATCH, SAMPLE, ROWS = 1, 2, 3, 4, 5


def sub_seed(*parts: int) -> int:
    """A 63-bit generator seed from integers of any size (a run seed past
    2**32, a tag, an index): each tuple is its own stream."""
    words = []
    for p in parts:
        p = int(p)
        words += [p & 0xFFFFFFFF, (p >> 32) & 0xFFFFFFFF, int(p < 0)]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def generator(device, *parts: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(*parts))


def zipf_inverse_cdf(u: torch.Tensor, n: torch.Tensor,
                     a: float) -> torch.Tensor:
    """Bounded power-law ranks in [1, n] from uniforms u: the closed-form
    inverse CDF of the continuous Zipf(a) truncated at n."""
    if abs(a - 1.0) < 1e-6:
        return torch.pow(n, u)
    t = 1.0 - a
    return torch.pow(u * (torch.pow(n, t) - 1.0) + 1.0, 1.0 / t)


def uniform_open(shape, g: torch.Generator, device,
                 low: float = 1e-7) -> torch.Tensor:
    """f32 uniforms in [low, 1)."""
    return low + (1.0 - low) * torch.rand(shape, generator=g, device=device)


def row_orders(cards: Sequence[int], seed: int,
               device) -> List[torch.Tensor]:
    """Each table's rows in an order drawn from the seed: a feature's
    Zipf rank k (0 the hottest) is row `orders[t][k]`."""
    return [torch.randperm(n, generator=generator(device, seed, ROWS, t),
                           device=device)
            for t, n in enumerate(cards)]


def feature_lengths(F: int, ids_per_feature) -> List[int]:
    """Each feature's ids an example: a traffic's `ids_per_feature`, one
    int for every feature or a list of F."""
    if isinstance(ids_per_feature, int):
        return [ids_per_feature] * F
    if len(ids_per_feature) != F:
        raise ValueError(f"ids_per_feature has {len(ids_per_feature)} "
                         f"entries for {F} features")
    return [int(n) for n in ids_per_feature]


def ids_per_example(F: int, ids_per_feature) -> int:
    """The real ids an example, the sum of the features' lengths: F L
    for an int L."""
    return sum(feature_lengths(F, ids_per_feature))


def make_batch(cards: Sequence[int], batch: int, ids_per_feature,
               zipf_a, seed: int, index: int, device,
               orders: Sequence[torch.Tensor] = ()) -> Dict[str, torch.Tensor]:
    """One batch on the device: ids [F, B, L] int32 (Zipf(zipf_a) ranks per
    feature, mapped to rows by `orders` (`row_orders`, drawn here where
    not given); uniform where zipf_a is None); dense [B, 13] log-normal
    features standardised as the port's Criteo stream does; labels [B]
    Bernoulli at the published click rate. `ids_per_feature` an int L:
    every slot real (lengths L). A list of F lengths L_f (a fixed number
    of ids a feature, as MLPerf's multi-hot Criteo has): L is their
    largest, lengths[f] = L_f, and the slots past L_f hold 0; the draws
    are those of an int L, in the same order and shapes."""
    g = generator(device, seed, BATCH, index)
    F, B = len(cards), batch
    per = feature_lengths(F, ids_per_feature)
    L = max(per)
    n = torch.as_tensor(cards, dtype=torch.int64, device=device)[:, None, None]
    if zipf_a is None:
        ids = torch.randint(0, 2 ** 62, (F, B, L), generator=g,
                            device=device, dtype=torch.int64) % n
    else:
        k = zipf_inverse_cdf(uniform_open((F, B, L), g, device), n.float(),
                             float(zipf_a))
        ranks = torch.minimum(torch.clamp(k.to(torch.int64) - 1, min=0),
                              n - 1)
        orders = orders or row_orders(cards, seed, device)
        ids = torch.stack([orders[t][ranks[t]] for t in range(F)])
    raw = torch.exp(1.0 + 1.6 * torch.randn((B, DENSE_FEATURES), generator=g,
                                            device=device))
    dense = (torch.log1p(raw) - 1.9) / 1.1
    labels = (torch.rand((B,), generator=g, device=device)
              < CRITEO_KAGGLE_CTR).float()
    lengths = torch.as_tensor(per, dtype=torch.int32, device=device)
    if min(per) < L:
        real = (torch.arange(L, device=device)[None, None, :]
                < lengths[:, None, None])
        ids = torch.where(real, ids, torch.zeros_like(ids))
    return {"ids": ids.to(torch.int32).contiguous(),
            "lengths": lengths[:, None].expand(F, B).contiguous(),
            "dense": dense.contiguous(), "labels": labels}


def make_pool(cards: Sequence[int], traffic: dict, seed: int,
              device) -> List[Dict[str, torch.Tensor]]:
    """The traffic's `pool` batches (`make_batch` 0, 1, ...), with the
    tables' row orders drawn once."""
    orders = (row_orders(cards, seed, device)
              if traffic["zipf_a"] is not None else ())
    return [make_batch(cards, traffic["batch"], traffic["ids_per_feature"],
                       traffic["zipf_a"], seed, i, device, orders)
            for i in range(traffic["pool"])]


def make_table(seed: int, t: int, rows: int, dim: int, device,
               dtype=torch.float32) -> torch.Tensor:
    """Table t, [rows, dim], U(-b, b) with b = sqrt(1 / rows) (the
    torchrec and port default), in one call."""
    g = generator(device, seed, TABLE, t)
    b = math.sqrt(1.0 / rows)
    w = torch.empty((rows, dim), dtype=torch.float32, device=device)
    w.uniform_(-b, b, generator=g)
    return w.to(dtype)


def make_linear(seed: int, i: int, fan_in: int, fan_out: int, device,
                bias: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Linear layer i: weight [out, in] and bias [out] (None for a layer
    without one), U(-b, b) with b = sqrt(1 / fan_in) (torch's nn.Linear
    bound)."""
    g = generator(device, seed, LINEAR, i)
    b = math.sqrt(1.0 / fan_in)
    w = torch.empty((fan_out, fan_in), device=device).uniform_(-b, b,
                                                               generator=g)
    if not bias:
        return w, None
    bias = torch.empty((fan_out,), device=device).uniform_(-b, b, generator=g)
    return w, bias


def make_linears(seed: int, shapes: Sequence[Tuple[int, int]], device,
                 biases: Optional[Sequence[bool]] = None
                 ) -> List[Tuple[torch.Tensor, Optional[torch.Tensor]]]:
    """Every layer of `shapes`, layer i from its own stream i; `biases`
    (all True where not given) says which layers have a bias."""
    biases = [True] * len(shapes) if biases is None else list(biases)
    return [make_linear(seed, i, fi, fo, device, bias)
            for i, ((fi, fo), bias) in enumerate(zip(shapes, biases))]


def sample_rows(seed: int, t: int, rows: int, count: int,
                device) -> torch.Tensor:
    """`count` row ids of table t drawn from the seed (with repeats), for
    checking rows that a step should leave alone."""
    g = generator(device, seed, SAMPLE, t)
    return torch.randint(0, rows, (count,), generator=g, device=device,
                         dtype=torch.int64)
