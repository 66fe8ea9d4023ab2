"""Frequency-calibrated synthetic Criteo (Kaggle DAC) stream.

Counterpart of torchrec_tpu/datasets/synthetic_criteo.py, whose
docstring gives the calibration: the published Kaggle cardinalities
(optionally capped by `max_ind_range`), Zipf(a) ids per feature,
log-normal dense features, and clicks drawn from a fixed logistic ground
truth over per-id latent scores at the published positive rate, scaled
so that the Bayes-optimal AUROC is `target_auroc`.

The host stream (`__iter__`) draws from `np.random.RandomState` in JAX's
order, so its batches are JAX's bit for bit. `device_batch_fn()` draws a
batch on the card with the same semantics from a re-seeded
`torch.Generator` (see datasets/random.py); its ids are scored by
`device_latent_score`, which is `latent_score` bit for bit, so the host
validation stream and the card-made training stream share one ground
truth.
"""

from __future__ import annotations

import math
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from torchrec_tpu_torch.datasets.random import (
    uniform_open,
    zipf_inverse_cdf,
)
from torchrec_tpu_torch.datasets.utils import Batch
from torchrec_tpu_torch.sparse import PaddedSparseBatch
from torchrec_tpu_torch.utils.device import DeviceLike, resolve_device

# Kaggle DAC (Criteo display-advertising challenge) categorical
# cardinalities as published for DLRM / MLPerf Kaggle configs.
CRITEO_KAGGLE_CARDINALITIES: Tuple[int, ...] = (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18,
    15, 286181, 105, 142572,
)
CRITEO_KAGGLE_CTR = 0.2562  # published DAC positive rate
INT_FEATURE_COUNT = 13
CAT_FEATURE_COUNT = 26

_SQRT3 = np.float32(np.sqrt(3.0))
_U32 = 0xFFFFFFFF


def latent_score(feature: np.ndarray, ids: np.ndarray) -> np.ndarray:
    """Deterministic per-(feature, id) latent in [-sqrt(3), sqrt(3)] (a
    unit-variance uniform): the ground truth an embedding model can learn.
    A 32-bit murmur-style finalizer; u is built from the hash's exact
    16-bit halves with IEEE f32 ops, which `device_latent_score` repeats."""
    key = (
        ids.astype(np.uint32)
        + np.uint32(1_000_003) * (feature.astype(np.uint32) + np.uint32(1))
    )
    z = key * np.uint32(0x9E3779B9)
    z = (z ^ (z >> np.uint32(16))) * np.uint32(0x85EBCA6B)
    z = (z ^ (z >> np.uint32(13))) * np.uint32(0xC2B2AE35)
    z = z ^ (z >> np.uint32(16))
    hi = (z >> np.uint32(16)).astype(np.float32)
    lo = (z & np.uint32(0xFFFF)).astype(np.float32)
    u = hi * np.float32(2.0**-16) + lo * np.float32(2.0**-32)
    return (np.float32(2.0) * u - np.float32(1.0)) * _SQRT3


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 a in [0, 2^32) and a constant c below
    2^32, the multiply split into a's 16-bit halves so that no product
    leaves int64's signed range."""
    lo = (a & 0xFFFF) * c
    hi = ((a >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def device_latent_score(feats: torch.Tensor,
                        ids: torch.Tensor) -> torch.Tensor:
    """`latent_score` in torch on the tensors' device, bit for bit: the
    uint32 hash in int64 (each value masked to 32 bits, each multiply
    split by `_mul_u32`, each right shift of a non-negative value
    logical), then the same f32 op sequence, one op a kernel."""
    key = ((ids.to(torch.int64) & _U32)
           + 1_000_003 * ((feats.to(torch.int64) & _U32) + 1)) & _U32
    z = _mul_u32(key, 0x9E3779B9)
    z = _mul_u32(z ^ (z >> 16), 0x85EBCA6B)
    z = _mul_u32(z ^ (z >> 13), 0xC2B2AE35)
    z = z ^ (z >> 16)
    hi = (z >> 16).to(torch.float32)
    lo = (z & 0xFFFF).to(torch.float32)
    u = hi * 2.0**-16 + lo * 2.0**-32
    return (2.0 * u - 1.0) * float(_SQRT3)


def zipf_ids(
    rng: np.random.RandomState, n: int, size, a: float = 1.05
) -> np.ndarray:
    """Bounded power-law ids in [0, n): the closed-form inverse CDF of the
    continuous Zipf(a) truncated at n, in float64."""
    u = rng.random_sample(size)
    if abs(a - 1.0) < 1e-6:
        k = np.power(float(n), u)
    else:
        t = 1.0 - a
        k = np.power(u * (float(n) ** t - 1.0) + 1.0, 1.0 / t)
    # continuous rank k in [1, n] -> id k-1 in [0, n)
    return np.clip(k.astype(np.int64) - 1, 0, n - 1)


class SyntheticCriteoDataset:
    """Criteo-Kaggle-shaped synthetic stream with Zipf ids and a fixed
    logistic ground truth; the same Batch interface as RandomRecDataset.

    batch_size, num_batches, manual_seed: the stream; max_ind_range caps
    each cardinality; zipf_a, target_auroc, ctr: the calibration;
    cardinalities, keys: the features (default: the Kaggle ones as
    cat_0 ... cat_25).
    """

    def __init__(
        self,
        batch_size: int,
        max_ind_range: Optional[int] = None,
        zipf_a: float = 1.05,
        target_auroc: float = 0.80,
        ctr: float = CRITEO_KAGGLE_CTR,
        num_batches: Optional[int] = None,
        manual_seed: int = 0,
        cardinalities: Sequence[int] = CRITEO_KAGGLE_CARDINALITIES,
        keys: Optional[Sequence[str]] = None,
    ):
        self.batch_size = batch_size
        self.cardinalities = tuple(
            min(c, max_ind_range) if max_ind_range else c
            for c in cardinalities
        )
        self.keys = (
            tuple(keys)
            if keys is not None
            else tuple(f"cat_{i}" for i in range(len(self.cardinalities)))
        )
        assert len(self.keys) == len(self.cardinalities)
        self.zipf_a = zipf_a
        self.num_batches = num_batches
        self.seed = manual_seed
        self.ctr = ctr
        # Bayes AUROC* = Phi(sigma / sqrt(2)) for a N(0, sigma^2) logit
        # spread around the intercept -> sigma = sqrt(2) Phi^-1(AUROC*)
        from scipy.stats import norm

        self.sigma = float(np.sqrt(2.0) * norm.ppf(target_auroc))
        # intercept calibrated so E_z[sigmoid(b + sigma z)] = ctr
        zs = norm.ppf(np.linspace(0.0005, 0.9995, 2001))
        lo, hi = -8.0, 8.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            if np.mean(1.0 / (1.0 + np.exp(-(mid + self.sigma * zs)))) < ctr:
                lo = mid
            else:
                hi = mid
        self.bias = 0.5 * (lo + hi)
        rng = np.random.RandomState(12345)
        self._dense_w = rng.randn(INT_FEATURE_COUNT).astype(
            np.float32
        ) / np.sqrt(INT_FEATURE_COUNT)
        # the Zipf weighting makes the token-weighted latent mean nonzero:
        # standardize z empirically so the calibration holds
        cal = np.random.RandomState(777)
        zr = []
        for _ in range(4):
            ids = np.stack(
                [
                    zipf_ids(cal, c, (4096,), self.zipf_a)
                    for c in self.cardinalities
                ]
            )
            dense = self._dense(cal, 4096)
            zr.append(self._raw_z(ids, dense))
        zr = np.concatenate(zr)
        self._z_mu = float(zr.mean())
        self._z_sd = float(zr.std()) or 1.0

    def _dense(self, rng: np.random.RandomState, B: int) -> np.ndarray:
        raw = rng.lognormal(mean=1.0, sigma=1.6, size=(B, INT_FEATURE_COUNT))
        dense = np.log1p(raw).astype(np.float32)
        return (dense - 1.9) / 1.1  # approx standardize

    def _raw_z(self, ids: np.ndarray, dense: np.ndarray) -> np.ndarray:
        F, B = ids.shape
        feats = np.arange(F)[:, None] * np.ones((1, B), np.int64)
        s = latent_score(feats, ids)  # [F, B], unit variance per token
        cat_term = s.mean(axis=0) * np.sqrt(F)
        dense_term = dense @ self._dense_w
        inter = s[2] * s[20]  # two heavy-tailed features interact
        z = 0.70 * cat_term + 0.55 * dense_term + 0.45 * inter
        return z / np.sqrt(0.70**2 + 0.55**2 + 0.45**2)

    def _logits(self, ids: np.ndarray, dense: np.ndarray) -> np.ndarray:
        """Ground-truth logit for [F, B] ids + [B, 13] dense."""
        z = (self._raw_z(ids, dense) - self._z_mu) / self._z_sd
        return self.bias + self.sigma * z

    def _batch(self, rng: np.random.RandomState) -> Batch:
        F, B = len(self.keys), self.batch_size
        ids = np.stack(
            [
                zipf_ids(rng, c, (B,), self.zipf_a)
                for c in self.cardinalities
            ]
        )  # [F, B]
        dense = self._dense(rng, B)
        logits = self._logits(ids, dense)
        labels = (
            rng.random_sample((B,)) < 1.0 / (1.0 + np.exp(-logits))
        ).astype(np.float32)
        sb = PaddedSparseBatch(
            ids=torch.from_numpy(ids[:, :, None].astype(np.int32)),
            lengths=torch.ones((F, B), dtype=torch.int32),
            keys=self.keys,
        )
        return Batch(dense_features=torch.from_numpy(dense),
                     sparse_features=sb, labels=torch.from_numpy(labels))

    def __iter__(self) -> Iterator[Batch]:
        rng = np.random.RandomState(self.seed)
        n = 0
        while self.num_batches is None or n < self.num_batches:
            yield self._batch(rng)
            n += 1

    def __len__(self) -> int:
        if self.num_batches is None:
            raise TypeError("infinite dataset")
        return self.num_batches

    def device_batch_fn(self, device: DeviceLike = None
                        ) -> Callable[[int], Batch]:
        """seed -> Batch drawn on `device` (default: the current CUDA
        card) with the host stream's semantics: Zipf ids from the f32
        inverse CDF, log-normal dense features, and labels drawn against
        sigmoid of the same ground-truth logits. The generator is
        re-seeded with `seed` (`random.step_seed(...)` of the run's
        counters) for every batch."""
        dev = resolve_device(device)
        F, B = len(self.keys), self.batch_size
        cards = torch.as_tensor(self.cardinalities, dtype=torch.int64,
                                device=dev)[:, None]
        cards_f = cards.float()
        a = self.zipf_a
        dense_w = torch.as_tensor(self._dense_w, dtype=torch.float32,
                                  device=dev)
        sigma, bias = self.sigma, self.bias
        z_mu, z_sd = self._z_mu, self._z_sd
        feats = torch.arange(F, dtype=torch.int32, device=dev)[:, None] \
            .expand(F, B)
        ones = torch.ones((F, B), dtype=torch.int32, device=dev)
        g = torch.Generator(device=dev)

        def gen(seed: int) -> Batch:
            g.manual_seed(seed)
            k = zipf_inverse_cdf(uniform_open((F, B), g, dev), cards_f, a)
            ids = torch.minimum(torch.clamp(k.to(torch.int64) - 1, min=0),
                                cards - 1)
            raw = torch.exp(1.0 + 1.6 * torch.randn(
                (B, INT_FEATURE_COUNT), generator=g, device=dev))
            dense = (torch.log1p(raw) - 1.9) / 1.1
            s = device_latent_score(feats, ids)
            cat_term = s.mean(dim=0) * math.sqrt(F)
            dense_term = dense @ dense_w
            inter = s[2] * s[20]
            z = 0.70 * cat_term + 0.55 * dense_term + 0.45 * inter
            z = z / math.sqrt(0.70**2 + 0.55**2 + 0.45**2)
            logits = bias + sigma * (z - z_mu) / z_sd
            labels = (torch.rand((B,), generator=g, device=dev)
                      < torch.sigmoid(logits)).float()
            sb = PaddedSparseBatch(ids=ids.to(torch.int32)[:, :, None],
                                   lengths=ones, keys=self.keys)
            return Batch(dense_features=dense, sparse_features=sb,
                         labels=labels)

        return gen
