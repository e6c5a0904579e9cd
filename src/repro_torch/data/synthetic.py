"""Deterministic synthetic data: LM token streams, classification datasets,
and the paper's experiment surrogates (digit images for the attack task).

The container has no network; the four §5.2 datasets (SENSORLESS, ACOUSTIC,
COVTYPE, SEISMIC) are emulated as seeded Gaussian-mixture problems with the
published feature/class counts — the optimizer comparison (the paper's
claim) is about convergence behaviour, not dataset identity.  Real libsvm
files are supported via ``repro_torch.data.libsvm`` when present on disk.

A copy of ``repro.data.synthetic`` (pure numpy, crc32-seeded), so both
packages draw identical datasets and batches.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np

DATASET_SPECS = {
    # name: (n_features, n_classes) — per Table 4 of the paper
    "sensorless": (48, 11),
    "acoustic": (50, 3),
    "covtype": (54, 7),
    "seismic": (50, 3),
}


@dataclass
class Dataset:
    name: str
    x_train: np.ndarray
    y_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray

    @property
    def n_features(self) -> int:
        return self.x_train.shape[1]

    @property
    def n_classes(self) -> int:
        return int(self.y_train.max()) + 1


def make_classification(name: str, n_train: int = 8192, n_test: int = 2048,
                        seed: int = 0, class_sep: float = 1.6) -> Dataset:
    if name not in DATASET_SPECS:
        raise KeyError(f"unknown dataset {name!r}; have {list(DATASET_SPECS)}")
    d, c = DATASET_SPECS[name]
    # stable hash: python's str hash is randomized per process, which would
    # make the "seeded" dataset differ between runs (the sim benchmarks
    # compare time-to-loss across processes)
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % (1 << 16))
    centers = rng.normal(size=(c, d)) * class_sep
    # anisotropic within-class covariance for a non-trivial decision surface
    mix = rng.normal(size=(c, d, d)) * 0.15 + np.eye(d)

    def sample(n):
        y = rng.integers(0, c, size=n)
        eps = rng.normal(size=(n, d))
        x = centers[y] + np.einsum("nd,ndk->nk", eps, mix[y])
        return x.astype(np.float32), y.astype(np.int32)

    xtr, ytr = sample(n_train)
    xte, yte = sample(n_test)
    mu, sd = xtr.mean(0), xtr.std(0) + 1e-6
    return Dataset(name, (xtr - mu) / sd, ytr, (xte - mu) / sd, yte)


def batches(ds: Dataset, batch: int, seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of i.i.d. sampled batches (with-replacement, as the
    paper's stochastic-oracle model assumes)."""
    rng = np.random.default_rng(seed)
    n = ds.x_train.shape[0]
    while True:
        idx = rng.integers(0, n, size=batch)
        yield {"x": ds.x_train[idx], "y": ds.y_train[idx]}


# --------------------------------------------------------------------------- #
# LM token stream
# --------------------------------------------------------------------------- #
def token_batches(vocab: int, batch: int, seq: int, seed: int = 0,
                  zipf_a: float = 1.3) -> Iterator[Dict[str, np.ndarray]]:
    """Zipf-distributed token batches with next-token labels (-1 on the last
    position, which has no target)."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    while True:
        toks = rng.choice(vocab, size=(batch, seq), p=probs).astype(np.int32)
        labels = np.full((batch, seq), -1, np.int32)
        labels[:, :-1] = toks[:, 1:]
        yield {"tokens": toks, "labels": labels}


# --------------------------------------------------------------------------- #
# synthetic digits (the §5.1 adversarial-attack surrogate for MNIST, d=900)
# --------------------------------------------------------------------------- #
def make_digits(n: int = 2048, side: int = 30, n_classes: int = 10,
                seed: int = 0):
    """30x30 'digit' images (d = 900, matching the paper's attack dimension):
    each class is a fixed smooth template + small pixel noise, in [-0.5, 0.5].
    """
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float64) / side
    templates = []
    for c in range(n_classes):
        ph = rng.uniform(0, 2 * np.pi, size=4)
        f = rng.uniform(1.5, 4.0, size=4)
        t = (
            np.sin(2 * np.pi * f[0] * xx + ph[0])
            + np.cos(2 * np.pi * f[1] * yy + ph[1])
            + np.sin(2 * np.pi * f[2] * (xx + yy) + ph[2])
            + np.cos(2 * np.pi * f[3] * (xx - yy) + ph[3])
        )
        templates.append(t / (np.abs(t).max() * 2.2))
    templates = np.stack(templates)
    y = rng.integers(0, n_classes, size=n).astype(np.int32)
    x = templates[y] + rng.normal(0, 0.02, size=(n, side, side))
    # keep pixels off the +-0.5 boundary: the attack's tanh re-param
    # (z = 0.5*tanh(atanh(2a)+x)) is exactly invertible only for |2a| < 1,
    # so saturated pixels would perturb images even at x = 0
    x = np.clip(x, -0.45, 0.45).astype(np.float32).reshape(n, side * side)
    return x, y
