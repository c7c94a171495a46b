"""Synthetic dataset generators matched to the paper's Table 2 scales.

A copy of ``repro/data/synthetic.py`` (numpy only), so that the PyTorch port
makes the same data from the same seed without importing the JAX package.

The UCI / ImageNet datasets are replaced by generators with identical
(N, D) and qualitatively similar structure: Gaussian mixtures (tabular
clusters), low-rank + noise (image-embedding like), binary occurrence
matrices (Plants-like), and heavy-tailed financial rows.  Each paper dataset
name maps to a preset so the benchmark tables line up row-for-row with the
paper.
"""

from __future__ import annotations

import numpy as np

# (N, D, kind) per paper Table 2
PRESETS = {
    "abalone":    (4_177, 10, "mixture"),
    "travel":     (5_454, 24, "mixture"),
    "facebook":   (7_050, 13, "mixture"),
    "frogs":      (7_195, 22, "mixture"),
    "electric":   (10_000, 12, "mixture"),
    "npi":        (10_440, 40, "binary"),
    "pulsar":     (17_898, 8, "mixture"),
    "creditcard": (30_000, 24, "mixture"),
    "adult":      (32_561, 110, "binary"),
    "plants":     (34_781, 70, "binary"),
    "bank":       (45_211, 53, "mixture"),
    "cifar10":    (50_000, 3_072, "lowrank"),
    "mnist":      (60_000, 784, "lowrank"),
    "survival":   (110_204, 4, "mixture"),
    "diabetes":   (253_680, 22, "mixture"),
    "music":      (515_345, 91, "lowrank"),
    "covtype":    (581_012, 55, "mixture"),
    "imagenet8":  (1_281_167, 192, "lowrank"),
    "imagenet32": (1_281_167, 3_072, "lowrank"),
    "census":     (2_458_285, 68, "binary"),
    "finance":    (6_362_620, 12, "heavytail"),
}


def make(kind: str, n: int, d: int, seed: int = 0,
         n_clusters: int = 10) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "mixture":
        centers = rng.normal(0, 3.0, size=(n_clusters, d))
        labels = rng.integers(0, n_clusters, size=n)
        x = centers[labels] + rng.normal(size=(n, d))
    elif kind == "lowrank":
        r = max(4, min(d // 8, 64))
        u = rng.normal(size=(n, r))
        v = rng.normal(size=(r, d))
        x = u @ v + 0.3 * rng.normal(size=(n, d))
    elif kind == "binary":
        p = rng.beta(0.5, 2.0, size=d)
        x = (rng.random((n, d)) < p).astype(np.float64)
    elif kind == "heavytail":
        x = rng.standard_t(df=3, size=(n, d)) * rng.gamma(2.0, 1.0, size=(1, d))
    else:
        raise ValueError(kind)
    # paper preprocessing: standardize (or leave binaries as-is, like [0,1])
    if kind != "binary":
        x = (x - x.mean(0)) / np.maximum(x.std(0), 1e-9)
    return x.astype(np.float32)


def load(name: str, seed: int = 0, max_n: int | None = None) -> np.ndarray:
    n, d, kind = PRESETS[name]
    if max_n:
        n = min(n, max_n)
    return make(kind, n, d, seed=seed)
