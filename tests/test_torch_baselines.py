"""The port's copy of the paper's baselines (``repro_torch.core.baselines``)
against the JAX package's, on the CPU.

The module is host code (numpy, scipy's ``cKDTree``): for every function
and seed the port's labels (and ``exact_small``'s optimum) are bitwise the
reference's.  Each test builds its own ``np.random.default_rng(seed)``.
"""

import numpy as np
import pytest
import torch

from repro.core import baselines as jax_baselines

from repro_torch.anticluster import anticluster
from repro_torch.core import baselines
from repro_torch.core.objective import balance_ok, objective_centroid

SEEDS = (0, 1, 7)


def _data(n, d, seed):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _cats(n, c, seed):
    return np.random.default_rng(seed + 1000).integers(0, c, size=n)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("categories", [False, True])
def test_random_partition_bitwise(seed, categories):
    n, k = 203, 7
    cats = _cats(n, 3, seed) if categories else None
    got = baselines.random_partition(n, k, seed=seed, categories=cats)
    _same(got, jax_baselines.random_partition(n, k, seed=seed,
                                              categories=cats))
    if cats is None:
        assert balance_ok(got, k, n)
    else:  # balanced within each category (constraint (5))
        for c in range(3):
            per = np.bincount(got[cats == c], minlength=k)
            assert per.max() - per.min() <= 1


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("mode,d", [("random", 4), ("nearest", 4),
                                    ("nearest", 33)])
def test_fast_anticlustering_bitwise(seed, mode, d):
    """P-R* and P-N* (the k-d tree at d <= 30, the chunked brute force
    above), one sweep and two."""
    x = _data(160, d, seed)
    for sweeps in (1, 2):
        kw = dict(n_partners=5, partner_mode=mode, seed=seed,
                  n_sweeps=sweeps)
        got = baselines.fast_anticlustering(x, 8, **kw)
        _same(got, jax_baselines.fast_anticlustering(x, 8, **kw))
        assert balance_ok(got, 8, 160)


@pytest.mark.parametrize("seed", SEEDS)
def test_fast_anticlustering_with_categories_bitwise(seed):
    x = _data(150, 3, seed)
    cats = _cats(150, 3, seed)
    got = baselines.fast_anticlustering(x, 5, seed=seed, categories=cats)
    _same(got, jax_baselines.fast_anticlustering(x, 5, seed=seed,
                                                 categories=cats))
    for c in range(3):  # constraint (5): swaps stay within a category
        per = np.bincount(got[cats == c], minlength=5)
        assert per.max() - per.min() <= 1


@pytest.mark.parametrize("seed", SEEDS)
def test_exchange_anticlustering_bitwise(seed):
    x = _data(300, 5, seed)
    kw = dict(n_partners=8, n_sweeps=2, seed=seed, max_rounds=16)
    got = baselines.exchange_anticlustering(x, 10, **kw)
    _same(got, jax_baselines.exchange_anticlustering(x, 10, **kw))
    assert balance_ok(got, 10, 300)


@pytest.mark.parametrize("seed", SEEDS)
def test_greedy_kcut_bitwise(seed):
    x = _data(120, 4, seed)
    got = baselines.greedy_kcut(x, 6, seed=seed, n_partners=10)
    _same(got, jax_baselines.greedy_kcut(x, 6, seed=seed, n_partners=10))


@pytest.mark.parametrize("n,k", [(6, 2), (8, 4), (9, 3)])
def test_exact_small_bitwise(n, k):
    x = _data(n, 2, n * 10 + k)
    labels, value = baselines.exact_small(x, k)
    ref_labels, ref_value = jax_baselines.exact_small(x, k)
    _same(labels, ref_labels)
    assert value == ref_value


def test_aba_beats_random_and_nears_exchange():
    """The baselines' role (Table 4): on the same rows the port's ABA beats
    the random partition and lands within 1 % of the exchange heuristic."""
    x = _data(512, 6, 3)
    k = 16
    obj = {name: float(objective_centroid(torch.from_numpy(x),
                                          torch.as_tensor(lab), k))
           for name, lab in (
               ("aba", anticluster(x, k=k, device="cpu").labels),
               ("random", baselines.random_partition(512, k, seed=0)),
               ("fast", baselines.fast_anticlustering(x, k, seed=0)))}
    assert obj["aba"] > obj["random"]
    assert obj["aba"] > 0.99 * obj["fast"], obj
