"""Benchmark baselines from the paper's experimental study (Section 5.2),
for the PyTorch port.

A copy of ``repro/core/baselines.py``: host code (numpy, and scipy's
``cKDTree`` for the nearest-partner table), with no kernel.  The same
seed gives the same labels bit for bit as the JAX package's copy.

- ``random_partition``      the paper's Rand baseline (balanced sizes).
- ``fast_anticlustering``   Papenberg & Klau's exchange heuristic with a
  limited number of exchange partners (P-N5 / P-R5 / P-R50 / P-R500).  Uses
  the centroid-form objective delta (their "fast" formulation) so one
  exchange evaluation is O(D), and is vectorized over objects per sweep.
- ``exchange_anticlustering``  the same exchange move set vectorized over
  all object/partner pairs per round (cluster-disjoint swap matching keeps
  every applied gain exact) -- the variant fast enough to run as the
  competitive frame in ``benchmarks/table10_scale.py``.
- ``greedy_kcut``           balanced k-cut via greedy refinement on the
  complete sq-Euclidean graph -- stands in for METIS (Section 5.5), which we
  do not reimplement (multilevel graph coarsening is out of scope; noted in
  DESIGN.md).  The cut-cost equivalence of Section 5.5 lets it reuse the
  anticlustering machinery.
- ``exact_small``           brute force over set partitions for tiny N
  (replaces the MILP/Gurobi reference in optimality-gap tests).
"""

from __future__ import annotations

import itertools

import numpy as np


def random_partition(n: int, k: int, seed: int = 0,
                     categories: np.ndarray | None = None) -> np.ndarray:
    """Balanced random labels; with categories, balanced per category (5)."""
    rng = np.random.default_rng(seed)
    labels = np.empty(n, np.int32)
    if categories is None:
        perm = rng.permutation(n)
        labels[perm] = np.arange(n) % k
        return labels
    for g in np.unique(categories):
        idx = np.flatnonzero(categories == g)
        perm = rng.permutation(len(idx))
        labels[idx[perm]] = np.arange(len(idx)) % k
    return labels


def _centroid_state(x: np.ndarray, labels: np.ndarray, k: int):
    sums = np.zeros((k, x.shape[1]))
    counts = np.bincount(labels, minlength=k).astype(np.float64)
    np.add.at(sums, labels, x)
    return sums, counts


def fast_anticlustering(
    x: np.ndarray,
    k: int,
    *,
    n_partners: int = 5,
    partner_mode: str = "random",  # "random" (P-R*) or "nearest" (P-N*)
    seed: int = 0,
    categories: np.ndarray | None = None,
    n_sweeps: int = 1,
) -> np.ndarray:
    """Exchange heuristic of Papenberg & Klau [2021] (the paper's main rival).

    Starts from a balanced random partition; for each object, evaluates
    swapping with ``n_partners`` exchange partners (same category when
    ``categories`` is given) and performs the best improving swap.  The
    objective delta uses the k-means identity: moving object i from cluster a
    to b changes sum_k n_k*Var_k via centroid updates only -- O(D) per
    candidate, as in the R package's fast_anticlustering().
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    labels = random_partition(n, k, seed=seed, categories=categories)
    sums, counts = _centroid_state(x, labels, k)

    def cluster_gain(i, j):
        """Objective delta of swapping labels of i and j (centroid form)."""
        a, b = labels[i], labels[j]
        if a == b:
            return 0.0
        # d_k = sum ||x||^2 - ||sum x||^2 / n_k  per cluster; only the
        # -||S_k||^2/n_k terms change (counts are preserved by a swap).
        sa, sb = sums[a], sums[b]
        na, nb = counts[a], counts[b]
        delta = x[j] - x[i]
        old = -(sa @ sa) / na - (sb @ sb) / nb
        sa2, sb2 = sa + delta, sb - delta
        new = -(sa2 @ sa2) / na - (sb2 @ sb2) / nb
        return new - old

    if partner_mode == "nearest":
        # nearest neighbours in feature space (the R package's default).
        # KD-trees degenerate above ~30 dims (mnist/cifar would take hours);
        # use chunked brute force there, exact same neighbours.
        if x.shape[1] <= 30:
            from scipy.spatial import cKDTree

            tree = cKDTree(x)
            _, nn = tree.query(x, k=n_partners + 1)
            partner_table = nn[:, 1:]
        else:
            sq = (x * x).sum(1)
            parts = []
            for lo in range(0, n, 2048):
                d = sq[lo:lo + 2048, None] - 2.0 * (x[lo:lo + 2048] @ x.T) \
                    + sq[None, :]
                idx = np.argpartition(d, n_partners + 1, axis=1)[
                    :, :n_partners + 1]
                # drop self, keep n_partners
                rows = []
                for r, row in enumerate(idx):
                    row = row[row != lo + r][:n_partners]
                    rows.append(row)
                parts.append(np.stack(rows))
            partner_table = np.concatenate(parts)
    else:
        partner_table = rng.integers(0, n, size=(n, n_partners))

    for _ in range(n_sweeps):
        for i in range(n):
            cands = partner_table[i]
            if categories is not None:
                cands = cands[categories[cands] == categories[i]]
            best_gain, best_j = 0.0, -1
            for j in cands:
                if labels[j] == labels[i]:
                    continue
                g = cluster_gain(i, int(j))
                if g > best_gain + 1e-12:
                    best_gain, best_j = g, int(j)
            if best_j >= 0:
                a, b = labels[i], labels[best_j]
                delta = x[best_j] - x[i]
                sums[a] += delta
                sums[b] -= delta
                labels[i], labels[best_j] = b, a
    return labels


def exchange_anticlustering(
    x: np.ndarray,
    k: int,
    *,
    n_partners: int = 8,
    n_sweeps: int = 3,
    seed: int = 0,
    max_rounds: int = 64,
) -> np.ndarray:
    """Vectorized exchange heuristic -- ``fast_anticlustering`` at scale.

    Same move set and same centroid-form O(D) gain as
    :func:`fast_anticlustering` (Papenberg & Klau's P-R* scheme), but
    evaluated for *every* object x partner pair at once in numpy instead of
    a Python loop per object, so it is usable as the paper's competitive
    frame at ``table10_scale`` sizes.  Each round applies the best
    improving swaps under a cluster-disjoint matching (each cluster touched
    by at most one swap per round): swaps on disjoint cluster pairs have
    additive objective deltas, so every applied gain is exact -- no stale
    centroid sums.  Rounds repeat until no candidate improves (or
    ``max_rounds``); each sweep redraws the random partner table.

    Returns balanced labels (swaps preserve cluster sizes by construction).
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    rng = np.random.default_rng(seed)
    labels = random_partition(n, k, seed=seed)
    sums, counts = _centroid_state(x, labels, k)
    rows = np.arange(n)

    for _ in range(n_sweeps):
        partners = rng.integers(0, n, size=(n, n_partners))
        for _round in range(max_rounds):
            a = labels[:, None]                       # (n, 1)
            b = labels[partners]                      # (n, P)
            delta = x[partners] - x[:, None, :]       # (n, P, d)
            # gain of swapping i<->j: only the -||S||^2/n_c terms move
            # (counts are preserved); expand ||S +- delta||^2:
            #   -(2 S_a.delta + ||delta||^2)/n_a + (2 S_b.delta - ||d||^2)/n_b
            d2 = np.einsum("npd,npd->np", delta, delta)
            sa_d = np.einsum("npd,npd->np",
                             np.broadcast_to(sums[labels][:, None, :],
                                             delta.shape), delta)
            sb_d = np.einsum("npd,npd->np", sums[b], delta)
            gain = (-(2.0 * sa_d + d2) / counts[a]
                    + (2.0 * sb_d - d2) / counts[b])
            gain[a == b] = 0.0
            best_p = np.argmax(gain, axis=1)          # best partner per i
            best_g = gain[rows, best_p]
            order = np.argsort(-best_g)
            used_obj = np.zeros(n, bool)
            used_cluster = np.zeros(k, bool)
            applied = False
            for i in order:
                g = best_g[i]
                if g <= 1e-9:
                    break
                j = partners[i, best_p[i]]
                ca, cb = labels[i], labels[j]
                if (used_obj[i] or used_obj[j]
                        or used_cluster[ca] or used_cluster[cb]):
                    continue
                dlt = x[j] - x[i]
                sums[ca] += dlt
                sums[cb] -= dlt
                labels[i], labels[j] = cb, ca
                used_obj[i] = used_obj[j] = True
                used_cluster[ca] = used_cluster[cb] = True
                applied = True
            if not applied:
                break
    return labels


def greedy_kcut(x: np.ndarray, k: int, *, seed: int = 0,
                n_sweeps: int = 2, n_partners: int = 30) -> np.ndarray:
    """Balanced k-cut proxy for METIS: random init + swap refinement.

    Minimizing the cut on the complete sq-Euclidean graph equals maximizing
    W(C) (Section 5.5), so refinement reuses the exchange machinery with a
    neighbour list of ``n_partners`` random peers (METIS was run by the paper
    on 30-random-neighbour sparsifications -- same information budget).
    """
    return fast_anticlustering(x, k, n_partners=n_partners, seed=seed,
                               n_sweeps=n_sweeps, partner_mode="random")


def exact_small(x: np.ndarray, k: int) -> tuple[np.ndarray, float]:
    """Exhaustive optimum for tiny instances (N <= ~12). Returns labels, W(C)."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    assert n % k == 0 and n <= 12, "exact_small is for tiny sanity checks"
    size = n // k
    d = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)

    best_val, best_labels = -1.0, None

    def rec(remaining: frozenset, labels: np.ndarray, g: int):
        nonlocal best_val, best_labels
        if not remaining:
            val = sum(d[i, j] for i in range(n) for j in range(i + 1, n)
                      if labels[i] == labels[j])
            if val > best_val:
                best_val, best_labels = val, labels.copy()
            return
        first = min(remaining)
        rest = remaining - {first}
        for combo in itertools.combinations(sorted(rest), size - 1):
            group = (first,) + combo
            for i in group:
                labels[i] = g
            rec(rest - set(combo), labels, g + 1)
        for i in [first]:
            labels[i] = -1

    rec(frozenset(range(n)), np.full(n, -1), 0)
    return best_labels.astype(np.int32), float(best_val)
