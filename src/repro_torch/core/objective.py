"""Anticlustering objectives, diversity statistics and the dual certificate.

Counterpart of ``repro/core/objective.py``.  The tables' ``ofv`` is the
centroid form ``sum_k sum_{i in C_k} ||x_i - mu_k||^2``.  Sums over rows use
``index_add_``, which on the card adds in no fixed order: these statistics
agree with the JAX ones to float32 rounding, not bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

# Rows per certificate chunk bound the (chunk, k) distance block.
_CERT_BLOCK = 1 << 22


def cluster_sizes(labels: torch.Tensor, k: int) -> torch.Tensor:
    return torch.bincount(labels.long(), minlength=k).to(torch.int32)


def centroids(x: torch.Tensor, labels: torch.Tensor, k: int) -> torch.Tensor:
    """(k, d) cluster centroids."""
    lab = labels.long()
    sums = x.new_zeros((k, x.shape[1])).index_add_(0, lab, x)
    counts = torch.bincount(lab, minlength=k).clamp(min=1)
    return sums / counts[:, None].to(x.dtype)


def diversity_per_cluster(x: torch.Tensor, labels: torch.Tensor,
                          k: int) -> torch.Tensor:
    """d_k = sum_{i in C_k} ||x_i - mu_k||^2."""
    lab = labels.long()
    sq = ((x - centroids(x, lab, k)[lab]) ** 2).sum(dim=-1)
    return x.new_zeros((k,)).index_add_(0, lab, sq)


def objective_centroid(x: torch.Tensor, labels: torch.Tensor,
                       k: int) -> torch.Tensor:
    """sum_k sum_{i in C_k} ||x_i - mu_k||^2 -- the tables' ``ofv``."""
    return diversity_per_cluster(x, labels, k).sum()


def diversity_stats(x: torch.Tensor, labels: torch.Tensor, k: int):
    """(sd, range) of the k per-cluster diversities (population sd)."""
    div = diversity_per_cluster(x, labels, k)
    return div.std(correction=0), div.amax() - div.amin()


def dual_certificate(x: torch.Tensor, labels: torch.Tensor,
                     prices: torch.Tensor, k: int):
    """LP-dual optimality-gap certificate from the auction's prices.

    Returns ``(dual_bound, gap)``: for the realized cluster sizes ``n_c``
    and centroids ``mu_c``, every reassignment of the rows to the clusters
    with these capacities has ``ofv <= sum_c n_c p_c + sum_i max_c
    (||x_i - mu_c||^2 - p_c)`` for any prices ``p``, so
    ``gap = (dual_bound - ofv) / ofv >= 0``.  Takes flat ``(n, d)`` rows with
    ``(k,)`` prices or a stacked ``(G, M, D)`` / ``(G, k)`` pair (then
    returns (G,) tensors).  Rows go through in chunks of
    ``_CERT_BLOCK // k``, so the live distance block stays O(chunk * k).
    """
    squeeze = x.dim() == 2
    if squeeze:
        x, labels, prices = x[None], labels[None], prices[None]
    G, M, D = x.shape
    seg = (labels.long() + k * torch.arange(G, device=x.device)[:, None])
    seg = seg.reshape(-1)
    sizes = torch.bincount(seg, minlength=G * k).view(G, k).to(x.dtype)
    sums = x.new_zeros((G * k, D)).index_add_(0, seg, x.reshape(-1, D))
    mu = sums.view(G, k, D) / sizes.clamp(min=1.0)[..., None]
    mu_sq = (mu * mu).sum(dim=-1)
    chunk = max(1, min(M, _CERT_BLOCK // max(k, 1)))
    ofv = x.new_zeros((G,))
    slack = x.new_zeros((G,))
    for s in range(0, M, chunk):
        xc, lc = x[:, s:s + chunk], labels[:, s:s + chunk].long()
        d2 = ((xc * xc).sum(dim=-1)[..., None]
              - 2.0 * torch.einsum("gcd,gkd->gck", xc, mu)
              + mu_sq[:, None, :])
        ofv += d2.gather(2, lc[..., None])[..., 0].sum(dim=1)
        slack += (d2 - prices[:, None, :]).amax(dim=-1).sum(dim=1)
    bound = (sizes * prices).sum(dim=-1) + slack
    gap = (bound - ofv) / ofv.clamp(min=1e-12)
    if squeeze:
        return bound[0], gap[0]
    return bound, gap


def balance_ok(labels, k: int, n: int | None = None) -> bool:
    """Constraint (2): all sizes in {floor(N/K), ceil(N/K)}."""
    labels = np.asarray(torch.as_tensor(labels).cpu())
    n = n or labels.shape[0]
    counts = np.bincount(labels, minlength=k)
    return bool(counts.min() >= n // k and counts.max() <= -(-n // k))
