"""K-plus feature augmentation (Papenberg 2024; paper Section 3.3), in PyTorch.

Counterpart of ``repro/core/kplus.py``.  Squared-Euclidean anticlustering
equalizes only the anticlusters' *means*; appending each feature's
standardized centered powers ((x - mean)^2 for the variance, ^3 for the
skew, ...) makes ABA balance those moments too, as extra columns.

Both functions work in float64 on the rows' device (the JAX package's
numpy float64) and never copy the rows to the host.
"""

from __future__ import annotations

import torch


def kplus_augment(x: torch.Tensor, moments: int = 2) -> torch.Tensor:
    """(n, d) -> (n, d * moments) float32: ``x`` and, for each moment
    2..moments, the standardized centered power of every feature; formed
    in float64 and cast to float32 once at the end."""
    if moments < 1:
        raise ValueError(f"moments={moments} must be >= 1")
    x = torch.as_tensor(x).double()
    cols = [x]
    centered = x - x.mean(dim=0, keepdim=True)
    for m in range(2, moments + 1):
        f = centered ** m
        std = f.std(dim=0, keepdim=True, correction=0)
        cols.append((f - f.mean(dim=0, keepdim=True)) / std.clamp(min=1e-12))
    return torch.cat(cols, dim=1).float()


def moment_spread(x: torch.Tensor, labels: torch.Tensor, k: int,
                  moment: int = 2) -> float:
    """Max - min over the k anticlusters of each feature's central moment
    ``moment``, averaged over the features (float64 cluster sums)."""
    x = torch.as_tensor(x).double()
    labels = torch.as_tensor(labels, device=x.device).long()
    size = torch.zeros((k,), dtype=torch.float64, device=x.device)
    size.index_add_(0, labels, torch.ones_like(labels, dtype=torch.float64))

    def cluster_mean(v):
        sums = torch.zeros((k, v.shape[1]), dtype=torch.float64,
                           device=x.device).index_add_(0, labels, v)
        return sums / size[:, None]

    vals = cluster_mean((x - cluster_mean(x)[labels]) ** moment)
    return float((vals.amax(dim=0) - vals.amin(dim=0)).mean())
