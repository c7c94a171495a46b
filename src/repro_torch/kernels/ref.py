"""Plain PyTorch versions of the port's kernels (the correctness contract).

The CPU path of every kernel wrapper runs these, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  Counterparts of
``repro/kernels/ref.py`` (``bid_top2_ref``) and of the jnp take behind
``repro.kernels.ops.gather_rows``.
"""

from __future__ import annotations

import torch

_NEG = -1e30  # sentinel "minus infinity" that survives f32 arithmetic


def top2(values: torch.Tensor):
    """Last-axis (best value, best index, second value) of a (..., n) tensor.

    Ties go to the lowest index; when the maximum occurs twice the second
    value equals the first.  Indices are int64.
    """
    j1 = values.argmax(dim=-1)
    v1 = values.gather(-1, j1[..., None])[..., 0]
    v2 = values.scatter(-1, j1[..., None], _NEG).amax(dim=-1)
    return v1, j1, v2


def bid_top2_ref(x: torch.Tensor, c: torch.Tensor, prices: torch.Tensor):
    """Top-2 of ``-2 x_i.c_j + ||c_j||^2 - p_j`` over j, per row i.

    Takes (m, d), (k, d), (k,) or the stacked (G, m, d), (G, k, d), (G, k).
    The stacked form solves each group with the same call as the flat form,
    so a group's result does not depend on G.
    """
    if x.dim() == 3:
        outs = [bid_top2_ref(x[g], c[g], prices[g]) for g in range(x.shape[0])]
        return tuple(torch.stack(t) for t in zip(*outs))
    x = x.float()
    c = c.float()
    vals = -2.0 * (x @ c.T) + (c * c).sum(dim=1)[None, :] - prices[None, :]
    return top2(vals)


def gather_rows_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[clip(idx, 0, n - 1)]`` as float32: (n, d), (m,) -> (m, d)."""
    return x[idx.long().clamp(0, x.shape[0] - 1)].float()
