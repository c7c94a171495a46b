"""Plain PyTorch versions of the port's kernels (the correctness contract).

The CPU path of every kernel wrapper runs these, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  Counterparts of
``repro/kernels/ref.py`` (``cdist_ref``, ``bid_top2_ref``,
``ssm_scan_ref``) and of the takes behind ``repro.kernels.ops``'s
``gather_rows`` / ``cdist(idx=)`` / ``bid_top2(idx=)``.  Every gather here
clips its indices to ``[0, n - 1]``, as the TPU kernels do.
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


def cdist_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(m, d), (n, d) -> (m, n) squared Euclidean distances,
    ``||x_i||^2 - 2 x_i.c_j + ||c_j||^2``."""
    x = x.float()
    c = c.float()
    xn = (x * x).sum(dim=1)[:, None]
    cn = (c * c).sum(dim=1)[None, :]
    return xn - 2.0 * (x @ c.T) + cn


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


def cdist_gather_ref(x: torch.Tensor, idx: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """``cdist_ref(x[clip(idx)], c)``: (n, d), (m,), (nc, d) -> (m, nc)."""
    return cdist_ref(gather_rows_ref(x, idx), c)


def bid_top2_gather_ref(x: torch.Tensor, idx: torch.Tensor, c: torch.Tensor,
                        prices: torch.Tensor):
    """``bid_top2_ref(x[clip(idx)], c, prices)``: (n, d), (m,), (k, d),
    (k,) -> (v1, j1, v2), each (m,)."""
    return bid_top2_ref(gather_rows_ref(x, idx), c, prices)


def ssm_scan_chunk_ref(dt, b_in, c_out, x_in, a_mat, h0):
    """The selective scan in time-major layout, one step at a time:
    ``h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t``, ``y_t = <h_t, C_t>``.

    dt, x_in (C, B, di); b_in, c_out (C, B, ds); a_mat (di, ds); h0
    (B, di, ds).  Returns (y (C, B, di), h_final (B, di, ds)).
    """
    a = a_mat.float()
    h = h0.float().clone()
    ys = []
    for t in range(dt.shape[0]):
        dt_t = dt[t].float()
        da = torch.exp(dt_t[:, :, None] * a[None])
        h = h * da + (dt_t * x_in[t].float())[:, :, None] * b_in[t].float()[:, None, :]
        ys.append((h * c_out[t].float()[:, None, :]).sum(dim=-1))
    y = (torch.stack(ys) if ys else
         torch.zeros(dt.shape, dtype=torch.float32, device=dt.device))
    return y, h


def ssm_scan_ref(dt, b_in, c_out, x_in, a_mat):
    """The selective scan from ``h0 = 0``: dt, x_in (B, S, di); b_in, c_out
    (B, S, ds); a_mat (di, ds).  Returns (y (B, S, di), h_final
    (B, di, ds))."""
    bsz, _, di = dt.shape
    h0 = torch.zeros((bsz, di, a_mat.shape[1]), dtype=torch.float32,
                     device=dt.device)
    y, h = ssm_scan_chunk_ref(*(t.transpose(0, 1) for t in
                                (dt, b_in, c_out, x_in)), a_mat, h0)
    return y.transpose(0, 1).contiguous(), h
