"""Wrapper of the CUDA bidding kernel ``csrc/bid_top2.cu``.

Counterpart of ``repro/kernels/bid_top2.py``'s ``bid_top2_pallas``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain version
``repro_torch.kernels.ref.bid_top2_ref``.  :func:`bid_top2_span` is the
factored auction's span pair in one launch (plain version
``bid_top2_span_ref``).  Launches are counted in
``_build.launches["bid_top2"]``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bid_top2_ref, bid_top2_span_ref


def bid_top2(x: torch.Tensor, c: torch.Tensor, prices: torch.Tensor):
    """(m, d), (k, d), (k,) -> (v1, j1, v2), each (m,); or the stacked
    (G, m, d), (G, k, d), (G, k) -> (G, m) each.

    v1 / v2 are the best / second-best of ``-2 x_i.c_j + ||c_j||^2 - p_j``
    (float32), j1 the best column (int64, lowest column on ties).
    """
    if not x.is_cuda:
        return bid_top2_ref(x, c, prices)
    squeeze = x.dim() == 2
    if squeeze:
        x, c, prices = x[None], c[None], prices[None]
    v1, j1, v2 = _launch("bid_top2_f32", 1, x, c, prices)
    return (v1[0, 0], j1[0, 0], v2[0, 0]) if squeeze else (v1[0], j1[0], v2[0])


def bid_top2_span(x: torch.Tensor, c: torch.Tensor):
    """``(bid_top2(x, c, 0), bid_top2(-x, c, 2 ||c||^2))`` on a (G, m, d),
    (G, k, d) stack: the two bids behind the factored auction's span.  On
    the card one launch (grid axis z is the pair, the rows of the second
    negated as they are loaded, its bias the launch's own -||c||^2),
    bitwise the two calls at those prices."""
    if not x.is_cuda:
        return bid_top2_span_ref(x, c)
    v1, j1, v2 = _launch("bid_top2_span_f32", 2, x, c, None)
    return (v1[0], j1[0], v2[0]), (v1[1], j1[1], v2[1])


def _launch(symbol, slots, x, c, prices):
    """(slots, G, m) v1, j1, v2 of the kernel's entry ``symbol`` on a
    (G, m, d), (G, k, d), (G, k) stack (``prices`` None: the span, which
    forms its own)."""
    shape = () if prices is None else tuple(prices.shape)
    if x.dim() != 3 or c.dim() != 3 or len(shape) not in (0, 2):
        raise ValueError(f"bid_top2 takes (m, d), (k, d), (k,) or a (G, ...) "
                         f"stack; got {tuple(x.shape)}, {tuple(c.shape)}, "
                         f"{shape}")
    G, m, d = x.shape
    k = c.shape[1]
    if c.shape != (G, k, d) or shape not in ((), (G, k)) or k < 1 or d < 1:
        raise ValueError(f"bid_top2 shapes disagree: x {tuple(x.shape)}, "
                         f"c {tuple(c.shape)}, prices {shape}")
    if G > 65535:
        raise ValueError(f"bid_top2 takes at most 65535 groups, got {G}")
    operands = dict(x=x, c=c) if prices is None else dict(x=x, c=c,
                                                          prices=prices)
    stream = _build.check_operands("bid_top2", **operands)
    v1, j1, v2 = top2_outputs((slots, G, m), x.device)
    p = () if prices is None else (prices.data_ptr(),)
    _build.launch("bid_top2", x.data_ptr(), c.data_ptr(), *p, v1.data_ptr(),
                  j1.data_ptr(), v2.data_ptr(), G, m, k, d, stream,
                  symbol=symbol)
    return v1, j1, v2


def top2_outputs(shape, device):
    """Empty (v1 float32, j1 int64, v2 float32) of ``shape``."""
    return (torch.empty(shape, dtype=torch.float32, device=device),
            torch.empty(shape, dtype=torch.int64, device=device),
            torch.empty(shape, dtype=torch.float32, device=device))
