"""Wrapper of the CUDA bidding kernel ``csrc/bid_top2.cu``.

Counterpart of ``repro/kernels/bid_top2.py``'s ``bid_top2_pallas``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain version
``repro_torch.kernels.ref.bid_top2_ref``.  ``launches`` counts the kernel
launches and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bid_top2_ref

launches = 0


def bid_top2(x: torch.Tensor, c: torch.Tensor, prices: torch.Tensor):
    """(m, d), (k, d), (k,) -> (v1, j1, v2), each (m,); or the stacked
    (G, m, d), (G, k, d), (G, k) -> (G, m) each.

    v1 / v2 are the best / second-best of ``-2 x_i.c_j + ||c_j||^2 - p_j``
    (float32), j1 the best column (int64, lowest column on ties).
    """
    if not x.is_cuda:
        return bid_top2_ref(x, c, prices)
    return _launch(x, c, prices)


def _launch(x, c, prices):
    global launches
    squeeze = x.dim() == 2
    if squeeze:
        x, c, prices = x[None], c[None], prices[None]
    if x.dim() != 3 or c.dim() != 3 or prices.dim() != 2:
        raise ValueError(f"bid_top2 takes (m, d), (k, d), (k,) or a (G, ...) "
                         f"stack; got {tuple(x.shape)}, {tuple(c.shape)}, "
                         f"{tuple(prices.shape)}")
    G, m, d = x.shape
    k = c.shape[1]
    if c.shape != (G, k, d) or prices.shape != (G, k) or k < 1 or d < 1:
        raise ValueError(f"bid_top2 shapes disagree: x {tuple(x.shape)}, "
                         f"c {tuple(c.shape)}, prices {tuple(prices.shape)}")
    if G > 65535:
        raise ValueError(f"bid_top2 takes at most 65535 groups, got {G}")
    for name, t in (("x", x), ("c", c), ("prices", prices)):
        if t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"bid_top2: {name} must be contiguous float32, "
                             f"got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"bid_top2: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"bid_top2: tensors on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    v1 = torch.empty((G, m), dtype=torch.float32, device=x.device)
    j1 = torch.empty((G, m), dtype=torch.int64, device=x.device)
    v2 = torch.empty((G, m), dtype=torch.float32, device=x.device)
    err = _build.function("bid_top2")(
        x.data_ptr(), c.data_ptr(), prices.data_ptr(), v1.data_ptr(),
        j1.data_ptr(), v2.data_ptr(), G, m, k, d,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bid_top2 kernel launch failed (cudaError {err})")
    launches += 1
    return (v1[0], j1[0], v2[0]) if squeeze else (v1, j1, v2)
