"""Wrappers of the CUDA row-gather kernels: ``csrc/gather_rows.cu`` and the
fused ``csrc/cdist_gather.cu`` / ``csrc/bid_top2_gather.cu``.

Counterparts of ``repro/kernels/gather.py``'s ``gather_rows_pallas``,
``cdist_gather_pallas`` and ``bid_top2_gather_pallas``.  Every index is
clipped to ``[0, n - 1]``, as the TPU kernels clip it.  A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain version in
``repro_torch.kernels.ref``.  Launches are counted in ``_build.launches``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.bid_top2 import top2_outputs
from repro_torch.kernels.cdist import MAX_CENTROIDS
from repro_torch.kernels.ref import (bid_top2_gather_ref, cdist_gather_ref,
                                     gather_rows_ref)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[clip(idx, 0, n - 1)]`` as float32: (n, d), (m,) -> (m, d)."""
    if not x.is_cuda:
        return gather_rows_ref(x, idx)
    n, d, m, stream = _check("gather_rows", x, idx)
    out = x.new_empty((m, d))
    _build.launch("gather_rows", x.data_ptr(), idx.data_ptr(),
                  idx.dtype == torch.int64, out.data_ptr(), n, m, d, stream)
    return out


def cdist_gather(x: torch.Tensor, idx: torch.Tensor,
                 c: torch.Tensor) -> torch.Tensor:
    """``cdist(x[clip(idx)], c)`` without writing ``x[idx]``:
    (n, d), (m,), (nc, d) -> (m, nc) squared distances."""
    if not x.is_cuda:
        return cdist_gather_ref(x, idx, c)
    n, d, m, stream = _check("cdist_gather", x, idx, c=c)
    nc = c.shape[0]
    if nc > MAX_CENTROIDS:
        raise ValueError(f"cdist_gather takes at most {MAX_CENTROIDS} "
                         f"centroids, got {nc}")
    out = torch.empty((m, nc), dtype=torch.float32, device=x.device)
    _build.launch("cdist_gather", x.data_ptr(), idx.data_ptr(),
                  idx.dtype == torch.int64, c.data_ptr(), out.data_ptr(),
                  n, m, nc, d, stream)
    return out


def bid_top2_gather(x: torch.Tensor, idx: torch.Tensor, c: torch.Tensor,
                    prices: torch.Tensor):
    """``bid_top2(x[clip(idx)], c, prices)`` without writing ``x[idx]``:
    (n, d), (m,), (k, d), (k,) -> (v1, j1, v2), each (m,)."""
    if not x.is_cuda:
        return bid_top2_gather_ref(x, idx, c, prices)
    n, d, m, stream = _check("bid_top2_gather", x, idx, c=c, prices=prices)
    k = c.shape[0]
    if prices.shape != (k,) or k < 1:
        raise ValueError(f"bid_top2_gather: prices {tuple(prices.shape)} "
                         f"for {k} centroids")
    if m > 2**31 - 1:
        raise ValueError("bid_top2_gather takes fewer than 2**31 rows")
    v1, j1, v2 = top2_outputs((m,), x.device)
    _build.launch("bid_top2_gather", x.data_ptr(), idx.data_ptr(),
                  idx.dtype == torch.int64, c.data_ptr(),
                  prices.data_ptr(), v1.data_ptr(), j1.data_ptr(),
                  v2.data_ptr(), n, m, k, d, stream)
    return v1, j1, v2


def _check(kernel, x, idx, **more):
    """Shapes and operands of an indexed-row kernel (``more`` holds ``c``,
    (k, d) centroids, and any other float32 operand), in one pass; returns
    (n, d, m, the current stream's handle)."""
    c = more.get("c")
    if x.dim() != 2 or idx.dim() != 1 or (c is not None and (
            c.dim() != 2 or c.shape[1] != x.shape[1])):
        raise ValueError(
            f"{kernel} takes (n, d) rows, (m,) indices"
            + ("" if c is None else " and (k, d) centroids")
            + f"; got {tuple(x.shape)}, {tuple(idx.shape)}"
            + ("" if c is None else f", {tuple(c.shape)}"))
    n, d = x.shape
    if n < 1:
        raise ValueError(f"{kernel}: x has no rows")
    stream = _build.check_operands(kernel, x=x, idx=idx, **more)
    return n, d, idx.shape[0], stream
