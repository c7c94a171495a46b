"""Wrappers of the CUDA row-gather kernels: ``csrc/gather_rows.cu`` and the
fused ``csrc/cdist_gather.cu`` / ``csrc/bid_top2_gather.cu``.

Counterparts of ``repro/kernels/gather.py``'s ``gather_rows_pallas``,
``cdist_gather_pallas`` and ``bid_top2_gather_pallas``.  Every index is
clipped to ``[0, n - 1]``, as the TPU kernels clip it.  A CUDA tensor
launches the kernel (or raises); a CPU tensor runs the plain version in
``repro_torch.kernels.ref``.  Launches are counted in ``_build.launches``.
:func:`bid_top2_gather_prev` and :func:`bid_top2_gather_timed` are for
measurement only and take CUDA tensors only.
"""

from __future__ import annotations

import ctypes

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
    return _bid_gather("bid_top2_gather_f32", x, idx, c, prices)


def bid_top2_gather_prev(x, idx, c, prices):
    """:func:`bid_top2_gather` through the previous design (bid_top2.cuh's
    kernel staging its rows through the index), kept as the yardstick the
    kernel is timed against; bitwise the same outputs."""
    _cuda_only(x, "bid_top2_gather_prev")
    return _bid_gather("bid_top2_gather_prev_f32", x, idx, c, prices)


# the timed instantiation's stamps a CTA, in SM clock cycles (``tiles``: a
# count)
STAGES = ("issue", "c_landed", "c_laid_out", "rows_landed", "fma_and_push",
          "merge_and_store", "cta", "tiles")


def bid_top2_gather_timed(x, idx, c, prices):
    """:func:`bid_top2_gather` through the kernel's timed instantiation.
    Also returns ``stamps`` (CTAs, 8) int64, one row a CTA (``STAGES``):
    the SM cycles spent issuing c and its first two tiles' indices and
    rows, waiting for c, laying c out with its bias, and, summed over its
    tiles, waiting for their rows, in the FMA loop and the pushes, in the
    merge and store; the whole CTA's cycles; the tiles it took."""
    _cuda_only(x, "bid_top2_gather_timed")
    tiles = -(-idx.shape[0] // 32) if idx.dim() == 1 else 0  # CTAs at most
    stamps = torch.zeros((max(tiles, 1), len(STAGES)), dtype=torch.int64,
                         device=x.device)
    grid = ctypes.c_int(0)
    out = _bid_gather("bid_top2_gather_timed_f32", x, idx, c, prices,
                      stamps.data_ptr(), ctypes.addressof(grid))
    return out, stamps[:grid.value]


def _cuda_only(x, kernel):
    if not x.is_cuda:
        raise ValueError(f"{kernel} measures the CUDA kernel and has no "
                         f"plain version; it takes CUDA tensors")


# the widest rows the fused bidding kernel takes: its ring holds two tiles
# of 32 whole rows in shared memory (``ops.bid_top2`` sends d > 512 to
# gather_rows and the unfused kernel, as the reference does)
BID_GATHER_MAX_D = 768


def _bid_gather(symbol, x, idx, c, prices, *more):
    n, d, m, stream = _check("bid_top2_gather", x, idx, c=c, prices=prices)
    if d > BID_GATHER_MAX_D:
        raise ValueError(f"bid_top2_gather takes at most {BID_GATHER_MAX_D} "
                         f"features, got {d}")
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
                  v2.data_ptr(), n, m, k, d, *more, stream, symbol=symbol)
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
