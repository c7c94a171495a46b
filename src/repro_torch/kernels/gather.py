"""Wrapper of the CUDA row-gather kernel ``csrc/gather_rows.cu``.

Counterpart of ``repro/kernels/gather.py``'s ``gather_rows_pallas``.  A
CUDA tensor launches the kernel (or raises); a CPU tensor runs the plain
version ``repro_torch.kernels.ref.gather_rows_ref``.  ``launches`` counts
the kernel launches and nothing else.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import gather_rows_ref

launches = 0


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[clip(idx, 0, n - 1)]`` as float32: (n, d), (m,) -> (m, d)."""
    if not x.is_cuda:
        return gather_rows_ref(x, idx)
    return _launch(x, idx)


def _launch(x, idx):
    global launches
    if x.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"gather_rows takes (n, d) rows and (m,) indices; "
                         f"got {tuple(x.shape)}, {tuple(idx.shape)}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"gather_rows: x must be contiguous float32, got "
                         f"{x.dtype}")
    if idx.dtype not in (torch.int32, torch.int64) or not idx.is_contiguous():
        raise ValueError(f"gather_rows: idx must be contiguous int32 or "
                         f"int64, got {idx.dtype}")
    if idx.device != x.device:
        raise ValueError(f"gather_rows: idx is on {idx.device}, x on "
                         f"{x.device}")
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"gather_rows: tensors on {x.device} but the current "
                         f"device is cuda:{torch.cuda.current_device()}")
    n, d = x.shape
    if n < 1:
        raise ValueError("gather_rows: x has no rows")
    m = idx.shape[0]
    out = torch.empty((m, d), dtype=torch.float32, device=x.device)
    err = _build.function("gather_rows")(
        x.data_ptr(), idx.data_ptr(), int(idx.dtype == torch.int64),
        out.data_ptr(), n, m, d, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gather_rows kernel launch failed (cudaError {err})")
    launches += 1
    return out
