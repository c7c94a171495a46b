"""Wrapper of the CUDA squared-distance kernel ``csrc/cdist.cu``.

Counterpart of ``repro/kernels/cdist.py``'s ``cdist_pallas``.  A CUDA
tensor launches the kernel (or raises); a CPU tensor runs the plain version
``repro_torch.kernels.ref.cdist_ref``.  Launches are counted in
``_build.launches["cdist"]``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import cdist_ref

MAX_CENTROIDS = 65535 * 128  # the grid's y axis covers 128 centroids a CTA


def cdist(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(m, d), (n, d) -> (m, n) float32 squared Euclidean distances,
    ``||x_i||^2 - 2 x_i.c_j + ||c_j||^2``."""
    if not x.is_cuda:
        return cdist_ref(x, c)
    if x.dim() != 2 or c.dim() != 2 or x.shape[1] != c.shape[1]:
        raise ValueError(f"cdist takes (m, d) and (n, d); got "
                         f"{tuple(x.shape)}, {tuple(c.shape)}")
    m, d = x.shape
    n = c.shape[0]
    if n > MAX_CENTROIDS:
        raise ValueError(f"cdist takes at most {MAX_CENTROIDS} centroids, "
                         f"got {n}")
    stream = _build.check_operands("cdist", x=x, c=c)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    _build.launch("cdist", x.data_ptr(), c.data_ptr(), out.data_ptr(), m, n, d,
                  stream)
    return out
