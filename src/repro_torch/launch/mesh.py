"""Mesh constructors of the PyTorch port.

Counterpart of ``repro/launch/mesh.py``: :func:`make_production_mesh`
(the dry-run's) and :func:`make_host_mesh`.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.sharding.specs import Mesh


def _grid(shape: tuple, axes: tuple, device) -> Mesh:
    """A mesh of ``shape`` over ``axes``: with ``device=None`` the first
    CUDA devices, one a position, raising where there are fewer; else that
    one device at every position."""
    n = math.prod(shape)
    if device is None:
        resolve_device(None)
        have = torch.cuda.device_count()
        if have < n:
            raise ValueError(
                f"need {n} CUDA devices, have {have}; pass device= to "
                "repeat one device at every position of the mesh")
        devs = [torch.device("cuda", i) for i in range(n)]
    else:
        devs = [resolve_device(device)] * n
    grid = np.empty(n, object)
    grid[:] = devs
    return Mesh(grid.reshape(shape), axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 = 256 positions a pod, axes ``("data", "model")``;
    ``multi_pod`` adds a leading 2-pod axis ``"pod"`` (512).

    ``device=None`` takes 256 (or 512) CUDA devices and raises where there
    are fewer.  ``device="meta"`` (the dry-run's), ``"cuda"`` or ``"cpu"``
    names that one device at every position."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, device)


def make_host_mesh(dp: int = 1, tp: int = 1, device=None) -> Mesh:
    """A ``(dp, tp)`` mesh with axes ``("data", "model")``.

    ``device=None`` takes the first ``dp * tp`` CUDA devices, one a
    position, and raises where there are fewer (as the reference does).  A
    device (``"cpu"``, ``"cuda"``, ``"cuda:1"``) names that one device at
    every position: the shards then run one after another on it, which is
    how a multi-shard mesh runs on the CPU or on one card.
    """
    return _grid((dp, tp), ("data", "model"), device)
