"""Mesh constructors of the PyTorch port.

Counterpart of ``repro/launch/mesh.py``'s ``make_host_mesh``; the
production mesh of the dry-run is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.sharding.specs import Mesh


def make_host_mesh(dp: int = 1, tp: int = 1, device=None) -> Mesh:
    """A ``(dp, tp)`` mesh with axes ``("data", "model")``.

    ``device=None`` takes the first ``dp * tp`` CUDA devices, one a
    position, and raises where there are fewer (as the reference does).  A
    device (``"cpu"``, ``"cuda"``, ``"cuda:1"``) names that one device at
    every position: the shards then run one after another on it, which is
    how a multi-shard mesh runs on the CPU or on one card.
    """
    n = dp * tp
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
    return Mesh(grid.reshape(dp, tp), ("data", "model"))
