"""Device, dtype and matmul-precision policy of the PyTorch port.

Every entry point takes ``device=None``, which means ``"cuda"``.  Where no
CUDA device is present the entry point raises unless the caller asked for
``"cpu"`` explicitly: the port never drops to the CPU silently.  On the CPU
the kernel wrappers run their plain PyTorch versions; on a CUDA device they
launch the hand-written kernels or raise.

The ABA path's arithmetic is float32; a model follows its config
(``compute_dtype``, bfloat16 at full width; the SSM scan is float32).
TF32 is switched off for matmuls and cuDNN: a TF32 product keeps about
three decimal digits, which flips the auction's top-2 argmaxes against the
float32 reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DTYPE = torch.float32


class ShapeDtype(NamedTuple):
    """A shape and a dtype, with no data: the port's
    ``jax.ShapeDtypeStruct`` (the dry-run's abstract arguments)."""
    shape: tuple
    dtype: torch.dtype

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for but absent.
    ``"meta"`` (shapes without data: the dry-run's) passes as asked."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain PyTorch path")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def as_float(a, device: torch.device) -> torch.Tensor:
    """``a`` (array or tensor) as a contiguous float32 tensor on ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=DTYPE).contiguous()
    return torch.as_tensor(np.asarray(a, np.float32), device=device)
