"""Kernel dispatch: which path a call takes, and the dispatching entry points.

Counterpart of ``repro/kernels/ops.py``.  The rule is the tensor's device:
a CUDA tensor takes the hand-written kernel (``"cuda"``), a CPU tensor the
plain PyTorch version (``"ref"``).  The :func:`forced_path` context selects
the plain version on the card too; it exists so that ``chip_smoke.py`` can
run the whole path against the plain versions, the counterpart of JAX's
``force=``.
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import bid_top2 as _bid
from repro_torch.kernels import gather as _gather
from repro_torch.kernels.ref import bid_top2_ref, gather_rows_ref

_forced: str | None = None


@contextlib.contextmanager
def forced_path(path: str):
    """Within the block every dispatch takes ``path`` (only ``"ref"``)."""
    global _forced
    if path != "ref":
        raise ValueError(f'only the plain path can be forced, got {path!r}')
    prev, _forced = _forced, path
    try:
        yield
    finally:
        _forced = prev


def resolve_path(t: torch.Tensor) -> str:
    """``"cuda"`` for a CUDA tensor, ``"ref"`` for a CPU tensor or inside
    :func:`forced_path`.  The single copy of the rule; both dispatchers
    branch on it."""
    if _forced == "ref" or not t.is_cuda:
        return "ref"
    return "cuda"


gather_path = resolve_path  # the row gather follows the same rule


def bid_top2(x: torch.Tensor, c: torch.Tensor, prices: torch.Tensor):
    """Fused auction bidding reduction (v1, j1, v2 per row); flat
    ``(m, d) x (k, d)`` or stacked ``(G, m, d) x (G, k, d)`` with ``(G, k)``
    prices (the stack is a grid axis of the kernel)."""
    if resolve_path(x) == "ref":
        return bid_top2_ref(x, c, prices)
    return _bid.bid_top2(x, c, prices)


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[clip(idx, 0, n - 1)]`` as float32: (n, d), (m,) -> (m, d)."""
    if gather_path(x) == "ref":
        return gather_rows_ref(x, idx)
    return _gather.gather_rows(x, idx)
