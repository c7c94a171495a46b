"""Kernel dispatch: which path a call takes, and the dispatching entry points.

Counterpart of ``repro/kernels/ops.py``.  The rule is the tensor's device:
a CUDA tensor takes the hand-written kernel (``"cuda"``), a CPU tensor the
plain PyTorch version (``"ref"``).  The :func:`forced_path` context selects
the plain version on the card too; it exists so that ``chip_smoke.py`` can
run the whole path against the plain versions, the counterpart of JAX's
``force=``.

``bid_top2_span`` is the factored auction's two span bids (x at zero
prices, -x at ``2 ||c||^2``) in one launch.  ``auction_phase`` runs one
epsilon phase of the factored values (the ``"auction_fused"`` solver, which
the stream route runs), ``auction_phase_dense`` every phase of a LAP's
schedule on an explicit cost stack (the ``"auction"`` solver, which the
default flat route and the stacked route run).  On the card each is one
launch of its phase kernel; on the plain path each runs the Python round
loop ``ref.auction_rounds``, over ``bid_top2_ref`` or over ``ref.top2`` of
``cost - p``, phase after phase.

``cdist`` and ``bid_top2`` take the reference's ``idx=``: the rows are
``x[clip(idx, 0, n - 1)]``, read by the fused gather kernels for
``d <= _GATHER_FUSE_MAX_D`` and by ``gather_rows`` followed by the unfused
kernel above it, the reference's dispatch table.  (The reference's jnp path
wraps a negative index the numpy way instead of clipping it; its Pallas
kernels clip, and so does every path here.)
"""

from __future__ import annotations

import contextlib

import torch

from repro_torch.kernels import gather as _gather
from repro_torch.kernels.auction_phase import auction_phase as _auction_phase
from repro_torch.kernels.auction_phase import \
    auction_phase_dense as _auction_phase_dense
from repro_torch.kernels.bid_top2 import bid_top2 as _bid_top2
from repro_torch.kernels.bid_top2 import bid_top2_span as _bid_top2_span
from repro_torch.kernels.cdist import cdist as _cdist
from repro_torch.kernels.ref import (auction_phase_dense_ref,
                                     auction_phase_ref, bid_top2_ref,
                                     bid_top2_span_ref, cdist_ref,
                                     gather_rows_ref)

_GATHER_FUSE_MAX_D = 512  # the reference's full-row limit of the fused kernels

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
    :func:`forced_path`.  The single copy of the rule; every dispatcher
    branches on it."""
    if _forced == "ref" or not t.is_cuda:
        return "ref"
    return "cuda"


gather_path = resolve_path  # the row gather follows the same rule


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[clip(idx, 0, n - 1)]`` as float32: (n, d), (m,) -> (m, d)."""
    if gather_path(x) == "ref":
        return gather_rows_ref(x, idx)
    return _gather.gather_rows(x, idx)


def cdist(x: torch.Tensor, c: torch.Tensor, *,
          idx: torch.Tensor | None = None) -> torch.Tensor:
    """Squared-distance cost matrix ``(..., m, d) x (n, d) -> (..., m, n)``;
    leading chunk dims are flattened into one launch and restored.

    With ``idx`` the rows are ``x[clip(idx)]`` (x must be flat (n, d)),
    gathered inside the fused kernel for ``d <= 512``.
    """
    if idx is not None:
        if x.dim() != 2:
            raise ValueError(f"cdist(idx=) needs flat (n, d) x, got "
                             f"{tuple(x.shape)}")
        if resolve_path(x) == "ref" or x.shape[1] > _GATHER_FUSE_MAX_D:
            return cdist(gather_rows(x, idx), c)
        return _gather.cdist_gather(x, idx, c)
    lead = x.shape[:-2]
    if lead:
        x = x.reshape(-1, x.shape[-1])
    out = cdist_ref(x, c) if resolve_path(x) == "ref" else _cdist(x, c)
    return out.reshape(*lead, -1, out.shape[-1]) if lead else out


def bid_top2(x: torch.Tensor, c: torch.Tensor, prices: torch.Tensor, *,
             idx: torch.Tensor | None = None):
    """Fused auction bidding reduction (v1, j1, v2 per row); flat
    ``(m, d) x (k, d)`` or stacked ``(G, m, d) x (G, k, d)`` with ``(G, k)``
    prices (the stack is a grid axis of the kernel).

    With ``idx`` the rows are ``x[clip(idx)]`` (x must be flat (n, d)),
    gathered inside the fused kernel for ``d <= 512``.
    """
    if idx is not None:
        if x.dim() != 2:
            raise ValueError(f"bid_top2(idx=) needs flat (n, d) x, got "
                             f"{tuple(x.shape)}")
        if resolve_path(x) == "ref" or x.shape[1] > _GATHER_FUSE_MAX_D:
            return bid_top2(gather_rows(x, idx), c, prices)
        return _gather.bid_top2_gather(x, idx, c, prices)
    if resolve_path(x) == "ref":
        return bid_top2_ref(x, c, prices)
    return _bid_top2(x, c, prices)


def bid_top2_span(x: torch.Tensor, c: torch.Tensor):
    """``(bid_top2(x, c, 0), bid_top2(-x, c, 2 ||c||^2))`` on a stacked
    ``(G, m, d) x (G, k, d)``: one launch on the card at any G, the two
    plain calls on the plain path."""
    if resolve_path(x) == "ref":
        return bid_top2_span_ref(x, c)
    return _bid_top2_span(x, c)


def auction_phase(x: torch.Tensor, c: torch.Tensor, is_real, prices, eps,
                  max_rounds: int, fixed_rounds: int = 0, *, skip=None,
                  seed_top2=None, return_rounds: bool = False):
    """One epsilon phase of the factored auction on a (G, n, d) stack (see
    ``kernels.auction_phase.auction_phase``); returns (assign, prices), and
    with ``return_rounds`` the (1, G) rounds of each group."""
    if resolve_path(x) == "ref":
        return auction_phase_ref(x, c, is_real, prices, eps, max_rounds,
                                  fixed_rounds, skip, seed_top2,
                                  return_rounds)
    return _auction_phase(x, c, is_real, prices, eps, max_rounds,
                          fixed_rounds, skip, seed_top2, return_rounds)


def auction_phase_dense(cost: torch.Tensor, prices, eps, max_rounds: int,
                        fixed_rounds: int = 0, *, skip=None, seed_top2=None,
                        return_rounds: bool = False):
    """The P epsilon phases of a (P, G) schedule ``eps`` (``skip`` (P, G) or
    None) of the dense-cost auction on a (G, n, n) cost stack, phase after
    phase (see ``kernels.auction_phase.auction_phase_dense``); returns the
    last phase's (assign, prices), and with ``return_rounds`` the (P, G)
    rounds of every phase and group."""
    if resolve_path(cost) == "ref":
        return auction_phase_dense_ref(cost, prices, eps, max_rounds,
                                       fixed_rounds, skip, seed_top2,
                                       return_rounds)
    return _auction_phase_dense(cost, prices, eps, max_rounds, fixed_rounds,
                                skip, seed_top2, return_rounds)
