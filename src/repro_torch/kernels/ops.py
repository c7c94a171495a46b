"""Kernel dispatch: which path a call takes, and the dispatching entry points.

Counterpart of ``repro/kernels/ops.py``.  The rule is the tensor's device:
a CUDA tensor takes the hand-written kernel (``"cuda"``), a CPU tensor the
plain PyTorch version (``"ref"``), a ``meta`` tensor (the dry-run's, which
holds no data) the count (``"meta"``): ``ssm_scan`` and its backward
return empty outputs of the kernels' shapes and dtypes and add the
kernel's operations and bytes (the counts of its bound in ``PERF.md`` §6)
to each counter registered by :func:`meta_counter`; the ABA dispatchers
raise there, since the batch scan around them reads the device
(``core/aba.py``'s ``.tolist()``).  The :func:`forced_path` context selects
the plain version on the card too; it exists so that ``chip_smoke.py`` can
run the whole path against the plain versions, the counterpart of JAX's
``force=``.  The wrappers under the dispatchers take their plain version
only for a CPU tensor, where the rule gives ``"ref"`` too; on a CUDA tensor
they launch their kernel or raise.

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

``ssm_scan`` is the selective scan the Mamba block runs (the counterpart
of ``ssm_scan_pallas``): one launch over the whole sequence on the card,
the step-by-step ``ref.ssm_scan_ref`` on the plain path.  It is an
autograd Function on both paths: where grad is enabled and an input
requires it, the card's launch also saves the state entering every tile
of 16 steps, and the backward is one launch of ``csrc/ssm_scan_bwd.cu``
(``ref.ssm_scan_bwd_ref``, the same reverse walk written out, on the
plain path).  Otherwise it launches what serving launches and keeps
nothing.
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
                                     gather_rows_ref, ssm_scan_bwd_ref,
                                     ssm_scan_ref)
from repro_torch.kernels.ssm_scan import ssm_scan as _ssm_scan
from repro_torch.kernels.ssm_scan import ssm_scan_bwd as _ssm_scan_bwd
from repro_torch.kernels.ssm_scan import ssm_scan_train as _ssm_scan_train

_GATHER_FUSE_MAX_D = 512  # the reference's full-row limit of the fused kernels

_forced: str | None = None
_meta_counters: list = []


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


@contextlib.contextmanager
def meta_counter(counter):
    """Within the block the ``meta`` path calls ``counter.add_kernel(name,
    flops, n_bytes)`` once a kernel it stands in for."""
    _meta_counters.append(counter)
    try:
        yield counter
    finally:
        _meta_counters.remove(counter)


def _count_meta(name: str, flops: int, n_bytes: int) -> None:
    for counter in _meta_counters:
        counter.add_kernel(name, flops, n_bytes)


def resolve_path(t: torch.Tensor) -> str:
    """``"meta"`` for a ``meta`` tensor, ``"cuda"`` for a CUDA tensor,
    ``"ref"`` for a CPU tensor or inside :func:`forced_path`.  The single
    copy of the rule; every dispatcher branches on it."""
    if t.is_meta:
        return "meta"
    if _forced == "ref" or not t.is_cuda:
        return "ref"
    return "cuda"


def gather_path(t: torch.Tensor) -> str:
    """:func:`resolve_path` for the ABA dispatchers, which raise on a
    ``meta`` tensor: their callers read the device between launches."""
    path = resolve_path(t)
    if path == "meta":
        raise ValueError(
            "the ABA kernels cannot run on meta tensors: the batch scan "
            "around them reads the device (core/aba.py's .tolist())")
    return path


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
        if gather_path(x) == "ref" or x.shape[1] > _GATHER_FUSE_MAX_D:
            return cdist(gather_rows(x, idx), c)
        return _gather.cdist_gather(x, idx, c)
    lead = x.shape[:-2]
    if lead:
        x = x.reshape(-1, x.shape[-1])
    out = cdist_ref(x, c) if gather_path(x) == "ref" else _cdist(x, c)
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
        if gather_path(x) == "ref" or x.shape[1] > _GATHER_FUSE_MAX_D:
            return bid_top2(gather_rows(x, idx), c, prices)
        return _gather.bid_top2_gather(x, idx, c, prices)
    if gather_path(x) == "ref":
        return bid_top2_ref(x, c, prices)
    return _bid_top2(x, c, prices)


def bid_top2_span(x: torch.Tensor, c: torch.Tensor):
    """``(bid_top2(x, c, 0), bid_top2(-x, c, 2 ||c||^2))`` on a stacked
    ``(G, m, d) x (G, k, d)``: one launch on the card at any G, the two
    plain calls on the plain path."""
    if gather_path(x) == "ref":
        return bid_top2_span_ref(x, c)
    return _bid_top2_span(x, c)


def auction_phase(x: torch.Tensor, c: torch.Tensor, is_real, prices, eps,
                  max_rounds: int, fixed_rounds: int = 0, *, skip=None,
                  seed_top2=None, return_rounds: bool = False):
    """One epsilon phase of the factored auction on a (G, n, d) stack (see
    ``kernels.auction_phase.auction_phase``); returns (assign, prices), and
    with ``return_rounds`` the (1, G) rounds of each group."""
    if gather_path(x) == "ref":
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
    if gather_path(cost) == "ref":
        return auction_phase_dense_ref(cost, prices, eps, max_rounds,
                                       fixed_rounds, skip, seed_top2,
                                       return_rounds)
    return _auction_phase_dense(cost, prices, eps, max_rounds, fixed_rounds,
                                skip, seed_top2, return_rounds)


def _ssm_meta_forward(dt, b_in, a_mat, save: bool):
    """The ``meta`` path of the forward: empty y (B, S, di) and h (B, di,
    ds), float32, and the counts of the kernel's bound: dt, x, y and B, C
    once, A, the final h; 7 operations a state and step and one a channel
    and step.  The saving launch also writes h every 16 steps."""
    bsz, s, di = dt.shape
    ds = a_mat.shape[1]
    n_bytes = 4 * (3 * bsz * s * di + 2 * bsz * s * ds + di * ds
                   + bsz * di * ds)
    if save:
        n_bytes += 4 * bsz * -(-s // 16) * di * ds
    _count_meta("ssm_scan", 7 * bsz * s * di * ds + bsz * s * di, n_bytes)
    return (torch.empty((bsz, s, di), dtype=torch.float32, device="meta"),
            torch.empty((bsz, di, ds), dtype=torch.float32, device="meta"))


def _ssm_meta_backward(dt, b_in, a_mat):
    """The ``meta`` path of the backward: empty gradients of the five
    inputs' shapes, and the counts of ``ssm_scan_bwd``'s bound: dt, x, dy
    read and d(dt), dx written; B, C and their gradients; the states saved
    every 16 steps; A, dA, dh and dh0; 20 operations a state and step."""
    bsz, s, di = dt.shape
    ds = a_mat.shape[1]
    n_bytes = 4 * (5 * bsz * s * di + 4 * bsz * s * ds
                   + bsz * -(-s // 16) * di * ds + 2 * di * ds
                   + 2 * bsz * di * ds)
    _count_meta("ssm_scan_bwd", 20 * bsz * s * di * ds, n_bytes)
    return tuple(torch.empty(shape, dtype=torch.float32, device="meta")
                 for shape in (dt.shape, b_in.shape, b_in.shape, dt.shape,
                               a_mat.shape))


class SSMScan(torch.autograd.Function):
    """:func:`ssm_scan` with its gradient.  ``path`` is the dispatch's
    (``"cuda"``, ``"ref"`` or ``"meta"``); ``save`` whether a backward will
    follow, decided by the caller, since grad is off inside ``forward``."""

    @staticmethod
    def forward(ctx, path, save, dt, b_in, c_out, x_in, a_mat):
        states = None
        if path == "meta":
            out = _ssm_meta_forward(dt, b_in, a_mat, save)
        elif path == "ref":
            out = ssm_scan_ref(dt, b_in, c_out, x_in, a_mat)
        elif save:
            y, h, states = _ssm_scan_train(dt, b_in, c_out, x_in, a_mat)
            out = (y, h)
        else:
            out = _ssm_scan(dt, b_in, c_out, x_in, a_mat)
        if save:
            ctx.path = path
            ctx.save_for_backward(dt, b_in, c_out, x_in, a_mat, states)
        return out

    @staticmethod
    def backward(ctx, dy, dh):
        dt, b_in, c_out, x_in, a_mat, states = ctx.saved_tensors
        bsz, di, ds = dt.shape[0], *a_mat.shape
        dy = torch.zeros_like(dt) if dy is None else dy.contiguous()
        dh = (dt.new_zeros((bsz, di, ds)) if dh is None
              else dh.contiguous())
        if ctx.path == "meta":
            grads = _ssm_meta_backward(dt, b_in, a_mat)
        elif ctx.path == "ref":
            grads = ssm_scan_bwd_ref(dt, b_in, c_out, x_in, a_mat, dy, dh)
        else:
            grads = _ssm_scan_bwd(dt, b_in, c_out, x_in, a_mat, states, dy,
                                  dh)[:5]
        return (None, None, *grads)


def ssm_scan(dt: torch.Tensor, b_in, c_out, x_in, a_mat):
    """The selective scan from ``h0 = 0``: dt, x_in (B, S, di); b_in, c_out
    (B, S, ds); a_mat (di, ds) -> (y (B, S, di), h_final (B, di, ds)), all
    float32 (see ``kernels.ssm_scan.ssm_scan``), through :class:`SSMScan`:
    differentiable in all five inputs."""
    args = (dt, b_in, c_out, x_in, a_mat)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in args)
    return SSMScan.apply(resolve_path(dt), save, *args)
