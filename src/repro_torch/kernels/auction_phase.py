"""Wrappers of the CUDA auction-phase kernels: ``csrc/auction_phase.cu``
(factored values) and ``csrc/auction_phase_dense.cu`` (an explicit cost
stack), both instantiations of ``csrc/auction_phase.cuh``.

Each launch runs whole epsilon phases of the auction on the card, one CTA
per group: the counterpart of the JAX ``lax.while_loop`` in
``repro/core/assignment.py``'s ``_auction_phase``, over the factored
reduction (:func:`auction_phase`, the ``"auction_fused"`` solver of the
stream route; one phase a launch) or over ``_top2_batched`` of a dense
cost (:func:`auction_phase_dense`, the ``"auction"`` solver of the default
flat route and the stacked route; a LAP's P phases a launch, its cost
staged on chip once).  A CUDA tensor launches the kernel (or raises); a CPU
tensor runs the plain version, the port's Python round loop
``repro_torch.kernels.ref.auction_rounds`` over the same reduction, phase
after phase.  Launches are counted in ``_build.launches["auction_phase"]``
and ``["auction_phase_dense"]``; the rounds and bids both kernels ran are
summed on the card and read by :func:`totals`.  :func:`auction_phase_timed`
and :func:`auction_phase_dense_timed` run the kernels' timed
instantiations, which also record the SM clock cycles of every round of
group 0 (measurement only).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import auction_phase_dense_ref, auction_phase_ref

# (CUDA device index, stream) -> int64 [rounds, bids, ticket, single-bidder
# rounds]: one set a stream, so that launches running at once on two
# streams (an engine's dispatch beside the caller's work) never share the
# ticket that finds a launch's last CTA
_totals: dict[tuple[int, int], torch.Tensor] = {}


def auction_phase(x, c, is_real, prices, eps, max_rounds: int,
                  fixed_rounds: int = 0, skip=None, seed_top2=None):
    """One epsilon phase of the factored auction on each group of a stack.

    x, c (G, n, d) float32 rows and centroids (cost ``-2 x_i.c_j +
    ||c_j||^2``, dummy rows 0); ``is_real`` (G, n) bool or None; prices
    (G, n) float32; eps (G,) float32; ``skip`` (G,) bool or None (rows of
    those groups start on the identity); ``seed_top2`` (v1, j1, v2), each
    (G, n), the first round's reduction, or None.  Returns ``(assign (G, n)
    int64 with -1 for an unassigned row, prices (G, n))``.
    """
    _check_shapes(x, c, is_real, prices, eps, skip, seed_top2)
    if not x.is_cuda:
        return auction_phase_ref(x, c, is_real, prices, eps, max_rounds,
                                 fixed_rounds, skip, seed_top2)
    return _launch(x, c, is_real, prices, eps, max_rounds, fixed_rounds,
                   skip, seed_top2)


def auction_phase_timed(x, c, is_real, prices, eps, max_rounds: int,
                        fixed_rounds: int = 0, skip=None, seed_top2=None, *,
                        trace_rounds: int, threshold: int = -1):
    """:func:`auction_phase` through the kernel's timed instantiation, for
    measurement only (``chip_smoke.py``; the solver never calls it).

    Also returns ``trace`` (trace_rounds, 7) int64: row r holds (bidders,
    SM clock cycles, 1 if the round ran in the one-warp path else 0, the
    cycles of its three steps: the top-2s, posting the bids, the update,
    and the bidders whose values came from cost rows staged in shared
    memory, 0 for the factored kernel) of group 0's round r, counted over
    the launch's phases, or -1 past its rounds.
    ``threshold`` >= 0 sets the most bidders a round may have to take the
    one-warp path (up to 32); -1 keeps the kernel's own crossover.  CUDA
    tensors only: there is no plain version of a clock.
    """
    _check_shapes(x, c, is_real, prices, eps, skip, seed_top2)
    trace = _trace(x, trace_rounds, threshold)
    assign, p_out = _launch(x, c, is_real, prices, eps, max_rounds,
                            fixed_rounds, skip, seed_top2,
                            timed=(trace.data_ptr(), trace_rounds, threshold))
    return assign, p_out, trace


def auction_phase_dense(cost, prices, eps, max_rounds: int,
                        fixed_rounds: int = 0, skip=None, seed_top2=None):
    """The P epsilon phases of the dense-cost auction on each group of a
    stack, phase after phase, in one launch.

    cost (G, n, n) float32, finite (dummy rows zeroed by the caller);
    prices (G, n) float32, the first phase's; eps (P, G) float32, the
    schedule; ``skip`` (P, G) bool or None (in phase p the rows of the
    groups ``skip[p]`` marks start on the identity); ``seed_top2`` (v1, j1,
    v2), each (G, n), the first phase's first reduction, or None.  Every
    phase starts with every row unassigned and the prices of the phase
    before; ``max_rounds`` and ``fixed_rounds`` hold in each.  Returns the
    last phase's ``(assign (G, n) int64 with -1 for an unassigned row,
    prices (G, n))``, bitwise those of ``ref.auction_rounds`` over
    ``ref.top2`` of ``cost - p``, phase after phase.
    """
    _check_dense_shapes(cost, prices, eps, skip, seed_top2)
    if not cost.is_cuda:
        return auction_phase_dense_ref(cost, prices, eps, max_rounds,
                                       fixed_rounds, skip, seed_top2)
    return _launch_dense(cost, prices, eps, max_rounds, fixed_rounds, skip,
                         seed_top2)


def auction_phase_dense_timed(cost, prices, eps, max_rounds: int,
                              fixed_rounds: int = 0, skip=None,
                              seed_top2=None, *, trace_rounds: int,
                              threshold: int = -1):
    """:func:`auction_phase_dense` through the dense kernel's timed
    instantiation, for measurement only: ``trace`` and ``threshold`` as in
    :func:`auction_phase_timed`, the trace's rows running on over the
    launch's phases.  CUDA tensors only."""
    _check_dense_shapes(cost, prices, eps, skip, seed_top2)
    trace = _trace(cost, trace_rounds, threshold)
    assign, p_out = _launch_dense(
        cost, prices, eps, max_rounds, fixed_rounds, skip, seed_top2,
        timed=(trace.data_ptr(), trace_rounds, threshold))
    return assign, p_out, trace


def _trace(t, trace_rounds: int, threshold: int) -> torch.Tensor:
    """The timed instantiations' (trace_rounds, 7) int64 trace, all -1."""
    if not t.is_cuda:
        raise ValueError("the timed phase kernels time the CUDA kernel; "
                         "they take CUDA tensors")
    if not 0 <= trace_rounds < 2**31 or not -1 <= threshold < 2**31:
        raise ValueError("the timed phase kernels: trace_rounds >= 0 and "
                         "threshold >= -1 must fit int32")
    return torch.full((trace_rounds, 7), -1, dtype=torch.int64,
                      device=t.device)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _operands(kernel, G, max_rounds, fixed_rounds, skip, seed_top2,
              **tensors):
    """Check the launch's integers and operands; returns (the seed's
    tensors by name, the current stream's handle)."""
    if G > 2**31 - 1 or not 0 <= max_rounds < 2**31 \
            or not 0 <= fixed_rounds < 2**31:
        raise ValueError(f"{kernel}: G, max_rounds and fixed_rounds must "
                         f"fit int32")
    seed = {} if seed_top2 is None else dict(zip(("v1", "j1", "v2"),
                                                 seed_top2))
    stream = _build.check_operands(
        kernel, **{k: t for k, t in tensors.items() if t is not None},
        **({} if skip is None else {"skip": skip}), **seed)
    return seed, stream


def _outputs(G, n, dev, stream, P=1):
    """(assign, prices, per-phase and group rounds, the stream's
    counters)."""
    counters = _totals.get((dev.index, stream))
    if counters is None:
        counters = _totals[(dev.index, stream)] = torch.zeros(
            4, dtype=torch.int64, device=dev)
    return (torch.empty((G, n), dtype=torch.int64, device=dev),
            torch.empty((G, n), dtype=torch.float32, device=dev),
            torch.empty((P, G), dtype=torch.int64, device=dev), counters)


def _launch(x, c, is_real, prices, eps, max_rounds, fixed_rounds, skip,
            seed_top2, timed=()):
    G, n, d = x.shape
    seed, stream = _operands("auction_phase", G, max_rounds, fixed_rounds,
                             skip, seed_top2, x=x, c=c, prices=prices,
                             eps=eps, is_real=is_real)
    assign, p_out, rounds, counters = _outputs(G, n, x.device, stream)
    # what does not fit in shared memory (the kernel decides): c
    # feature-major with a row of column terms, (d + 1, n rounded up to
    # 4), and the per-row state, 10 words a row
    scratch = torch.empty(G * (10 * n + (d + 1) * ((n + 3) & ~3)),
                          dtype=torch.float32, device=x.device)
    _build.launch("auction_phase", x.data_ptr(), c.data_ptr(), _ptr(is_real),
                  prices.data_ptr(), eps.data_ptr(), _ptr(skip),
                  _ptr(seed.get("v1")), _ptr(seed.get("j1")),
                  _ptr(seed.get("v2")), assign.data_ptr(), p_out.data_ptr(),
                  rounds.data_ptr(), counters.data_ptr(), scratch.data_ptr(),
                  G, n, d, max_rounds, fixed_rounds, *timed, stream,
                  symbol="auction_phase_timed_f32" if timed else None)
    return assign, p_out


def _launch_dense(cost, prices, eps, max_rounds, fixed_rounds, skip,
                  seed_top2, timed=()):
    G, n, _ = cost.shape
    P = eps.shape[0]
    seed, stream = _operands("auction_phase_dense", G, max_rounds,
                             fixed_rounds, skip, seed_top2, cost=cost,
                             prices=prices, eps=eps)
    assign, p_out, rounds, counters = _outputs(G, n, cost.device, stream,
                                               P)
    # the per-row state where it does not fit in shared memory (the kernel
    # decides), 10 words a row
    scratch = torch.empty(G * 10 * n, dtype=torch.float32, device=cost.device)
    _build.launch("auction_phase_dense", cost.data_ptr(), prices.data_ptr(),
                  eps.data_ptr(), _ptr(skip), _ptr(seed.get("v1")),
                  _ptr(seed.get("j1")), _ptr(seed.get("v2")),
                  assign.data_ptr(), p_out.data_ptr(), rounds.data_ptr(),
                  counters.data_ptr(), scratch.data_ptr(), G, n, P,
                  max_rounds, fixed_rounds, *timed, stream,
                  symbol="auction_phase_dense_timed_f32" if timed else None)
    return assign, p_out


def _check_shapes(x, c, is_real, prices, eps, skip, seed_top2):
    if x.dim() != 3 or c.shape != x.shape:
        raise ValueError(f"auction_phase takes (G, n, d) rows and centroids "
                         f"of one shape; got {tuple(x.shape)}, "
                         f"{tuple(c.shape)}")
    G, n, d = x.shape
    if n < 1 or d < 1:
        raise ValueError(f"auction_phase: empty problem {tuple(x.shape)}")
    _check_state("auction_phase", G, n, prices, eps, skip, seed_top2,
                 is_real=(is_real, (G, n), torch.bool))


def _check_dense_shapes(cost, prices, eps, skip, seed_top2):
    if cost.dim() != 3 or cost.shape[1] != cost.shape[2] \
            or cost.dtype != torch.float32:
        raise ValueError(f"auction_phase_dense takes a (G, n, n) float32 "
                         f"cost stack; got {cost.dtype} "
                         f"{tuple(cost.shape)}")
    G, n, _ = cost.shape
    if n < 1:
        raise ValueError(f"auction_phase_dense: empty problem "
                         f"{tuple(cost.shape)}")
    if eps.dim() != 2 or not 1 <= eps.shape[0] < 2**31:
        raise ValueError(f"auction_phase_dense: eps is the (P, G) schedule "
                         f"of P >= 1 phases, got {tuple(eps.shape)}")
    _check_state("auction_phase_dense", G, n, prices, eps, skip, seed_top2,
                 phases=(eps.shape[0],))


def _check_state(kernel, G, n, prices, eps, skip, seed_top2, phases=(),
                 **more):
    """The per-group operands both kernels take: prices, eps and ``skip``
    (one per group, or per phase and group with ``phases`` = (P,)),
    ``seed_top2`` (and ``more``: name -> (tensor, shape, dtype))."""
    want = {"prices": (prices, (G, n), torch.float32),
            "eps": (eps, (*phases, G), torch.float32),
            **more,
            "skip": (skip, (*phases, G), torch.bool)}
    if seed_top2 is not None:
        if len(seed_top2) != 3:
            raise ValueError(f"{kernel}: seed_top2 is (v1, j1, v2)")
        for name, t, dtype in zip(("v1", "j1", "v2"), seed_top2,
                                  (torch.float32, torch.int64,
                                   torch.float32)):
            want[name] = (t, (G, n), dtype)
    for name, (t, shape, dtype) in want.items():
        if t is not None and (tuple(t.shape) != shape or t.dtype != dtype):
            raise ValueError(f"{kernel}: {name} must be {dtype} of "
                             f"shape {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")


def totals() -> dict:
    """Rounds, bids and rounds with a single bidder that the kernels ran since
    :func:`reset_totals`, summed over devices (a read from the card).  A
    launch on a stack adds, for each of its phases, its longest group's
    rounds, as the Python loop over the stack counts them, and every
    group's bids and single-bidder rounds; summed over streams too."""
    out = {"rounds": 0, "bids": 0, "single_bidder_rounds": 0}
    for t in _totals.values():
        r, b, _, s = t.tolist()
        out["rounds"] += r
        out["bids"] += b
        out["single_bidder_rounds"] += s
    return out


def reset_totals() -> None:
    for t in _totals.values():
        t.zero_()
