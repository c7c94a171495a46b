"""Linear assignment by the Jacobi auction, in PyTorch.

Counterpart of ``repro/core/assignment.py``: the batched forward auction
with epsilon scaling, its dense form (``auction_solve``, the top-2 of an
explicit ``(B, n, n)`` cost stack) and its matrix-free form
(``auction_solve_factored``, whose every bidding round is one
``bid_top2`` kernel launch on ``cost = -2 x.c^T + ||c||^2``), and the solver
registry holding ``"auction"`` and ``"auction_fused"``.  All solvers
MAXIMIZE total cost.

Differences from the JAX engine, none of which changes a result:

* The phase loop is a Python loop.  Its predicate ("some row is still
  unassigned") is a device-to-host read, so it is tested only every
  ``_CHECK_EVERY`` rounds.  A converged state is a fixed point of the round
  (no unassigned row, no bid, no update), so the extra rounds change
  nothing, and the ``max_rounds`` cap is still honoured exactly.
* The epsilon schedule is computed per instance on the host from the span,
  so an instance's schedule, and with it its whole solve, does not depend
  on how many instances share the stack: a stacked solve equals the same
  instances solved one by one, bit for bit.  (The JAX factored path misses
  this by one ulp of the span; see ROADMAP fault R1.)
* Indices are int64 inside; the public solvers return int32 assignments.
* ``greedy``, ``scipy`` and solver telemetry are not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch._device import DTYPE, as_float, resolve_device
from repro_torch.kernels.ops import bid_top2
from repro_torch.kernels.ref import top2 as _top2_batched

_NEG = -1e30  # sentinel "minus infinity" that survives f32 arithmetic

# Warm re-entry slack, as in the JAX engine: only contested value gaps
# beyond this multiple of a phase's eps re-enter the schedule there.
_REENTRY_SLACK = 32.0

# Bidding rounds between two tests of the phase predicate.  Each test is a
# device-to-host read that drains the launch queue; a phase runs tens to
# hundreds of rounds.  Chosen on the H100 by timing R = 1, 8, 16, 32 in
# turns on one streaming chunk (PERF.md): R = 8 was fastest, 16 % under
# R = 1, with 2 % more rounds, the no-op ones.
_CHECK_EVERY = 8

rounds_executed = 0  # bidding rounds run in this process, no-op rounds too


class AuctionConfig(NamedTuple):
    """Epsilon-scaling schedule for the auction solver (as in the JAX one).

    eps runs ``n_phases`` geometric steps from ``span/eps_start_div`` down to
    ``span/(eps_end_mul * n)``; an eps-optimal assignment is within
    ``n * eps`` of the optimum.  ``fixed_rounds > 0`` runs exactly that many
    rounds per phase and never tests the predicate.  ``adaptive_reentry``
    picks where a warm-started solve re-enters the schedule (see
    :func:`_run_phases`).
    """

    n_phases: int = 4
    eps_start_div: float = 8.0
    eps_end_mul: float = 4.0
    max_rounds: int = 0  # 0 -> auto (50 * n + 1000)
    fixed_rounds: int = 0
    adaptive_reentry: bool = True


def _auction_phase(top2_fn, prices, eps, max_rounds: int,
                   fixed_rounds: int = 0, skip=None, seed_top2=None):
    """One epsilon phase of batched Jacobi forward auction (maximization).

    ``top2_fn(prices)`` returns the per-row ``(v1, j1, v2)`` of
    ``cost - prices``, each (B, n).  ``prices`` / ``eps`` are (B, n) / (B,).
    Every row starts unassigned, except in instances marked by ``skip``
    ((B,) bool), whose rows start on the identity and so never bid.
    ``seed_top2`` is the first round's reduction, already computed by the
    caller at the incoming prices.  Returns ``(row_to_col, prices)``.
    """
    global rounds_executed
    B, n = prices.shape
    dev = prices.device
    rows = torch.arange(n, device=dev).expand(B, n)
    # Column n of these buffers is a dump slot: a scatter to it is the JAX
    # ``mode="drop"``, and an unassigned row (-1) reads it as "no object".
    assign_ext = torch.full((B, n + 1), -1, dtype=torch.int64, device=dev)
    assign = assign_ext[:, :n]
    if skip is not None:
        assign.copy_(torch.where(skip[:, None], rows, -1))
    eps = eps[:, None]

    # The round below is the JAX round with fewer launches (this loop is
    # launch-bound) and the same results: rows that hold an object bid
    # -inf, below the NEG floor of every object's best bid, so they are
    # never the best bidder; and the lost-object test reads got_bid through
    # the dump column, which is False.
    def body(prices, top2):
        v1, j1, v2 = top2
        # Bid: raise the favourite object's price past the runner-up by eps.
        bids = v1 + prices.gather(1, j1) - v2 + eps
        bid_val = bids.masked_fill_(assign >= 0, -math.inf)
        # Per-object best bid, and the lowest row that made it.
        best = prices.new_full((B, n), _NEG).scatter_reduce_(
            1, j1, bid_val, "amax", include_self=True)
        cand = torch.where(bid_val >= best.gather(1, j1), rows, n)
        winner = torch.full((B, n + 1), n, dtype=torch.int64,
                            device=dev).scatter_reduce_(
            1, j1, cand, "amin", include_self=True)
        got_bid = winner < n  # (B, n + 1); the dump column is False
        # A row whose object got a bid loses it.  (It did not bid, so it
        # cannot be the winner.)
        assign.masked_fill_(got_bid.gather(1, assign.remainder(n + 1)), -1)
        winner = winner[:, :n]
        assign_ext.scatter_(1, winner, rows)  # winners take their objects
        return torch.where(got_bid[:, :n], best, prices)

    it = 0
    if seed_top2 is not None:
        prices = body(prices, seed_top2)
        it = 1
    if fixed_rounds:
        for _ in range(max(fixed_rounds - it, 0)):
            prices = body(prices, top2_fn(prices))
        rounds_executed += fixed_rounds
        return assign, prices
    while it < max_rounds and bool((assign < 0).any()):
        for _ in range(min(_CHECK_EVERY, max_rounds - it)):
            prices = body(prices, top2_fn(prices))
            it += 1
    rounds_executed += it
    return assign, prices


def _eps_schedule(span: torch.Tensor, n: int, config: AuctionConfig):
    """(B,) span -> (n_phases, B) geometric epsilon schedule.

    Computed per instance in double precision on the host, so that no
    instance's schedule depends on the others in the stack.
    """
    n_phases = max(int(config.n_phases), 1)
    sched = []
    for s in span.tolist():
        hi = s / config.eps_start_div
        lo = s / (config.eps_end_mul * n)
        if n_phases > 1:
            ratio = (lo / hi) ** (1.0 / (n_phases - 1))
            sched.append([hi * ratio ** p for p in range(n_phases)])
        else:
            sched.append([lo])
    return torch.tensor(sched, dtype=DTYPE).T.contiguous().to(span.device)


def _run_phases(top2_fn, eps_sched, n: int, config: AuctionConfig,
                prices0=None):
    """Run the eps-scaling schedule; returns (assignment, final prices).

    ``prices0`` ((B, n)) warm-starts the solve.  An instance whose incoming
    prices are all zero runs the full ramp, exactly as ``prices0=None``.  An
    instance with carried prices re-enters the schedule adaptively: one
    probe round at the carried prices measures the largest value gap a row
    stands to lose on a contested object, and the instance sits out every
    phase (but the last) whose eps exceeds that gap over ``_REENTRY_SLACK``.
    The probe's reduction becomes the first phase's first round.  The last
    phase always runs, so the ``n * eps_lo`` bound holds either way.
    """
    B = eps_sched.shape[1]
    n_phases = eps_sched.shape[0]
    max_rounds = config.max_rounds or (50 * n + 1000)
    if prices0 is None:
        prices = eps_sched.new_zeros((B, n))
        for p in range(n_phases):
            assign, prices = _auction_phase(top2_fn, prices, eps_sched[p],
                                            max_rounds, config.fixed_rounds)
        return _repair_permutation(assign), prices

    prices = prices0.to(DTYPE)
    is_warm = (prices != 0.0).any(dim=1)
    probe = None
    if config.adaptive_reentry:
        probe = top2_fn(prices)
        v1, j1, v2 = probe
        demand = torch.zeros_like(v1).scatter_add_(1, j1, torch.ones_like(v1))
        contested = demand.gather(1, j1) > 1.0
        infeas = torch.where(contested, v1 - v2, 0.0).amax(dim=1)
        reentry = torch.minimum(
            torch.maximum(infeas / _REENTRY_SLACK, eps_sched[-1]), eps_sched[0])
    else:
        # legacy fixed shortcut: warm instances skip all but the last phase
        reentry = torch.full((B,), -math.inf, device=prices.device)
    for p in range(n_phases):
        last = p == n_phases - 1
        skip = None if last else is_warm & (eps_sched[p] > reentry)
        assign, prices = _auction_phase(
            top2_fn, prices, eps_sched[p], max_rounds, config.fixed_rounds,
            skip=skip, seed_top2=probe if p == 0 else None)
    return _repair_permutation(assign), prices


def _repair_permutation(assign: torch.Tensor) -> torch.Tensor:
    """Fill any ``-1`` rows with the unused columns (order-preserving)."""
    used = torch.zeros_like(assign).scatter_add_(
        1, assign.clamp(min=0), (assign >= 0).long()) > 0
    free_cols = torch.argsort(used.to(torch.int8), dim=1, stable=True)
    need = assign < 0
    slot = (torch.cumsum(need, dim=1) - 1).clamp(min=0)
    return torch.where(need, free_cols.gather(1, slot), assign)


def _solve_dense(cost, config: AuctionConfig, prices=None):
    """(B, n, n) float32 -> ((B, n) int64 assignment, (B, n) prices)."""
    B, n, _ = cost.shape
    if n == 1:
        return (torch.zeros((B, 1), dtype=torch.int64, device=cost.device),
                cost.new_zeros((B, 1)) if prices is None else prices.to(DTYPE))
    finite = torch.where(cost <= _NEG / 2, 0.0, cost)
    span = (finite.amax(dim=(1, 2)) - finite.amin(dim=(1, 2))).clamp(min=1e-6)

    def top2_fn(p):
        return _top2_batched(cost - p[:, None, :])

    return _run_phases(top2_fn, _eps_schedule(span, n, config), n, config,
                       prices)


def _solve_factored(x, c, is_real, config: AuctionConfig, prices=None):
    """Matrix-free auction on (G, n, d) rows x (G, n, d) centroids.

    ``is_real`` ((G, n) bool, or None when every row is real) marks dummy
    rows, whose cost is the neutral constant 0.  Returns int64 assignments
    and the final prices.
    """
    G, n, _ = x.shape
    if n == 1:
        return (torch.zeros((G, 1), dtype=torch.int64, device=x.device),
                x.new_zeros((G, 1)) if prices is None else prices.to(DTYPE))
    # Span for the eps schedule: the max of the cost is bid_top2 at zero
    # prices, its min the max of the negated values (x -> -x, p = 2||c||^2).
    # ||c||^2 is summed group by group so that it does not depend on G.
    cn = torch.stack([(cg * cg).sum(dim=-1) for cg in c])
    hi_v1 = bid_top2(x, c, x.new_zeros((G, n)))[0]
    lo_v1 = bid_top2(-x, c, 2.0 * cn)[0]
    if is_real is None:
        hi = hi_v1.amax(dim=1)
        lo = -lo_v1.amax(dim=1)
    else:
        any_dummy = (~is_real).any(dim=1)
        hi = torch.where(is_real, hi_v1, _NEG).amax(dim=1)
        lo = -torch.where(is_real, lo_v1, _NEG).amax(dim=1)
        hi = torch.where(any_dummy, hi.clamp(min=0.0), hi)
        lo = torch.where(any_dummy, lo.clamp(max=0.0), lo)
    span = (hi - lo).clamp(min=1e-6)

    def top2_fn(p):
        v1, j1, v2 = bid_top2(x, c, p)
        if is_real is not None:
            # dummy rows all see value -p: one (G,) top-2 per group
            dv1, dj1, dv2 = _top2_batched(-p)
            v1 = torch.where(is_real, v1, dv1[:, None])
            j1 = torch.where(is_real, j1, dj1[:, None])
            v2 = torch.where(is_real, v2, dv2[:, None])
        return v1, j1, v2

    return _run_phases(top2_fn, _eps_schedule(span, n, config), n, config,
                       prices)


def auction_solve(cost, config: AuctionConfig = AuctionConfig(), *,
                  prices=None, return_prices: bool = False, device=None):
    """eps-optimal max-cost assignment of an (n, n) matrix or (B, n, n) stack.

    Returns ``row_to_col`` (int32, (n,) or (B, n)); instance b of a stack
    gets exactly ``auction_solve(cost[b])``.  ``prices`` ((n,) / (B, n))
    warm-starts the schedule; ``return_prices`` also returns the final
    prices.
    """
    dev = resolve_device(device)
    cost = as_float(cost, dev)
    if cost.dim() not in (2, 3) or cost.shape[-1] != cost.shape[-2]:
        raise ValueError(f"cost must be (n, n) or (B, n, n), got "
                         f"{tuple(cost.shape)}")
    squeeze = cost.dim() == 2
    p = None if prices is None else as_float(prices, dev)
    if squeeze:
        cost, p = cost[None], None if p is None else p[None]
    out, p_out = _solve_dense(cost, config, p)
    out = out.to(torch.int32)
    if squeeze:
        out, p_out = out[0], p_out[0]
    return (out, p_out) if return_prices else out


def auction_solve_factored(x, c, *, is_real=None,
                           config: AuctionConfig = AuctionConfig(),
                           prices=None, return_prices: bool = False,
                           device=None):
    """Matrix-free auction on ``cost[i, j] = -2 x_i . c_j + ||c_j||^2``.

    Takes a single ``(n, d) x (n, d)`` problem or a stacked
    ``(G, n, d) x (G, n, d)`` batch; every bidding round is one ``bid_top2``
    launch, so the (n, n) value matrix is never built.  ``is_real`` marks
    real rows (dummy rows cost 0).  Returns ``row_to_col`` int32, plus the
    final prices with ``return_prices``.
    """
    dev = resolve_device(device)
    x, c = as_float(x, dev), as_float(c, dev)
    if x.shape[-2] != c.shape[-2]:
        raise ValueError(f"LAP must be square: {x.shape[-2]} != {c.shape[-2]}")
    squeeze = x.dim() == 2
    p = None if prices is None else as_float(prices, dev)
    r = None if is_real is None else torch.as_tensor(is_real, device=dev)
    if squeeze:
        x, c = x[None], c[None]
        p = None if p is None else p[None]
        r = None if r is None else r[None]
    out, p_out = _solve_factored(x, c, None if r is None else r.bool(),
                                 config, p)
    out = out.to(torch.int32)
    if squeeze:
        out, p_out = out[0], p_out[0]
    return (out, p_out) if return_prices else out


# ---------------------------------------------------------------------------
# Solver registry
# ---------------------------------------------------------------------------

class Solver(NamedTuple):
    """A registered LAP backend for the ABA core.

    ``solve(cost, config, prices=None)`` takes a (B, n, n) float32 stack and
    returns ``(row_to_col, prices)`` as int64 / float32 tensors, maximizing
    total cost.  ``factored(x, c, is_real=..., config=..., prices=...)`` is
    the optional matrix-free path, used whenever the cost factors as
    ``-2 x.c^T + ||c||^2``.
    """

    solve: Callable
    factored: Callable | None = None


_REGISTRY: dict[str, Solver] = {}

_NOT_PORTED = {"greedy": "Queue 1 item 2", "scipy": "Queue 1 item 2"}


def register_solver(name: str, solve: Callable, *,
                    factored: Callable | None = None,
                    overwrite: bool = False) -> Solver:
    """Register a LAP backend under ``name`` (see :class:`Solver`)."""
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"solver {name!r} already registered "
                         f"(pass overwrite=True to replace it)")
    _REGISTRY[name] = Solver(solve=solve, factored=factored)
    return _REGISTRY[name]


def get_solver(name: str) -> Solver:
    if name in _NOT_PORTED and name not in _REGISTRY:
        raise NotImplementedError(
            f"solver {name!r} is not ported to PyTorch yet (ROADMAP "
            f"{_NOT_PORTED[name]})")
    if name not in _REGISTRY:
        raise KeyError(f"unknown solver {name!r}; registered: "
                       f"{available_solvers()}")
    return _REGISTRY[name]


def available_solvers() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _factored_entry(x, c, *, is_real=None, config=AuctionConfig(),
                    prices=None):
    return _solve_factored(x, c, is_real, config, prices)


register_solver("auction", _solve_dense)
register_solver("auction_fused", _solve_dense, factored=_factored_entry)
