"""Linear assignment by the Jacobi auction, in PyTorch.

Counterpart of ``repro/core/assignment.py``: the batched forward auction
with epsilon scaling, its dense form (``auction_solve``, the top-2 of an
explicit ``(B, n, n)`` cost stack, whose whole epsilon schedule is one
launch of the ``auction_phase_dense`` kernel on the card) and its
matrix-free form (``auction_solve_factored`` on ``cost = -2 x.c^T +
||c||^2``, whose every epsilon phase is one launch of the ``auction_phase``
kernel on the card), the delta update's ``solve_restricted_slots``, and
the solver registry holding ``"auction"``, ``"auction_fused"``,
``"greedy"`` and ``"scipy"``.  All solvers MAXIMIZE total cost.

Differences from the JAX engine, none of which changes a result:

* On the card a LAP of the dense solver (the flat and stacked routes) is
  one ``auction_phase_dense`` launch, all its epsilon phases in it; every
  epsilon phase of the factored one (the stream route) is one
  ``auction_phase`` launch.  The plain phase loop, a Python loop
  (``kernels.ref.auction_rounds``), runs both on the CPU and under
  ``ops.forced_path("ref")``, and is the kernels' correctness contract.
  Its predicate ("some row is still unassigned") is a device-to-host
  read, so it is tested only every ``kernels.ref._CHECK_EVERY`` rounds.
  A converged state is a fixed point of the round (no unassigned row, no
  bid, no update), so the extra rounds change nothing, and the
  ``max_rounds`` cap is still honoured exactly.  The phase kernel tests it
  every round, as JAX does.
* The epsilon schedule is ``float32(float64(span) * f_p)`` per instance,
  with factors ``f_p`` of n and the config alone (the reference's
  ``hi * ratio**p`` within one float32 ulp), formed on the device with no
  read to the host.  An instance's schedule, and with it its whole solve,
  does not depend on how many instances share the stack: a stacked solve
  equals the same instances solved one by one, bit for bit.  (The JAX
  factored path misses this by one ulp of the span; see ROADMAP fault
  R1.)
* Indices are int64 inside; the public solvers return int32 assignments.
* ``greedy_solve`` is a Python loop of n masked flat argmaxes on the
  cost's device (n rounds of a few launches each), not a traced loop;
  ``scipy`` is a host round trip (``.cpu()`` -> ``linear_sum_assignment``
  -> the cost's device), registered with ``host_callback=True``.
* The telemetry twins (``return_stats=True``, the registry's
  ``solve_stats`` / ``factored_stats``) give JAX's stats pytree.  Its
  ``rounds`` are the phase kernels' per-group ``rounds_g`` (the plain
  loop's exact per-instance count on the CPU), the longest group's per
  phase, which is what JAX's stacked while loop counts; they stay on the
  device.  A cold solve reports ``reentry`` 0, as JAX's ``prices=None``
  does; the port's engine ``partition`` runs that cold schedule where the
  JAX engine passes zero prices and reports the probe's re-entry epsilon
  (ROADMAP departure P6).
"""

from __future__ import annotations

import functools
import inspect
import math
import warnings
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch._device import DTYPE, as_float, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ops import bid_top2
from repro_torch.kernels.ref import dense_top2, factored_top2

_NEG = -1e30  # sentinel "minus infinity" that survives f32 arithmetic

# Warm re-entry slack, as in the JAX engine: only contested value gaps
# beyond this multiple of a phase's eps re-enter the schedule there.
_REENTRY_SLACK = 32.0



class AuctionConfig(NamedTuple):
    """Epsilon-scaling schedule for the auction solver (as in the JAX one).

    eps runs ``n_phases`` geometric steps from ``span/eps_start_div`` down to
    ``span/(eps_end_mul * n)``; an eps-optimal assignment is within
    ``n * eps`` of the optimum.  ``fixed_rounds > 0`` runs exactly that many
    rounds per phase and never tests the predicate.  ``adaptive_reentry``
    picks where a warm-started solve re-enters the schedule (see
    :func:`_schedule`).
    """

    n_phases: int = 4
    eps_start_div: float = 8.0
    eps_end_mul: float = 4.0
    max_rounds: int = 0  # 0 -> auto (50 * n + 1000)
    fixed_rounds: int = 0
    adaptive_reentry: bool = True


@functools.lru_cache(maxsize=None)
def _eps_factors(n: int, n_phases: int, eps_start_div: float,
                 eps_end_mul: float, device: torch.device) -> torch.Tensor:
    """(n_phases,) float64 ``f_p`` of the schedule ``eps[p] = span * f_p``:
    ``r**p / eps_start_div`` with ``r = (eps_start_div / (eps_end_mul *
    n)) ** (1 / (n_phases - 1))``, or ``1 / (eps_end_mul * n)`` for one
    phase.  They depend on no span, so they are formed on the host once per
    (n, config, device) and kept on the device."""
    if n_phases > 1:
        r = (eps_start_div / (eps_end_mul * n)) ** (1.0 / (n_phases - 1))
        f = [r ** p / eps_start_div for p in range(n_phases)]
    else:
        f = [1.0 / (eps_end_mul * n)]
    return torch.tensor(f, dtype=torch.float64, device=device)


def _eps_schedule(span: torch.Tensor, n: int, config: AuctionConfig):
    """(B,) span -> (n_phases, B) geometric epsilon schedule.

    ``float32(float64(span) * f_p)`` per instance: the products are IEEE
    multiplications by scalars, so no instance's schedule depends on the
    others in the stack, the CPU and the card give the same bits, and the
    schedule is formed on the device with no read to the host.
    """
    f = _eps_factors(n, max(int(config.n_phases), 1),
                     float(config.eps_start_div), float(config.eps_end_mul),
                     span.device)
    return (span.double()[None, :] * f[:, None]).to(DTYPE)


def _schedule(top2_fn, eps_sched, n: int, config: AuctionConfig,
              prices0=None):
    """The phases' starting state: ``(prices, skip, seed_top2)``.

    ``skip`` ((n_phases, B) bool, or None for a cold solve) marks the
    phases an instance sits out; ``seed_top2`` is the first phase's first
    reduction, or None.  ``top2_fn`` is the warm start's probe, plain
    PyTorch ops.

    ``prices0`` ((B, n)) warm-starts the solve.  An instance whose incoming
    prices are all zero runs the full ramp, exactly as ``prices0=None``.  An
    instance with carried prices re-enters the schedule adaptively: one
    probe round at the carried prices measures the largest value gap a row
    stands to lose on a contested object, and the instance sits out every
    phase (but the last) whose eps exceeds that gap over ``_REENTRY_SLACK``.
    The probe's reduction becomes the first phase's first round.  The last
    phase always runs, so the ``n * eps_lo`` bound holds either way.  All
    of it is device work: nothing is read back to the host.

    A fourth element is the telemetry's ``(warm, reentry)``, each (B,), or
    None for a cold solve.
    """
    B = eps_sched.shape[1]
    if prices0 is None:
        return eps_sched.new_zeros((B, n)), None, None, None
    prices = prices0.to(DTYPE)
    is_warm = (prices != 0.0).any(dim=1)
    probe = None
    if config.adaptive_reentry:
        probe = top2_fn(prices)
        reentry = _reentry(probe, eps_sched)
    else:
        # legacy fixed shortcut: warm instances skip all but the last phase
        reentry = torch.full((B,), -math.inf, device=prices.device)
    skip = is_warm[None, :] & (eps_sched > reentry[None, :])
    skip[-1] = False
    return prices, skip, probe, (is_warm, reentry)


def _reentry(probe, eps_sched):
    """(B,) epsilon at which a warm instance re-enters the schedule: the
    largest value gap ``v1 - v2`` a row stands to lose on a contested
    object (the probe's reduction at the carried prices), over
    ``_REENTRY_SLACK``, clipped to ``[eps_lo, eps_hi]``.  The demand
    counts are integer-valued float sums, exact in any order."""
    v1, j1, v2 = probe
    demand = torch.zeros_like(v1).scatter_add_(1, j1, torch.ones_like(v1))
    contested = demand.gather(1, j1) > 1.0
    infeas = torch.where(contested, v1 - v2, 0.0).amax(dim=1)
    return torch.minimum(
        torch.maximum(infeas / _REENTRY_SLACK, eps_sched[-1]), eps_sched[0])


def _max_rounds(n: int, config: AuctionConfig) -> int:
    return config.max_rounds or (50 * n + 1000)


def _repair_permutation(assign: torch.Tensor) -> torch.Tensor:
    """Fill any ``-1`` rows with the unused columns (order-preserving)."""
    used = torch.zeros_like(assign).scatter_add_(
        1, assign.clamp(min=0), (assign >= 0).long()) > 0
    free_cols = torch.argsort(used.to(torch.int8), dim=1, stable=True)
    need = assign < 0
    slot = (torch.cumsum(need, dim=1) - 1).clamp(min=0)
    return torch.where(need, free_cols.gather(1, slot), assign)


def _dense_span(cost: torch.Tensor) -> torch.Tensor:
    """(B, n, n) -> (B,) the span of each instance's finite costs."""
    finite = torch.where(cost <= _NEG / 2, 0.0, cost)
    return (finite.amax(dim=(1, 2)) - finite.amin(dim=(1, 2))).clamp(min=1e-6)


def _zero_stats(B: int, config: AuctionConfig, device) -> dict:
    """The telemetry pytree for solves that run no phases (n == 1)."""
    zeros = torch.zeros((max(int(config.n_phases), 1), B), dtype=DTYPE,
                        device=device)
    return _stats(zeros.long(), zeros, None, None)


def _squeeze_stats(stats: dict) -> dict:
    """Drop the B axis for single-instance (squeezed) solves."""
    return {"rounds": stats["rounds"], "eps": stats["eps"][:, 0],
            "warm": stats["warm"][0], "reentry": stats["reentry"][0],
            "skipped": stats["skipped"][:, 0]}


def _stats(rounds_g, eps_sched, skip, warm) -> dict:
    """JAX's telemetry pytree of one solve, all on the device: ``rounds``
    (P,) int32, the longest group's rounds of each phase (``rounds_g`` is
    (P, B)); ``eps`` (P, B); ``warm`` / ``reentry`` (B,); ``skipped``
    (P, B)."""
    P, B = eps_sched.shape
    dev = eps_sched.device
    if warm is None:
        is_warm = torch.zeros((B,), dtype=torch.bool, device=dev)
        reentry = torch.zeros((B,), dtype=DTYPE, device=dev)
    else:
        is_warm, reentry = warm
    return {"rounds": rounds_g.amax(dim=1).to(torch.int32),
            "eps": eps_sched,
            "warm": is_warm,
            "reentry": reentry,
            "skipped": (torch.zeros((P, B), dtype=torch.bool, device=dev)
                        if skip is None else skip)}


def _solve_dense(cost, config: AuctionConfig, prices=None):
    """(B, n, n) float32 -> ((B, n) int64 assignment, (B, n) prices)."""
    return _dense(cost, config, prices, False)


def _solve_dense_stats(cost, config: AuctionConfig, prices=None):
    """:func:`_solve_dense` and its telemetry: ``(assign, prices, stats)``
    with the same assignment and prices (the launch returns the rounds it
    writes anyway)."""
    return _dense(cost, config, prices, True)


def _dense(cost, config: AuctionConfig, prices, stats: bool):
    B, n, _ = cost.shape
    if n == 1:
        out = (torch.zeros((B, 1), dtype=torch.int64, device=cost.device),
               cost.new_zeros((B, 1)) if prices is None
               else prices.to(DTYPE))
        return out + (_zero_stats(B, config, cost.device),) if stats else out
    cost = cost.contiguous()
    eps_sched = _eps_schedule(_dense_span(cost), n, config)
    prices, skip, seed, warm = _schedule(dense_top2(cost), eps_sched, n,
                                         config, prices)
    # the whole schedule is one dispatch: one dense phase kernel launch on
    # the card, the Python loop over the phases on the CPU
    out = ops.auction_phase_dense(
        cost, prices, eps_sched, _max_rounds(n, config), config.fixed_rounds,
        skip=skip, seed_top2=seed, return_rounds=stats)
    assign, prices = _repair_permutation(out[0]), out[1]
    if not stats:
        return assign, prices
    return assign, prices, _stats(out[2], eps_sched, skip, warm)


def _solve_factored(x, c, is_real, config: AuctionConfig, prices=None):
    """Matrix-free auction on (G, n, d) rows x (G, n, d) centroids.

    ``is_real`` ((G, n) bool, or None when every row is real) marks dummy
    rows, whose cost is the neutral constant 0.  Returns int64 assignments
    and the final prices.
    """
    return _factored(x, c, is_real, config, prices, False)


def _solve_factored_stats(x, c, is_real, config: AuctionConfig,
                          prices=None):
    """:func:`_solve_factored` and its telemetry: ``(assign, prices,
    stats)``, the P one-phase launches' rounds stacked to (P, G)."""
    return _factored(x, c, is_real, config, prices, True)


def _factored(x, c, is_real, config: AuctionConfig, prices, stats: bool):
    G, n, _ = x.shape
    if n == 1:
        out = (torch.zeros((G, 1), dtype=torch.int64, device=x.device),
               x.new_zeros((G, 1)) if prices is None else prices.to(DTYPE))
        return out + (_zero_stats(G, config, x.device),) if stats else out
    # Span for the eps schedule: the max of the cost is bid_top2 at zero
    # prices, its min the max of the negated values (x -> -x, p = 2||c||^2);
    # the two bids are one launch on the card at any G, which forms
    # ||c||^2 itself in an order that does not depend on G.
    (hi_v1, _, _), (lo_v1, _, _) = ops.bid_top2_span(x, c)
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
    eps_sched = _eps_schedule(span, n, config)
    prices, skip, seed, warm = _schedule(
        factored_top2(x, c, is_real, bid_top2), eps_sched, n, config, prices)
    # every phase is one dispatch: the phase kernel on the card, the Python
    # loop on the CPU
    rounds = []
    for p in range(eps_sched.shape[0]):
        out = ops.auction_phase(
            x, c, is_real, prices, eps_sched[p], _max_rounds(n, config),
            config.fixed_rounds, skip=None if skip is None else skip[p],
            seed_top2=seed if p == 0 else None, return_rounds=stats)
        assign, prices = out[:2]
        rounds.extend(out[2:])
    assign = _repair_permutation(assign)
    if not stats:
        return assign, prices
    return assign, prices, _stats(torch.cat(rounds), eps_sched, skip, warm)


def auction_solve(cost, config: AuctionConfig = AuctionConfig(), *,
                  prices=None, return_prices: bool = False,
                  return_stats: bool = False, device=None):
    """eps-optimal max-cost assignment of an (n, n) matrix or (B, n, n) stack.

    Returns ``row_to_col`` (int32, (n,) or (B, n)); instance b of a stack
    gets exactly ``auction_solve(cost[b])``.  ``prices`` ((n,) / (B, n))
    warm-starts the schedule; ``return_prices`` also returns the final
    prices; ``return_stats`` returns ``(row_to_col, prices, stats)``, the
    telemetry pytree of JAX's ``_run_phases`` (the B axis dropped for an
    (n, n) input), with the same assignment and prices.
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
    return _public(_dense(cost, config, p, return_stats), squeeze,
                   return_prices or return_stats)


def _public(out, squeeze: bool, with_prices: bool):
    """A public solver's return: int32 ``row_to_col``, then the prices and
    the stats as asked, the instance axis dropped for a single instance."""
    assign, p_out = out[0].to(torch.int32), out[1]
    stats = out[2] if len(out) > 2 else None
    if squeeze:
        assign, p_out = assign[0], p_out[0]
        stats = None if stats is None else _squeeze_stats(stats)
    if stats is not None:
        return assign, p_out, stats
    return (assign, p_out) if with_prices else assign


def auction_solve_factored(x, c, *, is_real=None,
                           config: AuctionConfig = AuctionConfig(),
                           prices=None, return_prices: bool = False,
                           return_stats: bool = False, device=None):
    """Matrix-free auction on ``cost[i, j] = -2 x_i . c_j + ||c_j||^2``.

    Takes a single ``(n, d) x (n, d)`` problem or a stacked
    ``(G, n, d) x (G, n, d)`` batch; on the card every epsilon phase is one
    ``auction_phase`` launch, so the (n, n) value matrix is never built.
    ``is_real`` marks real rows (dummy rows cost 0).  Returns ``row_to_col``
    int32, plus the final prices with ``return_prices``; ``return_stats``
    returns ``(row_to_col, prices, stats)`` as :func:`auction_solve` does.
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
    return _public(_factored(x, c, None if r is None else r.bool(), config,
                             p, return_stats), squeeze,
                   return_prices or return_stats)


def solve_restricted_slots(cost, mandatory, *, solver: str = "auction",
                           config: AuctionConfig = AuctionConfig(),
                           prices=None, device=None):
    """Frozen-price restricted assignment of m arriving rows over T slots.

    The delta-update subsystem's dense-slot primitive: ``cost`` is the
    (m, T) value of placing each arriving row into each open capacity slot
    (m <= T), ``mandatory`` ((T,) bool) marks slots that MUST take a real
    row.  The problem is squared with ``T - m`` neutral dummy rows
    (constant cost 0) barred from mandatory slots by the span-scaled
    penalty ``pen = -(4 * span + 1)``: an eps-optimal assignment never
    takes a penalized pair when a feasible completion exists, and unlike
    the quota mask's ``-1e9`` it does not blow up the span-derived epsilon
    schedule (ROADMAP R6).  ``prices`` ((T,)) warm-starts the solve through
    :func:`_schedule`'s re-entry probe.

    Returns ``(slots (m,) int32, slot_prices (T,) float32)``.
    """
    dev = resolve_device(device)
    cost = as_float(cost, dev)
    if cost.dim() != 2:
        raise ValueError(f"cost must be (m, T), got {tuple(cost.shape)}")
    m, T = cost.shape
    if m > T:
        raise ValueError(f"m={m} arriving rows exceed T={T} open slots")
    solver_obj = get_solver(solver)
    if m == T:
        square = cost
    else:
        # dummy rows see cost 0, so the span must cover 0
        hi = cost.amax().clamp(min=0.0)
        lo = cost.amin().clamp(max=0.0)
        pen = -(4.0 * (hi - lo).clamp(min=1e-6) + 1.0)
        dummy = torch.where(torch.as_tensor(mandatory, device=dev).bool(),
                            pen, 0.0)
        square = torch.cat([cost, dummy.expand(T - m, T)])
    p = None if prices is None else as_float(prices, dev)[None]
    assign, p_out = solver_obj.solve(square[None], config, p)
    return assign[0, :m].to(torch.int32), p_out[0]


def greedy_solve(cost) -> torch.Tensor:
    """Global-greedy max assignment of an (n, n) matrix or a (B, n, n)
    stack: n rounds of a flat argmax (the first maximal index, as
    ``jnp.argmax``), the chosen row and column masked to ``_NEG``.  Returns
    int64 ``row_to_col``."""
    c = cost.to(DTYPE).clone()
    squeeze = c.dim() == 2
    if squeeze:
        c = c[None]
    B, n, _ = c.shape
    assign = torch.full((B, n), -1, dtype=torch.int64, device=c.device)
    b = torch.arange(B, device=c.device)
    for _ in range(n):
        flat = c.view(B, n * n).argmax(dim=1)
        r, col = flat // n, flat % n
        assign[b, r] = col
        c[b, r, :] = _NEG
        c[b, :, col] = _NEG
    return assign[0] if squeeze else assign


def scipy_solve(cost: np.ndarray) -> np.ndarray:
    """Exact max-cost assignment (Hungarian) of an (n, n) numpy matrix on
    the host, int32 ``row_to_col``."""
    from scipy.optimize import linear_sum_assignment

    rows, cols = linear_sum_assignment(np.asarray(cost), maximize=True)
    out = np.empty(cost.shape[0], dtype=np.int32)
    out[rows] = cols
    return out


def assignment_value(cost, row_to_col) -> float:
    """Total cost of an assignment (host arithmetic, float64)."""
    cost = np.asarray(cost, np.float64)
    return float(cost[np.arange(len(row_to_col)),
                      np.asarray(row_to_col)].sum())


# ---------------------------------------------------------------------------
# Solver registry
# ---------------------------------------------------------------------------

class Solver(NamedTuple):
    """A registered LAP backend for the ABA core.

    ``solve(cost, config, prices=None)`` takes a (B, n, n) float32 stack and
    returns ``(row_to_col, prices)`` as int64 / float32 tensors, maximizing
    total cost; backends without a price concept (greedy, Hungarian)
    return the incoming prices unchanged (zeros when cold).
    ``factored(x, c, is_real=..., config=..., prices=...)`` is the optional
    matrix-free path, used whenever the cost factors as ``-2 x.c^T +
    ||c||^2``.  ``host_callback`` marks backends that solve on the host
    (``"scipy"``): the engine's non-blocking
    ``AnticlusterEngine.dispatch_repartition`` refuses them, since their
    solve holds the host thread anyway.  ``solve_stats`` /
    ``factored_stats`` are the optional telemetry twins: the signatures of
    ``solve`` / ``factored``, returning ``(row_to_col, prices, stats)``.
    Backends without them report no telemetry (``None``).
    """

    solve: Callable
    factored: Callable | None = None
    host_callback: bool = False
    solve_stats: Callable | None = None
    factored_stats: Callable | None = None


_REGISTRY: dict[str, Solver] = {}


def _accepts_prices(fn: Callable) -> bool:
    try:
        return "prices" in inspect.signature(fn).parameters
    except (TypeError, ValueError):  # C callables etc.: assume legacy
        return False


def _prices_or_zeros(shape_src: torch.Tensor, prices):
    """Pass-through prices for price-less backends ((..., n) from
    (..., n, n))."""
    if prices is not None:
        return torch.as_tensor(prices, dtype=DTYPE, device=shape_src.device)
    return shape_src.new_zeros(shape_src.shape[:-1], dtype=DTYPE)


def _legacy_solve_shim(solve: Callable) -> Callable:
    @functools.wraps(solve)
    def shim(cost, config=AuctionConfig(), prices=None):
        return solve(cost, config), _prices_or_zeros(cost, prices)
    return shim


def _legacy_factored_shim(factored: Callable) -> Callable:
    @functools.wraps(factored)
    def shim(x, c, *, is_real=None, config=AuctionConfig(), prices=None):
        out = factored(x, c, is_real=is_real, config=config)
        if prices is None:
            return out, c.new_zeros(c.shape[:-1], dtype=DTYPE)
        return out, torch.as_tensor(prices, dtype=DTYPE, device=c.device)
    return shim


def register_solver(name: str, solve: Callable, *,
                    factored: Callable | None = None,
                    host_callback: bool = False,
                    solve_stats: Callable | None = None,
                    factored_stats: Callable | None = None,
                    overwrite: bool = False) -> Solver:
    """Register a LAP backend under ``name`` (see :class:`Solver`).

    A ``solve`` (or ``factored``) without a ``prices`` parameter is the
    legacy price-less form ``solve(cost, config) -> row_to_col``: it is
    wrapped in a pass-through shim (incoming prices returned unchanged,
    zeros when cold) with a ``DeprecationWarning``.
    """
    if not overwrite and name in _REGISTRY:
        raise ValueError(f"solver {name!r} already registered "
                         f"(pass overwrite=True to replace it)")
    if not _accepts_prices(solve):
        warnings.warn(
            f"solver {name!r} uses the deprecated price-less signature "
            "solve(cost, config); wrapping it in a pass-through shim. "
            "Migrate to solve(cost, config, prices=None) -> "
            "(assignment, prices) to participate in warm starts.",
            DeprecationWarning, stacklevel=2)
        solve = _legacy_solve_shim(solve)
    if factored is not None and not _accepts_prices(factored):
        warnings.warn(
            f"solver {name!r}: factored path uses the deprecated price-less "
            "signature; wrapping it in a pass-through shim.",
            DeprecationWarning, stacklevel=2)
        factored = _legacy_factored_shim(factored)
    _REGISTRY[name] = Solver(solve=solve, factored=factored,
                             host_callback=host_callback,
                             solve_stats=solve_stats,
                             factored_stats=factored_stats)
    return _REGISTRY[name]


def get_solver(name: str) -> Solver:
    if name not in _REGISTRY:
        raise KeyError(f"unknown solver {name!r}; registered: "
                       f"{available_solvers()}")
    return _REGISTRY[name]


def available_solvers() -> tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def _factored_entry(x, c, *, is_real=None, config=AuctionConfig(),
                    prices=None):
    return _solve_factored(x, c, is_real, config, prices)


def _factored_stats_entry(x, c, *, is_real=None, config=AuctionConfig(),
                          prices=None):
    return _solve_factored_stats(x, c, is_real, config, prices)


def _greedy_entry(cost, config=AuctionConfig(), prices=None):
    del config  # greedy has no tuning knobs
    return greedy_solve(cost), _prices_or_zeros(cost, prices)


def _scipy_entry(cost, config=AuctionConfig(), prices=None):
    """Exact Hungarian, instance by instance on the host; the assignment
    comes back to the cost's device, the prices pass through."""
    del config
    stack = cost.detach().to(DTYPE).cpu().numpy()
    squeeze = stack.ndim == 2
    out = np.stack([scipy_solve(c) for c in (stack[None] if squeeze
                                             else stack)])
    out = torch.from_numpy(out).to(device=cost.device, dtype=torch.int64)
    return out[0] if squeeze else out, _prices_or_zeros(cost, prices)


register_solver("auction", _solve_dense, solve_stats=_solve_dense_stats)
register_solver("auction_fused", _solve_dense, factored=_factored_entry,
                solve_stats=_solve_dense_stats,
                factored_stats=_factored_stats_entry)
register_solver("greedy", _greedy_entry)
register_solver("scipy", _scipy_entry, host_callback=True)
