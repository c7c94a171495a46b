"""The port's auction LAP engine against the JAX one and the exact optimum.

The port cannot match the JAX assignments bit for bit: a float32 sum taken
in another order, or a ``pow`` one ulp apart in the eps schedule, changes a
bid and the tie-breaks cascade.  So the contract with JAX is on quality:
every LAP value, from either package, lies within ``n * eps_lo`` of scipy's
optimum (``eps_lo = span / (4 n)``, the schedule's last eps).  Inside the
port the contracts are bitwise: stacked == per-instance, and testing the
phase predicate every R rounds == every round.
"""

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

import jax.numpy as jnp

from repro.core.assignment import auction_solve as jax_auction_solve
from repro.core.assignment import \
    auction_solve_factored as jax_auction_solve_factored

from repro_torch import state_from_numpy
from repro_torch.core.assignment import (AuctionConfig, auction_solve,
                                         auction_solve_factored)
from repro_torch.kernels import ops, ref
from repro_torch.kernels.bid_top2 import bid_top2_span

CPU = "cpu"


def _value(cost, a):
    a = np.asarray(a)
    return float(cost[np.arange(len(a)), a].sum())


def _check_near_optimal(cost, a):
    """A permutation whose value is within n * eps_lo of the optimum."""
    n = cost.shape[0]
    assert sorted(np.asarray(a).tolist()) == list(range(n))
    r, c = linear_sum_assignment(cost, maximize=True)
    opt = float(cost[r, c].sum())
    eps_lo = (cost.max() - cost.min()) / (AuctionConfig().eps_end_mul * n)
    slack = 1e-4 * max(1.0, abs(opt))  # float32 summation of the value
    val = _value(cost, a)
    assert val <= opt + slack
    assert val >= opt - n * eps_lo - slack


def _factored_instance(seed, G, n, d, n_real=None):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, n, d)).astype(np.float32)
    c = (rng.normal(size=(G, n, d)) * 1.5).astype(np.float32)
    ir = np.ones((G, n), bool)
    for g, r in enumerate(n_real or []):
        ir[g, r:] = False
    return x, c, ir


def _factored_cost(x, c, ir):
    """The dense matrix the factored solver works on: dummy rows cost 0."""
    cost = -2.0 * np.einsum("gid,gjd->gij", x.astype(np.float64), c) \
        + (c.astype(np.float64) ** 2).sum(-1)[:, None, :]
    return np.where(ir[..., None], cost, 0.0)


@pytest.mark.parametrize("B", [1, 3])
def test_dense_near_optimal_both_packages(B):
    rng = np.random.default_rng(10 + B)
    n = 24
    cost = (rng.normal(size=(B, n, n)) * 5).astype(np.float32)
    cost[-1, 17:] = 0.0  # neutral dummy rows
    port = auction_solve(torch.from_numpy(cost), device=CPU).numpy()
    jax_ = np.asarray(jax_auction_solve(jnp.asarray(cost)))
    for b in range(B):
        _check_near_optimal(cost[b].astype(np.float64), port[b])
        _check_near_optimal(cost[b].astype(np.float64), jax_[b])


@pytest.mark.parametrize("B", [1, 3])
def test_factored_near_optimal_both_packages(B):
    x, c, ir = _factored_instance(20 + B, B, 18, 5,
                                  n_real=[18, 13, 5][:B] if B > 1 else [12])
    port = auction_solve_factored(x, c, is_real=ir, device=CPU).numpy()
    jax_ = np.asarray(jax_auction_solve_factored(
        jnp.asarray(x), jnp.asarray(c), is_real=jnp.asarray(ir),
        force="ref"))
    cost = _factored_cost(x, c, ir)
    for b in range(B):
        _check_near_optimal(cost[b], port[b])
        _check_near_optimal(cost[b], jax_[b])


@pytest.mark.parametrize("seed", range(12))
def test_factored_stacked_equals_per_instance_bitwise(seed):
    """ROADMAP fault R1's shapes: the port's stacked solve is the per-instance
    solve, labels and prices, bit for bit."""
    x, c, ir = _factored_instance(1000 + seed, 3, 18, 5, n_real=[18, 13, 5])
    a, p = auction_solve_factored(x, c, is_real=ir, return_prices=True,
                                  device=CPU)
    for g in range(3):
        ag, pg = auction_solve_factored(x[g], c[g], is_real=ir[g],
                                        return_prices=True, device=CPU)
        assert torch.equal(a[g], ag)
        assert torch.equal(p[g], pg)


def test_dense_stacked_equals_per_instance_bitwise():
    rng = np.random.default_rng(3)
    cost = rng.normal(size=(4, 16, 16)).astype(np.float32)
    cost[2, 9:] = 0.0
    a, p = auction_solve(cost, return_prices=True, device=CPU)
    for b in range(4):
        ab, pb = auction_solve(cost[b], return_prices=True, device=CPU)
        assert torch.equal(a[b], ab)
        assert torch.equal(p[b], pb)


@pytest.mark.parametrize("adaptive", [True, False])
def test_warm_start_from_jax_prices(adaptive):
    """Prices from a JAX cold solve, carried into both packages' solvers on
    drifted costs through state_from_numpy: permutations within the bound."""
    cfg = AuctionConfig(adaptive_reentry=adaptive)
    x, c, _ = _factored_instance(77, 1, 20, 6)
    x, c = x[0], c[0]
    _, p_jax = jax_auction_solve_factored(jnp.asarray(x), jnp.asarray(c),
                                          force="ref", return_prices=True)
    state = state_from_numpy({"prices": (np.asarray(p_jax),)}, device=CPU)
    warm = state["prices"][0]
    assert warm.dtype == torch.float32 and torch.any(warm != 0)
    rng = np.random.default_rng(78)
    x2 = (x + 0.05 * rng.normal(size=x.shape)).astype(np.float32)
    cost = _factored_cost(x2[None], c[None], np.ones((1, 20), bool))[0]
    a_port = auction_solve_factored(x2, c, prices=warm, config=cfg,
                                    device=CPU)
    a_jax = jax_auction_solve_factored(jnp.asarray(x2), jnp.asarray(c),
                                       prices=jnp.asarray(p_jax), config=cfg,
                                       force="ref")
    _check_near_optimal(cost, a_port.numpy())
    _check_near_optimal(cost, np.asarray(a_jax))
    a_dense = auction_solve(cost.astype(np.float32), prices=warm, config=cfg,
                            device=CPU)
    _check_near_optimal(cost, a_dense.numpy())


@pytest.mark.parametrize("max_rounds", [0, 5, 37])
def test_checking_every_r_rounds_equals_every_round(monkeypatch, max_rounds):
    """A converged state is a fixed point of the round, and the cap is kept
    exactly, so the predicate's period changes nothing."""
    cfg = AuctionConfig(max_rounds=max_rounds)
    x, c, ir = _factored_instance(5, 3, 18, 5, n_real=[18, 13, 5])
    rng = np.random.default_rng(6)
    cost = rng.normal(size=(3, 18, 18)).astype(np.float32)
    warm = torch.from_numpy(rng.normal(size=(3, 18)).astype(np.float32))
    results = []
    for r in (1, 7, ref._CHECK_EVERY):
        monkeypatch.setattr(ref, "_CHECK_EVERY", r)
        before = ref.rounds_executed
        out = (auction_solve_factored(x, c, is_real=ir, config=cfg,
                                      return_prices=True, device=CPU),
               auction_solve(cost, config=cfg, return_prices=True,
                             device=CPU),
               auction_solve(cost, config=cfg, prices=warm,
                             return_prices=True, device=CPU))
        results.append(out)
        if max_rounds:  # 3 solves x 4 phases, each stopped by the cap
            assert ref.rounds_executed - before <= 3 * 4 * max_rounds
    for other in results[1:]:
        for (a0, p0), (a1, p1) in zip(results[0], other):
            assert torch.equal(a0, a1) and torch.equal(p0, p1)


def test_fixed_rounds_past_convergence_equals_the_loop():
    """fixed_rounds runs a set number of rounds and never tests the
    predicate; past convergence the extra rounds are no-ops."""
    rng = np.random.default_rng(9)
    cost = rng.normal(size=(2, 12, 12)).astype(np.float32)
    loop = auction_solve(cost, return_prices=True, device=CPU)
    fixed = auction_solve(cost, config=AuctionConfig(fixed_rounds=2000),
                          return_prices=True, device=CPU)
    assert torch.equal(loop[0], fixed[0]) and torch.equal(loop[1], fixed[1])


def _two_call_span(x, c):
    """The span as two ``ops.bid_top2`` calls: at zero prices, and with
    ``-x`` at ``2 ||c||^2``, summed group by group."""
    prices = torch.stack([2.0 * (cg * cg).sum(dim=-1) for cg in c])
    return (ops.bid_top2(x, c, x.new_zeros(prices.shape)),
            ops.bid_top2(-x, c, prices))


@pytest.mark.parametrize("G,n,d", [(1, 18, 5), (3, 18, 5), (2, 33, 1)])
def test_span_pair_equals_two_calls_bitwise(G, n, d):
    """The paired span on the plain path (the dispatcher's and the CUDA
    wrapper's, on CPU tensors) is the two separate calls, bit for bit: v1,
    j1 and v2 of both slots."""
    x, c, _ = _factored_instance(300 + G * n + d, G, n, d)
    x, c = torch.from_numpy(x), torch.from_numpy(c)
    want = _two_call_span(x, c)
    for span in (ops.bid_top2_span, bid_top2_span):
        for got_slot, want_slot in zip(span(x, c), want):
            for g, w in zip(got_slot, want_slot):
                assert torch.equal(g, w)


@pytest.mark.parametrize("G,k,d", [(1, 18, 5), (64, 64, 32), (7, 3, 1)])
def test_span_group_does_not_depend_on_G(G, k, d):
    """A group's span bids on a stack are bitwise the same group's alone
    (the factored LAP's eps schedule must not depend on G, ROADMAP P3),
    and slot 1 bids at ``2 ||c||^2``: its values are ``2 x.c - ||c||^2``."""
    rng = np.random.default_rng(G * k + d)
    x = torch.from_numpy(rng.normal(size=(G, k, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(G, k, d)).astype(np.float32) * 3)
    pair = ops.bid_top2_span(x, c)
    for g in range(G):
        alone = ops.bid_top2_span(x[g:g + 1], c[g:g + 1])
        for got_slot, want_slot in zip(pair, alone):
            for t, w in zip(got_slot, want_slot):
                assert torch.equal(t[g], w[0])
    vals = 2.0 * torch.einsum("gid,gjd->gij", x, c) \
        - (c * c).sum(dim=-1)[:, None, :]
    v1, j1, _ = pair[1]
    torch.testing.assert_close(v1, vals.amax(dim=-1), rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(vals.gather(-1, j1[..., None])[..., 0], v1,
                               rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("seed", range(12))
def test_factored_solve_unchanged_by_the_paired_span(monkeypatch, seed):
    """The factored solve's labels and prices are those of the two-call span
    (the seeds and shapes of the stacked-vs-per-instance test)."""
    x, c, ir = _factored_instance(1000 + seed, 3, 18, 5, n_real=[18, 13, 5])
    got = auction_solve_factored(x, c, is_real=ir, return_prices=True,
                                 device=CPU)
    monkeypatch.setattr(ops, "bid_top2_span", _two_call_span)
    want = auction_solve_factored(x, c, is_real=ir, return_prices=True,
                                  device=CPU)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _host_schedule(span: np.ndarray, n: int, config: AuctionConfig):
    """The schedule as the port formed it on the host before it moved to
    the device: ``hi * ratio**p`` in double per span, then float32."""
    n_phases = max(int(config.n_phases), 1)
    out = []
    for s in span.tolist():
        hi = s / config.eps_start_div
        lo = s / (config.eps_end_mul * n)
        if n_phases > 1:
            ratio = (lo / hi) ** (1.0 / (n_phases - 1))
            out.append([hi * ratio ** p for p in range(n_phases)])
        else:
            out.append([lo])
    return np.asarray(out, dtype=np.float32).T


@pytest.mark.parametrize("n_phases", [1, 4])
@pytest.mark.parametrize("n", [2, 16, 100, 256, 512, 8192])
def test_eps_schedule_equals_the_host_formula(n, n_phases):
    """``float32(float64(span) * f_p)`` on the device against the host
    formula ``hi * ratio**p`` on 10**5 seeded spans from 1e-6 to 1e10 at
    each n and phase count: the two differ only in the double rounding of
    the ratio, so by one float32 ulp at most, and on these 3 * 10**6 values
    by none."""
    from repro_torch.core.assignment import _eps_schedule
    rng = np.random.default_rng(n * 10 + n_phases)
    span = np.exp(rng.uniform(np.log(1e-6), np.log(1e10), 100_000))
    span = span.astype(np.float32)
    cfg = AuctionConfig(n_phases=n_phases)
    got = _eps_schedule(torch.from_numpy(span), n, cfg).numpy()
    want = _host_schedule(span, n, cfg)
    assert got.shape == want.shape == (n_phases, span.size)
    ulps = np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1
    assert int((ulps > 0).sum()) == 0


class _NoHostRead:
    """Within the block any read of a tensor's values to the host raises,
    and so does any upload (a tensor made from host data, or moved to a
    device), and the phase dispatchers are stubbed (a launch on the card,
    a Python loop here): what is left is the LAP's own code around its
    phases."""

    def __init__(self, monkeypatch):
        def refuse(name):
            def read(*args, **kwargs):
                raise AssertionError(f"host read or upload inside a LAP: "
                                     f"{name}")
            return read
        for name in ("tolist", "item", "cpu", "numpy", "__bool__",
                     "__int__", "__float__", "cuda"):
            monkeypatch.setattr(torch.Tensor, name, refuse(name))
        for name in ("tensor", "as_tensor", "from_numpy"):
            monkeypatch.setattr(torch, name, refuse(f"torch.{name}"))
        to = torch.Tensor.to

        def to_dtype(t, *args, **kwargs):  # a cast, never a move
            if "device" in kwargs or any(
                    isinstance(a, (str, torch.device, torch.Tensor))
                    for a in args):
                raise AssertionError(f"upload inside a LAP: to{args}")
            return to(t, *args, **kwargs)

        monkeypatch.setattr(torch.Tensor, "to", to_dtype)
        self.dense = self.factored = 0

        def dense(cost, prices, eps, *args, **kwargs):
            self.dense += 1
            return torch.zeros_like(prices, dtype=torch.int64), prices

        def factored(x, c, is_real, prices, eps, *args, **kwargs):
            self.factored += 1
            return torch.zeros_like(prices, dtype=torch.int64), prices

        monkeypatch.setattr(ops, "auction_phase_dense", dense)
        monkeypatch.setattr(ops, "auction_phase", factored)


@pytest.mark.parametrize("warm", [False, True])
def test_a_lap_reads_nothing_back_to_the_host(monkeypatch, warm):
    """``_solve_dense`` and ``_solve_factored``, cold and warm (the probe,
    the re-entry and the skips): the span, the eps schedule and the
    permutation repair are device work with no ``tolist``, ``item``,
    ``cpu`` or truth value of a tensor, so on the card nothing waits for
    the host inside a LAP; nor is anything uploaded (the schedule's
    factors are kept on the device from the first LAP of a shape on).  One
    dense dispatch a LAP, four factored."""
    from repro_torch.core.assignment import _solve_dense, _solve_factored
    rng = np.random.default_rng(12)
    G, n, d = 3, 16, 5
    cost = torch.from_numpy(rng.normal(size=(G, n, n)).astype(np.float32))
    x = torch.from_numpy(rng.normal(size=(G, n, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(G, n, d)).astype(np.float32))
    real = torch.from_numpy(np.arange(n) < n - 3).expand(G, n).contiguous()
    prices = (torch.from_numpy(rng.normal(size=(G, n)).astype(np.float32))
              if warm else None)
    _solve_dense(cost, AuctionConfig(), prices)  # the shape's first LAP
    spy = _NoHostRead(monkeypatch)
    a, p = _solve_dense(cost, AuctionConfig(), prices)
    a2, p2 = _solve_factored(x, c, real, AuctionConfig(), prices)
    assert (spy.dense, spy.factored) == (1, 4)
    monkeypatch.undo()
    for out in (a, a2):
        assert out.shape == (G, n) and out.dtype == torch.int64
    assert p.shape == p2.shape == (G, n)
