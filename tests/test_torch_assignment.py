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
from repro_torch.core import assignment as asg
from repro_torch.core.assignment import (AuctionConfig, auction_solve,
                                         auction_solve_factored)

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
    for r in (1, 7, asg._CHECK_EVERY):
        monkeypatch.setattr(asg, "_CHECK_EVERY", r)
        before = asg.rounds_executed
        out = (auction_solve_factored(x, c, is_real=ir, config=cfg,
                                      return_prices=True, device=CPU),
               auction_solve(cost, config=cfg, return_prices=True,
                             device=CPU),
               auction_solve(cost, config=cfg, prices=warm,
                             return_prices=True, device=CPU))
        results.append(out)
        if max_rounds:  # 3 solves x 4 phases, each stopped by the cap
            assert asg.rounds_executed - before <= 3 * 4 * max_rounds
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
