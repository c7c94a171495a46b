"""The dense auction's phase, as the ``auction_phase_dense`` kernel runs it,
on the CPU.

The dense solver (``"auction"``, the default flat route and the stacked
route) runs a LAP's whole epsilon schedule through one
``ops.auction_phase_dense`` call: one launch of the kernel
``kernels/csrc/auction_phase_dense.cu`` on the card, the Python round loop
``kernels.ref.auction_rounds`` over ``ref.top2`` of ``cost - p``, phase
after phase, on CPU tensors.  These tests pin the plain route of the
wrapper and the dispatcher, the wrapper's checks, that the solver reaches
the dispatcher once a LAP with its whole schedule, and the plain loop
against the JAX dense engine (quality on floats, the same bids on
integers).  The kernel itself
is held against the Python loop on the card (``tests/test_torch_cuda.py``
and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment

from repro.core.assignment import _auction_phase as jax_auction_phase
from repro.core.assignment import _top2_batched
from repro.core.assignment import auction_solve as jax_auction_solve
from repro_torch.core import assignment as asg
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import auction_phase as phase_kernel

CPU = "cpu"


def _cost(seed, G, n, integer=False, dummies=True):
    """A (G, n, n) float32 cost stack; the last group's last rows are
    dummies (zeroed), as ``_assign_batch`` builds them."""
    rng = np.random.default_rng(seed)
    if integer:
        cost = rng.integers(-3, 4, (G, n, n)).astype(np.float32)
    else:
        cost = (rng.normal(size=(G, n, n)) * 5).astype(np.float32)
    if dummies:
        cost[-1, n - n // 3:] = 0.0
    return cost


def _phase_inputs(G=3, n=12, integer=False):
    """A cost stack, warm prices and a two-phase (2, G) eps schedule."""
    cost = torch.from_numpy(_cost(11 + G + n, G, n, integer))
    rng = np.random.default_rng(5)
    warm = torch.from_numpy(rng.normal(size=(G, n)).astype(np.float32))
    eps = torch.tensor([[0.6], [0.3]] if integer else [[0.2], [0.05]]
                       ).expand(2, G).contiguous()
    return cost, warm, eps


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("kw", [
    {}, {"fixed_rounds": 9},
    {"skip": torch.tensor([[True, False, False], [False, False, False]])},
    {"seed": True},
    {"seed": True, "skip": torch.tensor([[False, True, False],
                                         [False, True, False]]),
     "fixed_rounds": 4}, {"max_rounds": 2}],
    ids=["cold", "fixed_rounds", "skip", "seed", "seed_skip_fixed",
         "max_rounds"])
def test_cpu_route_is_the_python_loop_over_top2(integer, kw):
    """On CPU tensors the wrapper and the dispatcher run the Python round
    loop over ``ref.top2`` of ``cost - p`` once a phase of the (P, G)
    schedule, each from the prices of the one before (the seed and the
    skips of each phase as given), bitwise, launch nothing, and count the
    loop's rounds and bids."""
    cost, warm, eps = _phase_inputs(integer=integer)
    kw = dict(kw)
    max_rounds = kw.pop("max_rounds", 500)
    if kw.pop("seed", False):
        kw["seed_top2"] = ref.top2(cost - warm[:, None, :])
    want = (None, warm)
    for p in range(eps.shape[0]):
        want = ref.auction_rounds(
            lambda q: ref.top2(cost - q[:, None, :]), want[1], eps[p],
            max_rounds, kw.get("fixed_rounds", 0),
            None if "skip" not in kw else kw["skip"][p],
            kw.get("seed_top2") if p == 0 else None)
    launches = dict(_build.launches)
    r0, b0 = ref.rounds_executed, ref.bid_totals()
    got = phase_kernel.auction_phase_dense(cost, warm, eps, max_rounds, **kw)
    assert ref.rounds_executed > r0
    assert ref.bid_totals()["bids"] > b0["bids"]
    via_ops = ops.auction_phase_dense(cost, warm, eps, max_rounds, **kw)
    via_ref = ref.auction_phase_dense_ref(cost, warm, eps, max_rounds, **kw)
    for a in (got, via_ops, via_ref):
        assert torch.equal(a[0], want[0]) and torch.equal(a[1], want[1])
    assert _build.launches == launches
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.float32
    if max_rounds == 2:  # the cap bites: rows are left unassigned
        assert bool((got[0] < 0).any())
    elif "fixed_rounds" not in kw:  # to convergence: every row assigned
        assert bool((got[0] >= 0).all())


@pytest.mark.parametrize("bad", ["cost_square", "cost_dim", "cost_dtype",
                                 "empty", "prices_shape", "prices_dtype",
                                 "eps_shape", "eps_one_phase_1d",
                                 "eps_no_phase", "skip_dtype", "skip_shape",
                                 "seed_len", "seed_shape", "seed_j1_dtype"])
def test_wrapper_checks_shapes_and_dtypes(bad):
    cost, warm, eps = _phase_inputs()
    kw = dict(cost=cost, prices=warm, eps=eps, max_rounds=50)
    seed = ref.top2(cost - warm[:, None, :])
    if bad == "cost_square":
        kw["cost"] = cost[:, :, :-1]
    elif bad == "cost_dim":
        kw["cost"] = cost[0]
    elif bad == "cost_dtype":
        kw["cost"] = cost.double()
    elif bad == "empty":
        kw["cost"], kw["prices"] = cost[:, :0, :0], warm[:, :0]
    elif bad == "prices_shape":
        kw["prices"] = warm[:, :-1]
    elif bad == "prices_dtype":
        kw["prices"] = warm.double()
    elif bad == "eps_shape":
        kw["eps"] = eps[:, :2]
    elif bad == "eps_one_phase_1d":  # one phase is a (1, G) schedule
        kw["eps"] = eps[0]
    elif bad == "eps_no_phase":
        kw["eps"] = eps[:0]
    elif bad == "skip_dtype":
        kw["skip"] = torch.zeros((2, 3), dtype=torch.int64)
    elif bad == "skip_shape":  # a skip flag a phase and group
        kw["skip"] = torch.zeros(3, dtype=torch.bool)
    elif bad == "seed_len":
        kw["seed_top2"] = seed[:2]
    elif bad == "seed_shape":
        kw["seed_top2"] = tuple(t[:2] for t in seed)
    else:
        kw["seed_top2"] = (seed[0], seed[1].int(), seed[2])
    with pytest.raises(ValueError):
        phase_kernel.auction_phase_dense(**kw)


class _Spy:
    """Counts the calls of ``ops.auction_phase_dense`` and passes them on."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = ops.auction_phase_dense

        def spy(cost, prices, eps, max_rounds, fixed_rounds=0, **kw):
            self.calls.append({"G": cost.shape[0], "eps": eps, **kw})
            return inner(cost, prices, eps, max_rounds, fixed_rounds, **kw)
        monkeypatch.setattr(ops, "auction_phase_dense", spy)


@pytest.mark.parametrize("B", [1, 3])
def test_solve_dense_runs_every_phase_through_the_dispatcher(monkeypatch, B):
    """A cold LAP is one ``ops.auction_phase_dense`` call on the whole
    stack carrying its (4, B) eps schedule, whose plain route runs the
    Python loop four times, once a phase; a warm LAP too (the probe is
    plain ops), with the (4, B) skips and the probe as the first phase's
    seed.  The Python loop runs nowhere else."""
    cost = torch.from_numpy(_cost(30 + B, B, 10))
    spy = _Spy(monkeypatch)
    calls_loop = []
    inner_loop = ref.auction_rounds

    def loop_spy(*a, **k):
        calls_loop.append(1)
        return inner_loop(*a, **k)
    monkeypatch.setattr(ref, "auction_rounds", loop_spy)
    a, p = asg.auction_solve(cost, return_prices=True, device=CPU)
    assert len(spy.calls) == 1
    assert spy.calls[0]["G"] == B
    assert tuple(spy.calls[0]["eps"].shape) == (
        asg.AuctionConfig().n_phases, B) == (4, B)
    assert spy.calls[0]["skip"] is None
    assert spy.calls[0]["seed_top2"] is None
    assert len(calls_loop) == 4  # the plain route: one loop a phase
    a2, _ = asg.auction_solve(cost, prices=p + 0.5, return_prices=True,
                              device=CPU)
    assert len(spy.calls) == 2 and len(calls_loop) == 8
    warm = spy.calls[1]
    assert warm["seed_top2"] is not None
    assert tuple(warm["skip"].shape) == (4, B) and warm["skip"].dtype == \
        torch.bool and not bool(warm["skip"][-1].any())
    for out in (a, a2):
        assert sorted(out[-1].tolist()) == list(range(10))


def test_solve_dense_n1_launches_nothing(monkeypatch):
    """n = 1 is solved without a phase, as the JAX engine's trivial LAP."""
    spy = _Spy(monkeypatch)
    a = asg.auction_solve(torch.ones((2, 1, 1)), device=CPU)
    assert a.tolist() == [[0], [0]] and not spy.calls


def _check_near_optimal(cost, a):
    """A permutation whose value is within n * eps_lo of the optimum."""
    n = cost.shape[0]
    assert sorted(np.asarray(a).tolist()) == list(range(n))
    r, c = linear_sum_assignment(cost, maximize=True)
    opt = float(cost[r, c].sum())
    eps_lo = (cost.max() - cost.min()) / (asg.AuctionConfig().eps_end_mul * n)
    slack = 1e-4 * max(1.0, abs(opt))
    val = float(cost[np.arange(n), np.asarray(a)].sum())
    assert opt - n * eps_lo - slack <= val <= opt + slack


@pytest.mark.parametrize("B", [1, 3])
def test_dense_solve_and_jax_near_optimal(monkeypatch, B):
    """The port's dense solve (every phase through the dispatcher) and the
    JAX ``auction_solve`` on the same seeded stacks, dummy rows in the last
    instance: both within n * eps_lo of scipy's optimum."""
    cost = _cost(50 + B, B, 20)
    spy = _Spy(monkeypatch)
    port = asg.auction_solve(torch.from_numpy(cost), device=CPU).numpy()
    assert len(spy.calls) == 1
    jax_ = np.asarray(jax_auction_solve(jnp.asarray(cost)))
    for b in range(B):
        _check_near_optimal(cost[b].astype(np.float64), port[b])
        _check_near_optimal(cost[b].astype(np.float64), jax_[b])


@pytest.mark.parametrize("G", [1, 3])
def test_plain_bid_counts_equal_jax_unassigned_rows(monkeypatch, G):
    """The dense plain loop counts, at each round's start, each group's
    unassigned rows (its bids) and the groups with exactly one
    (single-bidder rounds).  Held against the JAX ``_auction_phase`` over
    ``_top2_batched`` of ``cost - p``, stepped with ``fixed_rounds = r`` for
    r = 1, 2, ...: its unassigned rows after r rounds are the bidders of
    round r + 1.  Integer costs make value ties common and every value
    exact in both packages, so both run the same rounds, bit for bit."""
    cost = _cost(68 + G, G, 7, integer=True)
    rng = np.random.default_rng(3)
    eps = rng.uniform(0.1, 0.3, G).astype(np.float32)
    p0 = np.zeros((G, 7), np.float32)
    max_rounds = 500

    monkeypatch.setattr(ref, "_CHECK_EVERY", 1)
    b0, r0 = ref.bid_totals(), ref.rounds_executed
    assign, prices = ops.auction_phase_dense(
        *(torch.from_numpy(a) for a in (cost, p0, eps[None])), max_rounds)
    rounds = ref.rounds_executed - r0
    b1 = ref.bid_totals()
    assert 1 < rounds < max_rounds and bool((assign >= 0).all())

    def top2_fn(p):
        return _top2_batched(jnp.asarray(cost) - p[:, None, :])

    bidders = [np.full(G, 7)]  # round 1: every row
    for r in range(1, rounds + 1):
        a_r, p_r = jax_auction_phase(top2_fn, jnp.asarray(p0),
                                     jnp.asarray(eps), max_rounds,
                                     fixed_rounds=r)
        bidders.append((np.asarray(a_r) < 0).sum(axis=1))
    per_round = np.stack(bidders[:rounds])  # (rounds, G)
    assert bidders[rounds].sum() == 0 and per_round[-1].sum() > 0
    np.testing.assert_array_equal(np.asarray(a_r), assign.numpy())
    np.testing.assert_array_equal(np.asarray(p_r), prices.numpy())
    assert b1["bids"] - b0["bids"] == int(per_round.sum())
    assert (b1["single_bidder_rounds"] - b0["single_bidder_rounds"]
            == int((per_round == 1).sum()))
