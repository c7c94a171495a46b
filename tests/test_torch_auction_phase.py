"""The factored auction's phase, as the phase kernel runs it, on the CPU.

The CUDA kernel ``kernels/csrc/auction_phase.cu`` tests its stopping rule
after every round, where the Python loop ``kernels.ref.auction_rounds``
tests it every ``_CHECK_EVERY`` rounds; a converged state is a fixed point
of the round, so both give the same assignments and prices, bit for bit,
and the every-round loop runs no more rounds.  These tests pin that, the
plain loop's counts of bids and single-bidder rounds (against the JAX
phase), and the wrapper's CPU route and checks.
The kernel itself is held against the Python loop on the card
(``tests/test_torch_cuda.py`` and ``chip_smoke.py``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.assignment import _auction_phase as jax_auction_phase
from repro.core.assignment import _top2_batched
from repro_torch.core.assignment import AuctionConfig, auction_solve_factored
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import auction_phase as phase_kernel

CPU = "cpu"


def _instance(seed, G, n, d, dummies):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, n, d)).astype(np.float32)
    c = (rng.normal(size=(G, n, d)) * 1.5).astype(np.float32)
    ir = np.ones((G, n), bool)
    if dummies:
        ir[-1, n - n // 3:] = False
    warm = rng.normal(size=(G, n)).astype(np.float32)
    return x, c, (ir if dummies else None), warm


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("dummies", [False, True])
@pytest.mark.parametrize("warm", [False, True])
def test_every_round_rule_equals_every_r_rounds(monkeypatch, G, dummies,
                                                warm):
    """The kernel's stopping rule (test every round) against the Python
    loop's (every _CHECK_EVERY rounds): bitwise, and no more rounds."""
    x, c, ir, p0 = _instance(40 + 4 * G + 2 * dummies + warm, G, 24, 5,
                             dummies)
    out, rounds = [], []
    for r in (1, ref._CHECK_EVERY):
        monkeypatch.setattr(ref, "_CHECK_EVERY", r)
        before = ref.rounds_executed
        out.append(auction_solve_factored(
            x, c, is_real=ir, prices=p0 if warm else None,
            return_prices=True, device=CPU))
        rounds.append(ref.rounds_executed - before)
    assert torch.equal(out[0][0], out[1][0])
    assert torch.equal(out[0][1], out[1][1])
    assert 0 < rounds[0] <= rounds[1]


def _phase_inputs(G=3, n=12, d=4, dummies=True):
    x, c, ir, warm = _instance(7, G, n, d, dummies)
    x, c, warm = (torch.from_numpy(a) for a in (x, c, warm))
    ir = None if ir is None else torch.from_numpy(ir)
    eps = torch.full((G,), 0.05)
    return x, c, ir, warm, eps


@pytest.mark.parametrize("kw", [
    {}, {"fixed_rounds": 9}, {"skip": torch.tensor([True, False, False])},
    {"seed": True}])
def test_wrapper_cpu_route_is_the_python_loop(kw):
    """On CPU tensors the wrapper and the dispatcher run the plain version
    and launch nothing; the plain loop's rounds are counted."""
    x, c, ir, warm, eps = _phase_inputs()
    kw = dict(kw)
    if kw.pop("seed", False):
        kw["seed_top2"] = ref.factored_top2(x, c, ir)(warm)
    launches = dict(_build.launches)
    r0 = ref.rounds_executed
    got = phase_kernel.auction_phase(x, c, ir, warm, eps, 500, **kw)
    assert ref.rounds_executed > r0
    want = ref.auction_phase_ref(x, c, ir, warm, eps, 500, **kw)
    via_ops = ops.auction_phase(x, c, ir, warm, eps, 500, **kw)
    for a, b in ((got, want), (via_ops, want)):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert _build.launches == launches
    assert got[0].dtype == torch.int64 and got[1].dtype == torch.float32
    if "fixed_rounds" not in kw:  # run to convergence: every row assigned
        assert bool((got[0] >= 0).all())


@pytest.mark.parametrize("bad", ["c_shape", "prices_shape", "eps_dtype",
                                 "is_real_dtype", "skip_shape", "seed_len",
                                 "seed_j1_dtype", "x_dim", "empty"])
def test_wrapper_checks_shapes(bad):
    x, c, ir, warm, eps = _phase_inputs()
    kw = dict(x=x, c=c, is_real=ir, prices=warm, eps=eps, max_rounds=50)
    seed = ref.factored_top2(x, c, ir)(warm)
    if bad == "c_shape":
        kw["c"] = c[:, :-1]
    elif bad == "prices_shape":
        kw["prices"] = warm[:, :-1]
    elif bad == "eps_dtype":
        kw["eps"] = eps.double()
    elif bad == "is_real_dtype":
        kw["is_real"] = ir.float()
    elif bad == "skip_shape":
        kw["skip"] = torch.zeros(2, dtype=torch.bool)
    elif bad == "seed_len":
        kw["seed_top2"] = seed[:2]
    elif bad == "seed_j1_dtype":
        kw["seed_top2"] = (seed[0], seed[1].int(), seed[2])
    elif bad == "x_dim":
        kw["x"], kw["c"] = x[0], c[0]
    else:
        kw["x"], kw["c"] = x[:, :0], c[:, :0]
    with pytest.raises(ValueError):
        phase_kernel.auction_phase(**kw)


def test_max_rounds_cap_and_counting_on_the_plain_path():
    """The cap stops the phase with rows still unassigned (-1); every phase
    of a solve adds its rounds to rounds_executed."""
    x, c, ir, warm, eps = _phase_inputs(dummies=False)
    t0 = phase_kernel.totals()
    r0 = ref.rounds_executed
    assign, _ = ops.auction_phase(x, c, ir, warm, eps, 1)
    assert ref.rounds_executed - r0 == 1
    assert bool((assign < 0).any())
    r1 = ref.rounds_executed
    auction_solve_factored(x, c, config=AuctionConfig(fixed_rounds=6),
                           device=CPU)
    assert ref.rounds_executed - r1 == 4 * 6  # 4 phases of fixed rounds
    assert phase_kernel.totals() == t0  # no kernel ran


@pytest.mark.parametrize("G", [1, 3])
def test_plain_bid_counts_equal_jax_unassigned_rows(monkeypatch, G):
    """The plain loop counts, at each round's start, each group's unassigned
    rows (its bids) and the groups with exactly one (single-bidder rounds).
    Held against the JAX ``_auction_phase`` stepped with ``fixed_rounds = r``
    for r = 1, 2, ...: its unassigned rows after r rounds are the bidders of
    round r + 1.  Integer rows and centroids make every value exact in both
    packages, so both run the same rounds, bit for bit."""
    rng = np.random.default_rng(68 + G)
    n, d = 7, 3
    x = rng.integers(-2, 3, (G, n, d)).astype(np.float32)
    c = rng.integers(-1, 2, (G, n, d)).astype(np.float32)
    ir = np.ones((G, n), bool)
    ir[-1, n - 3:] = False  # the last group has dummy rows
    eps = rng.uniform(0.1, 0.3, G).astype(np.float32)
    p0 = np.zeros((G, n), np.float32)
    max_rounds = 500

    monkeypatch.setattr(ref, "_CHECK_EVERY", 1)
    b0, r0 = ref.bid_totals(), ref.rounds_executed
    assign, prices = ref.auction_phase_ref(
        *(torch.from_numpy(a) for a in (x, c, ir, p0, eps)), max_rounds)
    rounds = ref.rounds_executed - r0
    b1 = ref.bid_totals()
    assert 1 < rounds < max_rounds and bool((assign >= 0).all())

    cn = (c * c).sum(-1)

    def top2_fn(p):  # the factored values; dummy rows see -p
        vals = (-2.0 * jnp.einsum("gid,gjd->gij", x, c) + cn[:, None, :]
                - p[:, None, :])
        return _top2_batched(jnp.where(ir[:, :, None], vals, -p[:, None, :]))

    bidders = [np.full(G, n)]  # round 1: every row
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
