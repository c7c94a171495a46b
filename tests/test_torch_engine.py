"""The port's session API (``AnticlusterEngine``, ``ABAState``) and the
greedy and scipy solvers, against the JAX package on the CPU.

Inside the port: ``engine.partition`` gives ``anticluster``'s labels bit
for bit, a zeroed state gives ``partition``'s, and
``dispatch_repartition(...).wait()`` gives ``repartition``'s.  Against JAX
(whose labels the port cannot match bit for bit, ROADMAP P1): a JAX
session's warm state, moved across with ``abastate_from_numpy``,
warm-starts a port ``repartition`` to exact balance and an objective
within 1e-3 relative of JAX's warm ``repartition``; the re-entry epsilon of
a warm LAP is within 1e-5 relative of JAX's; greedy is bitwise JAX's on
integer costs; ``solve_restricted_slots`` is within ``n * eps_lo`` of
JAX's value.
"""

import pickle
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.anticluster import AnticlusterEngine as JaxEngine
from repro.core.assignment import auction_solve as jax_auction_solve
from repro.core.assignment import greedy_solve as jax_greedy
from repro.core.assignment import scipy_solve as jax_scipy
from repro.core.assignment import \
    solve_restricted_slots as jax_restricted_slots

from repro_torch import abastate_from_numpy, abastate_to_numpy
from repro_torch.anticluster import (ABAState, AnticlusterEngine,
                                     AnticlusterSpec, anticluster)
from repro_torch.core import assignment as asg
from repro_torch.core.assignment import (AuctionConfig, auction_solve,
                                         available_solvers, get_solver,
                                         register_solver,
                                         solve_restricted_slots)
from repro_torch.core.objective import balance_ok, objective_centroid
from repro_torch.kernels.ref import dense_top2

CPU = "cpu"


def _data(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _objective(x, labels, k):
    return float(objective_centroid(torch.as_tensor(np.array(x)),
                                    torch.as_tensor(np.array(labels)), k))


def _engine(**kw):
    return AnticlusterEngine(device=CPU, **kw)


ROUTES = {
    "flat": dict(k=7, plan=None),
    "hier": dict(k=24, plan=(4, 6)),
    "stream": dict(k=7, plan=None, chunk_size=100),
    "fused": dict(k=7, plan=None, solver="auction_fused"),
}


# ---------------------------------------------------------------------------
# cold parity inside the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES) + ["categorical", "stacked"])
def test_partition_equals_anticluster_bitwise(route):
    rng = np.random.default_rng(31)
    if route == "stacked":
        x = rng.normal(size=(3, 40, 5)).astype(np.float32)
        vm = np.ones((3, 40), bool)
        vm[1, 37:] = False
        kw = dict(k=5, plan=None, variant="base", valid_mask=vm)
    elif route == "categorical":
        x = _data(500, 5, 32)
        kw = dict(k=5, plan=None,
                  categories=rng.integers(0, 4, size=500).astype(np.int32))
    else:
        x = _data(600, 6, 31)
        kw = ROUTES[route]
    res, state = _engine(**kw).partition(x)
    one = anticluster(x, device=CPU, **kw)
    assert torch.equal(res.labels, one.labels)
    assert (res.plan, res.solver, res.route) == (one.plan, one.solver,
                                                 one.route)
    assert torch.equal(state.prev_labels, res.labels)
    assert res.updated is False and one.updated is False
    if route == "stacked":
        assert state.prices[0].shape == (3, 5)
        np.testing.assert_array_equal(state.moment_count.numpy(),
                                      [40.0, 37.0, 40.0])


@pytest.mark.parametrize("route", ["flat", "hier", "stream"])
def test_repartition_zeroed_state_bitwise_partition(route):
    x = _data(300, 5, 34)
    kw = {"flat": dict(k=6, plan=None), "hier": dict(k=12, plan=(3, 4)),
          "stream": dict(k=6, plan=None, chunk_size=64)}[route]
    eng = _engine(**kw)
    res, _ = eng.partition(x)
    res0, _ = eng.repartition(x, eng.init_state(x))
    assert torch.equal(res.labels, res0.labels)
    assert eng.compile_count == 1


# ---------------------------------------------------------------------------
# warm starts
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_warm_repartition_quality_and_compile_count(route):
    """Three drifting same-shape epochs: exact balance, the objective
    within 1 % of a cold solve (the JAX engine's contract), one solve
    closure built."""
    rng = np.random.default_rng(35)
    x = _data(640, 6, 35)
    kw = dict(ROUTES[route], k=24 if route == "hier" else 8)
    eng = _engine(**kw)
    _, state = eng.partition(x)
    for _ in range(3):
        x = x + rng.normal(size=x.shape).astype(np.float32) * 0.05
        res, state = eng.repartition(x, state)
        assert res.balanced and balance_ok(res.labels, eng.spec.k, 640)
        o_warm = _objective(x, res.labels, eng.spec.k)
        o_cold = _objective(x, anticluster(x, device=CPU, **kw).labels,
                            eng.spec.k)
        assert abs(o_warm - o_cold) / abs(o_cold) < 0.01
    assert eng.compile_count == 1


@pytest.mark.parametrize("route", list(ROUTES))
def test_jax_warm_state_warm_starts_the_port(route):
    """A JAX session's state, moved across, warm-starts a port
    repartition: exact balance and the objective within 1e-3 relative of
    JAX's warm repartition from the same state (P1)."""
    kw = dict(ROUTES[route])
    x = _data(700, 6, 36)
    jeng = JaxEngine(**kw)
    _, jstate = jeng.partition(jnp.asarray(x))
    state = abastate_from_numpy(jax.device_get(jstate), CPU)
    assert [tuple(p.shape) for p in state.prices] == \
        [tuple(p.shape) for p in jstate.prices]
    x2 = x + np.random.default_rng(37).normal(size=x.shape).astype(
        np.float32) * 0.05
    res, st2 = _engine(**kw).repartition(x2, state)
    jres, _ = jeng.repartition(jnp.asarray(x2), jstate)
    k = kw["k"]
    assert res.balanced and balance_ok(res.labels, k, 700)
    o, o_jax = _objective(x2, res.labels, k), _objective(x2, jres.labels, k)
    assert abs(o - o_jax) / abs(o_jax) < 1e-3
    back = abastate_to_numpy(st2)
    assert back["prev_labels"].shape == (700,)
    assert len(back["prices"]) == len(jstate.prices)


@pytest.mark.parametrize("drift", [0.0, 2.0], ids=["equilibrium", "drifted"])
def test_reentry_eps_matches_jax(drift):
    """The warm probe's re-entry epsilon against JAX's ``stats["reentry"]``
    on the same costs and carried prices."""
    rng = np.random.default_rng(52)
    cost = rng.normal(size=(3, 24, 24)).astype(np.float32)
    _, p = jax_auction_solve(jnp.asarray(cost), return_prices=True)
    p = np.asarray(p - p.max(axis=-1, keepdims=True))
    cost = cost + rng.normal(size=cost.shape).astype(np.float32) * drift
    _, _, stats = jax_auction_solve(jnp.asarray(cost), prices=jnp.asarray(p),
                                    return_stats=True)
    c = torch.from_numpy(cost)
    eps = asg._eps_schedule(asg._dense_span(c), 24, AuctionConfig())
    got = asg._reentry(dense_top2(c)(torch.from_numpy(p)), eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(stats["reentry"]),
                               rtol=1e-5)


def test_warm_prices_are_nonzero_and_recentered():
    _, state = _engine(k=6, plan=None).partition(_data(300, 4, 36))
    p = state.prices[0].numpy()
    assert (p != 0).any()
    np.testing.assert_allclose(p.max(axis=-1), 0.0, atol=1e-5)


def test_pickled_state_round_trips_through_repartition():
    eng = _engine(k=6, plan=(2, 3))
    x = _data(180, 4, 38)
    _, state = eng.partition(x)
    back = pickle.loads(pickle.dumps(state))
    assert isinstance(back, ABAState)
    res2, _ = eng.repartition(x, back)
    res3, _ = eng.repartition(x, state)
    assert torch.equal(res2.labels, res3.labels) and res2.balanced


def test_init_state_moments_and_shapes():
    eng = _engine(k=12, plan=(3, 4))
    st = eng.init_state((240, 5))
    assert [tuple(p.shape) for p in st.prices] == [(1, 3), (3, 4)]
    assert st.moment_sum.shape == (5,) and float(st.moment_count) == 0.0
    assert int(st.prev_labels.max()) == -1
    assert eng.price_shapes((240, 5)) == ((1, 3), (3, 4))
    assert eng.state_shardings((240, 5)) is None
    x = _data(240, 5, 40)
    _, st2 = eng.partition(x)
    np.testing.assert_allclose(st2.moment_sum.numpy(), x.sum(0), rtol=1e-4)
    assert float(st2.moment_count) == 240.0


def test_engine_guards():
    eng = _engine(k=6, plan=None)
    x = _data(120, 4, 37)
    _, state = eng.partition(x)
    with pytest.raises(ValueError, match="state prices"):
        eng.repartition(x, ABAState((torch.zeros((1, 7)),), state.moment_sum,
                                    state.moment_count, state.prev_labels))
    with pytest.raises(TypeError, match="ABAState"):
        eng.repartition(x, {"prices": state.prices})
    with pytest.raises(NotImplementedError, match="anticluster"):
        _engine(k=4, kplus_moments=2)
    with pytest.raises(NotImplementedError, match="batched"):
        _engine(k=4, batched=False)
    masked = _engine(k=6, plan=None, valid_mask=np.ones(120, bool))
    with pytest.raises(ValueError, match="mutually exclusive"):
        masked.repartition(x, masked.init_state(x),
                           valid_mask=np.ones(120, bool))
    with pytest.raises(ValueError, match="does not match"):
        eng.repartition(x, state, valid_mask=np.ones(119, bool))


def test_per_call_mask_is_its_own_closure():
    eng = _engine(k=6, plan=None)
    x = _data(120, 4, 41)
    vm = np.ones(120, bool)
    vm[100:] = False
    _, state = eng.partition(x)
    res, _ = eng.repartition(x, state, valid_mask=vm)
    res2, _ = eng.repartition(x, state, valid_mask=np.ones(120, bool))
    assert eng.compile_count == 2
    assert res.cluster_sizes.sum() == 100 and res.balanced
    assert res2.cluster_sizes.sum() == 120


# ---------------------------------------------------------------------------
# dispatch_repartition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_dispatch_wait_equals_repartition_bitwise(route):
    eng = _engine(**ROUTES[route])
    x = _data(600, 6, 42)
    _, state = eng.partition(x)
    x2 = x + 0.05 * _data(600, 6, 43)
    pending = eng.dispatch_repartition(x2, state)
    res_d, st_d = pending.wait()
    assert pending.ready() and pending.wait()[0] is res_d  # idempotent
    res_r, st_r = eng.repartition(x2, state)
    assert torch.equal(res_d.labels, res_r.labels)
    for a, b in zip(st_d.prices, st_r.prices):
        assert torch.equal(a, b)
    assert float(res_d.gap) == float(res_r.gap)


def test_dispatch_refuses_host_solvers_and_reraises():
    eng = _engine(k=4, plan=None, solver="scipy")
    x = _data(80, 3, 44)
    assert not eng.overlap_capable(x)
    assert _engine(k=4, plan=None).overlap_capable(x.shape)
    with pytest.raises(RuntimeError, match="overlap_capable"):
        eng.dispatch_repartition(x, eng.init_state(x))
    res, _ = eng.partition(x)  # the synchronous route still works
    assert res.balanced
    name = "test_torch_failing"
    if name not in available_solvers():
        def failing(cost, config=AuctionConfig(), prices=None):
            raise FloatingPointError("solver failed")
        register_solver(name, failing)
    bad = _engine(k=4, plan=None, solver=name)
    pending = bad.dispatch_repartition(x, bad.init_state(x))
    with pytest.raises(FloatingPointError, match="solver failed"):
        pending.wait()
    assert pending.ready()


def test_launch_counts_survive_threads(monkeypatch):
    """An engine's worker thread launches beside its caller's thread: the
    launch counter loses no update (more threads than cores, a short
    switch interval)."""
    import sys
    import threading
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "function", lambda name, symbol=None:
                        (lambda *args: 0))
    monkeypatch.setitem(_build.launches, "cdist", 0)
    n_threads, per_thread = 32, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            _build.launch("cdist") for _ in range(per_thread)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert _build.launches["cdist"] == n_threads * per_thread


def test_engine_close_stops_the_worker():
    eng = _engine(k=4, plan=None)
    x = _data(80, 3, 48)
    _, state = eng.partition(x)
    res, _ = eng.dispatch_repartition(x, state).wait()
    worker = eng._worker
    eng.close()
    assert eng._worker is None and worker._shutdown
    res2, _ = eng.dispatch_repartition(x, state).wait()  # starts a new one
    assert torch.equal(res.labels, res2.labels)
    eng.close()


# ---------------------------------------------------------------------------
# the solver registry: greedy, scipy, the legacy shim
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(7, 7), (4, 9, 9), (2, 32, 32)])
def test_greedy_matches_jax_on_integer_costs(shape):
    """Integer costs with many ties: the first maximal flat index, as
    jnp.argmax, so the assignment is JAX's bit for bit."""
    cost = np.random.default_rng(sum(shape)).integers(
        -3, 4, size=shape).astype(np.float32)
    got, p = get_solver("greedy").solve(torch.from_numpy(cost))
    want = (jax.vmap(jax_greedy)(jnp.asarray(cost)) if cost.ndim == 3
            else jax_greedy(jnp.asarray(cost)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not p.any() and p.shape == shape[:-1]


def test_scipy_matches_jax_and_passes_prices_through():
    cost = _data(3 * 10, 10, 46).reshape(3, 10, 10)
    p_in = torch.arange(30, dtype=torch.float32).reshape(3, 10)
    got, p = get_solver("scipy").solve(torch.from_numpy(cost), None, p_in)
    np.testing.assert_array_equal(
        got.numpy(), np.stack([jax_scipy(c) for c in cost]))
    assert torch.equal(p, p_in) and get_solver("scipy").host_callback


@pytest.mark.parametrize("solver", ["greedy", "scipy"])
def test_greedy_and_scipy_through_the_front_door(solver):
    """Both registered solvers run the flat route and the engine; their
    objective is within 1e-3 relative of JAX's with the same solver."""
    from repro.anticluster import anticluster as jax_anticluster
    x = _data(240, 4, 47)
    res = anticluster(x, k=8, solver=solver, device=CPU)
    ref = jax_anticluster(x, k=8, solver=solver)
    assert res.balanced and res.solver == solver
    o, o_jax = _objective(x, res.labels, 8), _objective(x, ref.labels, 8)
    assert abs(o - o_jax) / abs(o_jax) < 1e-3
    eng = _engine(k=8, solver=solver)
    r1, st = eng.partition(x)
    r2, _ = eng.repartition(x, st)
    assert torch.equal(r1.labels, res.labels)
    assert torch.equal(r1.labels, r2.labels)  # price-less: stays cold


@pytest.mark.parametrize("m,T", [(5, 8), (8, 8), (3, 16)])
def test_solve_restricted_slots_within_bound_of_jax(m, T):
    rng = np.random.default_rng(m * T)
    cost = rng.normal(size=(m, T)).astype(np.float32)
    mandatory = np.zeros(T, bool)
    mandatory[rng.choice(T, size=min(m, 2), replace=False)] = True
    slots, p = solve_restricted_slots(cost, mandatory, device=CPU)
    jslots, _ = jax_restricted_slots(jnp.asarray(cost), jnp.asarray(mandatory))
    slots, jslots = slots.numpy(), np.asarray(jslots)
    for sl in (slots, jslots):
        assert len(set(sl)) == m and mandatory[sl].sum() == mandatory.sum()
    val = cost[np.arange(m), slots].sum()
    jval = cost[np.arange(m), jslots].sum()
    # n * eps_lo = span / 4 of the squared (T, T) problem, whose dummy rows
    # hold 0 and the penalty on mandatory slots
    hi, lo = max(cost.max(), 0.0), min(cost.min(), 0.0)
    if m == T:
        span = cost.max() - cost.min()
    else:
        span = hi + 4.0 * (hi - lo) + 1.0
    assert val >= jval - span / 4.0 - 1e-5
    # warm: carried prices go through the re-entry probe
    slots_w, _ = solve_restricted_slots(cost, mandatory, prices=p,
                                        device=CPU)
    assert len(set(slots_w.numpy())) == m
    assert p.shape == (T,)


def test_registry_canonical_signature_returns_prices():
    solver = get_solver("auction")
    cost = torch.from_numpy(_data(16, 16, 41) @ _data(16, 16, 41).T)[None]
    assign, prices = solver.solve(cost, AuctionConfig(), None)
    assert sorted(assign[0].tolist()) == list(range(16))
    assert prices.shape == (1, 16)
    assign2, _ = solver.solve(cost, AuctionConfig(), prices)
    assert sorted(assign2[0].tolist()) == list(range(16))
    assert {"auction", "auction_fused", "greedy", "scipy"} <= set(
        available_solvers())


def test_legacy_priceless_solver_shim_warns_and_works():
    name = "test_torch_legacy_priceless"

    def old_style(cost, config=AuctionConfig()):
        return auction_solve(cost, config, device=CPU).long()

    if name not in available_solvers():
        with pytest.warns(DeprecationWarning, match="price-less"):
            register_solver(name, old_style)
    solver = get_solver(name)
    cost = torch.from_numpy(_data(12, 12, 42))[None]
    assign, prices = solver.solve(cost, AuctionConfig(), None)
    assert sorted(assign[0].tolist()) == list(range(12))
    assert not prices.any() and prices.shape == (1, 12)
    p_in = torch.arange(12, dtype=torch.float32)[None]
    _, p_out = solver.solve(cost, AuctionConfig(), p_in)
    assert torch.equal(p_out, p_in)
    eng = _engine(k=4, plan=None, solver=name)
    x = _data(80, 3, 42)
    r1, st = eng.partition(x)
    r2, _ = eng.repartition(x, st)
    assert torch.equal(r1.labels, r2.labels)  # stays cold


def test_new_style_registration_does_not_warn():
    name = "test_torch_new_style_priced"
    if name not in available_solvers():
        def new_style(cost, config=AuctionConfig(), prices=None):
            return asg._solve_dense(cost, config, prices)
        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            register_solver(name, new_style)
    assert name in available_solvers()


def test_telemetry_spec_still_raises():
    with pytest.raises(NotImplementedError, match="Consumers"):
        AnticlusterEngine(AnticlusterSpec(k=4, telemetry=True), device=CPU)
