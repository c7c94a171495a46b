"""The port's observability (``repro_torch.obs``) and the solver telemetry
twins against the JAX package on the CPU.

Tracing: the same calls on a fake clock export the same JSONL as
``repro.obs`` (ids, parents, timings, attributes), ``Histogram``
percentiles are the reference's, ``tools/trace_report.py`` reads the
port's export, ``summarize_auction_telemetry`` folds a pytree as the
reference does, and the front door, the engine and the delta update
record the reference's span and event names with its attribute keys.
``memory_profile`` reports ``available=False`` on the CPU.

Telemetry: JAX's keys, shapes and dtypes on the flat, stream and stacked
routes; None on the hierarchical route and for greedy and scipy; ``eps``
within one float32 ulp of JAX's (P3); ``warm`` / ``skipped`` / ``rounds``
equal to JAX's where the assignment is bitwise JAX's (integer-valued
stacks); labels with telemetry bitwise those without it.
"""

import importlib.util
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import obs as jax_obs
from repro.anticluster import AnticlusterEngine as JaxEngine
from repro.anticluster import AnticlusterSpec as JaxSpec
from repro.core.assignment import AuctionConfig as JaxConfig
from repro.core.assignment import auction_solve as jax_auction_solve
from repro.core.assignment import \
    auction_solve_factored as jax_auction_solve_factored
from repro.incremental import IncrementalPartition as JaxLive

from repro_torch import obs
from repro_torch.anticluster import (AnticlusterEngine, AnticlusterSpec,
                                     anticluster)
from repro_torch.core.assignment import (AuctionConfig, auction_solve,
                                         auction_solve_factored)
from repro_torch.incremental import IncrementalPartition

CPU = "cpu"
REPO = pathlib.Path(__file__).resolve().parent.parent


def _data(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        self.now += 0.125  # every reading advances: distinct, exact stamps
        return self.now


def _layout(tele):
    if tele is None:
        return None
    return {key: (tuple(np.shape(v)), np.asarray(v).dtype.name)
            for key, v in tele.items()}


def _numpy(tele):
    return {key: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)
            for key, v in tele.items()}


# ---------------------------------------------------------------------------
# Tracing, against repro.obs
# ---------------------------------------------------------------------------

def _script(mod, path):
    """The same calls on either package's trace module."""
    with mod.tracing(str(path), clock=FakeClock()) as tr:
        with mod.span("outer", k=8, shape=(4, 2)):
            mod.event("tick", n=np.int64(3))
            with mod.span("inner", solver="auction") as sp:
                sp.set(rounds=np.float32(2.5))
            pending = mod.begin("async", mode="flat")
        pending.finish(gap=None)
        mod.event("after", attrs=[1, 2])
    return tr


def test_trace_export_equals_the_reference(tmp_path):
    ours = _script(obs, tmp_path / "ours.jsonl")
    ref = _script(jax_obs, tmp_path / "ref.jsonl")
    assert len(ours) == len(ref) == 5
    assert (tmp_path / "ours.jsonl").read_text() == \
        (tmp_path / "ref.jsonl").read_text()
    assert not obs.enabled() and obs.active() is None
    # a one-element tensor attr exports as its value, as a numpy scalar does
    t = obs.Trace(clock=FakeClock())
    t.event("tensor", v=torch.tensor(1.5), many=torch.zeros(2))
    t.export_jsonl(str(tmp_path / "t.jsonl"))
    attrs = json.loads((tmp_path / "t.jsonl").read_text())["attrs"]
    assert attrs["v"] == 1.5 and isinstance(attrs["many"], str)


@pytest.mark.parametrize("samples", [[0.5, 0.1, 0.9, 0.3],
                                     list(np.linspace(0, 1, 101)),
                                     [2.0] * 7])
def test_histogram_equals_the_reference(samples):
    ours, ref = obs.Histogram(max_samples=64), jax_obs.Histogram(
        max_samples=64)
    for s in samples:
        ours.record(s)
        ref.record(s)
    assert ours.count == ref.count and ours.mean == ref.mean
    for q in (0, 1, 50, 90, 99, 100):
        assert ours.percentile(q) == ref.percentile(q)
    with pytest.raises(ValueError):
        obs.Histogram(max_samples=0)


def test_trace_report_reads_the_port_export(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "trace_report", REPO / "tools" / "trace_report.py")
    report = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(report)
    path = tmp_path / "TRACE.jsonl"
    with obs.tracing(str(path)):
        eng = AnticlusterEngine(k=4, telemetry=True, device=CPU)
        _, st = eng.partition(_data(96, 3, seed=1))
        eng.repartition(_data(96, 3, seed=1), st)
    summary = report.summarize(report.load_events(str(path)))
    assert summary["engine/repartition"]["count"] == 2
    assert summary["solver/phase"]["count"] == 8    # 4 phases, 2 calls
    assert "engine/repartition" in report.render(summary)


def test_summarize_auction_telemetry_equals_the_reference():
    rng = np.random.default_rng(0)
    tele = {"rounds": rng.integers(0, 9, (5, 4)).astype(np.int32),
            "eps": rng.random((5, 4, 2)).astype(np.float32),
            "warm": rng.random((5, 2)) > 0.5,
            "reentry": rng.random((5, 2)).astype(np.float32),
            "skipped": rng.random((5, 4, 2)) > 0.5}
    assert obs.summarize_auction_telemetry(tele) == \
        jax_obs.summarize_auction_telemetry(tele)
    single = {key: v[0] for key, v in tele.items()}
    assert obs.summarize_auction_telemetry(single) == \
        jax_obs.summarize_auction_telemetry(single)
    assert obs.summarize_auction_telemetry(None) is None


def _names_and_keys(trace):
    out = {}
    for ev in trace.snapshot():
        out.setdefault(ev["name"], set()).update(ev["attrs"])
    return {name: sorted(keys) for name, keys in out.items()}


@pytest.mark.parametrize("telemetry", [False, True])
def test_spans_and_events_equal_the_reference(telemetry):
    """The one-shot front door, a session (partition, a warm repartition, a
    streamed call) and a delta update record JAX's span and event names,
    counts and attribute keys on the same calls."""
    x = _data(200, 4, seed=2)
    added = _data(6, 4, seed=3)

    def drive(mod, anticluster_fn, engine_cls, live_cls, **dev):
        with mod.tracing() as tr:
            anticluster_fn(x, k=5, **dev)
            eng = engine_cls(k=5, telemetry=telemetry, **dev)
            _, st = eng.partition(x)
            eng.repartition(x, st)
            engine_cls(k=5, chunk_size=64, **dev).partition(x)
            live = live_cls(x, k=5, **dev)
            live.update(added=added)
        return tr

    from repro.anticluster import anticluster as jax_anticluster
    ours = drive(obs, anticluster, AnticlusterEngine, IncrementalPartition,
                 device=CPU)
    ref = drive(jax_obs, jax_anticluster, JaxEngine, JaxLive)
    assert _names_and_keys(ours) == _names_and_keys(ref)
    assert sorted(ev["name"] for ev in ours.snapshot()) == \
        sorted(ev["name"] for ev in ref.snapshot())
    if telemetry:
        rep = [ev for ev in ours.snapshot()
               if ev["name"] == "engine/repartition"
               and "rounds_total" in ev["attrs"]]
        assert len(rep) == 2 and all(ev["attrs"]["rounds_total"] > 0
                                     for ev in rep)


def test_memory_profile_is_unavailable_on_the_cpu():
    x = torch.from_numpy(_data(64, 3))
    prof = obs.memory_profile(lambda t: anticluster(t, k=4, device=CPU), x)
    assert prof.available is False
    assert prof.temp_bytes == prof.argument_bytes == prof.output_bytes == -1
    assert prof.total_bytes == -1
    assert obs.memory_profile(lambda device: 0, device=CPU).available \
        is False
    assert obs.peak_rss_bytes() > 0
    _, peak = obs.sample_rss(sum, range(10))
    assert peak > 0


# ---------------------------------------------------------------------------
# Telemetry twins, against JAX
# ---------------------------------------------------------------------------

ROUTES = {
    "flat": (dict(k=4), (128, 5)),
    "stream": (dict(k=4, chunk_size=48), (144, 5)),
    "stream-fused": (dict(k=4, chunk_size=48, solver="auction_fused"),
                     (144, 5)),
    "stacked": (dict(k=4), (3, 64, 5)),
}


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_engine_telemetry_layout_and_labels(route):
    kw, shape = ROUTES[route]
    x = np.random.default_rng(4).normal(size=shape).astype(np.float32)
    eng = AnticlusterEngine(AnticlusterSpec(telemetry=True, **kw),
                            device=CPU)
    plain = AnticlusterEngine(AnticlusterSpec(**kw), device=CPU)
    jeng = JaxEngine(JaxSpec(telemetry=True, **kw))
    r1, s1 = eng.partition(x)
    r0, s0 = plain.partition(x)
    jeng.partition(x)
    assert torch.equal(r1.labels, r0.labels)
    assert r1.route == ("stream" if "chunk_size" in kw else
                        "stacked" if len(shape) == 3 else "flat")
    tele, jtele = eng.last_telemetry, jeng.last_telemetry
    assert _layout(tele) == _layout(jtele)
    assert all(isinstance(v, np.ndarray) for v in tele.values())
    assert tele["rounds"].sum() > 0 and not tele["warm"].any()
    # the cold schedule reports reentry 0 (P6); JAX's zero-price engine
    # call reports its probe's epsilon
    assert not tele["reentry"].any() and jtele["reentry"].any()
    # warm: the same labels with and without telemetry, every LAP warm
    w1, _ = eng.repartition(x, s1)
    w0, _ = plain.repartition(x, s0)
    assert torch.equal(w1.labels, w0.labels)
    assert eng.last_telemetry["warm"].all()
    assert not eng.last_telemetry["skipped"][:, -1].any()
    assert eng.compile_count == 1 and plain.last_telemetry is None


@pytest.mark.parametrize("kw", [dict(k=6, plan=(2, 3)),
                                dict(k=4, solver="greedy"),
                                dict(k=4, solver="scipy")],
                         ids=["hier", "greedy", "scipy"])
def test_engine_telemetry_is_none_where_jax_has_none(kw):
    x = _data(96, 4, seed=5)
    eng = AnticlusterEngine(AnticlusterSpec(telemetry=True, **kw),
                            device=CPU)
    jeng = JaxEngine(JaxSpec(telemetry=True, **kw))
    res, _ = eng.partition(x)
    jeng.partition(x)
    assert res.balanced
    assert eng.last_telemetry is None and jeng.last_telemetry is None


def _exact_config(n_phases):
    """A schedule whose epsilons are exact in float32 on integer spans at
    n = 8 (``eps_end_mul * n`` and the ratio powers of two), so both
    packages bid with the same bits."""
    return AuctionConfig(n_phases=n_phases), JaxConfig(n_phases=n_phases)


@pytest.mark.parametrize("n_phases", [1, 2, 3])
@pytest.mark.parametrize("seed", range(4))
def test_dense_stats_equal_jax_on_integer_stacks(n_phases, seed):
    cfg, jcfg = _exact_config(n_phases)
    cost = np.random.default_rng(seed).integers(-3, 4, (4, 8, 8)).astype(
        np.float32)
    a, p, st = auction_solve(cost, cfg, return_stats=True, device=CPU)
    ja, jp, jst = jax_auction_solve(jnp.asarray(cost), jcfg,
                                    return_stats=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    assert _layout(_numpy(st)) == _layout(jst)
    for key in ("rounds", "eps", "warm", "skipped"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]))
    # warm from the carried prices: warm, skipped, rounds and the re-entry
    # epsilon too
    a2, p2, st2 = auction_solve(cost, cfg, prices=p, return_stats=True,
                                device=CPU)
    ja2, jp2, jst2 = jax_auction_solve(jnp.asarray(cost), jcfg, prices=jp,
                                       return_stats=True)
    np.testing.assert_array_equal(a2.numpy(), np.asarray(ja2))
    for key in ("rounds", "eps", "warm", "skipped", "reentry"):
        np.testing.assert_array_equal(st2[key].numpy(),
                                      np.asarray(jst2[key]))
    # the plain solve gives the same assignment and prices
    a0, p0 = auction_solve(cost, cfg, prices=p, return_prices=True,
                           device=CPU)
    assert torch.equal(a0, a2) and torch.equal(p0, p2)


@pytest.mark.parametrize("seed", range(3))
def test_factored_stats_equal_jax_on_integer_rows(seed):
    cfg, jcfg = _exact_config(3)
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (3, 8, 4)).astype(np.float32)
    c = rng.integers(-2, 3, (3, 8, 4)).astype(np.float32)
    a, p, st = auction_solve_factored(x, c, config=cfg, return_stats=True,
                                      device=CPU)
    ja, jp, jst = jax_auction_solve_factored(
        jnp.asarray(x), jnp.asarray(c), config=jcfg, return_stats=True)
    np.testing.assert_array_equal(a.numpy(), np.asarray(ja))
    assert _layout(_numpy(st)) == _layout(jst)
    for key in ("rounds", "eps", "warm", "skipped"):
        np.testing.assert_array_equal(st[key].numpy(), np.asarray(jst[key]))
    one = auction_solve_factored(x[0], c[0], config=cfg, return_stats=True,
                                 device=CPU)[2]
    assert _layout(_numpy(one)) == _layout(jax_auction_solve_factored(
        jnp.asarray(x[0]), jnp.asarray(c[0]), config=jcfg,
        return_stats=True)[2])


@pytest.mark.parametrize("fixed_rounds", [0, 5])
def test_stats_eps_within_one_ulp_and_edge_cases(fixed_rounds):
    cfg = AuctionConfig(fixed_rounds=fixed_rounds)
    jcfg = JaxConfig(fixed_rounds=fixed_rounds)
    cost = np.random.default_rng(6).normal(size=(3, 24, 24)).astype(
        np.float32)
    _, _, st = auction_solve(cost, cfg, return_stats=True, device=CPU)
    _, _, jst = jax_auction_solve(jnp.asarray(cost), jcfg,
                                  return_stats=True)
    eps, jeps = st["eps"].numpy(), np.asarray(jst["eps"])
    assert np.all(np.abs(eps - jeps) <= np.spacing(np.abs(jeps)))
    if fixed_rounds:
        np.testing.assert_array_equal(st["rounds"].numpy(),
                                      np.asarray(jst["rounds"]))
    # n == 1 runs no phase; a single instance drops the B axis
    one = auction_solve(np.ones((2, 1, 1), np.float32), cfg,
                        return_stats=True, device=CPU)[2]
    jone = jax_auction_solve(jnp.ones((2, 1, 1)), jcfg, return_stats=True)[2]
    assert _layout(_numpy(one)) == _layout(jone)
    assert not one["rounds"].any()
    sq = auction_solve(cost[0], cfg, return_stats=True, device=CPU)[2]
    jsq = jax_auction_solve(jnp.asarray(cost[0]), jcfg, return_stats=True)[2]
    assert _layout(_numpy(sq)) == _layout(jsq)


def test_registry_twins_match_jax():
    from repro.core.assignment import get_solver as jax_get_solver
    from repro_torch.core.assignment import get_solver
    for name in ("auction", "auction_fused", "greedy", "scipy"):
        ours, ref = get_solver(name), jax_get_solver(name)
        assert (ours.solve_stats is None) == (ref.solve_stats is None), name
        assert (ours.factored_stats is None) == \
            (ref.factored_stats is None), name
