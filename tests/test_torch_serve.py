"""The port's serving tier (``repro_torch.serve``) on the CPU: the
reference's ``tests/test_serve.py`` cases but the mesh one, on
``device="cpu"`` routers, held to the port's own one-shot ``anticluster``
(continuous batching, row-bucket padding parity, deadline shedding and
backpressure on a fake clock, engine-error containment, the degraded
hierarchical path, engine pools, the metrics snapshot, ``Spec.evolve``,
per-call engine masks, live partitions, latency percentiles); and the
router's results against the JAX router on the same burst (balance, an
objective within 1e-3, ROADMAP P1).  The router on the card is in
``tests/test_torch_cuda.py``.
"""

import threading
import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.objective import objective_centroid as jax_objective
from repro.serve import AnticlusterRouter as JaxRouter

from repro_torch.anticluster import (AnticlusterEngine, AnticlusterSpec,
                                     anticluster)
from repro_torch.core.objective import objective_centroid
from repro_torch.serve import (AnticlusterRouter, AnticlusterService,
                               Rejected, ServiceMetrics, Ticket)

CPU = "cpu"


def _data(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


class FakeClock:
    """Deterministic router clock: advances only when told to."""

    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt


def _router(**kw):
    kw.setdefault("background", False)
    kw.setdefault("device", CPU)
    return AnticlusterRouter(**kw)


def _oneshot(x, **kw):
    return anticluster(x, device=CPU, **kw).labels.numpy()


# ---------------------------------------------------------------------------
# Parity: async submit+result == one-shot, including padded near-shapes
# ---------------------------------------------------------------------------

def test_submit_padded_near_shapes_match_oneshot_bitwise():
    # 100/97/110 rows all land in the 128 bucket and share ONE padded
    # stacked call; every label vector must equal its unpadded one-shot
    r = _router(k=5, plan=None)
    xs = [_data(n, 4, seed=n) for n in (100, 97, 110)]
    tickets = [r.submit(x) for x in xs]
    for t, x in zip(tickets, xs):
        res = t.result()
        assert res.labels.shape == (x.shape[0],)
        np.testing.assert_array_equal(np.asarray(res.labels),
                                      _oneshot(x, k=5, plan=None))
    m = r.metrics()
    assert m.stacked_calls == 1 and m.completed == 3
    assert ("stack", (128, 4), 4) in r._lanes
    assert 0.0 < m.row_occupancy < 1.0  # padded rows are accounted


def test_sync_wrappers_match_async_path_bitwise():
    xs = [_data(n, 3, seed=n) for n in (80, 70, 80, 64)]
    svc = AnticlusterService(k=4, plan=None, device=CPU)
    sync = svc.partition_many(xs)
    r = _router(k=4, plan=None)
    tickets = [r.submit(x) for x in xs]
    for s, t in zip(sync, tickets):
        np.testing.assert_array_equal(np.asarray(s.labels),
                                      np.asarray(t.result().labels))
    # partition == submit().result() on yet another fresh router
    r2 = _router(k=4, plan=None)
    np.testing.assert_array_equal(np.asarray(r2.partition(xs[0]).labels),
                                  np.asarray(sync[0].labels))


def test_interleave_regime_is_never_padded():
    # n // k <= 8 solves through the interleave rearrangement, which the
    # masked core skips -- those requests must stack at exact shape only
    r = _router(k=8, plan=None)
    xs = [_data(40, 4, seed=s) for s in (1, 2)]
    t1, t2 = r.submit(xs[0]), r.submit(xs[1])
    for t, x in zip((t1, t2), xs):
        np.testing.assert_array_equal(np.asarray(t.result().labels),
                                      _oneshot(x, k=8, plan=None))
    assert ("stack", (40, 4), 2) in r._lanes  # 40 not padded to 64
    # a 48-row neighbour cannot share that lane
    t3 = r.submit(_data(48, 4, seed=3))
    t3.result()
    assert ("stack", (40, 4), 2) in r._lanes and r.lane_count == 2


def test_exact_fit_singleton_takes_solo_lane():
    r = _router(k=5, plan=None)
    x = _data(128, 4, seed=9)  # pow2 rows: nothing to pad
    np.testing.assert_array_equal(np.asarray(r.submit(x).result().labels),
                                  _oneshot(x, k=5, plan=None))
    assert ("solo", (128, 4)) in r._lanes and r.lane_count == 1


# ---------------------------------------------------------------------------
# Lane lifecycle under the queue
# ---------------------------------------------------------------------------

def test_row_bucket_growth_and_shrink():
    r = _router(k=5, plan=None)
    # growth: 100/120 share bucket 128, 200 opens bucket 256
    ts = [r.submit(_data(n, 3, seed=n)) for n in (100, 120, 200)]
    for t in ts:
        t.result()
    assert ("stack", (128, 3), 2) in r._lanes
    assert ("stack", (256, 3), 1) in r._lanes
    assert r.lane_count == 2
    # shrink: later sparse traffic in a known bucket opens a narrower
    # group lane but reuses the engine pool (no relearning of buckets)
    r.submit(_data(110, 3, seed=7)).result()
    assert ("stack", (128, 3), 1) in r._lanes and r.lane_count == 3
    # ...and a repeat burst warm-hits the wide lane instead of growing
    before = r.lane_count
    ts = [r.submit(_data(n, 3, seed=n + 50)) for n in (100, 120)]
    for t in ts:
        t.result()
    assert r.lane_count == before
    assert r.metrics().warm_calls >= 1


def test_max_group_splits_oversized_bursts():
    r = _router(k=4, plan=None, max_group=2)
    xs = [_data(100, 3, seed=s) for s in range(5)]
    outs = r.partition_many(xs)
    # the first group and the (separate-lane) remainder solve cold ->
    # bitwise one-shot parity; the second group warm-starts from the first
    # group's prices (eps-optimal drift allowed, balance exact)
    for i in (0, 1, 4):
        np.testing.assert_array_equal(np.asarray(outs[i].labels),
                                      _oneshot(xs[i], k=4, plan=None))
    assert all(o.balanced for o in outs)
    m = r.metrics()
    assert m.stacked_calls == 3  # 2 + 2 + 1 under max_group=2
    assert ("stack", (128, 3), 2) in r._lanes
    assert ("stack", (128, 3), 1) in r._lanes


def test_mixed_cold_warm_burst_counters():
    r = _router(k=5, plan=None)
    xs = [_data(96, 3, seed=s) for s in (0, 1)]
    r.partition_many(xs)                      # cold: compiles the 2-lane
    r.partition_many(xs)                      # warm: same lane, same shapes
    m = r.metrics()
    assert m.cold_calls == 1 and m.warm_calls == 1
    assert m.warm_hit_rate == 0.5
    # a new signature mid-stream is cold without disturbing the warm lane
    r.submit(_data(200, 3, seed=9)).result()
    m = r.metrics()
    assert m.cold_calls == 2 and m.warm_calls == 1
    lane = r._lanes[("stack", (128, 3), 2)]
    assert lane.engine.compile_count == 1     # warm reuse never retraced


# ---------------------------------------------------------------------------
# Deadlines, backpressure, shutdown (fake clock -- no sleeps)
# ---------------------------------------------------------------------------

def test_deadline_shedding_with_fake_clock():
    clock = FakeClock()
    r = _router(k=4, plan=None, clock=clock)
    keep = r.submit(_data(64, 3, seed=1))
    shed = r.submit(_data(64, 3, seed=2), deadline=5.0)
    clock.advance(10.0)                       # expire before any serving
    r.drain()
    assert keep.done() and shed.done()
    assert keep.rejection is None
    assert shed.rejection is not None and shed.rejection.reason == "deadline"
    with pytest.raises(Rejected, match="deadline"):
        shed.result()
    m = r.metrics()
    assert m.shed_deadline == 1 and m.completed == 1
    assert 0.0 < m.shed_rate < 1.0
    # latency stamps come from the router clock
    assert keep.latency == 10.0 and shed.latency == 10.0


def test_deadline_not_yet_expired_is_served():
    clock = FakeClock()
    r = _router(k=4, plan=None, clock=clock)
    t = r.submit(_data(64, 3, seed=3), deadline=5.0)
    clock.advance(4.0)
    assert t.result().labels.shape == (64,)
    assert r.metrics().shed_deadline == 0


def test_queue_full_backpressure():
    r = _router(k=4, plan=None, max_queue=2)
    x = _data(64, 3, seed=1)
    t1, t2 = r.submit(x), r.submit(x)
    with pytest.raises(Rejected, match="queue_full") as ei:
        r.submit(x)
    assert ei.value.reason == "queue_full"
    # an atomic burst larger than the remaining room is rejected whole,
    # and EVERY request it carried counts toward rejected_full
    with pytest.raises(Rejected, match="queue_full"):
        r.partition_many([x])
    with pytest.raises(Rejected, match="queue_full"):
        r.partition_many([x, x])
    assert r.metrics().rejected_full == 4
    r.drain()                                 # queue drains -> room again
    assert t1.done() and t2.done()
    assert r.submit(x).result().labels.shape == (64,)


def test_close_rejects_pending_and_new_requests():
    r = _router(k=4, plan=None)
    t = r.submit(_data(64, 3, seed=1))
    r.close()
    assert t.rejection is not None and t.rejection.reason == "shutdown"
    with pytest.raises(Rejected, match="shutdown"):
        r.submit(_data(64, 3, seed=2))


def test_router_is_a_context_manager():
    with _router(k=4, plan=None) as r:
        t = r.submit(_data(64, 3, seed=1))
        t.result()
    with pytest.raises(Rejected, match="shutdown"):
        r.submit(_data(64, 3, seed=1))


# ---------------------------------------------------------------------------
# Engine errors resolve tickets and never kill the serving loop
# ---------------------------------------------------------------------------

def test_engine_error_resolves_every_ticket_in_the_group(monkeypatch):
    r = _router(k=4, plan=None)
    t1 = r.submit(_data(64, 3, seed=1))
    t2 = r.submit(_data(64, 3, seed=2))   # same bucket: one popped group
    real = AnticlusterEngine.repartition

    def boom(self, *a, **kw):
        raise RuntimeError("lane exploded")

    monkeypatch.setattr(AnticlusterEngine, "repartition", boom)
    with pytest.raises(RuntimeError, match="lane exploded"):
        t1.result()
    # the whole popped group resolved -- nobody hangs on a lost request
    assert t1.done() and t2.done()
    assert t1.rejection is None and isinstance(t1.error, RuntimeError)
    with pytest.raises(RuntimeError, match="lane exploded"):
        t2.result()
    m = r.metrics()
    assert m.errored == 2 and m.completed == 0
    # the router keeps serving once the engine behaves again
    monkeypatch.setattr(AnticlusterEngine, "repartition", real)
    res = r.submit(_data(64, 3, seed=3)).result()
    assert res.labels.shape == (64,)
    assert r.metrics().completed == 1


def test_background_worker_survives_engine_error(monkeypatch):
    real = AnticlusterEngine.repartition

    def boom(self, *a, **kw):
        raise RuntimeError("lane exploded")

    monkeypatch.setattr(AnticlusterEngine, "repartition", boom)
    with AnticlusterRouter(k=4, plan=None, device=CPU) as r:
        t = r.submit(_data(64, 3, seed=1))
        with pytest.raises(RuntimeError, match="lane exploded"):
            t.result(timeout=300)          # worker resolves, not hangs
        monkeypatch.setattr(AnticlusterEngine, "repartition", real)
        t2 = r.submit(_data(64, 3, seed=2))
        assert t2.result(timeout=300).labels.shape == (64,)
        m = r.metrics()
        assert m.errored == 1 and m.completed == 1


def test_submit_restarts_a_dead_worker():
    with AnticlusterRouter(k=4, plan=None, device=CPU) as r:
        r.submit(_data(64, 3, seed=1)).result(timeout=300)
        dead = threading.Thread(target=lambda: None)
        dead.start()
        dead.join()
        r._worker = dead                   # simulate a crashed worker
        t = r.submit(_data(64, 3, seed=2))
        assert r._worker is not dead       # submit spawned a fresh one
        assert t.result(timeout=300).labels.shape == (64,)


def test_inline_timeout_checked_before_stepping():
    r = _router(k=4, plan=None)
    t = r.submit(_data(64, 3, seed=1))
    with pytest.raises(TimeoutError):
        t.result(timeout=0)                # zero budget: no step started
    assert not t.done()
    assert t.result().labels.shape == (64,)


# ---------------------------------------------------------------------------
# Degraded paths are loud
# ---------------------------------------------------------------------------

def test_hierarchical_burst_degrades_loudly_once():
    r = _router(k=6, plan=(2, 3))
    xs = [_data(120, 3, seed=s) for s in (0, 1)]
    with pytest.warns(RuntimeWarning, match="sequential"):
        outs = r.partition_many(xs)
    # first request is cold -> bitwise parity; the second warm-starts on
    # the same solo lane (eps-optimal drift allowed)
    np.testing.assert_array_equal(np.asarray(outs[0].labels),
                                  _oneshot(xs[0], k=6, plan=(2, 3)))
    assert all(o.balanced for o in outs)
    assert r.metrics().degraded_sequential == 2
    # the warning fires once; the counter keeps counting
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        r.partition_many(xs)
    assert r.metrics().degraded_sequential == 4
    assert ("solo", (120, 3)) in r._lanes     # served on one warm solo lane


def test_admission_guards():
    r = _router(k=4, plan=None)
    with pytest.raises(ValueError, match=r"\(n, d\)"):
        r.submit(_data(64, 3, seed=1)[None])
    with pytest.raises(ValueError, match="rows"):
        r.submit(_data(2, 3, seed=1))
    with pytest.raises(NotImplementedError, match="per-dataset"):
        AnticlusterRouter(k=4, valid_mask=np.ones(10, bool), device=CPU)
    with pytest.raises(ValueError, match="max_queue"):
        AnticlusterRouter(k=4, max_queue=0, device=CPU)


# ---------------------------------------------------------------------------
# Ticket API + background worker
# ---------------------------------------------------------------------------

def test_ticket_states_and_timestamps():
    clock = FakeClock()
    r = _router(k=4, plan=None, clock=clock)
    t = r.submit(_data(64, 3, seed=1))
    assert isinstance(t, Ticket)
    assert not t.done() and t.latency is None and t.rejection is None
    clock.advance(2.5)
    t.result()
    assert t.done() and t.latency == 2.5 and t.completed_at == 2.5


def test_background_worker_round_trip():
    x = _data(100, 4, seed=11)
    with AnticlusterRouter(k=5, plan=None, device=CPU) as r:
        t = r.submit(x)
        labels = np.asarray(t.result(timeout=300).labels)
        assert t.done()
    np.testing.assert_array_equal(labels, _oneshot(x, k=5, plan=None))


# ---------------------------------------------------------------------------
# Engine pools across devices
# ---------------------------------------------------------------------------

def test_engine_pool_places_lanes_round_robin():
    """On a CPU router the round robin has one device: every lane, and its
    engine, sits on the CPU (the CUDA placement is held on the card by
    ``tests/test_torch_cuda.py``)."""
    r = _router(k=4, plan=None, row_buckets=False)
    xs = [_data(n, 3, seed=n) for n in (64, 96)]  # two lanes, no sharing
    for x in xs:
        np.testing.assert_array_equal(
            np.asarray(r.submit(x).result().labels),
            _oneshot(x, k=4, plan=None))
    devices = [lane.device for lane in r._lanes.values()]
    assert len(devices) == 2
    assert all(d == torch.device("cpu") for d in devices)
    assert all(lane.engine.device == torch.device("cpu")
               for lane in r._lanes.values())
    assert r.metrics().devices == 1


def test_metrics_snapshot_schema():
    r = _router(k=4, plan=None)
    r.partition_many([_data(64, 3, seed=s) for s in (0, 1)])
    m = r.metrics()
    assert isinstance(m, ServiceMetrics)
    assert m.queue_depth == 0 and m.submitted == 2 and m.completed == 2
    assert m.stack_occupancy == 1.0           # 2 requests filled a 2-bucket
    assert m.shed_rate == 0.0 and m.errored == 0
    assert list(m.lane_compile_counts.values()) == [1]
    assert m.devices == 1


# ---------------------------------------------------------------------------
# AnticlusterSpec.evolve
# ---------------------------------------------------------------------------

def test_evolve_applies_and_revalidates():
    spec = AnticlusterSpec(k=6, plan=(2, 3))
    ev = spec.evolve(k=8, plan=None)
    assert ev.k == 8 and ev.plan is None and spec.k == 6
    assert spec.evolve() is spec              # no changes -> same object
    with pytest.raises(ValueError, match="prod"):
        spec.evolve(k=7)                      # __post_init__ re-runs
    with pytest.raises(TypeError, match="n_clusters"):
        spec.evolve(n_clusters=4)             # unknown field named back
    # every overrides surface routes through evolve (specs compare by
    # identity -- eq=False -- so check the evolved fields)
    eng = AnticlusterEngine(spec, k=8, plan=None, device=CPU)
    assert eng.spec.k == 8 and eng.spec.plan is None
    svc = AnticlusterService(spec, k=8, plan=None, device=CPU)
    assert svc.spec.k == 8 and svc.spec.plan is None


# ---------------------------------------------------------------------------
# Engine per-call valid_mask (the primitive the row buckets lean on)
# ---------------------------------------------------------------------------

def test_engine_per_call_mask_matches_unpadded_bitwise():
    x = _data(100, 4, seed=21)
    pad = np.concatenate([x, np.zeros((28, 4), np.float32)])
    mask = np.arange(128) < 100
    eng = AnticlusterEngine(k=5, plan=None, device=CPU)
    res, state = eng.partition(pad, valid_mask=mask)
    np.testing.assert_array_equal(np.asarray(res.labels[:100]),
                                  _oneshot(x, k=5, plan=None))
    # a differently-padded same-shape call reuses the SAME executable
    y = _data(90, 4, seed=22)
    pady = np.concatenate([y, np.zeros((38, 4), np.float32)])
    res2, _ = eng.repartition(pady, state, valid_mask=np.arange(128) < 90)
    assert res2.labels.shape == (128,)
    assert eng.compile_count == 1


def test_engine_per_call_mask_guards():
    eng = AnticlusterEngine(k=4, plan=None, device=CPU)
    x = _data(64, 3, seed=1)
    with pytest.raises(ValueError, match="does not match"):
        eng.partition(x, valid_mask=np.ones(32, bool))
    masked_spec = AnticlusterSpec(k=4, plan=None,
                                  valid_mask=np.ones(64, bool))
    with pytest.raises(ValueError, match="mutually exclusive"):
        AnticlusterEngine(masked_spec, device=CPU).partition(
            x, valid_mask=np.ones(64, bool))


# ---------------------------------------------------------------------------
# Live partitions: the update lane
# ---------------------------------------------------------------------------

def test_live_partition_open_update_close():
    r = _router(k=4, update_threshold=0.25)
    x = _data(64, 3, seed=7)
    res = r.open_partition("live", x).result()
    assert res.labels.shape == (64,)

    # in-threshold delta takes the update path and keeps balance
    res2 = r.submit_update("live", added=_data(4, 3, seed=8)).result()
    assert res2.updated
    labels = r.partition_labels("live")
    assert labels.shape == (68,)
    counts = np.bincount(labels.numpy(), minlength=4)
    assert counts.min() >= 68 // 4 and counts.max() <= -(-68 // 4)

    # over-threshold delta falls back loudly; the router counts it
    with pytest.warns(RuntimeWarning, match="full warm repartition"):
        res3 = r.submit_update("live", added=_data(40, 3, seed=9)).result()
    assert res3.updated is False
    m = r.metrics()
    assert m.update_calls == 2 and m.update_fallbacks == 1
    assert m.update_fallback_rate == 0.5 and m.live_partitions == 1

    assert r.live_partition("live").n == 108
    r.close_partition("live")
    assert r.metrics().live_partitions == 0
    with pytest.raises(ValueError, match="not open"):
        r.submit_update("live", added=_data(4, 3, seed=8))


def test_live_partition_guards():
    r = _router(k=4)
    r.open_partition("dup", _data(64, 3, seed=1)).result()
    with pytest.raises(ValueError, match="already open"):
        r.open_partition("dup", _data(64, 3, seed=2))
    with pytest.raises(ValueError, match="not open"):
        r.submit_update("missing", added=_data(4, 3, seed=3))
    with pytest.raises(KeyError):
        r.live_partition("missing")
    # a failed open must not reserve the name
    with pytest.raises(ValueError, match="rows"):
        r.open_partition("tiny", _data(2, 3, seed=4))
    r.open_partition("tiny", _data(64, 3, seed=5)).result()
    assert r.metrics().live_partitions == 2


# ---------------------------------------------------------------------------
# Latency / queue-wait percentiles (obs histograms, fake clock -- no sleeps)
# ---------------------------------------------------------------------------

def test_latency_percentiles_fake_clock():
    clock = FakeClock()
    r = _router(k=4, plan=None, clock=clock)
    m = r.metrics()                           # before any request: all 0.0
    assert m.latency_p50 == m.latency_p99 == 0.0
    assert m.queue_wait_p50 == m.queue_wait_p99 == 0.0

    r.submit(_data(64, 3, seed=1))
    clock.advance(0.25)                       # queued for exactly 0.25 s
    r.drain()                                 # clock frozen while serving
    m = r.metrics()
    assert m.latency_p50 == m.latency_p99 == 0.25
    assert m.queue_wait_p50 == m.queue_wait_p99 == 0.25

    r.submit(_data(64, 3, seed=2))
    clock.advance(0.5)                        # second sample: 0.5 s
    r.drain()
    m = r.metrics()
    # nearest-rank over [0.25, 0.5]: p50 is the first sample, p99 the last
    assert m.latency_p50 == 0.25 and m.latency_p99 == 0.5
    assert m.queue_wait_p50 == 0.25 and m.queue_wait_p99 == 0.5
    # shed requests never pollute the served-latency reservoir
    shed = r.submit(_data(64, 3, seed=3), deadline=1.0)
    clock.advance(10.0)
    r.drain()
    assert shed.rejection is not None
    assert r.metrics().latency_p99 == 0.5


# ---------------------------------------------------------------------------
# Against the JAX router, and the port's device policy
# ---------------------------------------------------------------------------

def test_burst_matches_the_jax_router_quality():
    """One padded stacked burst through both routers: exact balance and,
    per request, the objective within 1e-3 relative of JAX's (P1)."""
    xs = [_data(n, 6, seed=n) for n in (180, 200, 230, 256)]
    ours = _router(k=8, plan=None).partition_many(xs)
    ref = JaxRouter(k=8, plan=None, background=False).partition_many(
        [jnp.asarray(x) for x in xs])
    for x, o, j in zip(xs, ours, ref):
        assert o.balanced and o.labels.shape == (x.shape[0],)
        ofv = float(objective_centroid(torch.from_numpy(x), o.labels, 8))
        jofv = float(jax_objective(jnp.asarray(x), j.labels, 8))
        assert abs(ofv - jofv) <= 1e-3 * abs(jofv)


def test_router_defaults_to_cuda():
    """Without ``device=`` the router serves on the CUDA devices, and raises
    where there are none rather than serving on the CPU."""
    if torch.cuda.is_available():
        r = AnticlusterRouter(k=4, plan=None, background=False)
        assert r.device.type == "cuda"
        assert r.submit(_data(64, 3)).result().labels.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            AnticlusterRouter(k=4, plan=None, background=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            AnticlusterService(k=4, plan=None)


def test_concurrent_submitters_stress():
    """More submitting threads than cores against one background router,
    the interpreter switching threads often: every ticket resolves, and the
    metrics count every request once (a lost update would break the
    totals)."""
    import os
    import sys
    n_threads = 2 * (os.cpu_count() or 2) + 2
    per_thread = 3
    tickets, errors = [], []
    lock = threading.Lock()
    xs = [_data(64 + 8 * (i % 3), 3, seed=i) for i in range(n_threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        with AnticlusterRouter(k=4, plan=None, device=CPU) as r:
            def submit(i):
                try:
                    got = [r.submit(xs[i]) for _ in range(per_thread)]
                    with lock:
                        tickets.extend(got)
                except Exception as exc:  # reported below, not swallowed
                    with lock:
                        errors.append(exc)
            threads = [threading.Thread(target=submit, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=120)
            assert not any(t.is_alive() for t in threads)
            for t in tickets:
                assert t.result(timeout=300).balanced
            m = r.metrics()
    finally:
        sys.setswitchinterval(old)
    assert not errors
    total = n_threads * per_thread
    assert len(tickets) == total
    assert m.submitted == m.completed == total and m.errored == 0
    assert m.queue_depth == 0
