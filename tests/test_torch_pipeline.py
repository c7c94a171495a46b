"""The port's overlapped mini-batch pipeline (``repro_torch.train``) against
the port's sequencer and the JAX package, on the CPU.

Twins of the reference's ``tests/test_pipeline.py``: the dispatched solve
is bitwise the blocking one; the pipeline's labels and batch order are
bitwise the port's ``ABABatchSequencer``'s epoch by epoch, on one device
and on a 2-shard port mesh (both shards on the CPU); static membership
rotates the order only; an abandoned generator lands its solve; the
``scipy`` fallback warns once and keeps the bits; a mismatched refresh
raises before any solve.  Against JAX: the batch order is bitwise
``epoch_order``'s, the labels within ROADMAP P1 of JAX's ``ABAPipeline``,
and the spans carry the reference's names.  Each test builds its own
``np.random.default_rng(seed)``.
"""

import warnings

import numpy as np
import pytest
import torch

from repro import obs as jax_obs
from repro.data.minibatch import epoch_order as jax_epoch_order
from repro.train.pipeline import ABAPipeline as JaxPipeline

from repro_torch import obs
from repro_torch.anticluster import AnticlusterEngine, AnticlusterSpec
from repro_torch.core.objective import balance_ok, objective_centroid
from repro_torch.data.minibatch import (ABABatchSequencer,
                                        build_batch_schedule, epoch_order)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import ABAPipeline, PipelineEpoch

CPU = "cpu"


def _feats(n=256, d=8, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _drift(f, e):
    r = np.random.default_rng(100 + e)
    return (f + 0.05 * r.normal(size=f.shape)).astype(np.float32)


def _drift_chain(f, e):
    for i in range(1, e + 1):
        f = _drift(f, i)
    return f


def _objective(x, labels, k):
    return float(objective_centroid(torch.from_numpy(np.array(x)),
                                    torch.from_numpy(np.array(labels)), k))


# ---------------------------------------------------------------- dispatch


def test_dispatch_wait_matches_repartition():
    spec = AnticlusterSpec(k=8, plan="auto", max_k=512)
    e1 = AnticlusterEngine(spec, device=CPU)
    e2 = AnticlusterEngine(spec, device=CPU)
    x = _feats()
    _, s1 = e1.partition(x)
    _, s2 = e2.partition(x)
    x2 = _drift(_feats(), 1)
    ra, sa = e1.repartition(x2, s1)
    pending = e2.dispatch_repartition(x2, s2)
    rb, sb = pending.wait()
    assert torch.equal(ra.labels, rb.labels)
    assert torch.equal(ra.cluster_sizes, rb.cluster_sizes)
    assert float(ra.diversity_sd) == float(rb.diversity_sd)
    for a, b in zip((*sa.prices, sa.moment_sum, sa.moment_count),
                    (*sb.prices, sb.moment_sum, sb.moment_count)):
        assert torch.equal(a, b)
    rb2, sb2 = pending.wait()
    assert rb2 is rb and sb2 is sb
    assert e1.compile_count == 1 and e2.compile_count == 1
    e2.close()


def test_dispatch_refuses_host_callback_solver():
    spec = AnticlusterSpec(k=4, plan=None, solver="scipy", chunk_size=None)
    eng = AnticlusterEngine(spec, device=CPU)
    x = _feats(64, 4)
    _, st = eng.partition(x)
    assert not eng.overlap_capable(x)
    with pytest.raises(RuntimeError, match="host callback"):
        eng.dispatch_repartition(x, st)


# ------------------------------------------------- pipeline vs sequencer


def _parity(mesh=None):
    feats = _feats()
    seq = ABABatchSequencer(feats, 32, seed=3, mesh=mesh, device=CPU)
    pipe = ABAPipeline(feats, 32, seed=3, mesh=mesh, device=CPU)
    for e, ep in enumerate(pipe.epochs(
            4, features=lambda i: _drift_chain(feats, i))):
        seq_batches = seq.epoch(e, features=_drift_chain(feats, e)
                                if e else None)
        assert isinstance(ep, PipelineEpoch)
        np.testing.assert_array_equal(pipe.labels,
                                      seq.result.labels.numpy())
        assert ep.index == e
        np.testing.assert_array_equal(ep.order, epoch_order(3, e, len(seq)))
        got = [np.asarray(b) for b in ep]
        assert len(got) == len(seq_batches)
        for a, b in zip(got, seq_batches):
            np.testing.assert_array_equal(a, b)
    assert seq.engine.compile_count == 1
    assert pipe.engine.compile_count == 1
    pipe.engine.close()
    return pipe


def test_pipeline_matches_sequencer_bitwise():
    pipe = _parity()
    assert pipe.overlapped and pipe.result.route == "flat"


def test_pipeline_matches_sequencer_bitwise_mesh():
    """On a 2-shard port mesh: the sharded session's labels, each shard's
    batches drawn from its own rows."""
    pipe = _parity(mesh=make_host_mesh(2, 1, device=CPU))
    assert pipe.result.route == "mesh" and pipe.result.plan[0] == 2
    for b in pipe.batches:
        assert (np.asarray(b) < 128).all() or (np.asarray(b) >= 128).all()


def test_pipeline_static_membership_rotates_order_only():
    feats = _feats()
    pipe = ABAPipeline(feats, 32, seed=1, device=CPU)
    lab0 = pipe.labels.copy()
    orders = []
    for ep in pipe.epochs(3):
        orders.append(ep.order.copy())
        np.testing.assert_array_equal(pipe.labels, lab0)
    assert not np.array_equal(orders[0], orders[1])
    np.testing.assert_array_equal(orders[1], epoch_order(1, 1, len(pipe)))


def test_pipeline_abandoned_mid_epoch_recovers():
    feats = _feats()
    pipe = ABAPipeline(feats, 32, seed=0, device=CPU)
    for ep in pipe.epochs(4, features=lambda i: _drift_chain(feats, i)):
        break  # abandon with epoch 1's solve in flight
    ref = ABABatchSequencer(feats, 32, seed=0, device=CPU)
    ref.epoch(1, features=_drift_chain(feats, 1))
    np.testing.assert_array_equal(pipe.labels, ref.result.labels.numpy())
    for ep in pipe.epochs(1, start_epoch=2):
        assert len(list(ep)) == len(pipe)
    assert pipe.engine.compile_count == 1
    pipe.engine.close()


def test_pipeline_scipy_falls_back_loudly_same_bits():
    feats = _feats(64, 4)
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter("always")
        pipe = ABAPipeline(feats, 16, seed=0, solver="scipy", device=CPU)
        assert not pipe.overlapped
        labels = []
        for ep in pipe.epochs(3, features=lambda i: _drift_chain(feats, i)):
            labels.append(pipe.labels.copy())
    warns = [w for w in rec if issubclass(w.category, RuntimeWarning)
             and "host callback" in str(w.message)]
    assert len(warns) == 1
    eng = AnticlusterEngine(pipe.engine.spec, device=CPU)
    res, st = eng.partition(feats)
    np.testing.assert_array_equal(labels[0], res.labels.numpy())
    for e in (1, 2):
        res, st = eng.repartition(_drift_chain(feats, e), st)
        np.testing.assert_array_equal(labels[e], res.labels.numpy())
    assert pipe.engine.compile_count == 1


# ------------------------------------------- refresh signature validation


def test_refresh_rejects_mismatched_signature_instead_of_retracing():
    feats = _feats(256, 8)
    seq = ABABatchSequencer(feats, 32, seed=0, device=CPU)
    assert seq.engine.compile_count == 1
    with pytest.raises(ValueError, match="compiled signature"):
        seq.epoch(1, features=_feats(256, 9, seed=1))
    with pytest.raises(ValueError, match="compiled signature"):
        seq.refresh(_feats(128, 8, seed=1))
    with pytest.raises(TypeError, match="not numeric"):
        seq.refresh(feats.astype(np.complex64))
    assert seq.engine.compile_count == 1
    seq.epoch(1, features=_drift(feats, 1))
    assert seq.engine.compile_count == 1


def test_pipeline_epoch_schedule_helpers_agree():
    labels = np.random.default_rng(0).integers(0, 8, size=256)
    sched = build_batch_schedule(labels, 8)
    flat = np.concatenate([np.asarray(b) for b in sched])
    assert sorted(flat.tolist()) == list(range(256))
    for b, idx in enumerate(sched):
        assert np.all(labels[np.asarray(idx)] == labels[np.asarray(idx)][0])
    pipe = ABAPipeline(_feats(), 32, seed=0, device=CPU)
    assert len(pipe) == 8 and pipe.n_used == 256
    sd, spread = pipe.diversity_stats(_feats())
    assert sd >= 0 and spread >= 0
    rows = list(PipelineEpoch(0, pipe.batches, epoch_order(0, 0, 8))
                .gathered(_feats()))
    assert len(rows) == 8 and rows[0].shape == (32, 8)


# ------------------------------------------------------ against the JAX one


@pytest.mark.parametrize("seed", [0, 5, 11])
def test_batch_order_bitwise_jax_epoch_order(seed):
    for e in range(6):
        for k in (1, 8, 495):
            np.testing.assert_array_equal(epoch_order(seed, e, k),
                                          jax_epoch_order(seed, e, k))


def test_pipeline_within_p1_of_jax_pipeline_with_its_spans():
    """Epoch by epoch: the same batch order as JAX's pipeline, labels of
    exact balance and an objective within 1e-3 relative of JAX's, and the
    reference's span and event names in the trace."""
    feats = _feats(256, 6, 21)
    with obs.tracing() as tr, jax_obs.tracing() as jtr:
        pipe = ABAPipeline(feats, 32, seed=2, device=CPU)
        jpipe = JaxPipeline(feats, 32, seed=2)
        provider = lambda i: _drift_chain(feats, i)  # noqa: E731
        for e, (ep, jep) in enumerate(zip(
                pipe.epochs(3, features=provider),
                jpipe.epochs(3, features=provider))):
            np.testing.assert_array_equal(ep.order, jep.order)
            x = _drift_chain(feats, e)
            assert balance_ok(pipe.labels, 8, 256)
            want = _objective(x, np.asarray(jpipe.labels), 8)
            got = _objective(x, pipe.labels, 8)
            assert abs(got - want) <= 1e-3 * abs(want), (e, got, want)
    pipe.engine.close()
    names = sorted({ev["name"] for ev in tr.events
                    if ev["name"].startswith("pipeline/")})
    jnames = sorted({ev["name"] for ev in jtr.events
                     if ev["name"].startswith("pipeline/")})
    assert names == jnames == ["pipeline/dispatch", "pipeline/epoch",
                               "pipeline/wait"]
