"""The port's ABA cores and ``anticluster()`` against the JAX package.

Labels cannot match JAX bit for bit (see tests/test_torch_assignment.py),
so the contract is on quality: exactly balanced sizes and the centroid
objective within 1e-3 relative of JAX's on the same input.  Inside the
port, the streaming core with ``chunk_size >= n`` gives the dense core's
labels bit for bit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.anticluster import AnticlusterSpec as JaxSpec
from repro.anticluster import _route as jax_route
from repro.anticluster import anticluster as jax_anticluster
from repro.core.aba import aba_stream as jax_aba_stream
from repro.core import objective as jax_obj
from repro.core.objective import objective_centroid as jax_objective

from repro_torch import state_from_numpy, state_to_numpy
from repro_torch.anticluster import AnticlusterEngine, AnticlusterSpec
from repro_torch.anticluster import _route, anticluster
from repro_torch.core.aba import aba_core, aba_stream, interleave_permutation
from repro_torch.core import objective as obj
from repro_torch.core.objective import balance_ok, objective_centroid
from repro_torch.data.synthetic import make

CPU = "cpu"


def _data(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _objective(x, labels, k):
    return float(objective_centroid(torch.from_numpy(x),
                                    torch.as_tensor(labels), k))


@pytest.mark.parametrize("n,k", [(2048, 16), (2000, 24)])
@pytest.mark.parametrize("kw", [{}, {"chunk_size": 512},
                                {"chunk_size": 512, "solver": "auction_fused"},
                                {"solver": "auction_fused"}],
                         ids=["flat", "stream", "stream-fused", "flat-fused"])
def test_anticluster_matches_jax_quality(n, k, kw):
    x = _data(n, 8, seed=n)
    res = anticluster(x, k=k, device=CPU, **kw)
    ref = jax_anticluster(x, k=k, **kw)
    labels = res.labels.numpy()
    assert res.labels.dtype == torch.int32 and labels.shape == (n,)
    assert balance_ok(labels, k) and res.balanced
    assert res.route == ("stream" if "chunk_size" in kw else "flat")
    assert res.solver == ref.solver
    np.testing.assert_array_equal(np.sort(res.cluster_sizes.numpy()),
                                  np.sort(np.asarray(ref.cluster_sizes)))
    ours = _objective(x, labels, k)
    theirs = float(jax_objective(jnp.asarray(x), ref.labels, k))
    assert abs(ours - theirs) <= 1e-3 * theirs
    assert np.isfinite(float(res.gap)) and float(res.gap) >= 0.0


@pytest.mark.parametrize("solver", ["auction", "auction_fused"])
@pytest.mark.parametrize("n,k,variant", [(512, 16, "base"), (500, 24, "base"),
                                         (200, 32, "interleave")])
def test_stream_covering_chunk_equals_dense_bitwise(solver, n, k, variant):
    x = _data(n, 6, seed=k)
    dense, dst = aba_core(x[None], k, variant=variant, solver=solver,
                          return_state=True, device=CPU)
    for chunk in (n, n + 13):
        lab, st = aba_stream(x, k, chunk, variant=variant, solver=solver,
                             return_state=True, device=CPU)
        assert torch.equal(lab, dense[0])
        assert torch.equal(st["prices"], dst["prices"])
        assert torch.equal(st["mu"], dst["mu"][0])


def test_stream_small_chunks_balanced_and_close_to_dense():
    x = make("mixture", 1500, 8, seed=1)
    k = 24
    dense = aba_core(x[None], k, solver="auction_fused", device=CPU)[0]
    lab = aba_stream(x, k, 240, solver="auction_fused", device=CPU)
    assert balance_ok(lab.numpy(), k)
    od, os_ = _objective(x, dense, k), _objective(x, lab, k)
    assert abs(os_ - od) <= 1e-3 * od


def test_warm_stream_with_prices_from_jax():
    """Prices carried over from a JAX streaming run (its return_state) seed a
    warm streaming run in both packages: both stay balanced and agree."""
    n, d, k = 1024, 8, 16
    x = _data(n, d, seed=5)
    _, st = jax_aba_stream(jnp.asarray(x), k, 256, solver="auction_fused",
                           return_state=True)
    state = state_from_numpy({"prices": (np.asarray(st["prices"]),),
                              "mu": np.asarray(st["mu"])}, device=CPU)
    warm = state["prices"][0]
    assert warm.shape == (1, k) and torch.any(warm != 0)
    back = state_to_numpy(state)
    np.testing.assert_array_equal(back["prices"][0], np.asarray(st["prices"]))
    np.testing.assert_array_equal(back["mu"], np.asarray(st["mu"]))
    x2 = (x + 0.05 * np.random.default_rng(6).normal(size=x.shape)
          ).astype(np.float32)
    ours = aba_stream(x2, k, 256, solver="auction_fused", prices=warm,
                      device=CPU)
    theirs = jax_aba_stream(jnp.asarray(x2), k, 256, solver="auction_fused",
                            prices=jnp.asarray(st["prices"]))
    assert balance_ok(ours.numpy(), k)
    o_ours, o_theirs = _objective(x2, ours, k), _objective(x2, theirs, k)
    assert abs(o_ours - o_theirs) <= 1e-3 * o_theirs


def test_objective_module_matches_jax():
    rng = np.random.default_rng(11)
    n, d, k = 600, 5, 12
    x = rng.normal(size=(n, d)).astype(np.float32)
    labels = rng.permutation(np.arange(n) % k).astype(np.int32)
    prices = rng.normal(size=(k,)).astype(np.float32)
    tx, tl, tp = (torch.from_numpy(a) for a in (x, labels, prices))
    jx, jl, jp = (jnp.asarray(a) for a in (x, labels, prices))
    np.testing.assert_array_equal(obj.cluster_sizes(tl, k).numpy(),
                                  np.asarray(jax_obj.cluster_sizes(jl, k)))
    close = dict(rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(obj.centroids(tx, tl, k).numpy(),
                               np.asarray(jax_obj.centroids(jx, jl, k)),
                               **close)
    np.testing.assert_allclose(float(obj.objective_centroid(tx, tl, k)),
                               float(jax_obj.objective_centroid(jx, jl, k)),
                               **close)
    for ours, theirs in zip(obj.diversity_stats(tx, tl, k),
                            jax_obj.diversity_stats(jx, jl, k)):
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-4)
    for ours, theirs in zip(obj.dual_certificate(tx, tl, tp, k),
                            jax_obj.dual_certificate(jx, jl, jp, k)):
        np.testing.assert_allclose(float(ours), float(theirs), rtol=1e-4,
                                   atol=1e-5)
    stacked = obj.dual_certificate(tx.view(3, 200, d), tl.view(3, 200),
                                   tp.expand(3, k).contiguous(), k)
    want = jax_obj.dual_certificate(jx.reshape(3, 200, d),
                                    jl.reshape(3, 200),
                                    jnp.broadcast_to(jp, (3, k)), k)
    for ours, theirs in zip(stacked, want):
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs),
                                   rtol=1e-4, atol=1e-5)
    assert obj.balance_ok(labels, k) and not obj.balance_ok(
        np.zeros(n, np.int32), k)


def test_interleave_permutation_matches_jax():
    from repro.core.aba import interleave_permutation as jax_perm
    for n, k in [(100, 7), (64, 8), (5, 9), (1000, 24)]:
        np.testing.assert_array_equal(interleave_permutation(n, k),
                                      jax_perm(n, k))


def test_synthetic_copy_matches_jax():
    from repro.data.synthetic import make as jax_make
    for kind in ("mixture", "lowrank", "binary", "heavytail"):
        np.testing.assert_array_equal(make(kind, 300, 7, seed=3),
                                      jax_make(kind, 300, 7, seed=3))


@pytest.mark.parametrize("shape,kw", [
    ((65536, 8), {"chunk_size": "auto"}),
    ((65535, 8), {"chunk_size": "auto"}),
    ((4096, 8), {"chunk_size": 512}),
    ((4096, 8), {}),
    ((3, 64, 8), {}),
    ((4096, 8), {"max_k": 16}),
    ((4096, 8), {"plan": (4, 64)}),
    ((65536, 8), {"chunk_size": "auto", "max_k": 16}),
    ((65536, 8), {"chunk_size": 512, "plan": (16, 16)}),
])
def test_route_matches_jax(shape, kw):
    mode, plan, solver, chunk = _route(AnticlusterSpec(k=256, **kw), shape,
                                       False, False)
    j_mode, j_plan, j_solver, j_chunk = jax_route(JaxSpec(k=256, **kw), shape,
                                                  False, False)
    assert (mode, plan, solver, chunk) == (j_mode, j_plan, j_solver, j_chunk)


def test_stacked_route_runs_each_group():
    x = np.stack([_data(128, 5, seed=s) for s in range(3)])
    res = anticluster(x, k=8, device=CPU)
    assert res.route == "stacked" and res.labels.shape == (3, 128)
    for g in range(3):
        assert balance_ok(res.labels[g].numpy(), 8)
    assert res.gap.shape == (3,) and bool(torch.all(res.gap >= 0))


def test_default_device_is_cuda():
    """Without device= the port runs on the CUDA device, and raises where
    there is none rather than running on the CPU."""
    x = _data(64, 4)
    if torch.cuda.is_available():
        assert anticluster(x, k=4).labels.is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            anticluster(x, k=4)
        with pytest.raises(RuntimeError, match="CUDA"):
            aba_stream(x, 4, 32)


def _queue1_titles():
    """The bold titles of ROADMAP.md's Queue 1 items."""
    text = (Path(__file__).resolve().parents[1] / "ROADMAP.md").read_text()
    queue = text.split("### Queue 1", 1)[1].split("\n### ", 1)[0]
    return re.findall(r"^\d+\. \*\*(.+?)\*\*", queue, flags=re.M)


def _out_of_slice(kw, title):
    key = next(iter(kw))
    return pytest.param(kw, title,
                        id=key + "=" + str(next(iter(kw.values())))[:12])


@pytest.mark.parametrize("kw,title", [
    _out_of_slice({"fairness": np.zeros(64, np.int32), "mesh": object()},
                  "Mesh route"),
    _out_of_slice({"mesh": object()}, "Mesh route"),
    _out_of_slice({"telemetry": True}, "Consumers"),
    # the greedy and scipy solvers are ported: with them, the fields still
    # out of the slice raise as before
    _out_of_slice({"solver": "greedy", "mesh": object()}, "Mesh route"),
    _out_of_slice({"solver": "scipy", "telemetry": True}, "Consumers"),
])
def test_out_of_slice_fields_raise(kw, title):
    """Each raises naming its ROADMAP Queue 1 item by a title that the
    ROADMAP has (an item's title, not its number, which a re-anchor may
    change)."""
    assert any(t.startswith(title) for t in _queue1_titles()), title
    kw = {"k": 4, **kw}
    with pytest.raises(NotImplementedError,
                       match=re.escape(f"ROADMAP Queue 1: {title}")):
        anticluster(_data(64, 4), device=CPU, **kw)


def test_out_of_slice_core_arguments_and_engine_raise():
    x = _data(64, 4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        AnticlusterEngine(AnticlusterSpec(k=4, telemetry=True), device=CPU)
    titles = _queue1_titles()
    for call, title in (
            (lambda: aba_core(x[None], 4, telemetry=True, device=CPU),
             "Remaining solvers"),
            (lambda: aba_stream(x, 4, 32, telemetry=True, device=CPU),
             "Remaining solvers"),
            (lambda: AnticlusterEngine(AnticlusterSpec(k=4, telemetry=True),
                                       device=CPU),
             "Consumers")):
        assert any(t.startswith(title) for t in titles), title
        with pytest.raises(NotImplementedError,
                           match=re.escape(f"ROADMAP Queue 1: {title}")):
            call()
    # the engine is ported; a delta update of a categorical session is not
    # a local patch, and raises
    engine = AnticlusterEngine(AnticlusterSpec(
        k=4, categories=np.zeros(64, np.int32)), device=CPU)
    _, state = engine.partition(x)
    with pytest.raises(NotImplementedError, match="category-free"):
        engine.update(x, state, added=x[:2])
    with pytest.raises(KeyError):
        AnticlusterSpec(k=4, solver="no-such-solver")
