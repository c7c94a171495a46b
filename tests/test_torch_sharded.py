"""The port's mesh route (``repro_torch.core.sharded``, the ``"mesh"`` route
of the front door, the engine's sharded sessions and the consumers with a
mesh) against the JAX package on the CPU.

Inside the port: a 1-shard mesh is bitwise the port's flat, stream and
hierarchical routes; a 2-shard mesh (both shards on the CPU, one after
another) is bitwise its per-shard solves plus the shard offsets, each
shard's labels in ``[s * k_local, (s + 1) * k_local)``.  Against JAX
(ROADMAP P1: exact balance and the objective within 1e-3 relative): the
port's 1-shard mesh against JAX's 1-device mesh, and the port's 2-shard
mesh against JAX's 2-device ``sharded_core``, run in a subprocess that
alone sees two forced host devices.  The reference's
``tests/test_engine_sharded.py`` cases that run on one device have twins
here.  Each test builds its own ``np.random.default_rng(seed)``.
"""

import os
import pickle
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh as JaxMesh

from repro.anticluster import AnticlusterEngine as JaxEngine
from repro.anticluster import AnticlusterSpec as JaxSpec
from repro.anticluster import anticluster as jax_anticluster
from repro.core.sharded import sharded_price_shapes as jax_price_shapes
from repro.sharding.specs import resolve_data_axes as jax_resolve_axes

from repro_torch import shardedstate_from_numpy, shardedstate_to_numpy
from repro_torch.anticluster import (AnticlusterEngine, AnticlusterSpec,
                                     ShardedABAState, anticluster)
from repro_torch.core.objective import balance_ok, objective_centroid
from repro_torch.core.sharded import sharded_core, sharded_price_shapes
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import Mesh, resolve_data_axes, shard_devices

CPU = "cpu"
ROOT = Path(__file__).resolve().parents[1]


def _data(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _objective(x, labels, k):
    return float(objective_centroid(torch.from_numpy(np.array(x)),
                                    torch.from_numpy(np.array(labels)), k))


def _close(a, b, rel=1e-3):
    return abs(a - b) <= rel * abs(b)


def _mesh(shards=1):
    return make_host_mesh(shards, 1, device=CPU)


def _jax_mesh1():
    return JaxMesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                   ("data", "model"))


def _labels(res):
    return res.labels.numpy()


def _locality(labels, shards, k):
    """Shard s's rows hold only labels in [s * k / S, (s + 1) * k / S)."""
    n_local, k_local = len(labels) // shards, k // shards
    for s in range(shards):
        seg = labels[s * n_local:(s + 1) * n_local]
        assert seg.min() >= s * k_local and seg.max() < (s + 1) * k_local


# ---------------------------------------------------------------------------
# The mesh, its data axes and the price shapes
# ---------------------------------------------------------------------------

def test_make_host_mesh_and_shard_devices():
    mesh = _mesh(2)
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 2, "model": 1}
    assert shard_devices(mesh, ("data",)) == [torch.device(CPU)] * 2
    grid = Mesh(np.array([["cpu", "cpu"], ["cpu", "cpu"]], object),
                ("data", "model"))
    assert shard_devices(grid, ("data",)) == [torch.device(CPU)] * 2
    with pytest.raises(ValueError, match="axis names"):
        Mesh(np.array(["cpu"], object), ("data", "model"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_host_mesh(1, 1)


@pytest.mark.parametrize("axes", ["auto", ("data",), ("dta", "data"),
                                  ("model",), ()])
def test_resolve_data_axes_as_jax(axes):
    """The port's resolver gives JAX's axes, or raises JAX's message."""
    port, ref = _mesh(1), _jax_mesh1()
    try:
        want = jax_resolve_axes(ref, axes)
    except ValueError as err:
        with pytest.raises(ValueError, match=re.escape(str(err))):
            resolve_data_axes(port, axes)
        return
    assert resolve_data_axes(port, axes) == want


def test_data_axes_auto_needs_a_data_axis():
    mesh = Mesh(np.array(["cpu"], object), ("model",))
    with pytest.raises(ValueError, match="none of the default data axes"):
        anticluster(_data(64, 3, 56), AnticlusterSpec(k=4, mesh=mesh),
                    device=CPU)


@pytest.mark.parametrize("plan,shards", [((8,), 1), ((8,), 4),
                                         ((4, 6), 2), ((2, 3, 4), 3)])
def test_sharded_price_shapes_as_jax(plan, shards):
    assert sharded_price_shapes(plan, shards) == \
        jax_price_shapes(plan, shards)


# ---------------------------------------------------------------------------
# One shard: bitwise the port's own routes, P1 against JAX's 1-device mesh
# ---------------------------------------------------------------------------

ONE_SHARD = {
    "flat": (dict(k=8), {}),
    "stream": (dict(k=8, chunk_size=64), {}),
    "hier": (dict(k=12, max_k=4), {}),
    "categories": (dict(k=6), {"categories": 3}),
}


@pytest.mark.parametrize("case", sorted(ONE_SHARD))
def test_one_shard_mesh_is_the_local_route_bitwise(case):
    kw, extra = ONE_SHARD[case]
    x = _data(240, 5, 31)
    if "categories" in extra:
        kw = dict(kw, categories=np.random.default_rng(31).integers(
            0, extra["categories"], size=240).astype(np.int32))
    res = anticluster(x, mesh=_mesh(1), data_axes=("data",), device=CPU,
                      **kw)
    local = anticluster(x, device=CPU, **kw)
    assert res.route == "mesh"
    assert local.route == {"flat": "flat", "stream": "stream",
                           "hier": "hier",
                           "categories": "flat"}[case]
    np.testing.assert_array_equal(_labels(res), _labels(local))
    assert res.plan == local.plan
    assert res.dual_bound is None and res.gap is None
    torch.testing.assert_close(res.cluster_sizes, local.cluster_sizes,
                               rtol=0, atol=0)


@pytest.mark.parametrize("case", sorted(ONE_SHARD))
def test_one_shard_mesh_within_p1_of_jax(case):
    kw, extra = ONE_SHARD[case]
    x = _data(240, 5, 32)
    if "categories" in extra:
        kw = dict(kw, categories=np.random.default_rng(32).integers(
            0, extra["categories"], size=240).astype(np.int32))
    k = kw["k"]
    res = anticluster(x, mesh=_mesh(1), device=CPU, **kw)
    ref = jax_anticluster(jnp.asarray(x), JaxSpec(mesh=_jax_mesh1(), **kw))
    assert res.plan == ref.plan
    assert res.balanced and balance_ok(_labels(res), k, 240)
    assert _close(_objective(x, _labels(res), k),
                  _objective(x, np.asarray(ref.labels), k))


def test_stream_route_upgrades_per_shard():
    """chunk_size="auto" decides the stream route and the solver upgrade on
    one shard's rows, as JAX's ``_route`` does."""
    from repro.anticluster import _route as jax_route
    from repro_torch.anticluster import _route
    for shards, n in ((1, 1 << 16), (2, 1 << 16), (2, 1 << 17)):
        spec = AnticlusterSpec(k=8, chunk_size="auto", mesh=_mesh(shards))
        got = _route(spec, (n, 4), False, False)
        if shards == 1:
            jspec = JaxSpec(k=8, chunk_size="auto", mesh=_jax_mesh1())
            assert got == jax_route(jspec, (n, 4), False, False)
        assert got[0] == "mesh"
        assert (got[2] == "auction_fused") == (n // shards >= 1 << 16)
        assert (got[3] is None) == (n // shards < 1 << 16)


# ---------------------------------------------------------------------------
# Two shards on the CPU: bitwise the per-shard solves plus the offsets
# ---------------------------------------------------------------------------

TWO_SHARDS = {
    "flat": dict(k=16),
    "stream": dict(k=16, chunk_size=64),
    "hier": dict(k=24, max_k=4),
    "interleave": dict(k=64),
}


@pytest.mark.parametrize("case", sorted(TWO_SHARDS))
def test_two_shards_are_their_per_shard_solves(case):
    kw = TWO_SHARDS[case]
    k, n = kw["k"], 384
    x = _data(n, 4, 33)
    res = anticluster(x, mesh=_mesh(2), device=CPU, **kw)
    assert res.route == "mesh" and res.plan[0] == 2
    labels = _labels(res)
    local_kw = dict(kw, k=k // 2)
    for s in range(2):
        part = anticluster(x[s * 192:(s + 1) * 192], device=CPU, **local_kw)
        np.testing.assert_array_equal(labels[s * 192:(s + 1) * 192],
                                      s * (k // 2) + _labels(part))
        assert res.plan == (2,) + part.plan
    _locality(labels, 2, k)
    assert res.balanced and balance_ok(labels, k, n)


def test_two_shards_with_categories_and_mask():
    rng = np.random.default_rng(34)
    x = _data(256, 5, 34)
    cats = rng.integers(0, 4, size=256).astype(np.int32)
    res = anticluster(x, k=8, categories=cats, mesh=_mesh(2), device=CPU)
    labels = _labels(res)
    for s in range(2):
        rows = slice(s * 128, (s + 1) * 128)
        part = anticluster(x[rows], k=4, categories=cats[rows], device=CPU)
        np.testing.assert_array_equal(labels[rows], s * 4 + _labels(part))
        for g in range(4):  # constraint (5) per shard
            n_g = int((cats[rows] == g).sum())
            per = np.bincount(labels[rows][cats[rows] == g] - s * 4,
                              minlength=4)
            assert per.max() <= -(-n_g // 4) and per.min() >= n_g // 4
    vm = np.arange(256) % 17 != 0
    res = anticluster(x, k=8, valid_mask=vm, mesh=_mesh(2), device=CPU)
    for s in range(2):
        rows = slice(s * 128, (s + 1) * 128)
        part = anticluster(x[rows], k=4, plan=None, valid_mask=vm[rows],
                           device=CPU)
        np.testing.assert_array_equal(_labels(res)[rows][vm[rows]],
                                      s * 4 + _labels(part)[vm[rows]])
    assert int(res.n_valid) == int(vm.sum())


def test_sharded_core_state_layout_and_warm_start():
    x = _data(192, 4, 35)
    labels, st = sharded_core(x, 8, _mesh(2), return_state=True,
                              device=CPU)
    assert [tuple(p.shape) for p in st["prices"]] == [(2, 1, 4)]
    assert tuple(st["moment_sum"].shape) == (2, 4)
    torch.testing.assert_close(st["moment_count"], torch.tensor([96., 96.]))
    torch.testing.assert_close(st["moment_sum"],
                               torch.from_numpy(x).view(2, 96, 4).sum(1),
                               rtol=1e-5, atol=1e-4)
    cold = sharded_core(x, 8, _mesh(2), prices=tuple(
        torch.zeros_like(p) for p in st["prices"]), device=CPU)
    assert torch.equal(cold, labels)
    warm = sharded_core(x, 8, _mesh(2), prices=st["prices"], device=CPU)
    assert balance_ok(warm.numpy(), 8, 192)
    with pytest.raises(ValueError, match="levels"):
        sharded_core(x, 8, _mesh(2), prices=st["prices"] * 2, device=CPU)


def test_sharded_core_errors_as_jax():
    """On one shard the port raises JAX's errors, message for message; on
    two, the divisibility errors name the shard count."""
    from repro.core.sharded import sharded_core as jax_sharded_core
    x = _data(66, 3, 36)
    for k, kw in ((4, dict(data_axes=("dta",))),
                  (4, dict(valid_mask=np.ones(66, bool), max_k=2)),
                  (4, dict(categories=np.zeros(66, np.int32))),
                  (4, dict(batched=False, return_state=True))):
        with pytest.raises((ValueError, NotImplementedError)) as want:
            jax_sharded_core(jnp.asarray(x), k, _jax_mesh1(), **kw)
        with pytest.raises(want.type, match=re.escape(str(want.value))):
            sharded_core(x, k, _mesh(1), device=CPU, **kw)
    with pytest.raises(ValueError, match="k=5 must be divisible by shard "
                                         "count 2"):
        sharded_core(x, 5, _mesh(2), device=CPU)
    with pytest.raises(ValueError, match="n=65 rows must be divisible by "
                                         "shard count 2"):
        sharded_core(_data(65, 3), 4, _mesh(2), device=CPU)


_JAX_TWO_DEVICES = """
import os, sys
sys.path.insert(0, "src")
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.core.sharded import sharded_core
assert jax.device_count() == 2, jax.devices()
mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(2), ("data",))
out = {}
for name, (n, d, k, seed, kw) in CASES.items():
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    if kw.pop("categories", None):
        kw["categories"] = np.random.default_rng(seed).integers(
            0, 3, size=n).astype(np.int32)
        kw["n_categories"] = 3
    lab, st = sharded_core(jnp.asarray(x), k, mesh, data_axes=("data",),
                           return_state=True, **kw)
    out[name + "/labels"] = np.asarray(lab)
    out[name + "/moment_sum"] = np.asarray(st["moment_sum"])
    out[name + "/moment_count"] = np.asarray(st["moment_count"])
    out[name + "/prices0"] = np.asarray(st["prices"][0])
np.savez(OUT, **out)
print("ok")
"""

JAX_CASES = {
    "flat": (512, 6, 16, 40, {}),
    "stream": (512, 6, 16, 41, {"chunk_size": 96}),
    "hier": (480, 5, 24, 42, {"max_k": 4}),
    "categories": (384, 4, 8, 43, {"categories": True}),
}


def test_two_shards_within_p1_of_jax_two_devices(tmp_path):
    """JAX's 2-device ``sharded_core`` runs in a child process whose
    environment alone forces two host devices; the port's 2-shard mesh is
    held to P1 against it case by case, with JAX's state layout."""
    out = tmp_path / "jax_two_devices.npz"
    code = f"CASES = {JAX_CASES!r}\nOUT = {str(out)!r}\n" + textwrap.dedent(
        _JAX_TWO_DEVICES)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = np.load(out)
    for name, (n, d, k, seed, kw) in JAX_CASES.items():
        x = _data(n, d, seed)
        kw = dict(kw)
        if kw.pop("categories", None):
            kw["categories"] = np.random.default_rng(seed).integers(
                0, 3, size=n).astype(np.int32)
            kw["n_categories"] = 3
        labels, st = sharded_core(x, k, _mesh(2), data_axes=("data",),
                                  return_state=True, device=CPU, **kw)
        labels = labels.numpy()
        assert balance_ok(labels, k, n), name
        _locality(labels, 2, k)
        _locality(ref[name + "/labels"], 2, k)
        assert _close(_objective(x, labels, k),
                      _objective(x, ref[name + "/labels"], k)), name
        np.testing.assert_array_equal(st["moment_count"].numpy(),
                                      ref[name + "/moment_count"])
        np.testing.assert_allclose(st["moment_sum"].numpy(),
                                   ref[name + "/moment_sum"], rtol=1e-5,
                                   atol=1e-4)
        assert st["prices"][0].shape == ref[name + "/prices0"].shape


# ---------------------------------------------------------------------------
# The engine's sharded sessions (twins of tests/test_engine_sharded.py)
# ---------------------------------------------------------------------------

def _spec(**kw):
    return AnticlusterSpec(mesh=kw.pop("mesh", _mesh(1)),
                           data_axes=("data",), **kw)


def test_mesh_engine_cold_parity_and_sentinel():
    x = _data(128, 5, 50)
    spec = _spec(k=8)
    one = anticluster(x, spec, device=CPU)
    eng = AnticlusterEngine(spec, device=CPU)
    res, state = eng.partition(x)
    assert isinstance(state, ShardedABAState)
    np.testing.assert_array_equal(_labels(res), _labels(one))
    assert res.plan == one.plan and res.route == "mesh"
    res0, _ = eng.repartition(x, eng.init_state(x))
    np.testing.assert_array_equal(_labels(res0), _labels(one))
    assert eng.compile_count == 1
    np.testing.assert_array_equal(state.prev_labels.numpy(), _labels(res))


def test_mesh_engine_warm_quality_and_compile_count():
    rng = np.random.default_rng(51)
    x = _data(192, 6, 51)
    spec = _spec(k=12)
    eng = AnticlusterEngine(spec, device=CPU)
    _res, state = eng.partition(x)
    for _ in range(3):
        x = x + rng.normal(size=x.shape).astype(np.float32) * 0.05
        res, state = eng.repartition(x, state)
        assert res.balanced and balance_ok(_labels(res), 12, 192)
        o_warm = _objective(x, _labels(res), 12)
        o_ref = _objective(x, _labels(anticluster(x, spec, device=CPU)), 12)
        assert abs(o_warm - o_ref) / abs(o_ref) < 0.01
    assert eng.compile_count == 1
    assert any(bool(torch.any(p != 0)) for p in state.prices)


def test_mesh_engine_warm_starts_from_a_jax_state():
    """A JAX 1-device mesh session's ``ShardedABAState``, read as numpy,
    warm-starts the port's 1-shard session: the same layout, and the warm
    labels within P1 of JAX's warm repartition from the same state."""
    x = _data(160, 4, 52)
    x2 = x + np.random.default_rng(53).normal(size=x.shape).astype(
        np.float32) * 0.05
    jeng = JaxEngine(JaxSpec(k=8, mesh=_jax_mesh1(), data_axes=("data",)))
    _jr, jstate = jeng.partition(jnp.asarray(x))
    leaves = jax.device_get(jstate)
    eng = AnticlusterEngine(_spec(k=8), device=CPU)
    state = shardedstate_from_numpy(leaves, device=CPU)
    assert isinstance(state, ShardedABAState)
    back = shardedstate_to_numpy(state)
    for p, q in zip(back["prices"], leaves.prices):
        np.testing.assert_array_equal(p, np.asarray(q))
    np.testing.assert_array_equal(back["prev_labels"],
                                  np.asarray(leaves.prev_labels))
    res, new = eng.repartition(x2, state)
    jres, _ = jeng.repartition(jnp.asarray(x2), jstate)
    assert res.balanced
    assert _close(_objective(x2, _labels(res), 8),
                  _objective(x2, np.asarray(jres.labels), 8))
    assert [tuple(p.shape) for p in new.prices] == \
        [tuple(np.shape(p)) for p in leaves.prices]


def test_mesh_categories_parity_single_shard():
    rng = np.random.default_rng(52)
    x = _data(120, 4, 52)
    cats = rng.integers(0, 3, size=120).astype(np.int32)
    spec = _spec(k=6, categories=cats)
    res = anticluster(x, spec, device=CPU)
    ref = anticluster(x, AnticlusterSpec(k=6, categories=cats), device=CPU)
    np.testing.assert_array_equal(_labels(res), _labels(ref))
    eng = AnticlusterEngine(spec, device=CPU)
    r1, st = eng.partition(x)
    np.testing.assert_array_equal(_labels(r1), _labels(res))
    r2, _ = eng.repartition(x, st)
    assert r2.balanced


def test_mesh_valid_mask_flat_plan():
    x = _data(128, 4, 53)
    vm = np.ones(128, bool)
    vm[120:] = False
    spec = _spec(k=8, valid_mask=vm)
    res = anticluster(x, spec, device=CPU)
    ref = anticluster(x, AnticlusterSpec(k=8, plan=None, valid_mask=vm),
                      device=CPU)
    np.testing.assert_array_equal(np.where(vm, _labels(res), 0),
                                  np.where(vm, _labels(ref), 0))
    assert res.n_valid == 120
    eng = AnticlusterEngine(spec, device=CPU)
    r1, st = eng.partition(x)
    np.testing.assert_array_equal(_labels(r1)[vm], _labels(res)[vm])
    np.testing.assert_array_equal(st.moment_count.numpy(), [120.0])


def test_mesh_stream_chunk_ge_n_bit_parity():
    x = _data(160, 5, 54)
    dense = _spec(k=8)
    stream = dense.evolve(chunk_size=200)
    np.testing.assert_array_equal(
        _labels(anticluster(x, stream, device=CPU)),
        _labels(anticluster(x, dense, device=CPU)))
    eng = AnticlusterEngine(stream, device=CPU)
    res, st = eng.partition(x)
    np.testing.assert_array_equal(
        _labels(res), _labels(anticluster(x, dense, device=CPU)))
    res2, _ = eng.repartition(x, st)
    assert res2.balanced and eng.compile_count == 1


def test_sharded_core_chunked_with_categories_stays_stratified():
    rng = np.random.default_rng(67)
    x = _data(96, 3, 67)
    cats = rng.integers(0, 2, size=96).astype(np.int32)
    mesh = _mesh(1)
    lab_c = sharded_core(x, 4, mesh, data_axes=("data",), categories=cats,
                         n_categories=2, chunk_size=32, device=CPU)
    lab_d = sharded_core(x, 4, mesh, data_axes=("data",), categories=cats,
                         n_categories=2, device=CPU)
    assert torch.equal(lab_c, lab_d)
    vm = np.arange(96) < 90
    lab_vc = sharded_core(x, 4, mesh, data_axes=("data",), valid_mask=vm,
                          chunk_size=32, device=CPU)
    lab_vd = sharded_core(x, 4, mesh, data_axes=("data",), valid_mask=vm,
                          device=CPU)
    assert torch.equal(lab_vc[vm], lab_vd[vm])


def test_data_axes_absent_axis_raises_with_names():
    x = _data(64, 3, 55)
    spec = AnticlusterSpec(k=4, mesh=_mesh(1), data_axes=("dta", "data"))
    with pytest.raises(ValueError, match=r"dta"):
        anticluster(x, spec, device=CPU)
    with pytest.raises(ValueError, match=r"dta"):
        AnticlusterEngine(spec, device=CPU)
    with pytest.raises(ValueError, match=r"not present on the mesh"):
        sharded_core(x, 4, _mesh(1), data_axes=("dta",), device=CPU)


def test_mesh_rejects_indivisible_rows_and_mismatched_state():
    spec = _spec(k=4)
    eng = AnticlusterEngine(spec, device=CPU)
    x = _data(64, 3, 57)
    _, state = eng.partition(x)
    flat_eng = AnticlusterEngine(AnticlusterSpec(k=4, plan=None), device=CPU)
    _, flat_state = flat_eng.partition(x)
    with pytest.raises(TypeError, match="ShardedABAState"):
        eng.repartition(x, flat_state)
    with pytest.raises(TypeError, match="ABAState"):
        flat_eng.repartition(x, state)
    with pytest.raises(NotImplementedError, match="mesh sessions"):
        eng.update(x, state, added=x[:2])
    with pytest.raises(NotImplementedError, match="plan"):
        anticluster(x, spec.evolve(plan=(2, 2)), device=CPU)
    with pytest.raises(NotImplementedError, match="flat"):
        anticluster(x.reshape(2, 32, 3), spec, device=CPU)


def test_sharded_state_pickles_and_shardings():
    eng = AnticlusterEngine(_spec(k=8, mesh=_mesh(2)), device=CPU)
    x = _data(96, 4, 58)
    _, state = eng.partition(x)
    back = pickle.loads(pickle.dumps(state))
    assert isinstance(back, ShardedABAState)
    res, _ = eng.repartition(x, back)
    assert res.balanced
    assert eng.state_shardings(x) == [torch.device(CPU)] * 2
    assert AnticlusterEngine(k=8, device=CPU).state_shardings(x) is None
    assert eng.price_shapes(x.shape) == ((2, 1, 4),)


def test_mesh_telemetry_is_none_as_jax():
    x = _data(96, 4, 59)
    eng = AnticlusterEngine(_spec(k=4, telemetry=True), device=CPU)
    jeng = JaxEngine(JaxSpec(k=4, telemetry=True, mesh=_jax_mesh1(),
                             data_axes=("data",)))
    res, _ = eng.partition(x)
    jeng.partition(jnp.asarray(x))
    assert eng.last_telemetry is None and jeng.last_telemetry is None
    assert res.balanced


# ---------------------------------------------------------------------------
# Two-shard sessions (twins of the reference's two-device cases)
# ---------------------------------------------------------------------------

def test_two_shard_engine_matches_oneshot_and_keeps_one_closure():
    rng = np.random.default_rng(64)
    x = _data(256, 6, 64)
    spec = _spec(k=16, mesh=_mesh(2))
    one = anticluster(x, spec, device=CPU)
    assert one.plan[0] == 2
    eng = AnticlusterEngine(spec, device=CPU)
    res, state = eng.partition(x)
    np.testing.assert_array_equal(_labels(res), _labels(one))
    res0, _ = eng.repartition(x, eng.init_state(x))
    np.testing.assert_array_equal(_labels(res0), _labels(one))
    assert state.prices[0].shape[0] == 2
    xs = x
    for _ in range(3):
        xs = xs + rng.normal(size=xs.shape).astype(np.float32) * 0.05
        res, state = eng.repartition(xs, state)
        assert res.balanced
    assert eng.compile_count == 1
    _locality(_labels(res), 2, 16)


def test_two_shard_stream_and_categories():
    rng = np.random.default_rng(65)
    x = _data(256, 5, 65)
    dense = _spec(k=8, mesh=_mesh(2))
    stream = dense.evolve(chunk_size=512)
    np.testing.assert_array_equal(_labels(anticluster(x, stream, device=CPU)),
                                  _labels(anticluster(x, dense, device=CPU)))
    cats = rng.integers(0, 4, size=256).astype(np.int32)
    res = anticluster(x, dense.evolve(categories=cats), device=CPU)
    assert res.balanced


def test_two_shard_uneven_rows_autopad_parity():
    x = _data(65, 3, 70)
    spec = _spec(k=4, mesh=_mesh(2))
    res = anticluster(x, spec, device=CPU)
    assert res.labels.shape == (65,)
    counts = np.bincount(_labels(res), minlength=4)
    assert counts.min() >= 65 // 4 and counts.max() <= -(-65 // 4)
    pad = np.concatenate([x, np.zeros((1, 3), np.float32)])
    ref = anticluster(pad, spec.evolve(valid_mask=np.arange(66) < 65),
                      device=CPU)
    np.testing.assert_array_equal(_labels(res), _labels(ref)[:65])
    eng = AnticlusterEngine(spec, device=CPU)
    r1, st = eng.partition(x)
    np.testing.assert_array_equal(_labels(r1), _labels(res))
    assert st.prev_labels.shape == (66,)
    r2, _ = eng.repartition(x, st)
    assert r2.balanced and eng.compile_count == 1
    with pytest.raises(ValueError, match="divisible"):
        anticluster(x, spec.evolve(valid_mask=np.ones(65, bool)), device=CPU)


# ---------------------------------------------------------------------------
# Consumers with a mesh
# ---------------------------------------------------------------------------

def test_service_sharded_warm_lane():
    from repro_torch.serve import AnticlusterRouter, AnticlusterService
    rng = np.random.default_rng(60)
    spec = _spec(k=4)
    svc = AnticlusterService(spec, device=CPU)
    reqs = [rng.normal(size=(64, 3)).astype(np.float32) for _ in range(3)]
    outs = svc.partition_many(reqs)
    one = anticluster(reqs[0], spec, device=CPU)
    np.testing.assert_array_equal(_labels(outs[0]), _labels(one))
    for r, xi in zip(outs, reqs):
        assert r.balanced
        o_warm = _objective(xi, _labels(r), 4)
        o_ref = _objective(xi, _labels(anticluster(xi, spec, device=CPU)), 4)
        assert abs(o_warm - o_ref) / abs(o_ref) < 0.01
    assert svc.lane_count == 1
    assert isinstance(svc._lanes[("solo", (64, 3))].state, ShardedABAState)
    outs2 = svc.partition_many(reqs)
    assert svc.lane_count == 1 and all(r.balanced for r in outs2)
    router = AnticlusterRouter(_spec(k=8, mesh=_mesh(2), max_k=2),
                               background=False, device=CPU)
    try:
        with pytest.raises(NotImplementedError, match="delta updates"):
            router.open_partition("live", reqs[0])
        with pytest.raises(ValueError, match="hierarchical"):
            router.submit(_data(65, 3))
        res = router.partition(_data(64, 3, 61))
        assert res.balanced and res.route == "mesh"
    finally:
        router.close()


def test_sequencer_mesh_epochs_compile_once():
    from repro_torch.data import ABABatchSequencer
    rng = np.random.default_rng(61)
    feats = rng.normal(size=(256, 5)).astype(np.float32)
    seq = ABABatchSequencer(feats, 32, chunk_size=None, mesh=_mesh(2),
                            data_axes=("data",), device=CPU)
    assert seq.engine.spec.mesh is not None
    assert seq.engine.compile_count == 1
    for epoch in range(1, 3):
        feats = feats + rng.normal(size=feats.shape).astype(np.float32) * .05
        batches = list(seq.epoch(epoch, features=feats))
        flat = np.sort(np.concatenate(batches))
        np.testing.assert_array_equal(flat, np.arange(256))
    assert seq.engine.compile_count == 1


def test_folds_mesh_engine():
    from repro_torch.data import aba_folds, fold_engine
    feats = _data(128, 4, 62)
    eng = fold_engine(4, mesh=_mesh(2), data_axes=("data",), device=CPU)
    labels = aba_folds(feats, 4, engine=eng)
    assert balance_ok(labels, 4, 128)
    assert eng.compile_count == 1
    _locality(labels, 2, 4)


def test_sequencer_mesh_unplaceable_k_falls_back():
    from repro_torch.data import ABABatchSequencer
    feats = _data(56, 4, 63)
    with pytest.warns(RuntimeWarning, match="single-device"):
        seq = ABABatchSequencer(feats, 8, max_k=4, mesh=_mesh(1),
                                data_axes=("data",), device=CPU)
    assert seq.engine.spec.mesh is None
    with pytest.warns(RuntimeWarning, match="placement on the mesh"):
        seq = ABABatchSequencer(feats, 8, mesh=_mesh(2), device=CPU)  # k=7
    assert seq.engine.spec.mesh is None
