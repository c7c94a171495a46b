"""The port's kernels (bid_top2, gather_rows, bid_top2(idx=)) and its
kernel entry point against the JAX package's.

The same numpy inputs go through the JAX kernels (the Pallas bodies in
interpret mode, and the jnp references) and through the port's plain
versions, which are what the port's wrappers run on a CPU tensor.  The CUDA
kernels themselves are held against those plain versions on the card by
tests/test_torch_cuda.py and by ``chip_smoke.py``.
"""

import ctypes
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.kernels as jax_kernels
from repro.kernels.bid_top2 import bid_top2_pallas
from repro.kernels.ops import bid_top2 as jax_bid_top2
from repro.kernels.gather import gather_rows_pallas
from repro.kernels.ref import bid_top2_ref as jax_bid_top2_ref

from repro_torch.kernels import _build, ops
from repro_torch.kernels.bid_top2 import bid_top2 as cuda_bid_top2
from repro_torch.kernels.gather import gather_rows as cuda_gather_rows
from repro_torch.kernels.gather import bid_top2_gather as cuda_bid_gather
from repro_torch.kernels.ref import (bid_top2_gather_ref, bid_top2_ref,
                                     gather_rows_ref)


def _int_inputs(seed, m, k, d, G=None):
    rng = np.random.default_rng(seed)
    lead = () if G is None else (G,)
    x = rng.integers(-2, 3, size=lead + (m, d)).astype(np.float32)
    c = rng.integers(-1, 2, size=lead + (k, d)).astype(np.float32)
    p = rng.integers(-2, 3, size=lead + (k,)).astype(np.float32)
    return x, c, p


def _t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
def test_gather_rows_bitwise_vs_jax_pallas(idx_dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(253, 22)).astype(np.float32)
    idx = rng.integers(-40, 300, size=(300,)).astype(idx_dtype)  # clipped
    want = np.asarray(gather_rows_pallas(jnp.asarray(x),
                                         jnp.asarray(idx.astype(np.int32)),
                                         interpret=True))
    got = gather_rows_ref(*_t(x, idx)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    got_ops = ops.gather_rows(*_t(x, idx)).numpy()
    np.testing.assert_array_equal(got_ops.view(np.int32),
                                  want.view(np.int32))


@pytest.mark.parametrize("m,k,d", [(37, 1, 5), (37, 37, 5), (20, 513, 16),
                                   (8, 130, 3)])
def test_bid_top2_exact_on_integers(m, k, d):
    """Small integers make every product exact and ties common: v1, j1, v2
    match the JAX reference and Pallas kernel exactly (lowest column wins,
    a doubled maximum gives v2 == v1)."""
    x, c, p = _int_inputs(m * 1000 + k, m, k, d)
    got = [t.numpy() for t in bid_top2_ref(*_t(x, c, p))]
    jx = (jnp.asarray(x), jnp.asarray(c), jnp.asarray(p))
    for want in (jax_bid_top2_ref(*jx), bid_top2_pallas(*jx, interpret=True)):
        want = [np.asarray(w) for w in want]
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1].astype(np.int64))
        np.testing.assert_array_equal(got[2], want[2])
    if k > 1:
        assert (got[0] == got[2]).any(), "inputs should produce ties"


@pytest.mark.parametrize("m,k,d", [(64, 37, 5), (16, 513, 16)])
def test_bid_top2_float_vs_jax(m, k, d):
    """Gaussian floats: values within rtol 1e-5 / atol 1e-4*scale, and the
    argmax equal wherever JAX's top-2 gap exceeds 1e-4*scale."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(m, d)).astype(np.float32)
    c = rng.normal(size=(k, d)).astype(np.float32)
    p = rng.normal(size=(k,)).astype(np.float32)
    v1, j1, v2 = (t.numpy() for t in bid_top2_ref(*_t(x, c, p)))
    for fn in (jax_bid_top2_ref,
               lambda *a: bid_top2_pallas(*a, interpret=True)):
        w1, wj, w2 = (np.asarray(w) for w in fn(jnp.asarray(x),
                                                jnp.asarray(c),
                                                jnp.asarray(p)))
        scale = float(np.abs(w1).max())
        np.testing.assert_allclose(v1, w1, rtol=1e-5, atol=1e-4 * scale)
        np.testing.assert_allclose(v2, w2, rtol=1e-5, atol=1e-4 * scale)
        clear = (w1 - w2) > 1e-4 * scale
        np.testing.assert_array_equal(j1[clear], wj[clear])


def test_bid_top2_stacked_equals_per_group():
    x, c, p = _int_inputs(3, 40, 37, 6, G=4)
    rng = np.random.default_rng(4)
    x = x + rng.normal(size=x.shape).astype(np.float32)  # non-integer too
    stacked = ops.bid_top2(*_t(x, c, p))
    for g in range(4):
        single = ops.bid_top2(*_t(x[g], c[g], p[g]))
        for s, t in zip(stacked, single):
            np.testing.assert_array_equal(s[g].numpy(), t.numpy())


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    x, c, p = _t(*_int_inputs(5, 8, 9, 3))
    before = dict(_build.launches)
    assert ops.resolve_path(x) == "ref" and ops.gather_path(x) == "ref"
    with ops.forced_path("ref"):
        assert ops.resolve_path(x) == "ref"
    cuda_bid_top2(x, c, p)
    cuda_gather_rows(c, torch.arange(3))
    assert _build.launches == before
    with pytest.raises(ValueError):
        with ops.forced_path("pallas"):
            pass


def _assert_top2(got, want, integer):
    """Exact on integers; on floats the values within rtol 1e-5 / atol
    1e-4*scale and the argmax equal where the top-2 gap exceeds
    1e-4*scale (bid_top2's tolerance above)."""
    v1, j1, v2 = (t.numpy() for t in got)
    w1, wj, w2 = (np.asarray(w) for w in want)
    if integer:
        np.testing.assert_array_equal(v1, w1)
        np.testing.assert_array_equal(j1, wj.astype(np.int64))
        np.testing.assert_array_equal(v2, w2)
        return
    scale = float(np.abs(w1).max())
    np.testing.assert_allclose(v1, w1, rtol=1e-5, atol=1e-4 * scale)
    np.testing.assert_allclose(v2, w2, rtol=1e-5, atol=1e-4 * scale)
    clear = (w1 - w2) > 1e-4 * scale
    np.testing.assert_array_equal(j1[clear], wj[clear])


def _idx_inputs(seed, n, k, d, integer):
    x, c, p = _int_inputs(seed, n, k, d)
    if not integer:
        rng = np.random.default_rng(seed)
        x, c, p = (rng.normal(size=a.shape).astype(np.float32)
                   for a in (x, c, p))
    return x, c, p


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("k,d", [(37, 5), (256, 22), (130, 600)])
def test_bid_top2_idx_in_range_vs_jax(k, d, integer):
    """In-range indices: against the reference's jnp take and its Pallas
    kernels (the fused gather kernel at d <= 512, gather + bid_top2
    above)."""
    x, c, p = _idx_inputs(k + d, 60, k, d, integer)
    idx = np.random.default_rng(d).integers(0, 60, size=(48,))
    jargs = (jnp.asarray(x), jnp.asarray(c), jnp.asarray(p))
    ji = jnp.asarray(idx.astype(np.int32))
    wants = [jax_bid_top2(*jargs, idx=ji, force=f) for f in ("ref", "pallas")]
    for dtype in (torch.int32, torch.int64):
        got = ops.bid_top2(*_t(x, c, p), idx=torch.from_numpy(idx).to(dtype))
        for want in wants:
            _assert_top2(got, want, integer)


@pytest.mark.parametrize("integer", [True, False])
def test_bid_top2_idx_out_of_range_clips_like_pallas(integer):
    """Out-of-range indices clip to [0, n - 1], as the Pallas kernel does
    (the reference's jnp path wraps negatives instead: ROADMAP R4)."""
    x, c, p = _idx_inputs(11, 60, 37, 22, integer)
    idx = np.array([-1, 59, 60, -100, 3, 10**6, 0, -7] * 5)
    want = jax_bid_top2(jnp.asarray(x), jnp.asarray(c), jnp.asarray(p),
                        idx=jnp.asarray(idx.astype(np.int32)), force="pallas")
    for dtype in (torch.int32, torch.int64):
        ti = torch.from_numpy(idx).to(dtype)
        for got in (ops.bid_top2(*_t(x, c, p), idx=ti),
                    cuda_bid_gather(_t(x)[0], ti, *_t(c, p))):
            _assert_top2(got, want, integer)


def test_bid_top2_gather_equals_bid_top2_of_gathered_rows():
    x, c, p = _t(*_idx_inputs(12, 30, 9, 6, False))
    idx = torch.tensor([0, -3, 29, 30, 5, 5])
    want = bid_top2_ref(x[idx.clamp(0, 29)], c, p)
    for got in (bid_top2_gather_ref(x, idx, c, p),
                ops.bid_top2(x, c, p, idx=idx)):
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    with pytest.raises(ValueError):
        ops.bid_top2(x[None], c, p, idx=idx)


def test_bid_top2_gather_measurement_entries_take_cuda_tensors_only():
    """The fused kernel's previous design and its timed instantiation are
    for measurement only and have no plain version: on CPU tensors they
    raise and count nothing.  Their C functions live in the kernel's own
    library, with its argument types (the timed one adds its stamps and
    the grid it reports), and each C symbol the loader knows is defined in
    a source of csrc/."""
    from repro_torch.kernels.gather import (STAGES, bid_top2_gather_prev,
                                            bid_top2_gather_timed)
    x, c, p = _t(*_idx_inputs(13, 30, 9, 6, False))
    idx = torch.tensor([0, -3, 29, 30])
    before = dict(_build.launches)
    for fn in (bid_top2_gather_prev, bid_top2_gather_timed):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x, idx, c, p)
    assert _build.launches == before
    main = _build._SYMBOLS["bid_top2_gather"][1]
    assert _build._MORE_SYMBOLS["bid_top2_gather_prev_f32"] == main
    assert (_build._MORE_SYMBOLS["bid_top2_gather_timed_f32"]
            == main[:-1] + (ctypes.c_void_p,) * 3)
    assert len(STAGES) == 8 and STAGES[-2:] == ("cta", "tiles")
    sources = "".join(f.read_text() for f in _build._CSRC.glob("*.cu"))
    symbols = [sym for sym, _ in _build._SYMBOLS.values()]
    for sym in symbols + list(_build._MORE_SYMBOLS):
        assert f'extern "C" int {sym}(' in sources, sym
    gather_src = (_build._CSRC / "bid_top2_gather.cu").read_text()
    for sym in ("bid_top2_gather_f32", "bid_top2_gather_prev_f32",
                "bid_top2_gather_timed_f32"):
        assert f'extern "C" int {sym}(' in gather_src


def test_entry_point_exports_the_reference_names():
    """``repro_torch.kernels`` exports the counterpart of every name of
    ``repro.kernels`` (``ssm_scan`` for ``ssm_scan_pallas``), and all of
    them run on CPU tensors without a build."""
    import repro_torch.kernels as K
    want = [n.replace("ssm_scan_pallas", "ssm_scan")
            for n in jax_kernels.__all__]
    assert sorted(K.__all__) == sorted(want)
    assert all(callable(getattr(K, n)) for n in K.__all__)
    assert K.bid_top2 is ops.bid_top2 and K.cdist is ops.cdist


def test_library_path_hashes_sources_and_headers(tmp_path, monkeypatch):
    """Editing a header that a source includes moves the library's path, so
    a stale build is never loaded; so does editing the source itself."""
    from repro_torch.kernels import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build._CSRC, csrc)
    monkeypatch.setattr(_build, "_CSRC", csrc)
    assert '#include "bid_top2.cuh"' in (csrc / "bid_top2.cu").read_text()
    paths = {name: _build.library_path(name) for name in _build._SYMBOLS}
    assert len(set(paths.values())) == len(paths)
    header = csrc / "bid_top2.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    for name in ("bid_top2", "bid_top2_gather"):
        moved = _build.library_path(name)
        assert moved != paths[name] and moved.parent == paths[name].parent
    source = csrc / "cdist.cu"
    before = _build.library_path("cdist")
    source.write_text(source.read_text() + "\n// edited\n")
    assert _build.library_path("cdist") != before
