"""The port's kernels (bid_top2, gather_rows) against the JAX package's.

The same numpy inputs go through the JAX kernels (the Pallas bodies in
interpret mode, and the jnp references) and through the port's plain
versions, which are what the port's wrappers run on a CPU tensor.  The CUDA
kernels themselves are held against those plain versions on the card by
tests/test_torch_cuda.py and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.bid_top2 import bid_top2_pallas
from repro.kernels.gather import gather_rows_pallas
from repro.kernels.ref import bid_top2_ref as jax_bid_top2_ref

from repro_torch.kernels import bid_top2 as bid_mod
from repro_torch.kernels import gather as gather_mod
from repro_torch.kernels import ops
from repro_torch.kernels.ref import bid_top2_ref, gather_rows_ref


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
    before = (bid_mod.launches, gather_mod.launches)
    assert ops.resolve_path(x) == "ref" and ops.gather_path(x) == "ref"
    with ops.forced_path("ref"):
        assert ops.resolve_path(x) == "ref"
    bid_mod.bid_top2(x, c, p)
    gather_mod.gather_rows(c, torch.arange(3))
    assert (bid_mod.launches, gather_mod.launches) == before
    with pytest.raises(ValueError):
        with ops.forced_path("pallas"):
            pass
