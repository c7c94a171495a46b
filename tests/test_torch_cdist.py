"""The port's ``cdist`` entry point against the JAX package's.

The same numpy inputs go through ``repro.kernels.ops.cdist`` (the Pallas
kernels in interpret mode, and the jnp reference) and through the port's
``repro_torch.kernels.cdist``, which runs its plain versions on CPU
tensors.  The CUDA kernels are held against those plain versions on the
card by tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerances: small-integer inputs make every product and sum exact, so
distances match bitwise; on Gaussian floats the two sum the d products in
another order, so an entry may differ by a few ulps of the norms it
cancels: ``1e-5 (||x||^2 + ||c||^2) + 1e-6``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import cdist_ref as jax_cdist_ref
from repro.kernels.ops import cdist as jax_cdist

import repro_torch.kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.cdist import cdist as cuda_cdist
from repro_torch.kernels.gather import cdist_gather as cuda_cdist_gather
from repro_torch.kernels.ref import cdist_gather_ref, cdist_ref


def _inputs(seed, m, n, d, integer, lead=()):
    rng = np.random.default_rng(seed)
    if integer:
        x = rng.integers(-2, 3, size=lead + (m, d)).astype(np.float32)
        c = rng.integers(-1, 2, size=(n, d)).astype(np.float32)
    else:
        x = rng.normal(size=lead + (m, d)).astype(np.float32)
        c = rng.normal(size=(n, d)).astype(np.float32)
    return x, c


def _check(got, want, x_rows, c, integer):
    """Bitwise on integers, else within 1e-5 (||x||^2 + ||c||^2) + 1e-6."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if integer:
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
        return
    xn = (x_rows.astype(np.float64) ** 2).sum(-1)[..., None]
    cn = (c.astype(np.float64) ** 2).sum(-1)
    tol = 1e-5 * (xn + cn) + 1e-6
    assert (np.abs(got.astype(np.float64) - want) <= tol).all(), \
        float(np.max(np.abs(got - want) - tol))


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("m,n,d", [(37, 5, 3), (64, 256, 22), (16, 130, 200)])
def test_cdist_vs_jax(m, n, d, integer):
    x, c = _inputs(m * 7 + n + d, m, n, d, integer)
    got = [t(torch.from_numpy(x), torch.from_numpy(c)).numpy()
           for t in (K.cdist, cuda_cdist, cdist_ref)]
    jx, jc = jnp.asarray(x), jnp.asarray(c)
    for want in (jax_cdist(jx, jc, force="pallas"), jax_cdist_ref(jx, jc)):
        for g in got:
            _check(g, want, x, c, integer)


@pytest.mark.parametrize("integer", [True, False])
def test_cdist_leading_chunk_dims(integer):
    """(..., m, d) rows are flattened into one call and restored."""
    x, c = _inputs(3, 20, 40, 22, integer, lead=(3, 2))
    got = K.cdist(torch.from_numpy(x), torch.from_numpy(c)).numpy()
    want = jax_cdist(jnp.asarray(x), jnp.asarray(c), force="pallas")
    assert got.shape == (3, 2, 20, 40)
    _check(got, want, x, c, integer)
    flat = K.cdist(torch.from_numpy(x.reshape(-1, 22)), torch.from_numpy(c))
    np.testing.assert_array_equal(got.reshape(-1, 40), flat.numpy())


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("d", [22, 600])
def test_cdist_idx_in_range_vs_jax(d, integer):
    """In-range indices: against the reference's jnp take and its Pallas
    kernels (the fused gather kernel at d <= 512, gather + tiled kernel
    above)."""
    x, c = _inputs(d, 50, 24, d, integer)
    idx = np.random.default_rng(d).integers(0, 50, size=(40,))
    jx, jc = jnp.asarray(x), jnp.asarray(c)
    ji = jnp.asarray(idx.astype(np.int32))
    wants = [jax_cdist(jx, jc, idx=ji, force=f) for f in ("ref", "pallas")]
    for dtype in (torch.int32, torch.int64):
        got = K.cdist(torch.from_numpy(x), torch.from_numpy(c),
                      idx=torch.from_numpy(idx).to(dtype)).numpy()
        for want in wants:
            _check(got, want, x[idx], c, integer)


@pytest.mark.parametrize("integer", [True, False])
def test_cdist_idx_out_of_range_clips_like_pallas(integer):
    """Out-of-range indices clip to [0, n - 1], as the Pallas kernel does.
    The reference's jnp path wraps a negative index instead (ROADMAP R4),
    so it is not the comparison here."""
    x, c = _inputs(5, 50, 24, 22, integer)
    idx = np.array([-1, 49, 50, -60, 7, 10**6, 0, -2] * 4)
    want = jax_cdist(jnp.asarray(x), jnp.asarray(c),
                     idx=jnp.asarray(idx.astype(np.int32)), force="pallas")
    clipped = x[np.clip(idx, 0, 49)]
    for dtype in (torch.int32, torch.int64):
        ti = torch.from_numpy(idx).to(dtype)
        for got in (K.cdist(torch.from_numpy(x), torch.from_numpy(c), idx=ti),
                    cuda_cdist_gather(torch.from_numpy(x), ti,
                                      torch.from_numpy(c))):
            _check(got.numpy(), want, clipped, c, integer)
    jnp_path = np.asarray(jax_cdist(jnp.asarray(x), jnp.asarray(c),
                                    idx=jnp.asarray(idx.astype(np.int32)),
                                    force="ref"))
    assert not np.array_equal(jnp_path, np.asarray(want))  # R4 still holds


def test_cdist_gather_equals_cdist_of_gathered_rows():
    x, c = _inputs(9, 30, 12, 7, False)
    tx, tc = torch.from_numpy(x), torch.from_numpy(c)
    idx = torch.tensor([3, -4, 29, 31, 0, 3])
    want = cdist_ref(tx[idx.clamp(0, 29)], tc)
    assert torch.equal(cdist_gather_ref(tx, idx, tc), want)
    assert torch.equal(K.cdist(tx, tc, idx=idx), want)


def test_cdist_cpu_calls_launch_nothing():
    x, c = (torch.from_numpy(a) for a in _inputs(2, 9, 4, 3, False))
    before = dict(_build.launches)
    K.cdist(x, c)
    K.cdist(x, c, idx=torch.arange(5))
    K.cdist(x[None], c)
    assert _build.launches == before
    with pytest.raises(ValueError):
        K.cdist(x[None], c, idx=torch.arange(5))
