"""The port's selective scan against the JAX package's.

The same numpy inputs go through ``repro.kernels.ssm_scan_pallas`` /
``ssm_scan_chunk_pallas`` (in interpret mode) and ``ssm_scan_ref``, and
through the port's ``ssm_scan`` / ``ssm_scan_chunk``, which run their plain
versions on CPU tensors.  The CUDA kernel is held against those plain
versions on the card by tests/test_torch_cuda.py and ``chip_smoke.py``.

Tolerance: rtol 1e-4, atol 1e-4, that of the reference's own kernel test
(tests/test_kernels.py::test_ssm_scan_allclose): exp and the sum order of
y_t differ between the implementations.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ssm_scan_pallas, ssm_scan_ref as jax_ssm_scan_ref
from repro.kernels.ssm_scan import ssm_scan_chunk_pallas

import repro_torch.kernels as K
from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssm_scan_chunk_ref, ssm_scan_ref
from repro_torch.kernels.ssm_scan import ssm_scan_chunk

TOL = dict(rtol=1e-4, atol=1e-4)


def _inputs(seed, lead, di, ds):
    """dt > 0, A < 0 as in Mamba; ``lead`` is (B, S) or (C, B)."""
    rng = np.random.default_rng(seed)
    dt = (np.abs(rng.normal(size=lead + (di,))) * 0.1).astype(np.float32)
    b = rng.normal(size=lead + (ds,)).astype(np.float32)
    c = rng.normal(size=lead + (ds,)).astype(np.float32)
    x = rng.normal(size=lead + (di,)).astype(np.float32)
    a = (-np.abs(rng.normal(size=(di, ds)))).astype(np.float32)
    return dt, b, c, x, a


@pytest.mark.parametrize("s,di,ds,chunk", [(32, 64, 8, 8), (24, 128, 16, 8),
                                           (17, 32, 40, 16)])
def test_ssm_scan_vs_jax(s, di, ds, chunk):
    arrays = _inputs(s + di + ds, (2, s), di, ds)
    y, h = K.ssm_scan(*(torch.from_numpy(a) for a in arrays))
    assert y.shape == (2, s, di) and h.shape == (2, di, ds)
    ja = [jnp.asarray(a) for a in arrays]
    for want_y, want_h in (ssm_scan_pallas(*ja, chunk=chunk,
                                           bdi=min(64, di), interpret=True),
                           jax_ssm_scan_ref(*ja)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


@pytest.mark.parametrize("c,di,ds", [(8, 64, 16), (5, 32, 8)])
def test_ssm_scan_chunk_nonzero_h0_vs_jax(c, di, ds):
    arrays = _inputs(c * di, (c, 2), di, ds)
    h0 = np.random.default_rng(1).normal(size=(2, di, ds)).astype(np.float32)
    y, h = ssm_scan_chunk(*(torch.from_numpy(a) for a in arrays + (h0,)))
    want_y, want_h = ssm_scan_chunk_pallas(
        *(jnp.asarray(a) for a in arrays + (h0,)), bdi=min(64, di),
        interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_ssm_scan_is_chunks_carried_through_h():
    """The full-sequence scan equals two time-major chunks, the second
    started from the first's final state."""
    dt, b, c, x, a = (torch.from_numpy(t) for t in _inputs(3, (2, 12), 16, 4))
    y, h = ssm_scan_ref(dt, b, c, x, a)
    tm = [t.transpose(0, 1) for t in (dt, b, c, x)]
    h0 = torch.zeros(2, 16, 4)
    y1, h1 = ssm_scan_chunk_ref(*(t[:5] for t in tm), a, h0)
    y2, h2 = ssm_scan_chunk_ref(*(t[5:] for t in tm), a, h1)
    assert torch.equal(torch.cat([y1, y2]).transpose(0, 1), y)
    assert torch.equal(h2, h)


def test_ssm_scan_cpu_calls_launch_nothing():
    arrays = [torch.from_numpy(t) for t in _inputs(4, (1, 3), 8, 4)]
    before = dict(_build.launches)
    K.ssm_scan(*arrays)
    ssm_scan_chunk(*arrays, torch.zeros(3, 8, 4))
    assert _build.launches == before
