"""The selective scan's gradient in the port against the JAX reference, on
the CPU.

``ops.ssm_scan`` is a ``torch.autograd.Function`` on both paths; on the CPU
its backward is ``ref.ssm_scan_bwd_ref``, the reverse walk written out (the
plain version of ``csrc/ssm_scan_bwd.cu``, which runs on the card: the
``cuda`` tests hold the two together).  Here: the Function's gradients of
dt, B, C, x, A (and of h_final's cotangent) against ``jax.vjp`` of the
reference's ``ssm_scan_ref``, within 1e-5 of each gradient's max |.|, at S
a multiple of the kernels' 16-step tile and not; ``gradcheck`` in float64;
the node; nothing recorded when nothing needs a gradient; a Mamba layer's
parameter gradients against ``jax.grad`` through ``mamba_apply`` (its
``scan_chunk`` 16: S divisible and not).  Every draw comes from a
``default_rng`` of the test's own.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels.ref import ssm_scan_ref as jax_ssm_scan_ref
from repro.models import mamba as jax_mamba
from repro.models import registry as jax_registry

from repro_torch.kernels import _build, ops
from repro_torch.kernels.ref import ssm_scan_chunk_bwd_ref, ssm_scan_chunk_ref
from repro_torch.kernels.ssm_scan import ssm_scan_bwd, ssm_scan_train
from repro_torch.models import registry
from repro_torch.models.mamba import Mamba, mamba_defs

REL = 1e-5  # of each gradient's max |.|


def _scan_inputs(rng, bsz, s, di, ds, dtype=np.float32):
    return [a.astype(dtype) for a in (
        rng.uniform(0.0, 0.3, (bsz, s, di)), rng.normal(size=(bsz, s, ds)),
        rng.normal(size=(bsz, s, ds)), rng.normal(size=(bsz, s, di)),
        -rng.uniform(0.5, 4.0, (di, ds)))]


def _rel_close(got, want, rel=REL):
    want = np.asarray(want)
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    assert got.shape == want.shape
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= rel * scale + 1e-12, (
        np.abs(got - want).max(), scale)


@pytest.mark.parametrize("s", [32, 37, 5])
def test_function_grads_equal_jax_vjp(s):
    rng = np.random.default_rng(s)
    arrs = _scan_inputs(rng, 2, s, 12, 4)
    dy = rng.normal(size=(2, s, 12)).astype(np.float32)
    dh = rng.normal(size=(2, 12, 4)).astype(np.float32)
    ts = [torch.tensor(a, requires_grad=True) for a in arrs]
    y, h = ops.ssm_scan(*ts)
    torch.autograd.backward((y, h), (torch.from_numpy(dy),
                                     torch.from_numpy(dh)))
    (jy, jh), vjp = jax.vjp(jax_ssm_scan_ref, *map(jnp.asarray, arrs))
    _rel_close(y, jy, 1e-6)
    _rel_close(h, jh, 1e-6)
    for t, want in zip(ts, vjp((jnp.asarray(dy), jnp.asarray(dh)))):
        _rel_close(t.grad, want)


def test_function_grads_of_y_alone_and_h_alone():
    """A loss of y alone (h_final's cotangent None) and of h alone."""
    rng = np.random.default_rng(3)
    arrs = _scan_inputs(rng, 1, 21, 6, 3)
    (jy, jh), vjp = jax.vjp(jax_ssm_scan_ref, *map(jnp.asarray, arrs))
    for use_y in (True, False):
        ts = [torch.tensor(a, requires_grad=True) for a in arrs]
        y, h = ops.ssm_scan(*ts)
        (y.sum() if use_y else h.sum()).backward()
        cot = (jnp.ones_like(jy) if use_y else jnp.zeros_like(jy),
               jnp.zeros_like(jh) if use_y else jnp.ones_like(jh))
        for t, want in zip(ts, vjp(cot)):
            _rel_close(t.grad, want)


def test_gradcheck_float64():
    rng = np.random.default_rng(4)
    arrs = [torch.tensor(a, requires_grad=True)
            for a in _scan_inputs(rng, 2, 5, 3, 2, np.float64)]
    assert torch.autograd.gradcheck(
        lambda *a: ops.SSMScan.apply("ref", True, *a), arrs)


def test_grad_fn_is_the_function_and_nothing_recorded_without_grad():
    rng = np.random.default_rng(5)
    arrs = [torch.from_numpy(a) for a in _scan_inputs(rng, 1, 9, 4, 2)]
    y, h = ops.ssm_scan(*arrs)
    assert y.grad_fn is None and h.grad_fn is None
    req = [a.clone().requires_grad_(True) for a in arrs]
    y, h = ops.ssm_scan(*req)
    assert type(y.grad_fn) is ops.SSMScan._backward_cls
    assert y.grad_fn is h.grad_fn
    with torch.no_grad():
        y, _ = ops.ssm_scan(*req)
    assert y.grad_fn is None and not y.requires_grad
    launches = dict(_build.launches)
    ops.ssm_scan(*req)[0].sum().backward()
    assert _build.launches == launches  # the CPU runs no kernel


def test_plain_train_and_bwd_wrappers_with_h0():
    """The wrappers' plain versions: the states a tile of 16 steps apart
    (those of the plain scan cut there), and the time-major gradient from
    a nonzero h0, its dh0 too, against autograd of the plain forward loop
    (an independent oracle of the written-out walk)."""
    rng = np.random.default_rng(6)
    arrs = [torch.from_numpy(a) for a in _scan_inputs(rng, 2, 35, 5, 3)]
    y, h, tiles = ssm_scan_train(*arrs)
    want_y, want_h = ops.ssm_scan(*arrs)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert tiles.shape == (2, 3, 5, 3)
    tm = [t.transpose(0, 1) for t in arrs[:4]]
    _, h16 = ssm_scan_chunk_ref(*(t[:16] for t in tm), arrs[4],
                                torch.zeros(2, 5, 3))
    assert torch.equal(tiles[:, 0], torch.zeros(2, 5, 3))
    assert torch.equal(tiles[:, 1], h16)
    h0 = torch.from_numpy(rng.normal(size=(2, 5, 3)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(35, 2, 5)).astype(np.float32))
    dh = torch.from_numpy(rng.normal(size=(2, 5, 3)).astype(np.float32))
    tmc = [t.contiguous() for t in tm]
    _, _, tiles = ssm_scan_train(*tmc, arrs[4], h0, time_major=True)
    got = ssm_scan_bwd(*tmc, arrs[4], tiles, dy, dh, time_major=True)
    leaves = [t.clone().requires_grad_(True) for t in (*tmc, arrs[4], h0)]
    yy, hh = ssm_scan_chunk_ref(*leaves)
    torch.autograd.backward((yy, hh), (dy, dh))
    for g, leaf in zip(got, leaves):
        _rel_close(g, leaf.grad.numpy())
    assert torch.equal(got[-1], ssm_scan_chunk_bwd_ref(
        *tmc, arrs[4], h0, dy, dh)[-1])


def _mamba_weights(cfg, rng):
    out = {}
    for name, pd in mamba_defs(cfg).items():
        scale = 1.0 / math.sqrt(pd.fan_in) if pd.fan_in else 0.1
        out[name] = (rng.normal(size=pd.shape) * scale).astype(np.float32)
    out["a_log"] = np.log(rng.uniform(0.5, 8.0, size=out["a_log"].shape)
                          ).astype(np.float32)
    out["dt_b"] = rng.uniform(-3.0, -1.0, size=out["dt_b"].shape
                              ).astype(np.float32)
    return out


@pytest.mark.parametrize("seq", [32, 30])
def test_mamba_layer_grads_equal_jax_grad(seq):
    """Every parameter gradient of one Mamba layer, and the input's, against
    ``jax.grad`` through ``mamba_apply`` with ``scan_chunk`` 16 (S = 32
    takes the reference's checkpointed chunks, S = 30 its chunk-1
    fallback), within 1e-5 of each gradient's max |.|; the loss reads the
    output and h_final."""
    cfg, jcfg = (reg.get_config("falcon-mamba-7b", reduced=True)
                 for reg in (registry, jax_registry))
    cfg, jcfg = (dataclasses.replace(c, ssm=dataclasses.replace(
        c.ssm, scan_chunk=16)) for c in (cfg, jcfg))
    rng = np.random.default_rng(seq)
    w = _mamba_weights(cfg, rng)
    x = rng.normal(size=(2, seq, cfg.d_model)).astype(np.float32)
    wo = rng.normal(size=(2, seq, cfg.d_model)).astype(np.float32)
    wh = rng.normal(size=(2, cfg.d_inner, cfg.ssm.d_state)).astype(np.float32)

    def jloss(params, xx):
        out, (_, h) = jax_mamba.mamba_apply(jcfg, params, xx)
        return jnp.sum(out * wo) + jnp.sum(h * wh)

    jgw, jgx = jax.grad(jloss, argnums=(0, 1))(
        {k: jnp.asarray(v) for k, v in w.items()}, jnp.asarray(x))
    layer = Mamba(cfg, device="cpu")
    with torch.no_grad():
        for name, a in w.items():
            getattr(layer, name).copy_(torch.from_numpy(a))
    layer.requires_grad_(True)
    xt = torch.tensor(x, requires_grad=True)
    out, (_, h) = layer(xt)
    ((out * torch.from_numpy(wo)).sum()
     + (h * torch.from_numpy(wh)).sum()).backward()
    _rel_close(xt.grad, jgx)
    for name, p in layer.named_parameters():
        _rel_close(p.grad, jgw[name])
