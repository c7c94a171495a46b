"""The port's Multi-head Latent Attention (``repro_torch.models.mla``)
against the JAX reference's (``repro.models.mla``) on the CPU.

``mla_defs`` name for name, full and reduced; with ``q_lora`` 0 and 32:
the expanded prefill (its output and the latents it hands to the cache)
and three absorbed decode steps over the compressed cache, each within
rtol / atol 1e-4 of ``mla_apply`` in float32; the absorbed decode step
against the expanded form's last row over the extended sequence (the two
forms are one function); a decode write past the cache raises (departure
P10).  Every draw comes from a ``default_rng`` of the test's own.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import mla as jax_mla
from repro.models import registry as jax_registry

from repro_torch.models import mla
from repro_torch.models import registry

ARCH = "deepseek-v2-236b"
TOL = dict(rtol=1e-4, atol=1e-4)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _configs(q_lora):
    return [dataclasses.replace(c, mla=dataclasses.replace(c.mla,
                                                           q_lora=q_lora))
            for c in (registry.get_config(ARCH, reduced=True),
                      jax_registry.get_config(ARCH, reduced=True))]


def _positions(b, start, s):
    return np.broadcast_to(np.arange(start, start + s), (b, s)).astype(
        np.int32)


@pytest.fixture(scope="module", params=[0, 32], ids=["q_lora=0", "q_lora=32"])
def run(request):
    """One reference run a ``q_lora``: the prefill of S = 20 and three
    decode steps, on the same numpy weights and inputs in both."""
    cfg, jcfg = _configs(request.param)
    rng = np.random.default_rng(request.param)
    w = {}
    for name, pd in mla.mla_defs(cfg).items():
        scale = 1.0 / math.sqrt(pd.fan_in) if pd.fan_in else 0.3
        w[name] = (rng.normal(size=pd.shape) * scale).astype(np.float32)
    layer = mla.MLA(cfg, device="cpu")
    with torch.no_grad():
        for name, a in w.items():
            getattr(layer, name).copy_(torch.from_numpy(a))
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    b, s, steps, max_len = 2, 20, 3, 26
    xs = rng.normal(size=(b, s + steps, cfg.d_model)).astype(np.float32)
    out = {"cfg": cfg, "layer": layer, "x": xs, "s": s, "steps": steps}
    pos = _positions(b, 0, s)
    out["prefill"] = layer(torch.from_numpy(xs[:, :s]), torch.from_numpy(pos))
    out["ref_prefill"] = jax_mla.mla_apply(jcfg, jw, jnp.asarray(xs[:, :s]),
                                           jnp.asarray(pos))[0]
    out["ref_latents"] = jax_mla._latents(jcfg, jw, jnp.asarray(xs[:, :s]),
                                          jnp.asarray(pos))
    ckv = torch.zeros(b, max_len, cfg.mla.kv_lora)
    kr = torch.zeros(b, max_len, cfg.mla.qk_rope_dim)
    jcache = tuple(jnp.zeros(t.shape) for t in (ckv, kr))
    for t, full in zip((ckv, kr), out["prefill"][1]):
        t[:, :s] = full
    jcache = tuple(jc.at[:, :s].set(lat)
                   for jc, lat in zip(jcache, out["ref_latents"]))
    out["steps_out"], out["ref_steps"] = [], []
    for i in range(steps):
        x1 = xs[:, s + i:s + i + 1]
        p1 = _positions(b, s + i, 1)
        y, (ckv, kr) = layer(torch.from_numpy(x1), torch.from_numpy(p1),
                             cache=(ckv, kr), kv_len=s + i)
        jy, jcache = jax_mla.mla_apply(jcfg, jw, jnp.asarray(x1),
                                       jnp.asarray(p1), cache=jcache,
                                       kv_len=jnp.int32(s + i))
        out["steps_out"].append((y, ckv.clone(), kr.clone()))
        out["ref_steps"].append((jy,) + tuple(jcache))
    return out


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("q_lora", [None, 0])
def test_mla_defs_equal_reference(reduced, q_lora):
    cfg = registry.get_config(ARCH, reduced=reduced)
    jcfg = jax_registry.get_config(ARCH, reduced=reduced)
    if q_lora is not None:
        cfg, jcfg = (dataclasses.replace(c, mla=dataclasses.replace(
            c.mla, q_lora=q_lora)) for c in (cfg, jcfg))
    got = {k: tuple(pd) for k, pd in mla.mla_defs(cfg).items()}
    want = {k: (tuple(pd.shape), tuple(pd.axes), pd.fan_in)
            for k, pd in jax_mla.mla_defs(jcfg).items()}
    assert got == want
    assert ("wq" in got) == (cfg.mla.q_lora == 0)


def test_expanded_prefill_equals_reference(run):
    y, (c_kv, k_rope) = run["prefill"]
    assert tuple(y.shape) == (2, run["s"], run["cfg"].d_model)
    _close(y, run["ref_prefill"])
    _close(c_kv, run["ref_latents"][0])
    _close(k_rope, run["ref_latents"][1])


def test_absorbed_decode_equals_reference(run):
    """Each step's output and both cache buffers, every entry."""
    for got, want in zip(run["steps_out"], run["ref_steps"]):
        for g, w in zip(got, want):
            assert tuple(g.shape) == tuple(w.shape)
            _close(g, w)


def test_absorbed_decode_equals_expanded_last_row(run):
    """The absorbed form over the cache is the expanded form's last row
    over the prompt and the steps so far."""
    layer, xs, s = run["layer"], run["x"], run["s"]
    for i, (y, _, _) in enumerate(run["steps_out"]):
        n = s + i + 1
        full, _ = layer(torch.from_numpy(xs[:, :n]),
                        torch.from_numpy(_positions(2, 0, n)))
        _close(y[:, 0], full[:, -1])


def test_decode_past_the_cache_raises(run):
    cfg, layer = run["cfg"], run["layer"]
    ckv = torch.zeros(2, 8, cfg.mla.kv_lora)
    kr = torch.zeros(2, 8, cfg.mla.qk_rope_dim)
    x1 = torch.from_numpy(run["x"][:, :1])
    layer(x1, torch.full((2, 1), 7), cache=(ckv, kr), kv_len=7)
    with pytest.raises(ValueError, match="P10"):
        layer(x1, torch.full((2, 1), 8), cache=(ckv, kr), kv_len=8)
