"""The dense attention family's layers (``repro_torch.models.layers``)
against the JAX reference's (``repro.models.layers``) on the CPU.

RoPE at theta 1e4 and 1e6 within 1e-6; ``flash_attention`` at S = 30 and
96 (padded and several blocks), GQA 6/2 and 4/4, causal, a window of 24,
the softcap 50 and a ``q_offset``, within 1e-5 of the reference, and
against a full softmax over materialised, masked scores (the reference's
``tests/test_models.py::test_flash_attention_exact``); ``attend_one`` with
and without a window that binds; the gated MLP with ``silu`` and
``gelu``.  Every input comes from a ``default_rng`` of the test's own.
The card is in ``tests/test_torch_cuda.py``.
"""

import math
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.models import layers as JL
from repro.models import registry as jax_registry

from repro_torch.models import layers as L
from repro_torch.models import registry

TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _qkv(rng, b, sq, skv, h, kv, hd=16):
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kv, hd)).astype(np.float32)
    return q, k, v


def _both(fn_port, fn_ref, arrays, **kw):
    got = fn_port(*(torch.from_numpy(a) for a in arrays), **kw)
    want = fn_ref(*(jnp.asarray(a) for a in arrays), **kw)
    return got, want


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope_equals_reference(theta):
    """(B, S) positions up to 8 191, and (B, S, 3) positions of which the
    first stream counts; bfloat16 x rotates in float32 and casts back."""
    cfg = registry.get_config("qwen2.5-14b", reduced=True, rope_theta=theta)
    jcfg = jax_registry.get_config("qwen2.5-14b", reduced=True,
                                   rope_theta=theta)
    rng = np.random.default_rng(int(theta))
    x = rng.normal(size=(2, 40, 4, 16)).astype(np.float32)
    pos = rng.integers(0, 8192, (2, 40))
    _close(L.rope_freqs(cfg, 16), JL.rope_freqs(jcfg, 16), rtol=0, atol=0)
    got = L.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos))
    want = JL.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos))
    _close(got, want, rtol=1e-6, atol=1e-6)
    pos3 = np.stack([pos, pos + 1, pos + 2], -1)
    got3 = L.apply_rope(cfg, torch.from_numpy(x), torch.from_numpy(pos3))
    assert torch.equal(got3, got)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gotb = L.apply_rope(cfg, xb, torch.from_numpy(pos))
    wantb = JL.apply_rope(jcfg, jnp.asarray(x, jnp.bfloat16),
                          jnp.asarray(pos))
    assert gotb.dtype == torch.bfloat16
    _close(gotb, np.asarray(wantb.astype(jnp.float32)), rtol=0, atol=0)


# ---------------------------------------------------------------------------
# flash_attention
# ---------------------------------------------------------------------------

VARIANTS = {
    "causal": {},
    "window": {"window": 24},
    "softcap": {"softcap": 50.0},
    "window-softcap-offset": {"window": 24, "softcap": 50.0, "q_offset": 8},
    "noncausal": {"causal": False},
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("heads", [(6, 2), (4, 4)], ids=["gqa6-2", "mha4"])
@pytest.mark.parametrize("seq", [30, 96])
def test_flash_attention_equals_reference(seq, heads, variant):
    """Chunks of 32 queries and 16 keys: S = 30 pads both, S = 96 makes
    three q blocks and six kv blocks.  With ``q_offset`` the queries are
    the last S - 8 positions of the keys' sequence."""
    kw = dict(VARIANTS[variant], chunk_q=32, chunk_kv=16)
    rng = np.random.default_rng(seq * 10 + heads[0])
    sq = seq - kw.get("q_offset", 0)
    arrays = _qkv(rng, 2, sq, seq, *heads)
    got, want = _both(L.flash_attention, JL.flash_attention, arrays, **kw)
    assert tuple(got.shape) == (2, sq, heads[0], 16)
    _close(got, want)


def test_flash_attention_bfloat16_equals_reference():
    """bfloat16 q, k, v: float32 scores and accumulator, p cast to
    bfloat16 for the PV product, the output cast to bfloat16; within one
    bfloat16 ulp of the reference's at the output's scale."""
    rng = np.random.default_rng(3)
    arrays = _qkv(rng, 2, 96, 96, 6, 2)
    kw = dict(window=24, softcap=50.0, chunk_q=32, chunk_kv=16)
    got = L.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16)
                              for a in arrays), **kw)
    want = JL.flash_attention(*(jnp.asarray(a, jnp.bfloat16)
                                for a in arrays), **kw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    _close(got, want, rtol=0, atol=2.0 ** -8 * np.abs(want).max())


def _full_softmax(q, k, v, *, window=0, softcap=0.0):
    """Materialised, masked scores (B, KV, G, S, S), one softmax."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k) / math.sqrt(hd)
    scores = L._softcap(scores, softcap)
    pos = torch.arange(s)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v).reshape(b, s, h, hd)


@pytest.mark.parametrize("kw", [{}, {"window": 24},
                                {"window": 24, "softcap": 50.0}],
                         ids=["causal", "window", "window-softcap"])
def test_flash_attention_equals_full_softmax(kw):
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 96, 96, 6, 2))
    got = L.flash_attention(q, k, v, chunk_q=32, chunk_kv=16, **kw)
    torch.testing.assert_close(got, _full_softmax(q, k, v, **kw), **TOL)


# ---------------------------------------------------------------------------
# attend_one
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("window", [0, 8, 64], ids=["global", "binding",
                                                    "wider"])
@pytest.mark.parametrize("lens", ["int", "rows"])
def test_attend_one_equals_reference(window, lens):
    """A cache of 40 entries, 29 valid (or 29 and 17 by row), the softcap
    50; a window of 8 binds, one of 64 masks nothing."""
    rng = np.random.default_rng(window + len(lens))
    q, k, v = _qkv(rng, 2, 1, 40, 6, 2)
    kv_len = 29 if lens == "int" else np.array([29, 17], np.int32)
    kw = dict(softcap=50.0, window=window)
    got = L.attend_one(*(torch.from_numpy(a) for a in (q, k, v)),
                       kv_len=torch.from_numpy(kv_len) if lens == "rows"
                       else kv_len, **kw)
    want = JL.attend_one(*(jnp.asarray(a) for a in (q, k, v)),
                         kv_len=jnp.asarray(kv_len), **kw)
    _close(got, want)
    # the whole cache unmasked
    got, want = _both(L.attend_one, JL.attend_one, (q, k, v))
    _close(got, want)


def test_attend_one_equals_flash_attention_last_row():
    """A decode query at position S - 1 over the cache's first S entries is
    flash attention's last row, with a binding window."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 30, 40, 6, 2))
    full = L.flash_attention(q, k[:, :30], v[:, :30], window=8,
                             chunk_q=16, chunk_kv=16)
    one = L.attend_one(q[:, -1:], k, v, kv_len=30, window=8)
    torch.testing.assert_close(one, full[:, -1:], **TOL)


# ---------------------------------------------------------------------------
# the gated MLP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_mlp_apply_equals_reference(act):
    cfg = registry.get_config("gemma-7b", reduced=True, mlp_act=act)
    jcfg = jax_registry.get_config("gemma-7b", reduced=True, mlp_act=act)
    rng = np.random.default_rng(len(act))
    w = {n: (rng.normal(size=pd.shape) / math.sqrt(pd.fan_in)).astype(
        np.float32) for n, pd in L.mlp_defs(cfg).items()}
    x = rng.normal(size=(2, 12, cfg.d_model)).astype(np.float32)
    got = L.mlp_apply(cfg, types.SimpleNamespace(
        **{n: torch.from_numpy(a) for n, a in w.items()}),
        torch.from_numpy(x))
    want = JL.mlp_apply(jcfg, {n: jnp.asarray(a) for n, a in w.items()},
                        jnp.asarray(x))
    _close(got, want)
    module = L.MLP(cfg, device="cpu")
    with torch.no_grad():
        for n, a in w.items():
            getattr(module, n).copy_(torch.from_numpy(a))
    assert torch.equal(module(torch.from_numpy(x)), got)


@pytest.mark.parametrize("bias", [False, True])
def test_attention_layer_equals_reference(bias):
    """One ``Attention`` layer (``attn_apply``) on the same weights: the
    prefill's output with a binding window, then a decode step that writes
    at ``kv_len`` and attends over ``kv_len + 1`` entries."""
    from repro.models.config import LayerSpec as JSpec
    from repro_torch.models.config import LayerSpec
    cfg = registry.get_config("qwen2.5-14b", reduced=True, qkv_bias=bias,
                              attn_softcap=50.0)
    jcfg = jax_registry.get_config("qwen2.5-14b", reduced=True,
                                   qkv_bias=bias, attn_softcap=50.0)
    spec, jspec = LayerSpec(sliding_window=8), JSpec(sliding_window=8)
    rng = np.random.default_rng(int(bias))
    w = {n: (rng.normal(size=pd.shape) * 0.2).astype(np.float32)
         for n, pd in L.attn_defs(cfg).items()}
    layer = L.Attention(cfg, device="cpu")
    with torch.no_grad():
        for n, a in w.items():
            getattr(layer, n).copy_(torch.from_numpy(a))
    jw = {n: jnp.asarray(a) for n, a in w.items()}
    x = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(20), (2, 1))
    out, (k, v) = layer(torch.from_numpy(x), torch.from_numpy(pos),
                        spec=spec)
    jout, _ = JL.attn_apply(jcfg, jw, jnp.asarray(x), jnp.asarray(pos),
                            spec=jspec)
    _close(out, jout)
    ck = torch.zeros(2, 24, cfg.n_kv_heads, cfg.head_dim)
    cv = torch.zeros_like(ck)
    ck[:, :20], cv[:, :20] = k, v
    x1 = rng.normal(size=(2, 1, cfg.d_model)).astype(np.float32)
    pos1 = np.full((2, 1), 20)
    jcache = (jnp.asarray(ck.numpy()), jnp.asarray(cv.numpy()))
    out1, (ck1, cv1) = layer(torch.from_numpy(x1), torch.from_numpy(pos1),
                             spec=spec, cache=(ck, cv), kv_len=20)
    jout1, (jck, jcv) = JL.attn_apply(jcfg, jw, jnp.asarray(x1),
                                      jnp.asarray(pos1), spec=jspec,
                                      cache=jcache, kv_len=jnp.int32(20))
    _close(out1, jout1)
    _close(ck1, jck)
    _close(cv1, jcv)
    assert ck1 is ck  # written in place: the caller's own copy
