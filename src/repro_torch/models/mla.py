"""Multi-head Latent Attention (deepseek-v2).

Counterpart of ``repro/models/mla.py``.  The prefill uses the expanded
form: per-head k and v are materialised from the compressed latent, the
rotary part of k is shared by every head, and the port's
``flash_attention`` runs over q, k of width ``qk_nope + qk_rope`` and v of
width ``v_dim``.  Decode uses the absorbed form over the compressed cache
of ``(c_kv, k_rope)``: ``kv_lora + qk_rope`` values a token and a layer
instead of ``2 * H * head_dim``.  Both norms compute in float32 with the
``(1 + w)`` scale, then cast to the compute dtype.  Plain torch, as the
reference is plain ``jnp``.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch.models.layers import PD, apply_rope, flash_attention, register

_NEG = -1e30


def mla_defs(cfg):
    d, h = cfg.d_model, cfg.n_heads
    m = cfg.mla
    qk = m.qk_nope_dim + m.qk_rope_dim
    defs = {}
    if m.q_lora:
        defs["wq_down"] = PD((d, m.q_lora), ("fsdp", None), d)
        defs["q_norm"] = PD((m.q_lora,), (None,))
        defs["wq_up"] = PD((m.q_lora, h, qk), (None, "tp", None), m.q_lora)
    else:
        defs["wq"] = PD((d, h, qk), ("fsdp", "tp", None), d)
    defs |= {
        "wkv_down": PD((d, m.kv_lora + m.qk_rope_dim), ("fsdp", None), d),
        "kv_norm": PD((m.kv_lora,), (None,)),
        "wkv_up": PD((m.kv_lora, h, m.qk_nope_dim + m.v_dim),
                     (None, "tp", None), m.kv_lora),
        "wo": PD((h, m.v_dim, d), ("tp", None, "fsdp"), h * m.v_dim),
    }
    return defs


def _rms(cfg, w, x):
    """``x / rms(x) * (1 + w)`` in float32, cast back to x's dtype."""
    xf = x.float()
    return (xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + cfg.norm_eps)
            * (1.0 + w)).to(x.dtype)


def _queries(cfg, p, x, positions):
    """(q_nope, q_rope): (B, S, H, qk_nope) and (B, S, H, qk_rope), the
    second RoPE'd whole."""
    m = cfg.mla
    cd = x.dtype
    if m.q_lora:
        ql = _rms(cfg, p.q_norm, x @ p.wq_down.to(cd))
        q = torch.einsum("bsl,lhk->bshk", ql, p.wq_up.to(cd))
    else:
        q = torch.einsum("bsd,dhk->bshk", x, p.wq.to(cd))
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, apply_rope(cfg, q_rope, positions)


def _latents(cfg, p, x, positions):
    """(c_kv, k_rope): the normed latent (B, S, kv_lora) and the shared
    rotary key (B, S, qk_rope), RoPE'd: the cache's entries."""
    m = cfg.mla
    kv = x @ p.wkv_down.to(x.dtype)
    c_kv = _rms(cfg, p.kv_norm, kv[..., :m.kv_lora])
    k_rope = apply_rope(cfg, kv[..., None, m.kv_lora:], positions)[:, :, 0]
    return c_kv, k_rope


def mla_apply(cfg, p, x, positions, *, cache=None, kv_len=None):
    """x: (B, S, D); ``p`` holds ``mla_defs``' weights (an :class:`MLA`).

    Without ``cache``: the expanded form, causal ``flash_attention`` with
    ``scale = 1 / sqrt(qk_nope + qk_rope)``; returns (out, (c_kv,
    k_rope)), the latents being the prefill's cache entry (the reference
    recomputes them with ``_latents``: the same values).  With
    ``cache=(ckv_buf, krope_buf)`` (B, max_len, ...) and ``kv_len`` (an
    int: the entries already written): the step's latents are written at
    ``kv_len`` into the given tensors, in place, then the absorbed form
    over ``kv_len + S`` entries: q_nope absorbed into the latent space
    through ``wkv_up``'s k half in the compute dtype, the scores from the
    compute-dtype operands upcast to float32 (the reference's
    ``preferred_element_type=float32``; the products are exact, TF32 is
    off), the softmax in float32, the probabilities cast to the compute
    dtype and expanded through ``wkv_up``'s v half.  Returns (out,
    (ckv_buf, krope_buf)).  Where the reference clamps a write past
    ``max_len - S``, the port raises (departure P10)."""
    m = cfg.mla
    cd = x.dtype
    b, s, _ = x.shape
    scale = 1.0 / math.sqrt(m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = _queries(cfg, p, x, positions)
    c_kv, k_rope = _latents(cfg, p, x, positions)
    w_k = p.wkv_up[..., :m.qk_nope_dim].to(cd)
    w_v = p.wkv_up[..., m.qk_nope_dim:].to(cd)

    if cache is None:
        k_nope = torch.einsum("bsl,lhk->bshk", c_kv, w_k)
        v = torch.einsum("bsl,lhv->bshv", c_kv, w_v)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
            k_nope.shape[:3] + (m.qk_rope_dim,))], dim=-1)
        del k_nope
        out = flash_attention(q, k, v, causal=True, scale=scale,
                              chunk_q=cfg.attn_chunk_q,
                              chunk_kv=cfg.attn_chunk_kv)
        y = torch.einsum("bshv,hvd->bsd", out, p.wo.to(cd))
        return y, (c_kv, k_rope)

    ckv_buf, krope_buf = cache
    idx = int(kv_len)
    if idx < 0 or idx + s > ckv_buf.shape[1]:
        raise ValueError(
            f"a decode write at {idx} of {s} entries does not fit the "
            f"cache's {ckv_buf.shape[1]} (the reference would clamp it: "
            f"departure P10)")
    ckv_buf[:, idx:idx + s] = c_kv.to(ckv_buf.dtype)
    krope_buf[:, idx:idx + s] = k_rope.to(krope_buf.dtype)
    ckv, kr = ckv_buf.to(cd), krope_buf.to(cd)
    q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope, w_k)
    scores = (torch.einsum("bqhl,bsl->bhqs", q_abs.float(), ckv.float())
              + torch.einsum("bqhr,bsr->bhqs", q_rope.float(), kr.float())
              ) * scale
    pos = torch.arange(ckv.shape[1], device=x.device)
    scores = torch.where(pos < idx + s, scores, _NEG)
    probs = torch.softmax(scores, dim=-1)
    o_lat = torch.einsum("bhqs,bsl->bqhl", probs.to(cd), ckv)
    out = torch.einsum("bqhl,lhv->bqhv", o_lat, w_v)
    y = torch.einsum("bqhv,hvd->bqd", out, p.wo.to(cd))
    return y, (ckv_buf, krope_buf)


class MLA(nn.Module):
    """The MLA mixer under the reference's name ``attn``; its parameters
    carry ``mla_defs``' names and shapes."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        register(self, mla_defs(cfg), device=device, dtype=dtype)

    def forward(self, x, positions, *, cache=None, kv_len=None):
        return mla_apply(self.cfg, self, x, positions, cache=cache,
                         kv_len=kv_len)
