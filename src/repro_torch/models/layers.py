"""Shared building blocks of the model stack: the parameter definition, the
norms, RoPE, blockwise (flash) attention, decode attention over the KV
cache, GQA attention and the gated MLP.

Counterpart of ``repro/models/layers.py``.  Each module exposes
``<name>_defs(cfg)`` returning ``{name: PD(shape, logical_axes, fan_in)}``;
the stack (``transformer.py``) builds its parameters, their initialisation
and the reference's stacked layout from the same metadata.  The attention
and the MLP are plain torch, as the reference's are plain ``jnp`` (no
Pallas kernel): the scores and the attention's accumulator are float32
whatever the compute dtype, as the reference's
``preferred_element_type=jnp.float32`` makes them.  RoPE covers qwen2-vl's
M-RoPE; the attention layer covers whisper's non-causal encoder and its
cross-attention over the encoder's k and v.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

_NEG = -1e30


class PD(NamedTuple):
    """Parameter definition: shape + logical sharding tags + init fan-in."""
    shape: tuple
    axes: tuple       # logical tags per dim: 'fsdp' | 'tp' | 'sp' | None
    fan_in: int = 0   # 0 -> zeros/ones init decided by name ('norm'/'bias')


def register(module: nn.Module, defs: dict, *, device, dtype) -> None:
    """Give ``module`` one uninitialised parameter per ``PD`` of ``defs``,
    under the definition's name, without a gradient: serving records none;
    ``train.train_step``'s step turns the model's gradients on."""
    for name, pd in defs.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(pd.shape, device=device, dtype=dtype),
            requires_grad=False))


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_apply(cfg, w, x, b=None):
    """rmsnorm as ``x / rms(x) * (1 + w)`` (gemma-style, so zero-init is the
    identity) or layernorm (``+ b``), in float32, cast back to x's dtype."""
    xf = x.float()
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + cfg.norm_eps) * w
        if b is not None:
            out = out + b
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(ms + cfg.norm_eps) * (1.0 + w)
    return out.to(x.dtype)


def norm_defs(cfg, name="norm"):
    d = {name: PD((cfg.d_model,), (None,))}
    if cfg.norm == "layernorm":
        d[name + "_b"] = PD((cfg.d_model,), (None,))
    return d


# ---------------------------------------------------------------------------
# rotary embeddings (RoPE + qwen2-vl M-RoPE)
# ---------------------------------------------------------------------------

def rope_freqs(cfg, head_dim: int, device=None):
    """``theta ** (-2 i / head_dim)`` for the ``head_dim / 2`` pairs,
    float32.  The exponent is the reference's float32 arithmetic; the
    power is taken in float64 and rounded once, which gives XLA's float32
    ``pow`` bit for bit (torch's float32 ``pow`` is off by an ulp at some
    pairs of head_dim 64 and up, which moves an angle by ``position``
    ulps)."""
    half = head_dim // 2
    expo = -torch.arange(half, dtype=torch.float32, device=device) * 2.0 \
        / head_dim
    return (cfg.rope_theta ** expo.double()).float()


def apply_rope(cfg, x, positions):
    """x: (B, S, H, hd); positions: (B, S), or (B, S, 3) for M-RoPE.  Under
    ``cfg.mrope_sections`` with 3-stream positions, frequency pair ``i``
    takes its angle from stream ``stream_id[i]`` (the sections laid end to
    end: temporal, height, width); otherwise (B, S, 3) positions take
    stream 0.  The angles are float32, the rotation is computed in float32
    and cast back to x's dtype, as the reference does.  The whole last
    axis rotates: no caller of the reference passes its ``head_dim``
    argument (MLA rotates its ``qk_rope`` slices whole), so the port has
    none."""
    half = x.shape[-1] // 2
    inv = rope_freqs(cfg, x.shape[-1], device=x.device)  # (half,)
    if cfg.mrope_sections and positions.ndim == 3:
        if sum(cfg.mrope_sections) != half:
            raise ValueError(f"mrope_sections {cfg.mrope_sections} do not "
                             f"sum to the {half} frequency pairs")
        pf = positions.float()
        pos = torch.cat([pf[..., i, None].expand(*pf.shape[:2], n)
                         for i, n in enumerate(cfg.mrope_sections)],
                        dim=-1)  # (B, S, half)
    else:
        if positions.ndim == 3:
            positions = positions[..., 0]
        pos = positions.float()[:, :, None]  # (B, S, 1)
    ang = pos * inv[None, None, :]  # (B, S, half)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    rot = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rot.to(x.dtype)


# ---------------------------------------------------------------------------
# blockwise ("flash") attention
# ---------------------------------------------------------------------------

def _softcap(s, cap):
    return cap * torch.tanh(s / cap) if cap else s


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0,
                    scale=None, chunk_q=512, chunk_kv=1024, q_offset=0):
    """Online-softmax attention over kv chunks of ``chunk_kv``.

    q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd) with H % KV == 0 (GQA).
    ``q_offset`` is the absolute position of q[0] (prefill continuation).
    The reference's arithmetic: q is cut into ``chunk_q`` blocks and k, v
    into ``chunk_kv`` blocks (padding masked by ``kpos < Skv``); for each
    kv block in order, float32 scores times ``scale``, the softcap, the
    causal / window / padding mask to -1e30, then the running max, ``p``
    cast to v's dtype for the float32 PV product, and at the end the
    division by ``max(l, 1e-30)``.  The operands are upcast to float32
    (a product of bfloat16 values is exact in float32; TF32 is off).  The
    reference scans the q blocks carrying only their index, so here they
    are all one tensor and only the kv blocks loop.  The reference's
    ``_flash_shard`` / ``_flash_out_anchor`` are GSPMD sharding hints that
    do nothing without a mesh and have no counterpart.
    """
    b, sq, h, hd = q.shape
    skv, kv = k.shape[1], k.shape[2]
    vd = v.shape[-1]
    g = h // kv
    scale = scale or (1.0 / math.sqrt(hd))
    cq, ck = min(chunk_q, sq), min(chunk_kv, skv)
    nq, nk = -(-sq // cq), -(-skv // ck)
    dev = q.device

    qf = F.pad(q, (0, 0, 0, 0, 0, nq * cq - sq)).float()
    # (B, nq, KV, G, cq, hd)
    qc = qf.reshape(b, nq, cq, kv, g, hd).permute(0, 1, 3, 4, 2, 5)
    kp = F.pad(k, (0, 0, 0, 0, 0, nk * ck - skv))
    vp = F.pad(v, (0, 0, 0, 0, 0, nk * ck - skv))
    qpos = (q_offset + torch.arange(nq * cq, device=dev)).reshape(nq, cq)
    m = torch.full((b, nq, kv, g, cq), _NEG, device=dev)
    l = torch.zeros((b, nq, kv, g, cq), device=dev)
    acc = torch.zeros((b, nq, kv, g, cq, vd), device=dev)
    for j in range(nk):
        kt = kp[:, j * ck:(j + 1) * ck].float()       # (B, ck, KV, hd)
        vt = vp[:, j * ck:(j + 1) * ck]
        kpos = torch.arange(j * ck, (j + 1) * ck, device=dev)
        s = torch.einsum("bnkgqh,bskh->bnkgqs", qc, kt) * scale
        s = _softcap(s, softcap)
        mask = (kpos < skv)[None, None, :].expand(nq, cq, ck)
        if causal:
            mask = mask & (kpos[None, None, :] <= qpos[:, :, None])
        if window:
            mask = mask & (kpos[None, None, :] > qpos[:, :, None] - window)
        s = torch.where(mask[None, :, None, None], s, _NEG)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bnkgqs,bskh->bnkgqh", p.to(vt.dtype).float(), vt.float())
        m = m_new
    out = acc / l.clamp_min(1e-30)[..., None]
    out = out.permute(0, 1, 4, 2, 3, 5).reshape(b, nq * cq, h, vd)
    return out[:, :sq].to(q.dtype)


def attend_one(q, k, v, *, softcap=0.0, scale=None, kv_len=None, window=0):
    """Single-token decode attention; k, v are the full cache (B, S, KV, hd).

    ``kv_len``: the number of valid cache entries (an int or a (B,)
    tensor); the rest is masked.  ``window``: the sliding window (gemma2's
    local layers); the query sits at position ``kv_len - 1``, so an entry
    counts where ``pos > kv_len - 1 - window``, the training mask.  Scores
    and the PV product are float32, as in :func:`flash_attention`.
    """
    b, sq, h, hd = q.shape
    if sq != 1:
        raise ValueError(f"attend_one takes one query a row, got {sq}")
    kv = k.shape[2]
    g = h // kv
    scale = scale or (1.0 / math.sqrt(hd))
    qg = q.reshape(b, kv, g, hd).float()
    s = torch.einsum("bkgh,bskh->bkgs", qg, k.float()) * scale
    s = _softcap(s, softcap)
    if kv_len is not None:
        pos = torch.arange(k.shape[1], device=k.device)
        lens = (kv_len.to(k.device) if torch.is_tensor(kv_len) else
                torch.full((b,), kv_len, device=k.device))
        lens = lens.expand(b) if lens.ndim == 0 else lens
        valid = pos[None] < lens[:, None]
        if window:
            valid = valid & (pos[None] > lens[:, None] - 1 - window)
        s = torch.where(valid[:, None, None, :], s, _NEG)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v.dtype).float(), v.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------

def attn_defs(cfg):
    """QKV/O weights in the reference's fused (H*hd) layout."""
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    defs = {
        "wq": PD((d, h * hd), ("fsdp", "tp"), d),
        "wk": PD((d, kv * hd), ("fsdp", "tp"), d),
        "wv": PD((d, kv * hd), ("fsdp", "tp"), d),
        "wo": PD((h * hd, d), ("tp", "fsdp"), h * hd),
    }
    if cfg.qkv_bias:
        defs |= {
            "bq": PD((h * hd,), ("tp",)),
            "bk": PD((kv * hd,), ("tp",)),
            "bv": PD((kv * hd,), ("tp",)),
        }
    return defs


def _project(cfg, p, x, name, heads):
    """``x @ w{name}`` (``+ b{name}`` under ``qkv_bias``), the weight cast
    to x's dtype at use, as (B, S, heads, hd)."""
    y = x @ getattr(p, "w" + name).to(x.dtype)
    if cfg.qkv_bias:
        y = y + getattr(p, "b" + name).to(x.dtype)
    return y.reshape(*x.shape[:2], heads, cfg.head_dim)


def attn_qkv(cfg, p, x, positions):
    """q (B, S, H, hd), and k, v (B, S, KV, hd), q and k RoPE'd."""
    return (apply_rope(cfg, _project(cfg, p, x, "q", cfg.n_heads),
                       positions),
            apply_rope(cfg, _project(cfg, p, x, "k", cfg.n_kv_heads),
                       positions),
            _project(cfg, p, x, "v", cfg.n_kv_heads))


def attn_apply(cfg, p, x, positions, *, spec, cache=None, kv_len=None,
               kv_override=None):
    """x: (B, S, D); ``p`` holds ``attn_defs``' weights (an
    :class:`Attention`).  Without ``cache``: flash attention over the
    sequence, causal unless ``spec.encoder`` (whisper's encoder); returns
    (out, (k, v)), the RoPE'd k and v being the prefill's cache entry.
    With ``cache=(k_cache, v_cache)`` (B, max_len, KV, hd) and ``kv_len``
    (an int: the entries already written): k and v are written at
    ``kv_len`` into the given tensors, in place (the caller owns them;
    ``transformer.decode_step`` hands in its own copy), then
    :func:`attend_one` over ``kv_len + S`` entries; returns (out, (k_cache,
    v_cache)).  Where the reference clamps a write past ``max_len - S``,
    the port raises (departure P10).  With ``kv_override=(k, v)`` (B, T,
    KV, hd), the encoder's projections (cross-attention): q is not
    rotated and attends to all T entries, through :func:`attend_one` for
    one query and non-causal :func:`flash_attention` for more; ``cache``
    is not read; returns (out, (k, v))."""
    b, s, _ = x.shape
    if kv_override is not None:
        q = _project(cfg, p, x, "q", cfg.n_heads)
        k, v = kv_override
    else:
        q, k, v = attn_qkv(cfg, p, x, positions)
    if cache is not None and kv_override is None:
        ck, cv = cache
        idx = int(kv_len)
        if idx < 0 or idx + s > ck.shape[1]:
            raise ValueError(
                f"a decode write at {idx} of {s} entries does not fit the "
                f"cache's {ck.shape[1]} (the reference would clamp it: "
                f"departure P10)")
        ck[:, idx:idx + s] = k.to(ck.dtype)
        cv[:, idx:idx + s] = v.to(cv.dtype)
        out = attend_one(q, ck, cv, softcap=cfg.attn_softcap,
                         kv_len=idx + s, window=spec.sliding_window)
        entry = (ck, cv)
    elif s == 1 and kv_override is not None:
        out = attend_one(q, k, v, softcap=cfg.attn_softcap)
        entry = (k, v)
    else:
        out = flash_attention(
            q, k, v, causal=kv_override is None and not spec.encoder,
            window=spec.sliding_window, softcap=cfg.attn_softcap,
            chunk_q=cfg.attn_chunk_q, chunk_kv=cfg.attn_chunk_kv)
        entry = (k, v)
    y = out.reshape(b, s, cfg.n_heads * cfg.head_dim) @ p.wo.to(x.dtype)
    return y, entry


class Attention(nn.Module):
    """One GQA attention mixer under the reference's name ``attn`` (or the
    cross-attention under ``xattn``); its parameters carry ``attn_defs``'
    names and shapes."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        register(self, attn_defs(cfg), device=device, dtype=dtype)

    def forward(self, x, positions, *, spec, cache=None, kv_len=None,
                kv_override=None):
        return attn_apply(self.cfg, self, x, positions, spec=spec,
                          cache=cache, kv_len=kv_len, kv_override=kv_override)


# ---------------------------------------------------------------------------
# gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_defs(cfg, d_ff=None):
    d, f = cfg.d_model, d_ff or cfg.d_ff
    return {
        "wi": PD((d, f), ("fsdp", "tp"), d),
        "wg": PD((d, f), ("fsdp", "tp"), d),
        "wo": PD((f, d), ("tp", "fsdp"), f),
    }


def mlp_apply(cfg, p, x):
    """``act(x wg) * (x wi) wo``: SwiGLU with ``silu``, GeGLU with the tanh
    approximation of ``gelu`` (JAX's ``approximate=True``)."""
    cd = x.dtype
    act = F.silu if cfg.mlp_act == "silu" else functools.partial(
        F.gelu, approximate="tanh")
    h = act(x @ p.wg.to(cd)) * (x @ p.wi.to(cd))
    return h @ p.wo.to(cd)


class MLP(nn.Module):
    """The gated MLP under the reference's name ``mlp``."""

    def __init__(self, cfg, *, device=None, dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        register(self, mlp_defs(cfg), device=device, dtype=dtype)

    def forward(self, x):
        return mlp_apply(self.cfg, self, x)
