"""The model stack: parameter metadata -> the module and its initialisation,
the three execution modes (forward, prefill, decode) over the blocks, and
the training loss ``lm_loss`` (its vocab projection in checkpointed
chunks, each block under ``torch.utils.checkpoint`` when ``cfg.remat``).

Counterpart of ``repro/models/transformer.py`` for the SSM family
(``mixer="mamba"``: falcon-mamba-7b), the dense attention family
(``mixer="attn"``, ``mlp="dense"``, gemma2's post-block norms:
smollm-360m, gemma2-2b, gemma-7b, qwen2.5-14b), the MoE family
(``mlp="moe"``: granite-moe-3b; with ``mixer="mla"``: deepseek-v2-236b),
the hybrid jamba-v0.1-52b (Mamba and attention mixers, dense and MoE
MLPs in one block) and the front ends: qwen2-vl-7b (M-RoPE over (B, S, 3)
positions, precomputed patch embeddings ``extra_embeds`` in place of the
prompt's first positions) and whisper-medium (``encode``: precomputed
frame embeddings through a non-causal encoder; cross-attention over its
output in every decoder layer).  ``model_defs`` is the reference's
metadata, blocks stacked on a leading ``n_blocks`` axis (the encoder's
on ``enc_layers``), and the single source of the names and shapes;
:class:`Model` holds block ``b``'s slice of each stacked leaf in
``blocks[b]["L{i}"]`` (the encoder's in ``enc.blocks[b]["L0"]``) under
the same name, and runs the blocks in a Python loop where the reference
scans them.  The decode cache keeps the reference's stacked layout:
attention's k and v (``(n_blocks, B, max_len, KV, hd)``, the compute
dtype), MLA's latents ``ckv`` and ``kr`` (``(n_blocks, B, max_len,
kv_lora | qk_rope)``), the Mamba state and the cross-attention's ``xk``,
``xv`` (``(n_blocks, B, enc_len, H, hd)``, written by the prefill and
only read after).  Weights are cast to ``cfg.compute_dtype`` at use, as
the reference does; the SSM state, the scan, the MoE router and
attention's scores stay float32.

``mesh=`` (a :class:`~repro_torch.sharding.Mesh` with a ``"model"``
axis, and ``"data"`` / ``"pod"`` axes) reaches the MoE only: its module
runs ``_moe_call`` (``moe.moe_call``), which splits the batch over the
data positions and runs each shard's experts over the ``model`` axis,
as the reference's ``shard_map`` does.  The reference's other uses of its mesh are sharding
constraints (``_constrain``, ``layers.py::_flash_shard`` and
``_flash_out_anchor``, ``mamba.py::_anchor``), which do not change the
arithmetic, so they have no counterpart here.  The dry-run's abstract
layer is :func:`abstract_params`, :func:`param_pspecs`,
:func:`abstract_cache` and :func:`cache_pspecs`: shape-and-dtype records
and partition tuples keyed by the reference's leaf paths
(:func:`flatten_defs`).
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import ShapeDtype, resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.sharding.specs import to_pspec

# ---------------------------------------------------------------------------
# parameter metadata
# ---------------------------------------------------------------------------

def _add_norm(cfg, d: dict, name: str):
    d[name] = L.PD((cfg.d_model,), (None,))
    if cfg.norm == "layernorm":
        d[name + "_b"] = L.PD((cfg.d_model,), (None,))


# each mixer and MLP by its spec name: (its parameter metadata, its module)
_MIXERS = {"attn": (L.attn_defs, L.Attention), "mla": (MLA.mla_defs, MLA.MLA),
           "mamba": (M.mamba_defs, M.Mamba)}
_MLPS = {"dense": (L.mlp_defs, L.MLP), "moe": (MOE.moe_defs, MOE.MoE)}


def _layer_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    d = {}
    _add_norm(cfg, d, "ln1")
    if spec.mixer not in _MIXERS:
        raise ValueError(spec.mixer)
    d["attn"] = _MIXERS[spec.mixer][0](cfg)
    if cfg.post_block_norm:
        _add_norm(cfg, d, "ln1_post")
    if spec.cross_attn:
        _add_norm(cfg, d, "ln_x")
        d["xattn"] = L.attn_defs(cfg)
    if spec.mlp != "none":
        if spec.mlp not in _MLPS:
            raise ValueError(spec.mlp)
        _add_norm(cfg, d, "ln2")
        d["mlp"] = _MLPS[spec.mlp][0](cfg)
        if cfg.post_block_norm:
            _add_norm(cfg, d, "ln2_post")
    return d


def _stack(defs: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict)
            else L.PD((n,) + v.shape, (None,) + v.axes, v.fan_in)
            for k, v in defs.items()}


# whisper's encoder layer: self-attention without the causal mask
ENC_SPEC = LayerSpec(mixer="attn", mlp="dense", encoder=True)


def model_defs(cfg: ModelConfig) -> dict:
    d_model, v = cfg.d_model, cfg.padded_vocab
    if cfg.embed_shard == "dmodel":
        if cfg.tie_embeddings:
            raise ValueError("embed_shard=dmodel requires untied embeddings")
        embed_pd = L.PD((v, d_model), (None, "tp"), d_model)
    else:
        embed_pd = L.PD((v, d_model), ("tp", None), d_model)
    defs = {
        "embed": embed_pd,
        "final_norm": L.PD((d_model,), (None,)),
        "blocks": _stack(
            {f"L{i}": _layer_defs(cfg, s) for i, s in enumerate(cfg.pattern)},
            cfg.n_blocks),
    }
    if cfg.norm == "layernorm":
        defs["final_norm_b"] = L.PD((d_model,), (None,))
    if not cfg.tie_embeddings:
        defs["unembed"] = L.PD((d_model, v), ("fsdp", "tp"), d_model)
    if cfg.enc_layers:
        defs["enc"] = {
            "pos": L.PD((cfg.enc_ctx, d_model), (None, None), d_model),
            "final_norm": L.PD((d_model,), (None,)),
            "blocks": _stack({"L0": _layer_defs(cfg, ENC_SPEC)},
                             cfg.enc_layers),
        }
        if cfg.norm == "layernorm":
            defs["enc"]["final_norm_b"] = L.PD((d_model,), (None,))
    return defs


def flatten_defs(tree: dict, prefix: str = "") -> dict:
    """``{"a/b/c": leaf}`` of a nested dict (the reference's leaf paths)."""
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        out.update(flatten_defs(v, path + "/") if isinstance(v, dict)
                   else {path: v})
    return out


def n_params(cfg: ModelConfig) -> int:
    """Parameters of the model, counted from ``model_defs`` (no allocation)."""
    return sum(math.prod(pd.shape) for pd in flatten_defs(model_defs(cfg))
               .values())


def abstract_params(cfg: ModelConfig) -> dict:
    """``{leaf path: ShapeDtype}`` of the reference's stacked leaves, in
    ``cfg.param_dtype``."""
    dtype = getattr(torch, cfg.param_dtype)
    return {path: ShapeDtype(tuple(pd.shape), dtype)
            for path, pd in flatten_defs(model_defs(cfg)).items()}


def param_pspecs(cfg: ModelConfig, axis_names) -> dict:
    """``{leaf path: partition tuple}`` of the leaves' logical tags."""
    return {path: to_pspec(pd.axes, axis_names)
            for path, pd in flatten_defs(model_defs(cfg)).items()}


# ---------------------------------------------------------------------------
# the module and its parameters
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One position of the block pattern: its norms, the mixer under the
    reference's name ``attn`` (:class:`layers.Attention`, :class:`mla.MLA`
    or :class:`mamba.Mamba`), the cross-attention under ``xattn`` (a
    second :class:`layers.Attention`) and the MLP under ``mlp``
    (:class:`layers.MLP` or :class:`moe.MoE`), if the spec has them."""

    def __init__(self, cfg, spec: LayerSpec, *, device, dtype):
        super().__init__()
        self.spec = spec
        defs = _layer_defs(cfg, spec)
        L.register(self, {k: v for k, v in defs.items()
                          if k not in ("attn", "xattn", "mlp")},
                   device=device, dtype=dtype)
        self.attn = _MIXERS[spec.mixer][1](cfg, device=device, dtype=dtype)
        if "xattn" in defs:
            self.xattn = L.Attention(cfg, device=device, dtype=dtype)
        if "mlp" in defs:
            self.mlp = _MLPS[spec.mlp][1](cfg, device=device, dtype=dtype)


def _block_list(cfg, pattern, n: int, *, device, dtype) -> nn.ModuleList:
    return nn.ModuleList(
        nn.ModuleDict({f"L{i}": Layer(cfg, spec, device=device, dtype=dtype)
                       for i, spec in enumerate(pattern)})
        for _ in range(n))


class Model(nn.Module):
    """The stack's parameters, uninitialised: build one with
    :func:`init_params` or ``convert.params_from_jax``.  ``blocks[b]`` is an
    ``nn.ModuleDict`` of the pattern's layers ``"L0"``, ``"L1"``, ...; a
    config with an encoder adds ``enc``, whose ``pos``, ``final_norm``
    (``final_norm_b``) and ``blocks[b]["L0"]`` are the reference's
    ``enc`` subtree."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        defs = model_defs(cfg)
        L.register(self, {k: v for k, v in defs.items()
                          if k not in ("blocks", "enc")},
                   device=device, dtype=dtype)
        self.blocks = _block_list(cfg, cfg.pattern, cfg.n_blocks,
                                  device=device, dtype=dtype)
        if "enc" in defs:
            self.enc = nn.Module()
            L.register(self.enc, {k: v for k, v in defs["enc"].items()
                                  if k != "blocks"},
                       device=device, dtype=dtype)
            self.enc.blocks = _block_list(cfg, (ENC_SPEC,), cfg.enc_layers,
                                          device=device, dtype=dtype)

    def leaves(self):
        """``(reference path, block index or None, parameter)`` for every
        parameter; a block's parameter is index ``b`` of the reference's
        stacked leaf (``blocks/...`` or ``enc/blocks/...``)."""
        for name, p in self.named_parameters():
            parts = name.split(".")
            if "blocks" in parts:
                i = parts.index("blocks")
                yield ("/".join(parts[:i + 1] + parts[i + 2:]),
                       int(parts[i + 1]), p)
            else:
                yield "/".join(parts), None, p


@torch.no_grad()
def _init_leaf(path: str, pd: L.PD, p: torch.Tensor, generator):
    """The reference's ``_init_leaf`` rule, in place; ``normal_`` draws
    from ``generator`` on the parameter's device (departure P8: not JAX's
    bits)."""
    name = path.split("/")[-1]
    if "a_log" in name:
        ds = pd.shape[-1]
        p.copy_(torch.log(torch.arange(1, ds + 1, dtype=torch.float32,
                                       device=p.device)).expand(p.shape))
    elif "d_skip" in name:
        p.fill_(1.0)
    elif "dt_b" in name:
        p.fill_(-4.6)  # softplus^-1(0.01)
    elif pd.fan_in == 0 or name.startswith(("ln", "norm")) \
            or name.endswith("_b") \
            or name.startswith(("b", "conv_b", "q_norm", "kv_norm")):
        p.zero_()
    else:
        p.normal_(0.0, 1.0 / math.sqrt(max(pd.fan_in, 1)),
                  generator=generator)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> Model:
    """A :class:`Model` on ``device`` (default CUDA) with the reference's
    initialisation: its distributions and constants, every draw made on
    the device from ``generator`` (a ``torch.Generator`` of that device)."""
    dev = resolve_device(device)
    model = Model(cfg, device=dev)
    defs = flatten_defs(model_defs(cfg))
    for path, _, p in model.leaves():
        _init_leaf(path, defs[path], p, generator)
    return model


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _cdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def embed_tokens(cfg, model: Model, tokens):
    x = model.embed[tokens].to(_cdt(cfg))
    if cfg.scale_embed:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=_cdt(cfg))
    return x


def _norm(cfg, module, key, x):
    return L.norm_apply(cfg, getattr(module, key), x,
                        getattr(module, key + "_b", None))


# the cache entries of attention (RoPE'd k, v) and of MLA (its latents)
_KV_NAMES = {"attn": ("k", "v"), "mla": ("ckv", "kr")}
# the cross-attention's entries: written by the prefill, then only read
_CROSS_NAMES = ("xk", "xv")


def _cross_kv(cfg, p, enc_out):
    """The cross-attention's k and v of the encoder's output (B, T, KV,
    hd): ``wk``, ``wv`` cast to its dtype, no bias and no rotation (the
    reference's ``_cross_kv``)."""
    b, t, _ = enc_out.shape
    return tuple((enc_out @ w.to(enc_out.dtype)).reshape(
        b, t, cfg.n_kv_heads, cfg.head_dim) for w in (p.wk, p.wv))


# the reference's transformer._moe_call: the MoE MLP over a mesh
_moe_call = MOE.moe_call


def _apply_layer(cfg, layer: Layer, x, positions, *, mode="train",
                 cache=None, kv_len=None, enc_out=None, mesh=None):
    """One layer.  ``cache`` is the layer's slice of the stacked cache:
    ``mode="prefill"`` writes the layer's entry into it (attention's RoPE'd
    k and v, or MLA's latents, at positions ``0 .. S - 1``; the Mamba
    state; the cross-attention's k and v of ``enc_out``), ``mode="decode"``
    reads and advances it in place (``xk``, ``xv`` only read)."""
    spec = layer.spec
    h = _norm(cfg, layer, "ln1", x)
    if spec.mixer in _KV_NAMES:
        names = _KV_NAMES[spec.mixer]
        kw = {"spec": spec} if spec.mixer == "attn" else {}
        if mode == "decode":
            y, _ = layer.attn(h, positions, kv_len=kv_len, **kw,
                              cache=tuple(cache[n] for n in names))
        else:
            # the reference computes the entry again for the cache
            # (``_fresh_kv``, ``_latents``): the same products, so the
            # same values
            y, entry = layer.attn(h, positions, **kw)
            if mode == "prefill":
                for n, t in zip(names, entry):
                    cache[n][:, :t.shape[1]] = t
    else:
        st = (cache["conv"], cache["h"]) if mode == "decode" else None
        y, st_new = layer.attn(h, state=st)
        if mode != "train":
            cache["conv"].copy_(st_new[0])
            cache["h"].copy_(st_new[1])
    if cfg.post_block_norm:
        y = _norm(cfg, layer, "ln1_post", y)
    x = x + y
    if spec.cross_attn:
        h = _norm(cfg, layer, "ln_x", x)
        if mode == "decode":
            kv = tuple(cache[n] for n in _CROSS_NAMES)
        else:
            kv = _cross_kv(cfg, layer.xattn, enc_out)
            if mode == "prefill":
                for n, t in zip(_CROSS_NAMES, kv):
                    cache[n].copy_(t)
        y, _ = layer.xattn(h, positions, spec=spec, kv_override=kv)
        x = x + y
    if spec.mlp != "none":
        h = _norm(cfg, layer, "ln2", x)
        y = layer.mlp(h, mesh=mesh) if spec.mlp == "moe" else layer.mlp(h)
        if cfg.post_block_norm:
            y = _norm(cfg, layer, "ln2_post", y)
        x = x + y
    return x


def _run_block(cfg, block, x, positions, enc_out, mode="train", cache=None,
               kv_len=None, b=0, mesh=None):
    """One block's layers in order; block ``b`` of the cache."""
    for key, layer in block.items():
        x = _apply_layer(
            cfg, layer, x, positions, mode=mode, kv_len=kv_len,
            enc_out=enc_out, mesh=mesh, cache=None if cache is None else {
                n: t[b] for n, t in cache[key].items()})
    return x


def _run_blocks(cfg, blocks, x, positions, *, mode="train", cache=None,
                kv_len=None, enc_out=None, remat=None, mesh=None):
    """The blocks in order (``model.blocks``, or ``model.enc.blocks``).
    With ``cache`` (``cache_defs``' stacked layout), block ``b``'s layers
    write their entries into index ``b`` of it, in place.  ``remat``
    (default: ``cfg.remat`` in mode ``"train"``, as the reference's) runs
    each block under ``torch.utils.checkpoint``, so that the backward
    recomputes a block's activations instead of keeping them; it only
    matters where a gradient is being recorded."""
    if remat is None:
        remat = cfg.remat and mode == "train"
    remat = remat and torch.is_grad_enabled()
    for b, block in enumerate(blocks):
        if remat:
            x = checkpoint(_run_block, cfg, block, x, positions, enc_out,
                           mode, cache, kv_len, b, mesh, use_reentrant=False)
        else:
            x = _run_block(cfg, block, x, positions, enc_out, mode, cache,
                           kv_len, b, mesh)
    return x


def _positions_default(cfg, tokens):
    """``0 .. S - 1`` for every row: (B, S), or (B, S, 3) with the same
    value in each stream under M-RoPE."""
    b, s = tokens.shape[:2]
    pos = torch.arange(s, device=tokens.device).expand(b, s)
    return pos[..., None].expand(b, s, 3) if cfg.mrope_sections else pos


def encode(cfg, model: Model, frames):
    """Whisper's encoder over precomputed frame embeddings (B, T, D), T up
    to ``enc_ctx``: the learned positions ``pos[:T]`` added, the encoder
    blocks (non-causal, q and k RoPE'd at ``0 .. T - 1``, as the
    reference's are), the final layernorm."""
    if not cfg.enc_layers:
        raise ValueError(f"{cfg.name} has no encoder")
    x = frames.to(_cdt(cfg))
    t = x.shape[1]
    if t > cfg.enc_ctx:
        raise ValueError(f"{t} frames exceed enc_ctx {cfg.enc_ctx}")
    x = x + model.enc.pos[:t][None].to(x.dtype)
    x = _run_blocks(cfg, model.enc.blocks, x, _positions_default(cfg, x[..., 0]))
    return _norm(cfg, model.enc, "final_norm", x)


def _inputs(cfg, model: Model, tokens, positions, extra_embeds, enc_frames):
    """The embedded tokens with ``extra_embeds`` (B, P, D) in place of
    the first P positions, the positions (default
    :func:`_positions_default`) and the encoder's output (None without an
    encoder)."""
    x = embed_tokens(cfg, model, tokens)
    if extra_embeds is not None:
        pfx = extra_embeds.to(device=x.device, dtype=x.dtype)
        if pfx.shape[1] > x.shape[1]:
            raise ValueError(f"{pfx.shape[1]} prefix embeddings exceed the "
                             f"{x.shape[1]} prompt tokens")
        x = torch.cat([pfx, x[:, pfx.shape[1]:]], dim=1)
    positions = (_positions_default(cfg, tokens) if positions is None
                 else torch.as_tensor(positions, device=tokens.device))
    if cfg.enc_layers:
        if enc_frames is None:
            raise ValueError(f"{cfg.name} needs enc_frames")
        return x, positions, encode(cfg, model, enc_frames.to(x.device))
    if enc_frames is not None:
        raise ValueError(f"{cfg.name} has no encoder for enc_frames")
    return x, positions, None


def forward_hidden(cfg, model: Model, tokens, *, positions=None,
                   extra_embeds=None, enc_frames=None, mesh=None,
                   remat=None):
    """Token stream -> final hidden states (B, S, D)."""
    x, positions, enc_out = _inputs(cfg, model, tokens, positions,
                                    extra_embeds, enc_frames)
    x = _run_blocks(cfg, model.blocks, x, positions, enc_out=enc_out,
                    remat=remat, mesh=mesh)
    return _norm(cfg, model, "final_norm", x)


def logits_from_hidden(cfg, model: Model, h):
    w = model.embed.T if cfg.tie_embeddings else model.unembed
    logits = (h @ w.to(h.dtype)).float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    if cfg.padded_vocab != cfg.vocab_size:
        pad = torch.arange(cfg.padded_vocab, device=logits.device) \
            >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e30)
    return logits


def forward(cfg, model: Model, tokens, **kw):
    return logits_from_hidden(cfg, model,
                              forward_hidden(cfg, model, tokens, **kw))


def _chunk_nll(cfg, model: Model, hc, tc, mc):
    """(the summed masked next-token NLL, the mask's sum) of one chunk."""
    logits = logits_from_hidden(cfg, model, hc)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, tc[..., None].long())[..., 0]
    return ((lse - gold) * mc).sum(), mc.sum()


def lm_loss(cfg, model: Model, batch: dict, mesh=None, loss_chunk: int = 512):
    """Mean next-token CE; the vocab projection + CE run in seq chunks so
    fp32 logits never materialize at (B, S, V).

    ``batch``: ``tokens`` (B, S), and optionally ``labels`` (default the
    tokens), ``mask`` (B, S), ``positions``, ``extra_embeds`` and
    ``enc_frames`` (see :func:`forward_hidden`).  Position t predicts
    label t + 1.  The ``(S - 1) // c`` whole chunks of ``c = min(loss_chunk,
    S - 1)`` positions each run under ``torch.utils.checkpoint`` where a
    gradient is recorded, so that the backward recomputes a chunk's
    float32 logits instead of keeping them; the remainder runs directly,
    as in the reference.  Returns the float32 mean over the mask's
    weight (at least 1)."""
    tokens = batch["tokens"]
    h = forward_hidden(cfg, model, tokens, positions=batch.get("positions"),
                       extra_embeds=batch.get("extra_embeds"),
                       enc_frames=batch.get("enc_frames"), mesh=mesh)
    targets = batch.get("labels", tokens)
    mask = batch.get("mask")
    s = h.shape[1]
    h_in, t_in = h[:, :-1], targets[:, 1:].to(h.device)
    m_in = (torch.ones(t_in.shape, device=h.device) if mask is None
            else mask[:, 1:].to(device=h.device, dtype=torch.float32))
    c = min(loss_chunk, s - 1)
    trim = (s - 1) // c * c
    tot = cnt = torch.zeros((), device=h.device)
    for i in range(0, trim, c):
        args = (cfg, model, h_in[:, i:i + c], t_in[:, i:i + c],
                m_in[:, i:i + c])
        nll, m = (checkpoint(_chunk_nll, *args, use_reentrant=False)
                  if torch.is_grad_enabled() else _chunk_nll(*args))
        tot, cnt = tot + nll, cnt + m
    if trim < s - 1:  # the remainder: small, direct
        nll, m = _chunk_nll(cfg, model, h_in[:, trim:], t_in[:, trim:],
                            m_in[:, trim:])
        tot, cnt = tot + nll, cnt + m
    return tot / cnt.clamp_min(1.0)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, max_len: int,
               enc_len: int = 0) -> dict:
    """Shape and sharding metadata of the decode cache, stacked per pattern
    position: attention's k and v ``(B, max_len, KV, hd)``; MLA's latents
    ``ckv`` ``(B, max_len, kv_lora)`` and ``kr`` ``(B, max_len,
    qk_rope)``; the SSM cache, which does not grow with ``max_len``; a
    cross-attention's ``xk``, ``xv`` ``(B, enc_len, H, hd)``.  The
    reference lays those out over ``n_heads`` and fills them with
    ``n_kv_heads``, so a config where the two differ raises ValueError
    (ROADMAP R10)."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    out = {}
    for i, spec in enumerate(cfg.pattern):
        _layer_defs(cfg, spec)
        if spec.mixer == "attn":
            e = {n: L.PD((batch, max_len, kv, hd), ("dp", "sp", None, None))
                 for n in ("k", "v")}
        elif spec.mixer == "mla":
            e = {"ckv": L.PD((batch, max_len, cfg.mla.kv_lora),
                             ("dp", "sp", None)),
                 "kr": L.PD((batch, max_len, cfg.mla.qk_rope_dim),
                            ("dp", "sp", None))}
        else:
            e = {"conv": L.PD((batch, cfg.ssm.d_conv - 1, cfg.d_inner),
                              ("dp", None, "tp")),
                 "h": L.PD((batch, cfg.d_inner, cfg.ssm.d_state),
                           ("dp", "tp", None))}
        if spec.cross_attn:
            if cfg.n_heads != cfg.n_kv_heads:
                raise ValueError(
                    f"{cfg.name}: cross-attention's cache holds n_heads "
                    f"({cfg.n_heads}) heads, its k and v n_kv_heads "
                    f"({cfg.n_kv_heads}); the reference needs them equal")
            e |= {n: L.PD((batch, enc_len, cfg.n_heads, hd),
                          ("dp", None, "tp", None)) for n in _CROSS_NAMES}
        out[f"L{i}"] = e
    return _stack(out, cfg.n_blocks)


def abstract_cache(cfg, batch: int, max_len: int, enc_len: int = 0) -> dict:
    """``{leaf path: ShapeDtype}`` of the cache (``"L0/k"``, ...): the SSM
    state ``h`` float32, the rest in the compute dtype."""
    return {path: ShapeDtype(tuple(pd.shape), torch.float32
                             if path.endswith("/h") else _cdt(cfg))
            for path, pd in flatten_defs(
                cache_defs(cfg, batch, max_len, enc_len)).items()}


def cache_pspecs(cfg, batch: int, max_len: int, axis_names,
                 enc_len: int = 0) -> dict:
    """``{leaf path: partition tuple}`` of the cache."""
    return {path: to_pspec(pd.axes, axis_names)
            for path, pd in flatten_defs(
                cache_defs(cfg, batch, max_len, enc_len)).items()}


def init_cache(cfg, batch: int, max_len: int, enc_len: int = 0, *,
               device=None) -> dict:
    """Zeros in ``cache_defs``' layout: the SSM state ``h`` float32, the
    rest in the compute dtype."""
    dev = resolve_device(device)
    return {key: {n: torch.zeros(pd.shape, device=dev, dtype=(
        torch.float32 if n == "h" else _cdt(cfg))) for n, pd in e.items()}
        for key, e in cache_defs(cfg, batch, max_len, enc_len).items()}


def decode_step(cfg, model: Model, cache, kv_len, tokens, *, positions=None,
                mesh=None):
    """One token for every sequence.  tokens: (B, 1); ``kv_len`` (an int:
    the tokens seen so far) is where attention writes its key.  Positions
    default to ``kv_len``, in every stream under M-RoPE (the reference's
    default).  Returns (logits, cache): the cache passed in is not
    changed, the step writes into its own copy of every entry but the
    cross-attention's ``xk`` and ``xv``, which it only reads and shares
    with the cache passed in."""
    kv_len = int(kv_len)
    b = tokens.shape[0]
    new = {key: {n: t if n in _CROSS_NAMES else t.clone()
                 for n, t in e.items()} for key, e in cache.items()}
    if positions is None:
        positions = torch.full((b, 1, 3) if cfg.mrope_sections else (b, 1),
                               kv_len, device=tokens.device)
    else:
        positions = torch.as_tensor(positions, device=tokens.device)
    x = _run_blocks(cfg, model.blocks, embed_tokens(cfg, model, tokens),
                    positions, mode="decode", cache=new, kv_len=kv_len,
                    mesh=mesh)
    return logits_from_hidden(cfg, model, _norm(cfg, model, "final_norm",
                                                x)), new


def prefill(cfg, model: Model, tokens, max_len: int, *, positions=None,
            enc_frames=None, extra_embeds=None, mesh=None):
    """Process the prompt, build the cache.  Returns (last-pos logits,
    cache); ``max_len`` sizes attention's and MLA's cache (zeros past the
    prompt), not the SSM state; the cross-attention's entries hold the
    encoder's T frames."""
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"{s} prompt tokens do not fit max_len {max_len}")
    x, positions, enc_out = _inputs(cfg, model, tokens, positions,
                                    extra_embeds, enc_frames)
    cache = init_cache(cfg, b, max_len, 0 if enc_out is None
                       else enc_out.shape[1], device=tokens.device)
    x = _run_blocks(cfg, model.blocks, x, positions, mode="prefill",
                    cache=cache, enc_out=enc_out, mesh=mesh)
    h = _norm(cfg, model, "final_norm", x[:, -1:])
    return logits_from_hidden(cfg, model, h), cache
