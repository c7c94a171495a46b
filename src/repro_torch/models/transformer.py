"""The model stack: parameter metadata -> the module and its initialisation,
and the three execution modes (forward, prefill, decode) over the blocks.

Counterpart of ``repro/models/transformer.py`` for the SSM family
(``mixer="mamba"``: falcon-mamba-7b), the dense attention family
(``mixer="attn"``, ``mlp="dense"``, gemma2's post-block norms:
smollm-360m, gemma2-2b, gemma-7b, qwen2.5-14b), the MoE family
(``mlp="moe"``: granite-moe-3b; with ``mixer="mla"``: deepseek-v2-236b)
and the hybrid jamba-v0.1-52b (Mamba and attention mixers, dense and MoE
MLPs in one block).  ``model_defs`` is the reference's metadata, blocks
stacked on a leading ``n_blocks`` axis, and the single source of the
names and shapes; :class:`Model` holds block ``b``'s slice of each
stacked leaf in ``blocks[b]["L{i}"]`` under the same name, and runs the
blocks in a Python loop where the reference scans them.  The decode
cache keeps the reference's stacked layout: attention's k and v
(``(n_blocks, B, max_len, KV, hd)``, the compute dtype), MLA's latents
``ckv`` and ``kr`` (``(n_blocks, B, max_len, kv_lora | qk_rope)``) and
the Mamba state.  Weights are cast to ``cfg.compute_dtype`` at use, as
the reference does; the SSM state, the scan, the MoE router and
attention's scores stay float32.  The MoE runs without a mesh (the
reference's ``_moe_call`` with ``mesh=None``).  Cross-attention, the
encoder, M-RoPE and the modality front ends raise
``NotImplementedError``: they are later slices of the port
(``ROADMAP.md`` Queue 1 item 1).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import mla as MLA
from repro_torch.models import moe as MOE
from repro_torch.models.config import LayerSpec, ModelConfig

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
        raise L.unported("cross-attention (cross_attn)")
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


def model_defs(cfg: ModelConfig) -> dict:
    if cfg.enc_layers:
        raise L.unported("the encoder (enc_layers)")
    if cfg.mrope_sections:
        raise L.unported("M-RoPE (mrope_sections: qwen2-vl)")
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


# ---------------------------------------------------------------------------
# the module and its parameters
# ---------------------------------------------------------------------------

class Layer(nn.Module):
    """One position of the block pattern: its norms, the mixer under the
    reference's name ``attn`` (:class:`layers.Attention`, :class:`mla.MLA`
    or :class:`mamba.Mamba`) and the MLP under ``mlp`` (:class:`layers.MLP`
    or :class:`moe.MoE`), if the spec has one."""

    def __init__(self, cfg, spec: LayerSpec, *, device, dtype):
        super().__init__()
        self.spec = spec
        defs = _layer_defs(cfg, spec)
        L.register(self, {k: v for k, v in defs.items()
                          if k not in ("attn", "mlp")},
                   device=device, dtype=dtype)
        self.attn = _MIXERS[spec.mixer][1](cfg, device=device, dtype=dtype)
        if "mlp" in defs:
            self.mlp = _MLPS[spec.mlp][1](cfg, device=device, dtype=dtype)


class Model(nn.Module):
    """The stack's parameters, uninitialised: build one with
    :func:`init_params` or ``convert.params_from_jax``.  ``blocks[b]`` is an
    ``nn.ModuleDict`` of the pattern's layers ``"L0"``, ``"L1"``, ..."""

    def __init__(self, cfg: ModelConfig, *, device=None):
        super().__init__()
        self.cfg = cfg
        dtype = getattr(torch, cfg.param_dtype)
        top = {k: v for k, v in model_defs(cfg).items() if k != "blocks"}
        L.register(self, top, device=device, dtype=dtype)
        self.blocks = nn.ModuleList(
            nn.ModuleDict({f"L{i}": Layer(cfg, spec, device=device,
                                          dtype=dtype)
                           for i, spec in enumerate(cfg.pattern)})
            for _ in range(cfg.n_blocks))

    def leaves(self):
        """``(reference path, block index or None, parameter)`` for every
        parameter; a block's parameter is index ``b`` of the reference's
        stacked leaf."""
        for name, p in self.named_parameters():
            parts = name.split(".")
            if parts[0] == "blocks":
                yield "/".join(["blocks"] + parts[2:]), int(parts[1]), p
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


def _apply_layer(cfg, layer: Layer, x, positions, *, mode="train",
                 cache=None, kv_len=None):
    """One layer.  ``cache`` is the layer's slice of the stacked cache:
    ``mode="prefill"`` writes the layer's entry into it (attention's RoPE'd
    k and v, or MLA's latents, at positions ``0 .. S - 1``; the Mamba
    state), ``mode="decode"`` reads and advances it in place."""
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
    if spec.mlp != "none":
        y = layer.mlp(_norm(cfg, layer, "ln2", x))
        if cfg.post_block_norm:
            y = _norm(cfg, layer, "ln2_post", y)
        x = x + y
    return x


def _run_blocks(cfg, model: Model, x, positions, *, mode="train",
                cache=None, kv_len=None):
    """The blocks in order.  With ``cache`` (``cache_defs``' stacked
    layout), block ``b``'s layers write their entries into index ``b`` of
    it, in place."""
    for b, block in enumerate(model.blocks):
        for key, layer in block.items():
            x = _apply_layer(
                cfg, layer, x, positions, mode=mode, kv_len=kv_len,
                cache=None if cache is None else {
                    n: t[b] for n, t in cache[key].items()})
    return x


def _positions_default(tokens):
    b, s = tokens.shape[:2]
    return torch.arange(s, device=tokens.device).expand(b, s)


def _front_ends(extra_embeds, enc_frames):
    if extra_embeds is not None or enc_frames is not None:
        raise L.unported("extra_embeds / enc_frames (the vision and audio "
                         "front ends)")


def forward_hidden(cfg, model: Model, tokens, *, extra_embeds=None,
                   enc_frames=None):
    """Token stream -> final hidden states (B, S, D)."""
    _front_ends(extra_embeds, enc_frames)
    x = _run_blocks(cfg, model, embed_tokens(cfg, model, tokens),
                    _positions_default(tokens))
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


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_defs(cfg: ModelConfig, batch: int, max_len: int) -> dict:
    """Shape and sharding metadata of the decode cache, stacked per pattern
    position: attention's k and v ``(B, max_len, KV, hd)``; MLA's latents
    ``ckv`` ``(B, max_len, kv_lora)`` and ``kr`` ``(B, max_len,
    qk_rope)``; the SSM cache, which does not grow with ``max_len``."""
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    out = {}
    for i, spec in enumerate(cfg.pattern):
        _layer_defs(cfg, spec)
        if spec.mixer == "attn":
            out[f"L{i}"] = {
                n: L.PD((batch, max_len, kv, hd), ("dp", "sp", None, None))
                for n in ("k", "v")}
        elif spec.mixer == "mla":
            out[f"L{i}"] = {
                "ckv": L.PD((batch, max_len, cfg.mla.kv_lora),
                            ("dp", "sp", None)),
                "kr": L.PD((batch, max_len, cfg.mla.qk_rope_dim),
                           ("dp", "sp", None))}
        else:
            out[f"L{i}"] = {
                "conv": L.PD((batch, cfg.ssm.d_conv - 1, cfg.d_inner),
                             ("dp", None, "tp")),
                "h": L.PD((batch, cfg.d_inner, cfg.ssm.d_state),
                          ("dp", "tp", None))}
    return _stack(out, cfg.n_blocks)


def init_cache(cfg, batch: int, max_len: int, *, device=None) -> dict:
    """Zeros in ``cache_defs``' layout: the SSM state ``h`` float32, the
    rest in the compute dtype."""
    dev = resolve_device(device)
    return {key: {n: torch.zeros(pd.shape, device=dev, dtype=(
        torch.float32 if n == "h" else _cdt(cfg))) for n, pd in e.items()}
        for key, e in cache_defs(cfg, batch, max_len).items()}


def decode_step(cfg, model: Model, cache, kv_len, tokens):
    """One token for every sequence.  tokens: (B, 1); ``kv_len`` (an int:
    the tokens seen so far) is its position, where attention writes its
    key.  Returns (logits, cache): the cache passed in is not changed, the
    step writes into its own copy.  Positions are always ``kv_len`` (the
    reference's default; M-RoPE positions come with qwen2-vl)."""
    kv_len = int(kv_len)
    b = tokens.shape[0]
    new = {key: {n: t.clone() for n, t in e.items()}
           for key, e in cache.items()}
    positions = torch.full((b, 1), kv_len, device=tokens.device)
    x = _run_blocks(cfg, model, embed_tokens(cfg, model, tokens), positions,
                    mode="decode", cache=new, kv_len=kv_len)
    return logits_from_hidden(cfg, model, _norm(cfg, model, "final_norm",
                                                x)), new


def prefill(cfg, model: Model, tokens, max_len: int, *, enc_frames=None,
            extra_embeds=None):
    """Process the prompt, build the cache.  Returns (last-pos logits,
    cache); ``max_len`` sizes attention's and MLA's cache (zeros past the
    prompt), not the SSM state."""
    _front_ends(extra_embeds, enc_frames)
    b, s = tokens.shape
    if s > max_len:
        raise ValueError(f"{s} prompt tokens do not fit max_len {max_len}")
    cache = init_cache(cfg, b, max_len, device=tokens.device)
    x = _run_blocks(cfg, model, embed_tokens(cfg, model, tokens),
                    _positions_default(tokens), mode="prefill", cache=cache)
    h = _norm(cfg, model, "final_norm", x[:, -1:])
    return logits_from_hidden(cfg, model, h), cache
