"""The model stack: parameter metadata -> the module and its initialisation,
and the three execution modes (forward, prefill, decode) over the blocks.

Counterpart of ``repro/models/transformer.py`` for the SSM family
(``mixer="mamba"``, ``mlp="none"``: falcon-mamba-7b).  ``model_defs`` is the
reference's metadata, blocks stacked on a leading ``n_blocks`` axis, and
the single source of the names and shapes; :class:`Model` holds block
``b``'s slice of each stacked leaf in ``blocks[b]["L{i}"]`` under the same
name, and runs the blocks in a Python loop where the reference scans them.
The decode cache keeps the reference's stacked layout.  Weights are cast to
``cfg.compute_dtype`` at use, as the reference does; the SSM state and the
scan stay float32.  Every other mixer and MLP, the encoder and the
modality front ends raise ``NotImplementedError``: they are later slices of
the port (``ROADMAP.md`` Queue 1 item 1).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models.config import LayerSpec, ModelConfig


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet: the port's model stack serves the SSM "
        f"family (mixer 'mamba', mlp 'none'); the rest is ROADMAP.md Queue 1 "
        f"item 1")


# ---------------------------------------------------------------------------
# parameter metadata
# ---------------------------------------------------------------------------

def _add_norm(cfg, d: dict, name: str):
    d[name] = L.PD((cfg.d_model,), (None,))
    if cfg.norm == "layernorm":
        d[name + "_b"] = L.PD((cfg.d_model,), (None,))


def _layer_defs(cfg: ModelConfig, spec: LayerSpec) -> dict:
    if spec.mixer != "mamba":
        raise _unported(f"mixer {spec.mixer!r}")
    if spec.mlp != "none":
        raise _unported(f"mlp {spec.mlp!r}")
    if spec.cross_attn or cfg.post_block_norm:
        raise _unported("cross-attention and post-block norms")
    d = {}
    _add_norm(cfg, d, "ln1")
    d["attn"] = M.mamba_defs(cfg)
    return d


def _stack(defs: dict, n: int) -> dict:
    return {k: _stack(v, n) if isinstance(v, dict)
            else L.PD((n,) + v.shape, (None,) + v.axes, v.fan_in)
            for k, v in defs.items()}


def model_defs(cfg: ModelConfig) -> dict:
    if cfg.enc_layers:
        raise _unported("the encoder (enc_layers)")
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
    """One position of the block pattern: ``ln1`` and the mixer, under the
    reference's name ``attn``."""

    def __init__(self, cfg, spec: LayerSpec, *, device, dtype):
        super().__init__()
        defs = _layer_defs(cfg, spec)
        L.register(self, {k: v for k, v in defs.items() if k != "attn"},
                   device=device, dtype=dtype)
        self.attn = M.Mamba(cfg, device=device, dtype=dtype)


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


def _apply_layer(cfg, layer: Layer, x, *, mode="train", cache=None):
    """One layer; returns (x, new_cache_entry)."""
    h = _norm(cfg, layer, "ln1", x)
    st = (cache["conv"], cache["h"]) if mode == "decode" else None
    y, st_new = layer.attn(h, state=st)
    new_cache = ({"conv": st_new[0], "h": st_new[1]}
                 if mode in ("decode", "prefill") else {})
    return x + y, new_cache


def _run_blocks(cfg, model: Model, x, *, mode="train", cache_blocks=None):
    """The blocks in order; with ``mode`` "prefill" or "decode" also the
    new cache, stacked on a leading ``n_blocks`` axis (``cache_blocks``,
    the decode cache, in the same layout)."""
    entries = []
    for b, block in enumerate(model.blocks):
        e = {}
        for key, layer in block.items():
            bc = (None if cache_blocks is None else
                  {n: t[b] for n, t in cache_blocks[key].items()})
            x, e[key] = _apply_layer(cfg, layer, x, mode=mode, cache=bc)
        entries.append(e)
    if mode == "train":
        return x, None
    return x, {key: {n: torch.stack([e[key][n] for e in entries])
                     for n in entry}
               for key, entry in entries[0].items()}


def _front_ends(extra_embeds, enc_frames):
    if extra_embeds is not None or enc_frames is not None:
        raise _unported("extra_embeds / enc_frames (the vision and audio "
                        "front ends)")


def forward_hidden(cfg, model: Model, tokens, *, extra_embeds=None,
                   enc_frames=None):
    """Token stream -> final hidden states (B, S, D)."""
    _front_ends(extra_embeds, enc_frames)
    x, _ = _run_blocks(cfg, model, embed_tokens(cfg, model, tokens))
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
    position; the SSM cache does not grow with ``max_len``."""
    out = {}
    for i, spec in enumerate(cfg.pattern):
        _layer_defs(cfg, spec)
        out[f"L{i}"] = {
            "conv": L.PD((batch, cfg.ssm.d_conv - 1, cfg.d_inner),
                         ("dp", None, "tp")),
            "h": L.PD((batch, cfg.d_inner, cfg.ssm.d_state),
                      ("dp", "tp", None))}
    return _stack(out, cfg.n_blocks)


def init_cache(cfg, batch: int, max_len: int, *, device=None) -> dict:
    """Zeros in ``cache_defs``' layout: ``h`` float32, ``conv`` in the
    compute dtype."""
    dev = resolve_device(device)
    return {key: {n: torch.zeros(pd.shape, device=dev, dtype=(
        torch.float32 if n == "h" else _cdt(cfg))) for n, pd in e.items()}
        for key, e in cache_defs(cfg, batch, max_len).items()}


def decode_step(cfg, model: Model, cache, kv_len, tokens):
    """One token for every sequence.  tokens: (B, 1).  Returns (logits,
    cache).  ``kv_len``, the tokens seen so far, places attention's next
    key; the SSM state needs no position."""
    x, new_cache = _run_blocks(cfg, model, embed_tokens(cfg, model, tokens),
                               mode="decode", cache_blocks=cache)
    return logits_from_hidden(cfg, model, _norm(cfg, model, "final_norm",
                                                x)), new_cache


def prefill(cfg, model: Model, tokens, max_len: int, *, enc_frames=None,
            extra_embeds=None):
    """Process the prompt, build the cache.  Returns (last-pos logits,
    cache); ``max_len`` sizes attention's cache, not the SSM state."""
    _front_ends(extra_embeds, enc_frames)
    x, cache = _run_blocks(cfg, model, embed_tokens(cfg, model, tokens),
                           mode="prefill")
    h = _norm(cfg, model, "final_norm", x[:, -1:])
    return logits_from_hidden(cfg, model, h), cache
