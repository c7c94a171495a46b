"""The front ends of the port's model stack against the JAX reference on the
CPU: qwen2-vl-7b's M-RoPE and patch-embedding prefix, whisper-medium's
encoder and cross-attention.

At the reduced configs (qwen2-vl: M-RoPE sections (2, 3, 3) over 8
frequency pairs; whisper: 2 encoder and 2 decoder layers, ``enc_ctx``
16), every input drawn from the test's own ``np.random.default_rng``:
``apply_rope`` under M-RoPE with three streams that differ (float32 within
1e-6, bfloat16 bitwise), and with equal streams bitwise plain RoPE;
``model_defs`` name for name (qwen2-vl-7b 7 615 616 512 parameters,
whisper-medium 1 013 989 376) and the cache layout with ``enc_len``; the
attention layer's cross-attention and non-causal encoder; ``encode``,
``forward``, ``prefill`` (its logits and every cache entry, ``xk`` and
``xv`` among them) and decode steps with the default and with explicit
3-stream positions, within rtol = atol = 1e-4 in float32; greedy
``Generator`` tokens token for token.  The reference zero-initialises
every layernorm weight, so whisper under ``init_params`` computes zeros
(ROADMAP R9): the parity tests redraw the norms' weights and biases
before ``params_from_jax``, and one test pins the zeros.  The card is in
``tests/test_torch_cuda.py``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import layers as JL
from repro.models import registry as jax_registry
from repro.models import transformer as JT
from repro.models.config import LayerSpec as JaxLayerSpec
from repro.serve.generate import Generator as JaxGenerator

from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.models.config import LayerSpec
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Generator

CPU = "cpu"
VLM, AUDIO = "qwen2-vl-7b", "whisper-medium"
FULL_PARAMS = {VLM: 7_615_616_512, AUDIO: 1_013_989_376}
TOL = dict(rtol=1e-4, atol=1e-4)
GRID = 4  # the reduced tests' patch grid: 16 patches lead each prompt


def _configs(arch, **over):
    return (registry.get_config(arch, reduced=True, **over),
            jax_registry.get_config(arch, reduced=True, **over))


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), **(tol or TOL))


def _grid_positions(b, s, grid):
    """Qwen2-VL's positions for ``grid**2`` patches then text: patch ``i``
    at (0, i // grid, i % grid), text token ``j`` at ``grid + j`` in all
    three streams.  (B, S, 3) int32."""
    p = grid * grid
    pos = np.empty((s, 3), np.int32)
    i = np.arange(p)
    pos[:p] = np.stack([np.zeros_like(i), i // grid, i % grid], -1)
    pos[p:] = (grid + np.arange(s - p))[:, None]
    return np.broadcast_to(pos, (b, s, 3)).copy()


def _redraw_norms(tree, rng, layernorm):
    """The reference tree with every norm weight and bias drawn anew, in
    place: layernorm weights 1 + 0.02 N(0, 1), rmsnorm weights (applied as
    ``1 + w``) and the biases 0.02 N(0, 1).  The reference's init zeroes
    them, which makes whisper compute zeros (R9)."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _redraw_norms(v, rng, layernorm)
        elif k.startswith(("ln", "final_norm")):
            noise = (0.02 * rng.normal(size=v.shape)).astype(v.dtype)
            weight = layernorm and not k.endswith("_b")
            tree[k] = noise + 1 if weight else noise
        elif not np.any(v):  # qwen2-vl's zero q, k, v biases
            tree[k] = (0.02 * rng.normal(size=v.shape)).astype(v.dtype)
    return tree


def _models(arch, seed=0):
    """(cfg, jcfg, reference params, port model), the norms redrawn."""
    cfg, jcfg = _configs(arch)
    tree = jax.tree.map(np.asarray,
                        JT.init_params(jcfg, jax.random.PRNGKey(seed)))
    tree = _redraw_norms(tree, np.random.default_rng(seed + 100),
                         cfg.norm == "layernorm")
    return (cfg, jcfg, jax.tree.map(jnp.asarray, tree),
            params_from_jax(cfg, tree, device=CPU))


def _front(cfg, b, s, seed, grid_positions):
    """Tokens, and the keyword arguments of the model's front end:
    ``extra_embeds`` for the 16 leading patches (with grid positions if
    asked), or ``enc_frames`` over all ``enc_ctx`` frames (with positions
    shifted by 3 if asked: any (B, S) positions go through)."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    kw = {}
    if cfg.enc_layers:
        kw["enc_frames"] = rng.normal(size=(b, cfg.enc_ctx, cfg.d_model)
                                      ).astype(np.float32)
        if grid_positions:
            kw["positions"] = np.tile(np.arange(s, dtype=np.int32) + 3,
                                      (b, 1))
    else:
        kw["extra_embeds"] = rng.normal(size=(b, GRID * GRID, cfg.d_model)
                                        ).astype(np.float32)
        if grid_positions:
            kw["positions"] = _grid_positions(b, s, GRID)
    return tokens, kw


def _port(kw):
    return {k: torch.from_numpy(v) for k, v in kw.items()}


def _ref(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


CASES = [(VLM, False), (VLM, True), (AUDIO, False), (AUDIO, True)]
IDS = ["qwen2-vl-default", "qwen2-vl-grid", "whisper-default",
       "whisper-explicit"]


# ---------------------------------------------------------------------------
# M-RoPE
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("reduced", [True, False], ids=["reduced", "full"])
def test_mrope_equals_reference(reduced, dtype):
    """Three streams that differ: the grid positions of 64 patches then
    text, shifted by random offsets up to 4 096 per row.  At full width
    (head_dim 128, sections (16, 24, 24), theta 1e6) and reduced (16,
    (2, 3, 3))."""
    cfg = registry.get_config(VLM, reduced=reduced)
    jcfg = jax_registry.get_config(VLM, reduced=reduced)
    rng = np.random.default_rng(7 + reduced)
    x = rng.normal(size=(2, 80, 3, cfg.head_dim)).astype(np.float32)
    pos = _grid_positions(2, 80, 8) + rng.integers(0, 4096, (2, 1, 1))
    assert all(np.any(pos[..., i] != pos[..., j])
               for i, j in ((0, 1), (0, 2), (1, 2)))
    xt = torch.from_numpy(x).to(getattr(torch, dtype))
    got = L.apply_rope(cfg, xt, torch.from_numpy(pos))
    want = JL.apply_rope(jcfg, jnp.asarray(x, dtype), jnp.asarray(pos))
    assert got.dtype == xt.dtype
    exact = dtype == "bfloat16"
    _close(got, np.asarray(want.astype(jnp.float32)),
           rtol=0 if exact else 1e-6, atol=0 if exact else 1e-6)
    plain = L.apply_rope(cfg, xt, torch.from_numpy(pos[..., 0]))
    assert not torch.equal(got, plain)  # the height and width streams count


def test_mrope_with_equal_streams_is_plain_rope():
    """The same position in all three streams is plain RoPE, bitwise: so
    default positions cannot tell M-RoPE from RoPE, and the model tests
    run with grid positions too."""
    cfg, jcfg = _configs(VLM)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 30, 4, 16)).astype(np.float32))
    pos = torch.from_numpy(rng.integers(0, 10_000, (2, 30)))
    pos3 = pos[..., None].expand(2, 30, 3)
    assert torch.equal(L.apply_rope(cfg, x, pos3), L.apply_rope(cfg, x, pos))
    plain = dataclasses.replace(cfg, mrope_sections=())
    assert torch.equal(L.apply_rope(cfg, x, pos3),
                       L.apply_rope(plain, x, pos))


def test_mrope_falls_back_like_reference():
    """Sections with (B, S) positions, and (B, S, 3) positions without
    sections (stream 0), take the plain path in both packages."""
    cfg, jcfg = _configs(VLM)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(1, 20, 2, 16)).astype(np.float32)
    pos3 = _grid_positions(1, 20, GRID)
    for c, jc, pos in (
            (cfg, jcfg, pos3[..., 1]),
            (dataclasses.replace(cfg, mrope_sections=()),
             dataclasses.replace(jcfg, mrope_sections=()), pos3)):
        got = L.apply_rope(c, torch.from_numpy(x), torch.from_numpy(pos))
        _close(got, JL.apply_rope(jc, jnp.asarray(x), jnp.asarray(pos)),
               rtol=1e-6, atol=1e-6)
        assert torch.equal(got, L.apply_rope(
            c, torch.from_numpy(x), torch.from_numpy(
                pos if pos.ndim == 2 else pos[..., 0])))


def test_mrope_sections_must_cover_the_pairs():
    cfg = dataclasses.replace(registry.get_config(VLM, reduced=True),
                              mrope_sections=(2, 3, 2))
    with pytest.raises(ValueError, match="frequency pairs"):
        L.apply_rope(cfg, torch.zeros(1, 4, 2, 16),
                     torch.zeros(1, 4, 3, dtype=torch.long))


# ---------------------------------------------------------------------------
# parameters and cache layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_model_defs_equal_reference(arch, reduced):
    """Name for name, shape, axes and fan-in, the encoder's ``enc``
    subtree and the cross-attention's ``ln_x`` / ``xattn`` included."""
    cfg = registry.get_config(arch, reduced=reduced)
    jcfg = jax_registry.get_config(arch, reduced=reduced)
    got = {path: tuple(pd) for path, pd in
           T.flatten_defs(T.model_defs(cfg)).items()}
    want = {path: (tuple(pd.shape), tuple(pd.axes), pd.fan_in) for path, pd
            in JT._flatten_with_path(JT.model_defs(jcfg))}
    assert got == want
    assert T.n_params(cfg) == sum(math.prod(s) for s, _, _ in want.values())
    if not reduced:
        assert T.n_params(cfg) == FULL_PARAMS[arch]
    if arch == AUDIO:
        assert {"enc/pos", "enc/final_norm", "enc/final_norm_b",
                "blocks/L0/ln_x", "blocks/L0/ln_x_b",
                "blocks/L0/xattn/wq"} <= set(got)


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_module_leaves_and_init_params(arch):
    """``Model.leaves`` names every ``model_defs`` leaf once, the encoder's
    blocks by their index; ``init_params`` keeps the reference's rule:
    the norms (``ln_x``, the encoder's ``final_norm``) and biases zero,
    ``enc/pos`` and the cross-attention's weights drawn at 1/sqrt(fan_in)."""
    cfg = registry.get_config(arch, reduced=True)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(1),
                          device=CPU)
    defs = T.flatten_defs(T.model_defs(cfg))
    seen = {}
    for path, block, p in model.leaves():
        seen.setdefault(path, set()).add(block)
        if block is not None:
            assert tuple(p.shape) == defs[path].shape[1:]
        name = path.split("/")[-1]
        if name.startswith(("ln", "final_norm", "b")):
            assert not p.any(), path
        elif name in ("pos", "wq", "wk", "wv"):
            std = p.std().item() * math.sqrt(defs[path].fan_in)
            assert 0.8 < std < 1.2, (path, std)
    assert set(seen) == set(defs)
    if arch == AUDIO:
        assert seen["enc/blocks/L0/attn/wq"] == set(range(cfg.enc_layers))
        assert seen["blocks/L0/xattn/wo"] == set(range(cfg.n_blocks))


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_cache_layout_equals_reference(arch):
    """``cache_defs`` / ``init_cache`` with ``enc_len`` against the
    reference's: names, shapes, axes and dtypes; ``xk`` and ``xv`` over
    the encoder's frames."""
    for reduced in (False, True):
        cfg = registry.get_config(arch, reduced=reduced)
        jcfg = jax_registry.get_config(arch, reduced=reduced)
        enc_len = 16 if reduced else 1500
        got = T.cache_defs(cfg, 2, 40, enc_len)
        want = JT.cache_defs(jcfg, 2, 40, enc_len)
        assert {k: {n: tuple(pd) for n, pd in e.items()}
                for k, e in got.items()} == {
            k: {n: (tuple(pd.shape), tuple(pd.axes), pd.fan_in)
                for n, pd in e.items()} for k, e in want.items()}
    cache = T.init_cache(cfg, 2, 40, 16, device=CPU)
    jcache = JT.abstract_cache(jcfg, 2, 40, 16)
    for key, entry in cache.items():
        assert set(entry) == ({"k", "v", "xk", "xv"} if cfg.enc_layers
                              else {"k", "v"})
        for name, t in entry.items():
            assert tuple(t.shape) == jcache[key][name].shape
            assert str(t.dtype).split(".")[1] == str(jcache[key][name].dtype)


def test_cross_attention_cache_needs_equal_head_counts():
    """The reference lays ``xk`` out over ``n_heads`` and fills it with
    ``n_kv_heads`` (R10): the port raises where they differ."""
    cfg = registry.get_config(AUDIO, reduced=True, n_kv_heads=2)
    with pytest.raises(ValueError, match="n_kv_heads"):
        T.cache_defs(cfg, 1, 8, 4)


# ---------------------------------------------------------------------------
# the attention layer: cross-attention and the encoder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["cross-prefill", "cross-one", "encoder"])
def test_attention_layer_front_ends_equal_reference(case):
    """``attn_apply`` with ``kv_override`` (13 encoder frames, one query
    through ``attend_one`` or 20 through non-causal flash attention over
    chunks of 16, the padding masked) and with an encoder spec (q and k
    RoPE'd, no causal mask), on the same weights."""
    cfg, jcfg = _configs(AUDIO)
    rng = np.random.default_rng(len(case))
    w = {n: (rng.normal(size=pd.shape) * 0.2).astype(np.float32)
         for n, pd in L.attn_defs(cfg).items()}
    layer = L.Attention(cfg, device=CPU)
    with torch.no_grad():
        for n, a in w.items():
            getattr(layer, n).copy_(torch.from_numpy(a))
    jw = {n: jnp.asarray(a) for n, a in w.items()}
    s = 1 if case == "cross-one" else 20
    x = rng.normal(size=(2, s, cfg.d_model)).astype(np.float32)
    pos = np.tile(np.arange(s) + 5, (2, 1))
    kw, jkw = {}, {}
    if case.startswith("cross"):
        k, v = (rng.normal(size=(2, 13, cfg.n_kv_heads, cfg.head_dim))
                .astype(np.float32) for _ in range(2))
        kw["kv_override"] = (torch.from_numpy(k), torch.from_numpy(v))
        jkw["kv_override"] = (jnp.asarray(k), jnp.asarray(v))
    enc = case == "encoder"
    out, entry = layer(torch.from_numpy(x), torch.from_numpy(pos),
                       spec=LayerSpec(encoder=enc), **kw)
    want, _ = JL.attn_apply(jcfg, jw, jnp.asarray(x), jnp.asarray(pos),
                            spec=JaxLayerSpec(encoder=enc), **jkw)
    _close(out, want)
    if case.startswith("cross"):
        assert entry[0] is kw["kv_override"][0]
    else:  # non-causal: the first position sees the last
        causal, _ = layer(torch.from_numpy(x), torch.from_numpy(pos),
                          spec=LayerSpec())
        assert not torch.allclose(out[:, 0], causal[:, 0])


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("frames", [16, 11])
def test_encode_equals_reference(frames):
    """whisper's encoder over all 16 frame positions and over 11."""
    cfg, jcfg, params, model = _models(AUDIO, seed=1)
    x = np.random.default_rng(frames).normal(
        size=(2, frames, cfg.d_model)).astype(np.float32)
    got = T.encode(cfg, model, torch.from_numpy(x))
    want = JT.encode(jcfg, params, jnp.asarray(x))
    assert got.shape == (2, frames, cfg.d_model)
    assert got.abs().max() > 0.1
    _close(got, want)


def test_encode_checks_its_frames():
    cfg, _, _, model = _models(AUDIO)
    with pytest.raises(ValueError, match="enc_ctx"):
        T.encode(cfg, model, torch.zeros(1, cfg.enc_ctx + 1, cfg.d_model))
    tokens = torch.zeros(1, 4, dtype=torch.long)
    with pytest.raises(ValueError, match="enc_frames"):
        T.forward(cfg, model, tokens)
    vcfg, _, _, vlm = _models(VLM)
    with pytest.raises(ValueError, match="no encoder"):
        T.forward(vcfg, vlm, tokens, enc_frames=torch.zeros(1, 2, 64))
    with pytest.raises(ValueError, match="prefix"):
        T.forward(vcfg, vlm, tokens, extra_embeds=torch.zeros(1, 5, 64))


@pytest.mark.parametrize("arch,positions", CASES, ids=IDS)
def test_forward_equals_reference(arch, positions):
    """``forward`` on 30 tokens (chunks of 16: padded) with the model's
    front end, at default and explicit positions."""
    cfg, jcfg, params, model = _models(arch, seed=2)
    tokens, kw = _front(cfg, 2, 30, 5, positions)
    got = T.forward(cfg, model, torch.from_numpy(tokens).long(), **_port(kw))
    want = JT.forward(jcfg, params, jnp.asarray(tokens), **_ref(kw))
    assert got.shape == (2, 30, cfg.padded_vocab)
    assert got[..., :cfg.vocab_size].abs().max() > 0.1
    _close(got, want)


def test_front_ends_change_the_output():
    """The patch embeddings and grid positions, and the encoder's frames,
    each move the logits (so the parity above is not vacuous)."""
    cfg, _, _, model = _models(VLM, seed=3)
    tokens, kw = _front(cfg, 2, 30, 6, True)
    tt = torch.from_numpy(tokens).long()
    base = T.forward(cfg, model, tt)
    embeds = T.forward(cfg, model, tt, extra_embeds=_port(kw)["extra_embeds"])
    grid = T.forward(cfg, model, tt, **_port(kw))
    assert (embeds - base).abs().max() > 1e-3
    assert (grid - embeds).abs().max() > 1e-3
    acfg, _, _, audio = _models(AUDIO, seed=3)
    tokens, kw = _front(acfg, 2, 30, 6, False)
    frames = torch.from_numpy(kw["enc_frames"])
    a = T.forward(acfg, audio, torch.from_numpy(tokens).long(),
                  enc_frames=frames)
    b = T.forward(acfg, audio, torch.from_numpy(tokens).long(),
                  enc_frames=frames.flip(1))
    assert (a - b).abs().max() > 1e-3


def _decode_positions(cfg, b, step_pos, explicit):
    if not explicit:
        return None
    shape = (b, 1, 3) if cfg.mrope_sections else (b, 1)
    return np.full(shape, step_pos, np.int32)


@pytest.mark.parametrize("arch,positions", CASES, ids=IDS)
def test_prefill_and_decode_equal_reference(arch, positions):
    """``prefill`` of 30 tokens (the logits and every cache entry, ``xk``
    and ``xv`` included), then two ``decode_step``s at the default
    positions or explicit ones (qwen2-vl: the grid's next text position in
    all three streams), each step's logits and whole cache against the
    reference's; the cache passed in is left as it was."""
    cfg, jcfg, params, model = _models(arch, seed=4)
    b, s, steps = 2, 30, 2
    tokens, kw = _front(cfg, b, s, 8, positions)
    lp, cache = T.prefill(cfg, model, torch.from_numpy(tokens).long(), 40,
                          **_port(kw))
    jlp, jcache = JT.prefill(jcfg, params, jnp.asarray(tokens), 40,
                             **_ref(kw))
    if cfg.enc_layers:
        assert cache["L0"]["xk"].shape == (
            cfg.n_blocks, b, cfg.enc_ctx, cfg.n_heads, cfg.head_dim)
    shift = GRID - GRID * GRID if cfg.mrope_sections else 3
    for step in range(steps + 1):
        _close(lp, jlp)
        assert set(cache) == set(jcache)
        for key, entry in cache.items():
            assert set(entry) == set(jcache[key])
            for name, t in entry.items():
                _close(t, jcache[key][name])
        if step == steps:
            break
        nxt = np.asarray(jnp.argmax(jlp, axis=-1)).astype(np.int32)
        pos = _decode_positions(cfg, b, s + step + shift, positions)
        before = {k: {n: t.clone() for n, t in e.items()}
                  for k, e in cache.items()}
        lp, new = T.decode_step(
            cfg, model, cache, s + step, torch.from_numpy(nxt).long(),
            positions=None if pos is None else torch.from_numpy(pos))
        for k, e in cache.items():
            for n, t in e.items():
                assert torch.equal(t, before[k][n])
        cache = new
        jlp, jcache = JT.decode_step(
            jcfg, params, jcache, jnp.int32(s + step), jnp.asarray(nxt),
            positions=None if pos is None else jnp.asarray(pos))


def test_explicit_decode_positions_matter():
    """A qwen2-vl step at the grid's text position differs from one at the
    default ``kv_len``, and equals one given ``kv_len`` explicitly."""
    cfg, _, _, model = _models(VLM, seed=5)
    tokens, kw = _front(cfg, 2, 30, 9, True)
    _, cache = T.prefill(cfg, model, torch.from_numpy(tokens).long(), 32,
                         **_port(kw))
    nxt = torch.zeros(2, 1, dtype=torch.long)
    default, _ = T.decode_step(cfg, model, cache, 30, nxt)
    same, _ = T.decode_step(cfg, model, cache, 30, nxt,
                            positions=torch.full((2, 1, 3), 30))
    grid, _ = T.decode_step(cfg, model, cache, 30, nxt,
                            positions=torch.full((2, 1, 3), 30 + GRID - 16))
    assert torch.equal(default, same)
    assert (grid - default).abs().max() > 1e-4


def test_decode_step_shares_the_cross_entries():
    """``xk`` and ``xv`` are the input cache's own tensors in the step's
    cache (the same storage, never copied); every other entry is a copy."""
    cfg, _, _, model = _models(AUDIO, seed=6)
    tokens, kw = _front(cfg, 2, 12, 10, False)
    _, cache = T.prefill(cfg, model, torch.from_numpy(tokens).long(), 16,
                         **_port(kw))
    _, new = T.decode_step(cfg, model, cache, 12,
                           torch.zeros(2, 1, dtype=torch.long))
    for key, entry in cache.items():
        for name, t in entry.items():
            shared = new[key][name].data_ptr() == t.data_ptr()
            assert shared == (name in ("xk", "xv")), (key, name)
    _, again = T.decode_step(cfg, model, new, 13,
                             torch.zeros(2, 1, dtype=torch.long))
    assert again["L0"]["xk"] is cache["L0"]["xk"]


@pytest.mark.parametrize("arch", [VLM, AUDIO])
def test_generator_greedy_equals_reference(arch):
    """2 prompts of 24 tokens with the front end's inputs given as numpy
    arrays, 8 greedy steps, token for token."""
    cfg, jcfg, params, model = _models(arch, seed=7)
    tokens, kw = _front(cfg, 2, 24, 11, False)
    got = Generator(cfg, model, max_len=40, device=CPU).generate(
        tokens, 8, **kw)
    want = JaxGenerator(jcfg, params, max_len=40).generate(
        tokens, 8, **_ref(kw))
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
    again = Generator(cfg, model, max_len=40, device=CPU).generate(
        tokens, 8, **_port(kw))
    np.testing.assert_array_equal(again, got)


def test_whisper_under_init_params_computes_zeros():
    """R9, kept in both packages: the init rule zeroes every layernorm
    weight and bias, so the encoder's output and the logits are exactly
    0 (``*= w`` where rmsnorm has ``1 + w``)."""
    cfg, jcfg = _configs(AUDIO)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(2),
                          device=CPU)
    params = JT.init_params(jcfg, jax.random.PRNGKey(2))
    tokens, kw = _front(cfg, 2, 10, 12, False)
    got = T.forward(cfg, model, torch.from_numpy(tokens).long(), **_port(kw))
    enc = T.encode(cfg, model, _port(kw)["enc_frames"])
    want = JT.forward(jcfg, params, jnp.asarray(tokens), **_ref(kw))
    assert not enc.any()
    assert not got[..., :cfg.vocab_size].any()
    assert not np.asarray(want)[..., :cfg.vocab_size].any()
