"""The port's ``lm_loss`` and its gradients against the JAX reference, on
the CPU.

``transformer.lm_loss`` against the reference's for all ten reduced configs
(float32 compute), within 1e-5 relative, with ``loss_chunk`` dividing
S - 1 (whole chunks only) and not (the remainder path) under a mask;
qwen2-vl-7b with ``extra_embeds`` and M-RoPE positions, whisper-medium with
``enc_frames``.  Then ``lm_loss``'s gradients against ``jax.grad`` for
smollm-360m, falcon-mamba-7b and jamba-v0.1-52b (attention, Mamba through
the scan's autograd Function, MoE), each block's slice of a leaf within
1e-4 of the leaf's max |g|, with the blocks under ``torch.utils.checkpoint``
(``cfg.remat``) and bitwise the same without it.  The weights are numpy
draws of the test's own ``default_rng`` (every norm drawn, so whisper does
not compute zeros: ROADMAP R9), handed to both packages through
``params_from_jax``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import registry as jax_registry
from repro.models import transformer as JT

from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import flatten_defs, model_defs

ARCHS = ("smollm-360m", "gemma2-2b", "gemma-7b", "qwen2.5-14b",
         "falcon-mamba-7b", "granite-moe-3b-a800m", "deepseek-v2-236b",
         "jamba-v0.1-52b", "qwen2-vl-7b", "whisper-medium")
S = 17


def _numpy_params(cfg, rng) -> dict:
    """A nested dict of float32 draws at ``model_defs``' shapes: weights
    N(0, 1 / fan_in), the Mamba constants as the init rule sets them,
    every other leaf (norms, biases) 0.02 N(0, 1), plus 1 for a layernorm
    weight."""
    tree: dict = {}
    for path, pd in flatten_defs(model_defs(cfg)).items():
        name = path.split("/")[-1]
        if "a_log" in name:
            a = np.broadcast_to(np.log(np.arange(1, pd.shape[-1] + 1)),
                                pd.shape)
        elif "d_skip" in name:
            a = np.ones(pd.shape)
        elif "dt_b" in name:
            a = np.full(pd.shape, -4.6)
        elif pd.fan_in:
            a = rng.normal(size=pd.shape) / math.sqrt(pd.fan_in)
        else:
            one = cfg.norm == "layernorm" and not name.endswith("_b")
            a = float(one) + 0.02 * rng.normal(size=pd.shape)
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = np.asarray(a, np.float32)
    return tree


def _setup(arch, seed):
    cfg, jcfg = (reg.get_config(arch, reduced=True)
                 for reg in (registry, jax_registry))
    rng = np.random.default_rng(seed)
    tree = _numpy_params(cfg, rng)
    model = params_from_jax(cfg, tree, device="cpu")
    jparams = jax.tree.map(jnp.asarray, tree)
    tokens = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
    batch = {"tokens": tokens}
    if cfg.mrope_sections:
        # 4 patch embeddings on a 2 x 2 grid, then text in every stream
        batch["extra_embeds"] = rng.normal(size=(2, 4, cfg.d_model)).astype(
            np.float32)
        grid = [(0, i // 2, i % 2) for i in range(4)]
        text = [(2 + j,) * 3 for j in range(S - 4)]
        batch["positions"] = np.broadcast_to(
            np.asarray(grid + text, np.int32), (2, S, 3)).copy()
    if cfg.enc_layers:
        batch["enc_frames"] = rng.normal(size=(2, 8, cfg.d_model)).astype(
            np.float32)
    return cfg, jcfg, model, jparams, batch, rng


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["tokens"] = out["tokens"].long()
    return out


@pytest.mark.parametrize("chunk,masked", [(8, False), (5, True)],
                         ids=["chunk-divides", "remainder-masked"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_equals_reference(arch, chunk, masked):
    cfg, jcfg, model, jparams, batch, rng = _setup(arch, len(arch) + chunk)
    if masked:
        batch["mask"] = (rng.random((2, S)) < 0.7).astype(np.float32)
        batch["labels"] = rng.integers(0, cfg.vocab_size, (2, S)).astype(
            np.int32)
    want = float(JT.lm_loss(jcfg, jparams, jax.tree.map(jnp.asarray, batch),
                            loss_chunk=chunk))
    with torch.no_grad():
        got = T.lm_loss(cfg, model, _torch_batch(batch), loss_chunk=chunk)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - want) <= 1e-5 * abs(want), (float(got), want)


@pytest.mark.parametrize("arch", ["smollm-360m", "falcon-mamba-7b",
                                  "jamba-v0.1-52b"])
def test_lm_loss_grads_equal_reference(arch):
    cfg, jcfg, model, jparams, batch, _ = _setup(arch, 7)
    jgrads = flatten_defs(jax.tree.map(np.asarray, jax.grad(
        lambda p: JT.lm_loss(jcfg, p, jax.tree.map(jnp.asarray, batch),
                             loss_chunk=5))(jparams)))
    assert cfg.remat

    def grads(cfg):
        model.requires_grad_(True)
        model.zero_grad(set_to_none=True)
        T.lm_loss(cfg, model, _torch_batch(batch), loss_chunk=5).backward()
        return {(path, b): p.grad.clone() for path, b, p in model.leaves()}

    got = grads(cfg)
    for (path, b), g in got.items():
        want = jgrads[path] if b is None else jgrads[path][b]
        scale = np.abs(jgrads[path]).max()
        err = np.abs(g.numpy() - want).max()
        assert err <= 1e-4 * scale + 1e-12, (path, b, err, scale)
    plain = grads(dataclasses.replace(cfg, remat=False))
    assert all(torch.equal(got[k], plain[k]) for k in got)
