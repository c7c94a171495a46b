"""The port's ``Generator`` (``repro_torch.serve.generate``) against the
JAX reference's (``repro.serve.generate``) on the CPU.

The reduced falcon-mamba-7b with the reference's parameters
(``params_from_jax``): greedy tokens equal token for token on 3 prompts x
8 steps, and with ``stop_token`` the same early stop.  Sampling draws from
a ``torch.Generator``, not ``jax.random.categorical``'s bits (departure
P9), so ``temperature > 0`` is held to the reference test's properties
(``tests/test_system.py::test_generate_serving``): tokens in range, equal
for equal seeds, unlike greedy.  The dense attention family: greedy
tokens equal the reference's token for token on smollm-360m (the
reference's own ``test_generate_serving`` model), gemma2-2b, and gemma2-2b
with a window of 8 on every layer, which binds in the prefill and in
every decode step.  The MoE and MLA family and the hybrid (granite-moe-3b,
deepseek-v2-236b, jamba-v0.1-52b, reduced) likewise.  The card is in
``tests/test_torch_cuda.py``.
"""

import dataclasses


import numpy as np
import pytest
import torch

import jax

from repro.models import registry as jax_registry
from repro.models.config import LayerSpec as JaxLayerSpec
from repro.models import transformer as JT
from repro.serve.generate import Generator as JaxGenerator

from repro_torch.models import registry
from repro_torch.models.config import LayerSpec
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import Generator

CPU = "cpu"
FALCON = "falcon-mamba-7b"


@pytest.fixture(scope="module")
def served():
    """(port config, reference config, reference params, port model)."""
    cfg = registry.get_config(FALCON, reduced=True)
    jcfg = jax_registry.get_config(FALCON, reduced=True)
    params = JT.init_params(jcfg, jax.random.PRNGKey(2))
    return cfg, jcfg, params, params_from_jax(
        cfg, jax.tree.map(np.asarray, params), device=CPU)


def _prompts(cfg, b=3, s=12, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_greedy_equals_reference(served):
    cfg, jcfg, params, model = served
    prompts = _prompts(cfg)
    got = Generator(cfg, model, max_len=48, device=CPU).generate(prompts, 8)
    want = JaxGenerator(jcfg, params, max_len=48).generate(prompts, 8)
    assert got.dtype == np.int32 and got.shape == (3, 8)
    np.testing.assert_array_equal(got, want)


def test_stop_token_stops_like_reference(served):
    """Rows that all emit the stop token at step 3 stop there, in both."""
    cfg, jcfg, params, model = served
    prompts = np.repeat(_prompts(cfg, b=1, seed=1), 2, axis=0)
    full = JaxGenerator(jcfg, params, max_len=48).generate(prompts, 8)
    stop = int(full[0, 3])
    got = Generator(cfg, model, max_len=48, device=CPU).generate(
        prompts, 8, stop_token=stop)
    want = JaxGenerator(jcfg, params, max_len=48).generate(
        prompts, 8, stop_token=stop)
    np.testing.assert_array_equal(got, want)
    # the decode steps' first emission of the stop token ends the run
    last = 1 + int(np.argmax(full[0, 1:] == stop))
    assert got.shape == (2, last + 1) and last < 7


def test_sampling_properties(served):
    """P9: tokens in range, equal for equal seeds, other than greedy."""
    cfg, _, _, model = served
    gen = Generator(cfg, model, max_len=48, device=CPU)
    prompts = _prompts(cfg)
    greedy = gen.generate(prompts, 8)
    np.testing.assert_array_equal(greedy, gen.generate(prompts, 8))
    sampled = gen.generate(prompts, 8, temperature=1.0, seed=1)
    assert sampled.shape == (3, 8)
    assert (sampled >= 0).all() and (sampled < cfg.vocab_size).all()
    np.testing.assert_array_equal(
        sampled, gen.generate(prompts, 8, temperature=1.0, seed=1))
    assert not np.array_equal(sampled, greedy)
    assert not np.array_equal(
        sampled, gen.generate(prompts, 8, temperature=1.0, seed=2))
    # the first token is the prefill's argmax at any temperature
    np.testing.assert_array_equal(sampled[:, 0], greedy[:, 0])


def test_padded_vocabulary_is_never_sampled():
    cfg = registry.get_config(FALCON, reduced=True, vocab_size=251)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(0),
                          device=CPU)
    out = Generator(cfg, model, max_len=64, device=CPU).generate(
        _prompts(cfg, b=4, s=8), 32, temperature=5.0, seed=3)
    assert (out < 251).all() and (out >= 0).all()


def test_max_len_is_enforced(served):
    cfg, _, _, model = served
    gen = Generator(cfg, model, max_len=16, device=CPU)
    with pytest.raises(ValueError, match="max_len"):
        gen.generate(_prompts(cfg, s=12), 5)
    assert gen.generate(_prompts(cfg, s=12), 4).shape == (3, 4)


def test_default_device_raises_without_cuda(served):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg, _, _, model = served
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Generator(cfg, model)


def _local(cfg, spec_type, window):
    return dataclasses.replace(cfg, pattern=tuple(
        spec_type(mixer="attn", mlp="dense", sliding_window=window)
        for _ in cfg.pattern))


@pytest.mark.parametrize("arch,window", [("smollm-360m", 0),
                                         ("gemma2-2b", 0),
                                         ("gemma2-2b", 8)])
def test_dense_greedy_equals_reference(arch, window):
    """3 prompts of 20 tokens, 10 greedy steps: the KV cache grows to 29
    entries, past a window of 8 from the prefill on."""
    cfg = registry.get_config(arch, reduced=True)
    jcfg = jax_registry.get_config(arch, reduced=True)
    if window:
        cfg, jcfg = _local(cfg, LayerSpec, window), _local(
            jcfg, JaxLayerSpec, window)
    params = JT.init_params(jcfg, jax.random.PRNGKey(3))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                            device=CPU)
    prompts = _prompts(cfg, s=20, seed=window + 1)
    got = Generator(cfg, model, max_len=32, device=CPU).generate(prompts, 10)
    want = JaxGenerator(jcfg, params, max_len=32).generate(prompts, 10)
    assert got.shape == (3, 10)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b",
                                  "jamba-v0.1-52b"])
def test_moe_greedy_equals_reference(arch):
    """The MoE / MLA family and the hybrid: 2 prompts of 16 tokens, 8
    greedy steps, token for token (deepseek's decode steps run the
    absorbed form over the latent cache; jamba's its Mamba, attention and
    MoE layers)."""
    cfg = registry.get_config(arch, reduced=True)
    jcfg = jax_registry.get_config(arch, reduced=True)
    params = JT.init_params(jcfg, jax.random.PRNGKey(5))
    model = params_from_jax(cfg, jax.tree.map(np.asarray, params),
                            device=CPU)
    prompts = _prompts(cfg, b=2, s=16, seed=5)
    got = Generator(cfg, model, max_len=24, device=CPU).generate(prompts, 8)
    want = JaxGenerator(jcfg, params, max_len=24).generate(prompts, 8)
    assert got.shape == (2, 8)
    np.testing.assert_array_equal(got, want)
