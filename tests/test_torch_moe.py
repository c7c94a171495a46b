"""The port's Mixture-of-Experts (``repro_torch.models.moe``) against the JAX
reference's (``repro.models.moe``) on the CPU.

``moe_defs``, ``padded_experts`` and ``_capacity`` equal the reference's
for granite-moe-3b, deepseek-v2-236b and jamba-v0.1-52b, full and reduced.
The routing equals the reference's: the experts the reference's
``lax.top_k`` chose (read from its own call) exactly, their probabilities
within rtol 1e-5 (renormed as the reference does; the float32 logits of
XLA's and torch's products differ by ulps, which exp scales by |logit|),
and the ranks, kept pairs and slots exactly, the latter
against a plain count over the reference's choices; with renorm on and
off, with and without a shared expert, with ``silu`` and ``gelu``, and
with ``capacity_factor=0.5``, where pairs are dropped.  The layer's output
within rtol / atol 1e-4 in float32.  The tie rule: with the router zeroed
the reference picks experts ``0 .. k-1`` for every token, and so does the
port.  Every draw comes from a ``default_rng`` of the test's own.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as jax_moe
from repro.models import registry as jax_registry

from repro_torch.models import moe
from repro_torch.models import registry

CPU = "cpu"
ARCHS = ("granite-moe-3b-a800m", "deepseek-v2-236b", "jamba-v0.1-52b")
TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(arch="granite-moe-3b-a800m", **moe_over):
    """The port's and the reference's config of ``arch``, reduced, with
    ``moe_over`` replacing fields of the MoE spec."""
    return [dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe_over))
            for c in (registry.get_config(arch, reduced=True),
                      jax_registry.get_config(arch, reduced=True))]


def _weights(cfg, rng, zero_router=False):
    out = {}
    for name, pd in moe.moe_defs(cfg).items():
        out[name] = (rng.normal(size=pd.shape) / math.sqrt(pd.fan_in)
                     ).astype(np.float32)
    if zero_router:
        out["router"][:] = 0.0
    else:  # logits of a few units, so that the choices are not close calls
        out["router"] *= 4.0
    return out


def _layer(cfg, w):
    layer = moe.MoE(cfg, device=CPU)
    with torch.no_grad():
        for name, a in w.items():
            getattr(layer, name).copy_(torch.from_numpy(a))
    return layer


def _reference(jcfg, w, x):
    """The reference's output and the (top_p, top_e) of its own
    ``lax.top_k`` call."""
    seen = []
    real = jax.lax.top_k

    def spy(operand, k):
        out = real(operand, k)
        seen.append(tuple(np.asarray(a) for a in out))
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.lax, "top_k", spy)
        out = jax_moe.moe_ref(jcfg, {k: jnp.asarray(v) for k, v in w.items()},
                              jnp.asarray(x))
    assert len(seen) == 1
    return np.asarray(out), seen[0]


def _ranks(top_e, e_pad):
    """Each (token, choice) pair's rank in its expert, token-major: the
    pairs before it that chose the same expert, counted one by one."""
    count = np.zeros(e_pad, np.int64)
    ranks = []
    for e in top_e.reshape(-1):
        ranks.append(count[e])
        count[e] += 1
    return np.asarray(ranks)


CASES = {
    "renorm-silu": dict(renorm=True),
    "no-renorm-shared-silu": dict(renorm=False, n_shared=1),
    "renorm-shared-gelu": dict(renorm=True, n_shared=1, act="gelu"),
    "no-renorm-gelu": dict(renorm=False, act="gelu"),
    "drops": dict(renorm=True, n_shared=1, capacity_factor=0.5),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    """One reference run a case: (case name, port config, routing, the
    port's output, the reference's output and (top_p, top_e))."""
    over = dict(CASES[request.param])
    act = over.pop("act", "silu")
    cfg, jcfg = (dataclasses.replace(c, mlp_act=act)
                 for c in _configs(**over))
    rng = np.random.default_rng(sorted(CASES).index(request.param))
    w = _weights(cfg, rng)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    layer = _layer(cfg, w)
    got = layer(torch.from_numpy(x))
    routing = moe.route(cfg, layer.router, torch.from_numpy(x).reshape(
        -1, cfg.d_model))
    want, top = _reference(jcfg, w, x)
    return request.param, cfg, routing, got, want, top


def test_routing_equals_reference(case):
    name, cfg, r, _, _, (top_p, top_e) = case
    e_pad = moe.padded_experts(cfg)
    np.testing.assert_array_equal(r.top_e.numpy(), top_e)
    if cfg.moe.renorm:  # the reference's, after its top_k call
        top_p = top_p / np.maximum(top_p.sum(-1, keepdims=True), 1e-9)
    np.testing.assert_allclose(r.top_p.numpy(), top_p, rtol=1e-5, atol=1e-7)
    ranks = _ranks(top_e, e_pad)
    cap = jax_moe._capacity(cfg, top_e.shape[0], e_pad)
    keep = ranks < cap
    assert r.cap == cap
    np.testing.assert_array_equal(r.ranks.numpy(), ranks)
    np.testing.assert_array_equal(r.keep.numpy(), keep)
    np.testing.assert_array_equal(
        r.slot.numpy(), np.where(keep, top_e.reshape(-1) * cap + ranks,
                                 e_pad * cap))
    # padded experts are never chosen; some pairs drop only where asked
    assert (top_e < cfg.moe.n_experts).all()
    assert keep.all() == (name != "drops")


def test_output_equals_reference(case):
    _, _, _, got, want, _ = case
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("n_experts,top_k", [(8, 2), (40, 8)])
def test_tie_rule_picks_the_lowest_experts_like_reference(n_experts, top_k):
    """The tie rule (``route``'s docstring): with the router zeroed every
    real expert has the same probability, and the lower index comes first
    in both: experts ``0 .. k-1`` for every token (granite's 40 experts,
    padded to 48, top 8, among them)."""
    cfg, jcfg = _configs(n_experts=n_experts, top_k=top_k)
    rng = np.random.default_rng(n_experts)
    w = _weights(cfg, rng, zero_router=True)
    x = rng.normal(size=(2, 8, cfg.d_model)).astype(np.float32)
    layer = _layer(cfg, w)
    r = moe.route(cfg, layer.router, torch.from_numpy(x).reshape(
        -1, cfg.d_model))
    want, (_, top_e) = _reference(jcfg, w, x)
    lowest = np.broadcast_to(np.arange(top_k), (16, top_k))
    np.testing.assert_array_equal(top_e, lowest)
    np.testing.assert_array_equal(r.top_e.numpy(), lowest)
    np.testing.assert_allclose(r.top_p.numpy(), 1.0 / top_k, rtol=1e-6)
    np.testing.assert_allclose(layer(torch.from_numpy(x)).numpy(), want,
                               **TOL)


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_defs_and_capacity_equal_reference(arch, reduced):
    cfg = registry.get_config(arch, reduced=reduced)
    jcfg = jax_registry.get_config(arch, reduced=reduced)
    got = {k: tuple(pd) for k, pd in moe.moe_defs(cfg).items()}
    want = {k: (tuple(pd.shape), tuple(pd.axes), pd.fan_in)
            for k, pd in jax_moe.moe_defs(jcfg).items()}
    assert got == want
    e_pad = moe.padded_experts(cfg)
    assert e_pad == jax_moe.padded_experts(jcfg) and e_pad % 16 == 0
    assert moe.EP_GRANULARITY == jax_moe.EP_GRANULARITY
    for t in (1, 7, 48, 4096, 4098):
        for e in (e_pad, 16, 160):
            assert moe._capacity(cfg, t, e) == jax_moe._capacity(jcfg, t, e)
    layer = moe.MoE(cfg, device="meta")
    assert {n: tuple(p.shape) for n, p in layer.named_parameters()} == {
        k: v[0] for k, v in got.items()}


def test_mesh_axis_is_not_ported_yet():
    cfg, _ = _configs()
    layer = _layer(cfg, _weights(cfg, np.random.default_rng(0)))
    with pytest.raises(NotImplementedError, match="Queue 1"):
        moe.moe_apply_local(cfg, layer, torch.zeros(1, 2, cfg.d_model),
                            axis="model")
