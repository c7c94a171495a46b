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
within rtol / atol 1e-4 in float32.  Over the ``model`` axis, at 2 and 4
positions and on a (2, 2) mesh, against the reference's ``shard_map`` on
4 host devices in a child process, within 1e-4 of max |out|.  The tie rule: with the router zeroed
the reference picks experts ``0 .. k-1`` for every token, and so does the
port.  Every draw comes from a ``default_rng`` of the test's own.
"""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models import moe as jax_moe
from repro.models import registry as jax_registry

from repro_torch.launch import make_host_mesh
from repro_torch.models import moe
from repro_torch.models import registry
from repro_torch.models import transformer as T

ROOT = Path(__file__).resolve().parents[1]
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


# --- the MoE over the ``model`` axis ----------------------------------------

_JAX_MESH = """
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.models import registry
from repro.models import transformer as JT

d = dict(np.load(IN))
jcfg = registry.get_config("granite-moe-3b-a800m", reduced=True)
jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                         **MOE_OVER))
w = {k[2:]: jnp.asarray(v) for k, v in d.items() if k.startswith("w/")}
out = {}
for name, (dp, tp, b) in MESH_CASES.items():
    devs = np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp)
    mesh = Mesh(devs, ("data", "model"))
    out[name] = np.asarray(JT._moe_call(jcfg, w, jnp.asarray(d["x/" + name]),
                                        mesh))
np.savez(OUT, **out)
print("ok")
"""

# shared experts (their "tp" split) and a capacity that drops pairs
MESH_MOE = dict(n_shared=1, capacity_factor=1.25, renorm=False)
# name: (data positions, model positions, batch)
MESH_CASES = {"tp2": (1, 2, 2), "tp4": (1, 4, 2), "dp2-tp2": (2, 2, 4),
              "dp2-tp2-replicated": (2, 2, 3)}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The reference's ``_moe_call`` (its ``shard_map`` over ``model``) on
    4 host devices in a child process, whose environment alone forces
    them; returns (port config, layer, inputs, the reference's outputs)."""
    tmp = tmp_path_factory.mktemp("moe_mesh")
    cfg, _ = _configs(**MESH_MOE)
    rng = np.random.default_rng(31)
    w = _weights(cfg, rng)
    xs = {name: rng.normal(size=(b, 12, cfg.d_model)).astype(np.float32)
          for name, (_, _, b) in MESH_CASES.items()}
    np.savez(tmp / "in.npz", **{"w/" + k: v for k, v in w.items()},
             **{"x/" + k: v for k, v in xs.items()})
    code = (f"IN = {str(tmp / 'in.npz')!r}\nOUT = {str(tmp / 'out.npz')!r}\n"
            f"MOE_OVER = {MESH_MOE!r}\nMESH_CASES = {MESH_CASES!r}\n"
            + _JAX_MESH)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return cfg, _layer(cfg, w), xs, dict(np.load(tmp / "out.npz"))


def _within(got, want):
    err = np.abs(got - want).max()
    assert err <= 1e-4 * np.abs(want).max(), err


@pytest.mark.parametrize("name", ["tp2", "tp4"])
def test_moe_apply_local_over_model_equals_reference_shard_map(mesh_run,
                                                               name):
    """Each position's experts and its ``fs / tp`` slice of the shared
    experts, summed over the positions: within 1e-4 of max |out| of the
    reference's ``shard_map`` on a (1, tp) mesh."""
    cfg, layer, xs, want = mesh_run
    tp = MESH_CASES[name][1]
    got = moe.moe_apply_local(cfg, layer, torch.from_numpy(xs[name]),
                              axis="model", devices=[CPU] * tp)
    _within(got.numpy(), want[name])


@pytest.mark.parametrize("name", ["dp2-tp2", "dp2-tp2-replicated"])
def test_moe_call_on_a_two_by_two_mesh_equals_reference(mesh_run, name):
    """``_moe_call`` over a (2, 2) mesh: the batch of 4 splits into two
    data shards, each routing its own tokens with its own capacity; the
    batch of 3 does not divide, so it is replicated, as in the
    reference."""
    cfg, layer, xs, want = mesh_run
    got = T._moe_call(cfg, layer, torch.from_numpy(xs[name]),
                      make_host_mesh(2, 2, device=CPU))
    _within(got.numpy(), want[name])
    if name == "dp2-tp2":  # the shards' capacity differs from one batch's
        whole = moe.moe_ref(cfg, layer, torch.from_numpy(xs[name]))
        assert not np.allclose(whole.numpy(), want[name], rtol=1e-4,
                               atol=1e-4)


def test_one_model_position_equals_no_mesh_bitwise():
    cfg, _ = _configs(**MESH_MOE)
    layer = _layer(cfg, _weights(cfg, np.random.default_rng(32)))
    x = torch.from_numpy(np.random.default_rng(33).normal(
        size=(2, 10, cfg.d_model)).astype(np.float32))
    assert torch.equal(moe.moe_apply_local(cfg, layer, x, axis="model",
                                           devices=[CPU]),
                       moe.moe_ref(cfg, layer, x))


def test_model_axis_must_divide_experts_and_shared_width():
    cfg, _ = _configs(**MESH_MOE)
    layer = _layer(cfg, _weights(cfg, np.random.default_rng(34)))
    x = torch.zeros(1, 2, cfg.d_model)
    with pytest.raises(ValueError, match="does not divide"):
        moe.moe_apply_local(cfg, layer, x, axis="model", devices=[CPU] * 3)
    wide = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=16, d_expert=30))
    with pytest.raises(ValueError, match="shared width 30"):
        moe.moe_apply_local(wide, moe.MoE(wide, device=CPU), x,
                            axis="model", devices=[CPU] * 4)


def test_the_stack_runs_each_moe_module_with_its_mesh():
    """``_apply_layer`` calls the layer's :class:`MoE` module with the
    mesh, so that its forward hooks see each MoE layer's input and its own
    ``cfg`` (which a caller may swap, as the card's capacity checks do)
    sets the routing; the output equals ``_moe_call``'s."""
    cfg = registry.get_config("granite-moe-3b-a800m", reduced=True)
    model = T.init_params(cfg, generator=torch.Generator().manual_seed(35),
                          device=CPU)
    tokens = torch.from_numpy(np.random.default_rng(36).integers(
        0, cfg.vocab_size, (2, 8)))
    mesh = make_host_mesh(1, 2, device=CPU)
    seen = []
    mods = [m for m in model.modules() if isinstance(m, moe.MoE)]
    hooks = [m.register_forward_hook(
        lambda mod, args, kw, out: seen.append(
            (kw.get("mesh"), out, T._moe_call(mod.cfg, mod, args[0],
                                              kw.get("mesh")))),
        with_kwargs=True) for m in mods]
    try:
        T.forward(cfg, model, tokens, mesh=mesh)
    finally:
        for h in hooks:
            h.remove()
    assert len(seen) == len(mods) == cfg.n_layers
    for me, out, want in seen:
        assert me is mesh and torch.equal(out, want)
