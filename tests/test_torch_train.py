"""Training in the port (``repro_torch.train``, ``repro_torch.launch.train``)
against the JAX reference (``repro.train``), on the CPU.

``lm_token_stream`` bitwise; ``lr_at`` over a schedule; ``adamw_update`` on
the same numpy tree within 1e-6 relative, its decay by the reference's
stacked rank pinned (a block's ``ln1`` decays, ``final_norm`` does not);
three train steps' losses against the reference's ``make_train_step``
within 1e-4 relative, and microbatches 4 against 1 at the reference's own
tolerances; checkpoint files in both directions bitwise, retention, and
engine states; ``ef_allreduce`` bitwise and one compressed step against the
reference's 2-device ``shard_map`` (a child process whose environment alone
forces two host devices); the launcher's 6 steps straight against 3, a stop
and a resume, the last loss bitwise.  Every draw comes from a
``default_rng`` of the test's own.
"""

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.anticluster import ABAState as JaxABAState
from repro.data.synthetic import lm_token_stream as jax_lm_token_stream
from repro.models import registry as jax_registry
from repro.models import transformer as JT
from repro.train import checkpoint as jax_ckpt
from repro.train import optimizer as jax_opt
from repro.train.train_step import make_train_step as jax_make_train_step

from repro_torch.anticluster import AnticlusterEngine
from repro_torch.data.synthetic import lm_token_stream
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import main as train_main
from repro_torch.models import registry
from repro_torch.models import transformer as T
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.models.transformer import flatten_defs, model_defs
from repro_torch.train import checkpoint as ckpt
from repro_torch.train import optimizer as opt
from repro_torch.train.compression import (ef_allreduce, init_error_state,
                                           make_compressed_dp_train_step)
from repro_torch.train.train_step import (make_prefill_step, make_serve_step,
                                          make_train_step)

ROOT = Path(__file__).resolve().parents[1]
ARCH = "smollm-360m"


def _configs(arch=ARCH):
    return [reg.get_config(arch, reduced=True)
            for reg in (registry, jax_registry)]


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for path, a in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = a
    return tree


def _numpy_params(cfg, rng) -> dict:
    """Float32 draws at ``model_defs``' shapes: weights N(0, 1 / fan_in),
    every other leaf 0.02 N(0, 1)."""
    return _nest({path: (rng.normal(size=pd.shape) / math.sqrt(pd.fan_in)
                         if pd.fan_in else 0.02 * rng.normal(size=pd.shape)
                         ).astype(np.float32)
                  for path, pd in flatten_defs(model_defs(cfg)).items()})


def _stacked(model) -> dict:
    return params_to_numpy(model)


def _rel(got, want):
    want = np.asarray(want, np.float64)
    return np.abs(np.asarray(got, np.float64) - want).max() / max(
        np.abs(want).max(), 1e-30)


def test_lm_token_stream_is_bitwise_the_reference():
    for args in ((64, 33, 256, 3), (10, 7, 1000, 0, 4)):
        got, want = lm_token_stream(*args), jax_lm_token_stream(*args)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_lr_at_equals_reference():
    cfg = opt.OptConfig(lr=3e-3, warmup_steps=7, decay_steps=40)
    jcfg = jax_opt.OptConfig(**cfg._asdict())
    steps = np.arange(50)
    got = opt.lr_at(cfg, torch.from_numpy(steps)).numpy()
    want = np.asarray(jax_opt.lr_at(jcfg, jnp.asarray(steps)))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert float(opt.lr_at(cfg, 3)) == pytest.approx(float(want[3]), rel=1e-6)


def _random_opt_state(cfg, rng, step):
    shapes = {p: pd.shape for p, pd in flatten_defs(model_defs(cfg)).items()}
    return {"m": _nest({p: (0.01 * rng.normal(size=s)).astype(np.float32)
                        for p, s in shapes.items()}),
            "v": _nest({p: (1e-4 * rng.random(s)).astype(np.float32)
                        for p, s in shapes.items()}),
            "step": np.int32(step)}


def _port_opt_state(state):
    return {"m": {k: torch.from_numpy(v) for k, v in
                  flatten_defs(state["m"]).items()},
            "v": {k: torch.from_numpy(v) for k, v in
                  flatten_defs(state["v"]).items()},
            "step": torch.tensor(state["step"], dtype=torch.int32)}


def _port_grads(model, flat_grads):
    return {(path, b): torch.from_numpy(np.ascontiguousarray(
        flat_grads[path] if b is None else flat_grads[path][b]))
        for path, b, _ in model.leaves()}


@pytest.mark.parametrize("clip", [1.0, 0.0])
def test_adamw_update_equals_reference(clip):
    cfg, jcfg = _configs()
    rng = np.random.default_rng(11)
    params = _numpy_params(cfg, rng)
    grads = _nest({p: rng.normal(size=a.shape).astype(np.float32)
                   for p, a in flatten_defs(params).items()})
    state = _random_opt_state(cfg, rng, 5)
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=3, decay_steps=20,
                         grad_clip=clip)
    jp, js, jm = jax_opt.adamw_update(
        jax_opt.OptConfig(**ocfg._asdict()), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state), jax.tree.map(jnp.asarray, params))
    model = params_from_jax(cfg, params, device="cpu")
    pstate = _port_opt_state(state)
    model, pstate, pm = opt.adamw_update(
        ocfg, _port_grads(model, flatten_defs(grads)), pstate, model)
    jflat = flatten_defs(jax.tree.map(np.asarray, jp))
    for path, a in _stacked(model).items():
        assert _rel(a, jflat[path]) <= 1e-6, path
    for name in ("m", "v"):
        jf = flatten_defs(jax.tree.map(np.asarray, js[name]))
        for path, a in pstate[name].items():
            assert _rel(a.numpy(), jf[path]) <= 1e-6, (name, path)
    assert int(pstate["step"]) == int(js["step"]) == 6
    assert pstate["step"].dtype == torch.int32
    for k in ("lr", "grad_norm"):
        assert float(pm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


def test_weight_decay_follows_the_stacked_rank():
    """Zero gradients and moments: only the decay moves a parameter.  A
    block's 1-D ``ln1`` (stacked (n_blocks, D)) decays, as every block
    leaf does; the top-level 1-D ``final_norm`` does not; the reference
    agrees."""
    cfg, jcfg = _configs()
    rng = np.random.default_rng(12)
    params = _numpy_params(cfg, rng)
    zeros = jax.tree.map(np.zeros_like, params)
    ocfg = opt.OptConfig(lr=1e-2, warmup_steps=0, decay_steps=10)
    jp, _, _ = jax_opt.adamw_update(
        jax_opt.OptConfig(**ocfg._asdict()), jax.tree.map(jnp.asarray, zeros),
        jax_opt.adamw_init(jax.tree.map(jnp.asarray, params)),
        jax.tree.map(jnp.asarray, params))
    model = params_from_jax(cfg, params, device="cpu")
    model, _, _ = opt.adamw_update(
        ocfg, _port_grads(model, flatten_defs(zeros)), opt.adamw_init(model),
        model)
    got, jflat = _stacked(model), flatten_defs(jax.tree.map(np.asarray, jp))
    flat = flatten_defs(params)
    for path in ("blocks/L0/ln1", "blocks/L0/ln2", "final_norm"):
        decays = path != "final_norm"
        assert np.array_equal(got[path], flat[path]) != decays, path
        assert np.array_equal(jflat[path], flat[path]) != decays, path
        np.testing.assert_allclose(got[path], jflat[path], rtol=1e-6)
    assert model.blocks[0]["L0"].ln1.ndim == 1  # the port's own rank is 1


def _batches(cfg, rng, n, b=4, s=17):
    return [rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
            for _ in range(n)]


def test_three_train_steps_equal_reference():
    cfg, jcfg = _configs()
    rng = np.random.default_rng(13)
    params = _numpy_params(cfg, rng)
    batches = _batches(cfg, rng, 3)
    ocfg = opt.OptConfig(lr=3e-3, warmup_steps=1, decay_steps=10)
    jstep = jax.jit(jax_make_train_step(
        jcfg, None, jax_opt.OptConfig(**ocfg._asdict()), loss_chunk=8))
    jp = jax.tree.map(jnp.asarray, params)
    js = jax_opt.adamw_init(jp)
    step = make_train_step(cfg, None, ocfg, loss_chunk=8)
    model = params_from_jax(cfg, params, device="cpu")
    state = opt.adamw_init(model)
    for tokens in batches:
        jp, js, jm = jstep(jp, js, {"tokens": jnp.asarray(tokens)})
        model, state, m = step(model, state,
                               {"tokens": torch.from_numpy(tokens).long()})
        assert abs(float(m["loss"]) - float(jm["loss"])) <= 1e-4 * abs(
            float(jm["loss"]))
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4)
    assert all(p.grad is None for p in model.parameters())
    jflat = flatten_defs(jax.tree.map(np.asarray, jp))
    for path, a in _stacked(model).items():
        assert _rel(a, jflat[path]) <= 1e-3, path


def test_microbatches_four_against_one():
    """The reference's own check (tests/test_train.py): one step with 4
    microbatches against 1, the loss within 1e-2 and every parameter
    within rtol 2e-2 / atol 2e-3."""
    cfg, _ = _configs()
    rng = np.random.default_rng(14)
    params = _numpy_params(cfg, rng)
    tokens = torch.from_numpy(_batches(cfg, rng, 1, b=8, s=32)[0]).long()
    ocfg = opt.OptConfig(lr=1e-3, warmup_steps=0, decay_steps=10,
                         grad_clip=0.0)
    out = []
    for mb in (1, 4):
        model = params_from_jax(cfg, params, device="cpu")
        model, _, m = make_train_step(cfg, None, ocfg, microbatches=mb,
                                      loss_chunk=8)(
            model, opt.adamw_init(model), {"tokens": tokens})
        out.append((float(m["loss"]), _stacked(model)))
    assert abs(out[0][0] - out[1][0]) < 1e-2
    for path, a in out[0][1].items():
        np.testing.assert_allclose(a, out[1][1][path], rtol=2e-2, atol=2e-3)
    with pytest.raises(ValueError):
        make_train_step(cfg, None, ocfg, microbatches=3)(
            model, opt.adamw_init(model), {"tokens": tokens})


def test_serve_and_prefill_steps_wrap_the_stack():
    cfg, _ = _configs()
    model = params_from_jax(cfg, _numpy_params(cfg, np.random.default_rng(
        15)), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(16).integers(
        0, cfg.vocab_size, (2, 9)))
    logits, cache = make_prefill_step(cfg, None, 12)(model, tokens)
    want, want_cache = T.prefill(cfg, model, tokens, 12)
    assert torch.equal(logits, want)
    nxt, step_logits, _ = make_serve_step(cfg, None)(model, cache, 9,
                                                     logits.argmax(-1))
    want_logits, _ = T.decode_step(cfg, model, want_cache, 9,
                                   want.argmax(-1))
    assert torch.equal(step_logits, want_logits)
    assert nxt.dtype == torch.int32 and torch.equal(
        nxt[:, 0], want_logits[:, -1].argmax(-1).int())
    # a dense config: a mesh reaches only the MoE, so the steps through a
    # (1, 2) mesh are bitwise the steps without one
    mesh = make_host_mesh(1, 2, device="cpu")
    got, got_cache = make_prefill_step(cfg, mesh, 12)(model, tokens)
    assert torch.equal(got, logits)
    assert torch.equal(make_serve_step(cfg, mesh)(
        model, got_cache, 9, logits.argmax(-1))[1], step_logits)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _ckpt_tree(cfg, rng):
    return {"params": _numpy_params(cfg, rng),
            "opt": _random_opt_state(cfg, rng, 3)}


def _port_tree(cfg, tree):
    return {"params": params_from_jax(cfg, tree["params"], device="cpu"),
            "opt": _port_opt_state(tree["opt"])}


def _assert_port_tree_equals(port, tree):
    assert all(np.array_equal(a, flatten_defs(tree["params"])[p])
               for p, a in _stacked(port["params"]).items())
    for name in ("m", "v"):
        for p, a in flatten_defs(tree["opt"][name]).items():
            assert np.array_equal(port["opt"][name][p].numpy(), a)
    assert port["opt"]["step"].dtype == torch.int32
    assert int(port["opt"]["step"]) == int(tree["opt"]["step"])


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    cfg, _ = _configs()
    rng = np.random.default_rng(17)
    tree = _ckpt_tree(cfg, rng)
    jax_ckpt.save(str(tmp_path), 3, jax.tree.map(jnp.asarray, tree))
    like = _port_tree(cfg, _ckpt_tree(cfg, rng))
    restored, step = ckpt.restore(str(tmp_path), like)
    assert step == 3
    _assert_port_tree_equals(restored, tree)
    assert restored["params"] is not like["params"]


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    cfg, _ = _configs()
    rng = np.random.default_rng(18)
    tree = _ckpt_tree(cfg, rng)
    path = ckpt.save(str(tmp_path), 7, _port_tree(cfg, tree))
    assert path.endswith("step_0000000007")
    like = jax.tree.map(jnp.asarray, _ckpt_tree(cfg, rng))
    restored, step = jax_ckpt.restore(str(tmp_path), like)
    assert step == 7
    for got, want in zip(jax.tree.leaves(restored), jax.tree.leaves(tree)):
        got = np.asarray(got)
        assert got.dtype == np.asarray(want).dtype
        assert np.array_equal(got, want)
    # the manifest is the reference's, key for key
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    ref_dir = tmp_path / "ref"
    ref_path = jax_ckpt.save(str(ref_dir), 7, jax.tree.map(jnp.asarray, tree))
    with open(os.path.join(ref_path, "manifest.json")) as f:
        assert json.load(f) == manifest


def test_retention_latest_and_devices(tmp_path):
    x = {"w": torch.arange(6.0).reshape(2, 3), "b": (torch.ones(2),
                                                    torch.zeros(1))}
    for s in range(1, 6):
        ckpt.save(str(tmp_path), s, {"w": x["w"] * s, "b": x["b"]}, keep=2)
    assert sorted(ckpt.latest_steps(str(tmp_path))) == [4, 5]
    assert ckpt.restore(str(tmp_path / "none"), x) == (None, -1)
    got, step = ckpt.restore(str(tmp_path), x, step=4)
    assert step == 4 and torch.equal(got["w"], x["w"] * 4)
    assert isinstance(got["b"], tuple) and torch.equal(got["b"][0], x["b"][0])
    cpu = torch.device("cpu")
    got, step = ckpt.restore(str(tmp_path), x, shardings={"w": cpu,
                                                          "b": (cpu, cpu)})
    assert step == 5 and got["w"].device == cpu
    with pytest.raises(ValueError):
        ckpt.restore(str(tmp_path), {"w": torch.zeros(3, 2), "b": x["b"]})


def test_engine_state_round_trips_and_crosses_packages(tmp_path):
    x = np.random.default_rng(19).normal(size=(96, 3)).astype(np.float32)
    eng = AnticlusterEngine(k=8, device="cpu")
    _, state = eng.partition(x)
    ckpt.save_engine_state(str(tmp_path / "port"), 2, state)
    back, step = ckpt.restore_engine_state(str(tmp_path / "port"), eng, x)
    assert step == 2 and type(back) is type(state)
    for f in ("moment_sum", "moment_count", "prev_labels"):
        assert torch.equal(getattr(back, f), getattr(state, f))
    assert all(torch.equal(a, b) for a, b in zip(back.prices, state.prices))
    # the reference's writer, the port's reader, and back
    rng = np.random.default_rng(20)
    arrays = {f: rng.normal(size=getattr(state, f).shape).astype(np.float32)
              for f in ("moment_sum", "moment_count")}
    jstate = JaxABAState(
        prices=tuple(jnp.asarray(rng.normal(size=p.shape).astype(np.float32))
                     for p in state.prices),
        moment_sum=jnp.asarray(arrays["moment_sum"]),
        moment_count=jnp.asarray(arrays["moment_count"]),
        prev_labels=jnp.asarray(rng.integers(0, 8, 96).astype(np.int32)))
    jax_ckpt.save_engine_state(str(tmp_path / "ref"), 4, jstate)
    got, step = ckpt.restore_engine_state(str(tmp_path / "ref"), eng, x)
    assert step == 4
    assert np.array_equal(got.prev_labels.numpy(),
                          np.asarray(jstate.prev_labels))
    assert np.array_equal(got.prices[0].numpy(), np.asarray(jstate.prices[0]))
    ckpt.save_engine_state(str(tmp_path / "port2"), 5, got)
    again, _ = jax_ckpt.restore(str(tmp_path / "port2"), jstate)
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(jstate)):
        assert np.array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# int8 gradient compression
# ---------------------------------------------------------------------------

_JAX_TWO_DEVICES = """
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.compat import shard_map
from repro.models.registry import get_config
from repro.train.compression import (ef_allreduce, init_error_state,
                                     make_compressed_dp_train_step)
from repro.train.optimizer import OptConfig, adamw_init

inp = dict(np.load(IN))
mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
tree = {k[2:]: v for k, v in inp.items() if k.startswith("g/")}
errs = {k[2:]: v for k, v in inp.items() if k.startswith("e/")}

def local(g, e):
    g = {k: v[0] for k, v in g.items()}
    e = {k: v[0] for k, v in e.items()}
    out, err = ef_allreduce(g, e, ("data",))
    return ({k: v[None] for k, v in out.items()},
            {k: v[None] for k, v in err.items()})

f = shard_map(local, mesh=mesh, in_specs=(P("data"), P("data")),
              out_specs=(P("data"), P("data")), check_vma=False)
out, err = f(jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, errs))
res = {}
for k in tree:
    res["mean/" + k] = np.asarray(out[k])
    res["err/" + k] = np.asarray(err[k])

cfg = get_config("smollm-360m", reduced=True)
params = {}
for k, v in inp.items():
    if k.startswith("p/"):
        node = params
        *parents, leaf = k[2:].split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(v)
ocfg = OptConfig(lr=3e-3, warmup_steps=1, decay_steps=10)
step = jax.jit(make_compressed_dp_train_step(
    make_cfg := cfg, Mesh(np.asarray(jax.devices()[:2]).reshape(2, 1),
                          ("data", "model")), ocfg, loss_chunk=8))
state, e = adamw_init(params), init_error_state(params)
p2, _, e2, m = step(params, state, e, {"tokens": jnp.asarray(inp["tokens"])})
res["loss"] = np.asarray(m["loss"])
res["grad_norm"] = np.asarray(m["grad_norm"])
for path, leaf in jax.tree_util.tree_flatten_with_path(p2)[0]:
    res["p2/" + "/".join(str(q.key) for q in path)] = np.asarray(leaf)
for path, leaf in jax.tree_util.tree_flatten_with_path(e2)[0]:
    key = "/".join(str(q.key) for q in path)
    for s, shard in enumerate(leaf.addressable_shards):
        res[f"e2/{s}/{key}"] = np.asarray(shard.data)
np.savez(OUT, **res)
print("ok")
"""


def test_ef_allreduce_and_a_compressed_step_equal_jax_two_devices(tmp_path):
    """``ef_allreduce`` on the same per-shard gradients and errors (a
    stacked block leaf whose flattened size does not divide by 2, and a
    top-level leaf): the mean and each shard's error bitwise the
    reference's.  Then one compressed step of the reduced smollm-360m over
    2 data shards: the loss within 1e-5, the parameters within 1e-4 of
    each leaf's max, each shard's error state within one quantization
    step (the gradients themselves differ in the last bits)."""
    rng = np.random.default_rng(21)
    cfg, _ = _configs()
    params = _numpy_params(cfg, rng)
    tokens = _batches(cfg, rng, 1, b=4, s=17)[0]
    leaves = {"blocks/w": (2, 3, 7), "top": (5,)}
    g = {k: rng.normal(size=(2,) + s).astype(np.float32)
         for k, s in leaves.items()}
    e = {k: 0.01 * rng.normal(size=(2,) + s).astype(np.float32)
         for k, s in leaves.items()}
    inp = {**{"g/" + k: v for k, v in g.items()},
           **{"e/" + k: v for k, v in e.items()},
           **{"p/" + k: v for k, v in flatten_defs(params).items()},
           "tokens": tokens}
    np.savez(tmp_path / "in.npz", **inp)
    code = (f"IN = {str(tmp_path / 'in.npz')!r}\n"
            f"OUT = {str(tmp_path / 'out.npz')!r}\n"
            + textwrap.dedent(_JAX_TWO_DEVICES))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = dict(np.load(tmp_path / "out.npz"))

    def keyed(arrs, s):  # one shard's tree, keyed as grads_of
        out = {}
        for k, v in arrs.items():
            if k.startswith("blocks/"):
                out.update({(k, b): torch.from_numpy(v[s][b].copy())
                            for b in range(v.shape[1])})
            else:
                out[(k, None)] = torch.from_numpy(v[s].copy())
        return out

    means, errs = ef_allreduce([keyed(g, s) for s in range(2)],
                               [keyed(e, s) for s in range(2)])
    for s in range(2):
        for (k, b), t in means[s].items():
            want = ref["mean/" + k][s] if b is None else ref["mean/" + k][s][b]
            assert np.array_equal(t.numpy(), want), ("mean", s, k, b)
        for (k, b), t in errs[s].items():
            want = ref["err/" + k][s] if b is None else ref["err/" + k][s][b]
            assert np.array_equal(t.numpy(), want), ("err", s, k, b)

    model = params_from_jax(cfg, params, device="cpu")
    step = make_compressed_dp_train_step(
        cfg, make_host_mesh(2, 1, device="cpu"),
        opt.OptConfig(lr=3e-3, warmup_steps=1, decay_steps=10), loss_chunk=8)
    model, _, err, m = step(model, opt.adamw_init(model),
                            init_error_state(model),
                            {"tokens": torch.from_numpy(tokens).long()})
    assert float(m["loss"]) == pytest.approx(float(ref["loss"]), rel=1e-5)
    for path, a in _stacked(model).items():
        assert _rel(a, ref["p2/" + path]) <= 1e-4, path
    assert len(err) == 2
    for s in range(2):
        for (path, b), t in err[s].items():
            want = ref[f"e2/{s}/{path}"]
            want = want if b is None else want[b]
            step_size = np.abs(ref[f"e2/{s}/{path}"]).max() * 2 + 1e-12
            assert np.abs(t.numpy() - want).max() <= step_size, (s, path, b)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_stop_and_resume_ends_on_the_same_loss(tmp_path, capsys):
    args = ["--arch", ARCH, "--reduced", "--steps", "6", "--batch", "8",
            "--seq", "24", "--n-docs", "192", "--aba-batching",
            "--device", "cpu", "--log-every", "100"]
    straight = train_main(args + ["--ckpt-dir", str(tmp_path / "a")])
    first = train_main(args + ["--ckpt-dir", str(tmp_path / "b"),
                               "--stop-after", "3"])
    resumed = train_main(args + ["--ckpt-dir", str(tmp_path / "b")])
    out = capsys.readouterr().out
    assert "[preempt] stopped after step 2" in out
    assert "[restore] resumed from step 3" in out
    assert "[data] ABA batches: K=24" in out
    assert math.isfinite(first) and resumed == straight
    assert sorted(ckpt.latest_steps(str(tmp_path / "b"))) == [3, 6]
    compressed = train_main(args + ["--grad-compression", "--dp", "2",
                                    "--steps", "2"])
    assert math.isfinite(compressed)
