"""The port's launch layer against the JAX reference's on the CPU.

The abstract layer (``transformer.abstract_params``, ``param_pspecs``,
``abstract_cache``, ``cache_pspecs``, ``optimizer.opt_abstract``,
``opt_pspecs``, ``launch.inputs``) equals the reference's for all ten
configs, the four cells and both production meshes: the same leaf paths,
shapes, dtypes and partition tuples (the reference's shardings built over
a ``jax.sharding.AbstractMesh``); tokens, labels and positions are int32
in both.  ``_active_params``, ``model_flops`` and ``aba_model_flops``
equal the reference's.  The cost counter: exact FLOPs and bytes of a
matmul-only function, the Mamba scan's ``meta`` counts equal to its
bound's formulas, the ABA dispatchers raising on ``meta``.  The dry-run:
``run_cell`` ``ok`` for one cell of each kind and the ABA cell,
``skipped`` for a full-attention ``long_500k``, the departures of P11,
the CLI's cache of records.  ``make_train_step`` over a (1, 2) mesh
against ``mesh=None``.  Every draw comes from a ``default_rng`` of the
test's own.
"""

import copy
import dataclasses
import importlib
import json
import math
import os
import time

import numpy as np
import pytest
import torch

import jax
from jax.sharding import AbstractMesh

from repro.launch import inputs as JI
from repro.models import registry as JR
from repro.models import transformer as JT
from repro.train import optimizer as JO

from repro_torch.core.sharded import sharded_aba_lowerable
from repro_torch.kernels import ops
from repro_torch.launch import (cost, dryrun, inputs, make_host_mesh,
                                make_production_mesh)
from repro_torch.models import layers as L
from repro_torch.models import registry, transformer as T
from repro_torch.sharding import (LOGICAL, NamedSharding, to_pspec,
                                  tree_pspecs)
from repro_torch.train import (OptConfig, adamw_init, make_train_step,
                               opt_abstract, opt_pspecs)

CPU = "cpu"
ARCHS = tuple(registry.ALIASES)
MESHES = {False: ((16, 16), ("data", "model")),
          True: ((2, 16, 16), ("pod", "data", "model"))}


def _ref_dryrun():
    """The reference's dry-run module, imported without keeping the
    device count it sets for JAX in this process's environment."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module("repro.launch.dryrun")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def _flat(tree):
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in leaves}


def _same_shapes(got: dict, want: dict):
    """Port ShapeDtype records against the reference's ShapeDtypeStructs."""
    assert set(got) == set(want)
    for k, sd in got.items():
        assert sd.shape == want[k].shape, k
        assert str(sd.dtype).removeprefix("torch.") == str(want[k].dtype), k


def _same_specs(got: dict, want: dict):
    """Port partition tuples (or NamedSharding records) against the
    reference's PartitionSpecs (or NamedShardings)."""
    assert set(got) == set(want)
    for k, spec in got.items():
        spec = spec.spec if isinstance(spec, NamedSharding) else spec
        w = want[k].spec if hasattr(want[k], "spec") else want[k]
        assert spec == tuple(w), (k, spec, w)


@pytest.mark.parametrize("multi_pod", [False, True], ids=["16x16",
                                                         "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_layer_equals_reference(arch, multi_pod):
    cfg, jcfg = registry.get_config(arch), JR.get_config(arch)
    shape, axes = MESHES[multi_pod]
    jmesh = AbstractMesh(shape, axes)
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    assert mesh.axis_names == axes and tuple(mesh.devices.shape) == shape
    p_abs = T.abstract_params(cfg)
    _same_shapes(p_abs, _flat(JT.abstract_params(jcfg)))
    _same_specs(T.param_pspecs(cfg, axes), _flat(JT.param_pspecs(jcfg,
                                                                  axes)))
    _same_specs(inputs.param_shardings(cfg, mesh),
                _flat(JI.param_shardings(jcfg, jmesh)))
    j_opt = JO.opt_abstract(JT.abstract_params(jcfg))
    opt = opt_abstract(p_abs)
    for part in ("m", "v"):
        _same_shapes(opt[part], _flat(j_opt[part]))
    assert opt["step"].shape == () and opt["step"].dtype == torch.int32
    assert str(j_opt["step"].dtype) == "int32"
    specs = opt_pspecs(T.param_pspecs(cfg, axes))
    j_specs = JO.opt_pspecs(JT.param_pspecs(jcfg, axes))
    _same_specs(specs["m"], _flat(j_specs["m"]))
    assert specs["step"] == tuple(j_specs["step"]) == ()
    for name, cell in inputs.SHAPES.items():
        jcell = JI.SHAPES[name]
        assert tuple(cell) == tuple(jcell)
        assert inputs.cell_applicable(cfg, name) == JI.cell_applicable(
            jcfg, name)
        _same_shapes(inputs.batch_specs(cfg, cell),
                     JI.batch_specs(jcfg, jcell))
        _same_specs(inputs.batch_shardings(cfg, cell, mesh),
                    JI.batch_shardings(jcfg, jcell, jmesh))
        _same_shapes(inputs.abstract_cache(cfg, cell),
                     _flat(JI.abstract_cache(jcfg, jcell)))
        _same_specs(inputs.cache_shardings(cfg, cell, mesh),
                    _flat(JI.cache_shardings(jcfg, jcell, jmesh)))
        enc = cfg.enc_ctx if cfg.enc_layers else 0
        _same_specs(T.cache_pspecs(cfg, cell.batch, cell.seq, axes,
                                   enc_len=enc),
                    _flat(JT.cache_pspecs(jcfg, cell.batch, cell.seq, axes,
                                          enc_len=enc)))


def test_logical_rules_equal_reference():
    from repro.sharding import specs as JS
    assert LOGICAL == JS.LOGICAL
    for axes in MESHES.values():
        names = axes[1]
        for tags in (("fsdp", "tp"), ("dp", None, "sp"), (None,), ()):
            assert to_pspec(tags, names) == tuple(JS.to_pspec(tags, names))
        tree = {"a": ("fsdp", None), "b": {"c": ("tp",)}}
        got = tree_pspecs(tree, names)
        want = JS.tree_pspecs(tree, names)
        assert got["a"] == tuple(want["a"])
        assert got["b"]["c"] == tuple(want["b"]["c"])


@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_reference(arch):
    jd = _ref_dryrun()
    cfg, jcfg = registry.get_config(arch), JR.get_config(arch)
    p_abs, j_abs = T.abstract_params(cfg), JT.abstract_params(jcfg)
    assert dryrun._active_params(cfg, p_abs) == jd._active_params(jcfg,
                                                                  j_abs)
    for name, cell in inputs.SHAPES.items():
        assert dryrun.model_flops(cfg, cell, p_abs) == jd.model_flops(
            jcfg, JI.SHAPES[name], j_abs), name


@pytest.mark.parametrize("multi_pod", [False, True])
def test_aba_model_flops_equal_reference(multi_pod):
    jd = _ref_dryrun()
    shape, axes = MESHES[multi_pod]
    assert dryrun.ABA_CELLS == jd.ABA_CELLS
    spec = dryrun.ABA_CELLS["aba_1m"]
    assert dryrun.aba_model_flops(
        spec, make_production_mesh(multi_pod=multi_pod, device="meta")) == \
        jd.aba_model_flops(spec, AbstractMesh(shape, axes))


def test_production_mesh_without_device_needs_the_cards():
    with pytest.raises((RuntimeError, ValueError)):
        make_production_mesh()


def test_sharded_aba_lowerable_partitions_over_the_mesh():
    mesh = make_host_mesh(2, 1, device=CPU)
    fn, spec = sharded_aba_lowerable(mesh, 64, 3, 8, device=CPU)
    assert spec.shape == (64, 3) and spec.dtype == torch.float32
    x = np.random.default_rng(41).normal(size=spec.shape).astype(np.float32)
    labels = fn(torch.from_numpy(x)).numpy()
    assert np.bincount(labels, minlength=8).tolist() == [8] * 8
    assert set(labels[:32]) == set(range(4))  # shard 0's anticlusters


# --- the cost counter ---------------------------------------------------------

def test_counter_counts_a_matmul_function_exactly():
    """``mlp_apply`` of a small config on ``meta``: three products of
    2 m n k FLOPs each; the bytes each operation's inputs and outputs."""
    cfg = dataclasses.replace(registry.get_config("smollm-360m",
                                                  reduced=True),
                              compute_dtype="float32")
    mlp = L.MLP(cfg, device="meta")
    t, d, f = 6, cfg.d_model, cfg.d_ff
    x = torch.empty((1, t, d), device="meta")
    with cost.CostCounter() as c:
        L.mlp_apply(cfg, mlp, x)
    assert c.flops == 3 * 2 * t * d * f
    assert dict(c.flops_by_op) == {"aten.mm": 3 * 2 * t * d * f}
    with cost.CostCounter() as c:
        y = x * 2.0 + 1.0
    assert c.flops == 0 and c.bytes == 2 * 2 * 4 * t * d
    assert y.is_meta and c.unknown_trip_whiles == 0


def test_counter_agrees_with_torch_flop_counter_on_a_model():
    cfg = registry.get_config("granite-moe-3b-a800m", reduced=True)
    model = T.Model(cfg, device="meta")
    tokens = torch.zeros((2, 16), dtype=torch.int32, device="meta")
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), cost.CostCounter() as c:
        T.forward(cfg, model, tokens)
    with torch.no_grad(), FlopCounterMode(display=False) as f:
        T.forward(cfg, model, tokens)
    assert c.flops == f.get_total_flops() > 0


def test_ssm_scan_meta_counts_equal_the_bound_formulas():
    """The forward's and the backward's counts are those ``PERF.md`` §6
    bounds the kernels with; the outputs are empty, of the kernels'
    shapes and dtypes."""
    bsz, s, di, ds = 2, 40, 8, 4
    dt, x = (torch.empty((bsz, s, di), device="meta", requires_grad=True)
             for _ in range(2))
    b, c_ = (torch.empty((bsz, s, ds), device="meta", requires_grad=True)
             for _ in range(2))
    a = torch.empty((di, ds), device="meta", requires_grad=True)
    with cost.CostCounter() as c:
        with torch.no_grad():
            y, h = ops.ssm_scan(dt, b, c_, x, a)
        assert c.flops_by_op["ssm_scan"] == 7 * bsz * s * di * ds + bsz * s * di
        assert c.bytes == 4 * (3 * bsz * s * di + 2 * bsz * s * ds + di * ds
                               + bsz * di * ds)
        assert (y.shape, h.shape) == ((bsz, s, di), (bsz, di, ds))
        assert y.dtype == h.dtype == torch.float32 and y.is_meta
        c.bytes = 0
        y, h = ops.ssm_scan(dt, b, c_, x, a)  # the saving forward
        saved = 4 * bsz * math.ceil(s / 16) * di * ds
        assert c.bytes == 4 * (3 * bsz * s * di + 2 * bsz * s * ds + di * ds
                               + bsz * di * ds) + saved
        before = c.bytes
        torch.autograd.grad((y.sum(), h.sum()), (dt, b, c_, x, a))
    assert c.flops_by_op["ssm_scan_bwd"] == 20 * bsz * s * di * ds
    bwd = 4 * (5 * bsz * s * di + 4 * bsz * s * ds + bsz * math.ceil(s / 16)
               * di * ds + 2 * di * ds + 2 * bsz * di * ds)
    assert c.bytes - before >= bwd  # beside it, the sums' own passes


def test_aba_dispatchers_raise_on_meta():
    x = torch.empty((8, 3), device="meta")
    c = torch.empty((4, 3), device="meta")
    with pytest.raises(ValueError, match="tolist"):
        ops.cdist(x, c)
    with pytest.raises(ValueError, match="tolist"):
        ops.gather_rows(x, torch.zeros(2, dtype=torch.long, device="meta"))
    with pytest.raises(ValueError, match="tolist"):
        ops.bid_top2(x, c, torch.empty(4, device="meta"))
    assert ops.resolve_path(torch.zeros(1)) == "ref"
    assert ops.resolve_path(x) == "meta"


# --- the dry-run --------------------------------------------------------------

@pytest.mark.parametrize("arch,shape,multi_pod,over", [
    ("qwen2.5-14b", "decode_32k", False, None),
    ("falcon-mamba-7b", "long_500k", True, None),
    # the MoE over the production mesh's 16 data shards and 16 positions
    ("granite-moe-3b-a800m", "prefill_32k", False, {"n_layers": 2}),
])
def test_run_cell_counts_a_serving_cell(arch, shape, multi_pod, over):
    rec = dryrun.run_cell(arch, shape, multi_pod=multi_pod, overrides=over)
    assert rec["status"] == "ok", rec.get("error")
    devices = 512 if multi_pod else 256
    assert rec["devices"] == devices
    assert rec["flops_per_device"] * devices == rec["counted_flops_total"] > 0
    assert rec["bytes_per_device"] > 0
    # P11: no partitioner, no buffer assignment, no uncounted loop
    assert rec["collective_bytes_per_device"] == {}
    assert rec["memory"]["temp_bytes"] is None
    assert rec["unknown_trip_whiles"] == 0
    assert rec["terms"]["collective_s"] == 0.0
    assert rec["dominant"] in rec["terms"]
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["output_bytes"] > 0


def test_run_cell_counts_a_train_cell_and_the_ssm_kernels():
    """falcon-mamba-7b's train step, cut to 2 layers by ``overrides``:
    the forward, the recompute under remat and the backward of each
    Mamba layer's scan reach the counter."""
    rec = dryrun.run_cell("falcon-mamba-7b", "train_4k", multi_pod=False,
                          overrides={"n_layers": 2})
    assert rec["status"] == "ok", rec.get("error")
    assert rec["overrides"] == {"n_layers": "2"}
    cfg = registry.get_config("falcon-mamba-7b", n_layers=2)
    arg = rec["memory"]["argument_bytes"]
    # parameters, both moments (all sharded) and the batch, per device
    assert arg > 3 * 4 * T.n_params(cfg) / 256 * 0.9
    assert rec["model_flops_total"] == dryrun.model_flops(
        cfg, inputs.SHAPES["train_4k"], T.abstract_params(cfg))
    n = 256 * 4096 * cfg.d_inner * cfg.ssm.d_state
    # a layer's forward and its recompute, then its backward
    assert rec["flops_by_op"]["ssm_scan"] == 2 * 2 * (
        7 * n + 256 * 4096 * cfg.d_inner)
    assert rec["flops_by_op"]["ssm_scan_bwd"] == 2 * 20 * n


def test_run_cell_records_the_aba_cell_uncounted():
    rec = dryrun.run_cell("aba-pipeline", "aba_1m", multi_pod=False)
    assert rec["status"] == "ok" and rec["flops_per_device"] is None
    assert "tolist" in rec["reason"]
    assert rec["model_flops_total"] == 2.0 * (1 << 20) * 512 * 192
    assert rec["memory"]["argument_bytes"] == (1 << 20) * 192 * 4 // 16


def test_run_cell_skips_long_500k_for_full_attention():
    rec = dryrun.run_cell("smollm-360m", "long_500k", multi_pod=False)
    assert rec["status"] == "skipped" and "sub-quadratic" in rec["reason"]


def test_falcon_prefill_32k_counts_in_under_a_minute():
    t0 = time.perf_counter()
    rec = dryrun.run_cell("falcon-mamba-7b", "prefill_32k", multi_pod=False)
    assert rec["status"] == "ok", rec.get("error")
    assert time.perf_counter() - t0 < 60.0


def test_dryrun_cli_appends_and_skips_cached_cells(tmp_path, capsys):
    out = str(tmp_path / "results.json")
    argv = ["--arch", "falcon-mamba-7b", "--shape", "long_500k", "--out", out]
    dryrun.main(argv)
    dryrun.main(argv)
    assert "[skip-cached]" in capsys.readouterr().out
    with open(out) as f:
        recs = json.load(f)
    assert [r["status"] for r in recs] == ["ok"]
    with pytest.raises(SystemExit):
        dryrun.main(["--out", out])


def test_fix_batch_replicates_an_undivided_batch():
    mesh = make_production_mesh(device="meta")
    tree = {"t": NamedSharding(mesh, ("data", None)),
            "c": {"k": NamedSharding(mesh, ("data", "model", None))}}
    assert dryrun._fix_batch(mesh, tree, 32) == tree
    fixed = dryrun._fix_batch(mesh, tree, 3)
    assert fixed["t"].spec == (None, None)
    assert fixed["c"]["k"].spec == (None, "model", None)


# --- the train step over a model axis ----------------------------------------

def test_train_step_over_a_model_axis_equals_no_mesh():
    """One step of the reduced deepseek-v2-236b (MLA, MoE with a shared
    expert) through a (1, 2) mesh and without one, from the same weights:
    the loss and every gradient within 1e-4 of its max |.|, and the
    updated weights too."""
    cfg = registry.get_config("deepseek-v2-236b", reduced=True)
    gen = torch.Generator().manual_seed(43)
    model = T.init_params(cfg, generator=gen, device=CPU)
    twin = copy.deepcopy(model)
    tokens = torch.from_numpy(np.random.default_rng(44).integers(
        0, cfg.vocab_size, (2, 17)))
    batch = {"tokens": tokens}
    mesh = make_host_mesh(1, 2, device=CPU)
    grads = []
    for m, me in ((model, None), (twin, mesh)):
        m.requires_grad_(True)
        loss = T.lm_loss(cfg, m, batch, mesh=me)
        loss.backward()
        grads.append((loss.item(), {n: p.grad.clone() for n, p in
                                    m.named_parameters()}))
        m.zero_grad(set_to_none=True)
    assert abs(grads[0][0] - grads[1][0]) <= 1e-4 * abs(grads[0][0])
    for n, g in grads[0][1].items():
        assert (g - grads[1][1][n]).abs().max() <= 1e-4 * max(
            g.abs().max(), 1e-30), n
    opt = OptConfig(lr=1e-3, warmup_steps=1)
    out = [make_train_step(cfg, me, opt)(m, adamw_init(m), batch)
           for m, me in ((model, None), (twin, mesh))]
    assert abs(out[0][2]["loss"] - out[1][2]["loss"]) <= 1e-4
    for (n, p), q in zip(model.named_parameters(), twin.parameters()):
        assert (p - q).abs().max() <= 1e-4 * max(p.abs().max(), 1e-30), n
