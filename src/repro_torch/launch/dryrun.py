"""Multi-pod dry-run: count every (arch x input-shape x mesh) cell on
``meta`` tensors and record its work, argument sizes and roofline terms.

Counterpart of ``repro/launch/dryrun.py``.  The reference lowers and
compiles each cell for 256 or 512 placeholder devices and reads XLA's
cost and memory analyses.  PyTorch has no such compiler, so the port runs
the cell's step once on ``meta`` tensors (shapes without data) over the
production mesh of ``meta`` positions, under :class:`~repro_torch.launch.
cost.CostCounter`.  Departures (P11):

- there is no partitioner: the counted work is divided by the cell's
  devices as an ideal partition, so no padding waste is counted, and
  ``collective_bytes_per_device`` is ``{}``;
- ``memory.temp_bytes`` is None (no buffer assignment); the argument and
  output bytes a device holds come from the abstract shapes and their
  partition specs;
- bytes are each operation's input and output bytes, counted before any
  fusion;
- the roofline terms use the H100's peak and bandwidth, not the v5e's;
- the ABA cell is not counted (``flops_per_device`` None): its batch scan
  reads the device, which a ``meta`` tensor cannot give.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m \\
      --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod |
      --both-meshes] [--out results.json]

No card is needed.  Results are appended to the JSON file cell by cell,
so a crash loses at most one cell and a re-run skips completed cells.
The reference's ``--save-hlo`` and ``--reanalyze`` read XLA's HLO text and
have no counterpart.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback
from typing import NamedTuple

import torch

from repro_torch._device import ShapeDtype
from repro_torch.launch import inputs as I
from repro_torch.launch.cost import CostCounter
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import transformer as T
from repro_torch.models.registry import ARCHS, get_config
from repro_torch.sharding.specs import NamedSharding, spec_shards, to_pspec
from repro_torch.train.optimizer import (OptConfig, adamw_init,
                                         opt_abstract)
from repro_torch.train.train_step import (make_prefill_step, make_serve_step,
                                          make_train_step)

# --- NVIDIA H100 80GB HBM3 (SXM, 700.00 W), per card: its data sheet -------
PEAK_FLOPS = 989e12      # bf16 dense, tensor cores
HBM_BW = 3.35e12         # bytes/s
LINK_BW = 900e9          # bytes/s, NVLink 4 (the sheet's total a GPU)

UNCOUNTED_ABA = ("the ABA batch scan reads the device between launches "
                 "(core/aba.py's .tolist()), so it does not run on meta "
                 "tensors")


def _active_params(cfg, abstract: dict) -> tuple[int, int]:
    """(total, active) param counts; active discounts unrouted experts."""
    total = sum(math.prod(sd.shape) for sd in abstract.values())
    expert = sum(math.prod(sd.shape) for path, sd in abstract.items()
                 if "mlp" in path and len(sd.shape) == 4)
    if cfg.moe and expert:
        frac = cfg.moe.top_k / cfg.moe.n_experts
        active = total - expert + int(expert * frac)
    else:
        active = total
    embed = cfg.vocab_size * cfg.d_model
    return total, active - embed  # embedding gather is not matmul FLOPs


def model_flops(cfg, cell, abstract: dict) -> float:
    total, active = _active_params(cfg, abstract)
    if cfg.tie_embeddings:
        active += cfg.vocab_size * cfg.d_model  # unembed matmul reuses table
    tokens = cell.batch * (cell.seq if cell.kind in ("train", "prefill") else 1)
    mult = 6 if cell.kind == "train" else 2
    flops = mult * active * tokens
    # attention score/AV term (only what's actually attended)
    att_layers = sum(1 for s in cfg.pattern if s.mixer in ("attn", "mla"))
    att_layers = att_layers * cfg.n_blocks
    hd = cfg.head_dim if cfg.mla is None else (
        cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim + cfg.mla.v_dim)
    if cell.kind == "train":
        flops += (mult / 2) * 2 * 2 * att_layers * cfg.n_heads * hd \
            * cell.batch * cell.seq ** 2 * 0.5
    elif cell.kind == "prefill":
        flops += 2 * 2 * att_layers * cfg.n_heads * hd * cell.batch \
            * cell.seq ** 2 * 0.5
    else:  # decode: one query against the cache
        flops += 2 * 2 * att_layers * cfg.n_heads * hd * cell.batch * cell.seq
    return flops


def _map(fn, tree):
    """``fn`` over the leaves of nested dicts and tuples (None kept)."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and not isinstance(
            tree, (ShapeDtype, NamedSharding)):
        return tuple(_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _fix_batch(mesh, sharding_tree, batch):
    """Replicate the batch dim when it doesn't divide the dp shard count."""
    dp = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            dp *= mesh.shape[a]
    if batch % dp == 0:
        return sharding_tree
    dp_vals = {("pod", "data"), ("data",), "data", ("pod",)}

    def fix(ns):
        return NamedSharding(mesh, tuple(None if e in dp_vals else e
                                         for e in ns.spec))

    return _map(fix, sharding_tree)


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, tuple) and not isinstance(
            tree, (ShapeDtype, NamedSharding)):
        return [x for v in tree for x in _leaves(v)]
    return [] if tree is None else [tree]


def device_bytes(abstract, shardings) -> int:
    """The bytes one device holds of ``abstract`` (ShapeDtype leaves)
    laid out by ``shardings`` (NamedSharding leaves, the same tree): each
    dim divided by its shards, rounded up."""
    total = 0
    for sd, ns in zip(_leaves(abstract), _leaves(shardings), strict=True):
        n = sd.dtype.itemsize
        for dim, shards in zip(sd.shape, spec_shards(ns.spec, ns.mesh)):
            n *= -(-dim // shards)
        total += n
    return total


def _nest(flat: dict) -> dict:
    """``{"L0/k": t}`` -> ``{"L0": {"k": t}}`` (the cache's layout)."""
    out = {}
    for path, t in flat.items():
        *keys, last = path.split("/")
        node = out
        for key in keys:
            node = node.setdefault(key, {})
        node[last] = t
    return out


def _meta(tree):
    """``meta`` tensors of a tree of ShapeDtype leaves."""
    return _map(lambda sd: torch.empty(sd.shape, dtype=sd.dtype,
                                       device="meta"), tree)


# --- ABA data-pipeline cell: the paper's technique on the production mesh ---
ABA_CELLS = {
    # imagenet8-scale mini-batch generation: 1M objects, D=192, K=8192
    # anticlusters (batch size 128).  Auction modeled at 320 Jacobi
    # rounds/phase (fixed_rounds -> known trip counts for the profiler;
    # 320 measured sufficient for valid permutations at 512 columns).
    "aba_1m": dict(n=1 << 20, d=192, k=8192, rounds=320),
}


def lower_aba_cell(shape_name: str, *, multi_pod: bool, device="meta"):
    """``(mesh, fn, args, spec)``: ``fn(x)`` partitions the cell's rows
    over the production mesh of ``device`` positions."""
    from repro_torch.core.assignment import AuctionConfig
    from repro_torch.core.sharded import sharded_aba_lowerable
    spec = ABA_CELLS[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device=device)
    acfg = AuctionConfig(fixed_rounds=spec["rounds"])
    fn, x_spec = sharded_aba_lowerable(mesh, spec["n"], spec["d"], spec["k"],
                                       data_axes="auto", auction_config=acfg,
                                       device=device)
    return mesh, fn, (x_spec,), spec


def aba_model_flops(spec, mesh) -> float:
    shards = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            shards *= mesh.shape[a]
    k_local = spec["k"] // shards
    return 2.0 * spec["n"] * k_local * spec["d"]


class Lowered(NamedTuple):
    """One cell, ready to count: ``step(*inputs)`` runs it on ``meta``
    tensors; ``args`` and ``outs`` are its arguments' and outputs'
    ShapeDtype trees, ``in_shardings`` and ``out_shardings`` their
    NamedSharding trees."""
    cfg: object
    cell: I.ShapeCell
    mesh: object
    step: object
    inputs: tuple
    args: tuple
    in_shardings: tuple
    outs: tuple
    out_shardings: tuple


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               overrides: dict | None = None) -> Lowered:
    """Build one cell's step and its ``meta`` inputs (the model, the
    optimizer state or cache, the batch) over the production mesh of
    ``meta`` positions."""
    cfg = get_config(arch, **(overrides or {}))
    cell = I.SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    an = mesh.axis_names

    def nsh(*tags):
        return NamedSharding(mesh, to_pspec(tags, an))

    p_sh = I.param_shardings(cfg, mesh)
    p_abs = T.abstract_params(cfg)
    scalar = NamedSharding(mesh, ())
    model = T.Model(cfg, device="meta")

    if cell.kind == "train":
        step = make_train_step(cfg, mesh, OptConfig(), microbatches=1)
        o_sh = {"m": p_sh, "v": p_sh, "step": scalar}
        b_abs = I.batch_specs(cfg, cell)
        b_sh = _fix_batch(mesh, I.batch_shardings(cfg, cell, mesh),
                          cell.batch)
        metric = ShapeDtype((), torch.float32)
        metric_sh = {"loss": scalar, "lr": scalar, "grad_norm": scalar}
        o_abs = opt_abstract(p_abs)
        return Lowered(
            cfg, cell, mesh, step, (model, adamw_init(model), _meta(b_abs)),
            (p_abs, o_abs, b_abs), (p_sh, o_sh, b_sh),
            (p_abs, o_abs, {k: metric for k in metric_sh}),
            (p_sh, o_sh, metric_sh))
    c_abs = I.abstract_cache(cfg, cell)
    c_sh = _fix_batch(mesh, I.cache_shardings(cfg, cell, mesh), cell.batch)
    logits = ShapeDtype((cell.batch, 1, cfg.padded_vocab), torch.float32)
    logit_sh = _fix_batch(mesh, {"l": nsh("dp", None, "tp")},
                          cell.batch)["l"]
    if cell.kind == "decode":
        step = make_serve_step(cfg, mesh)
        tok = ShapeDtype((cell.batch, 1), torch.int32)
        tok_sh = _fix_batch(mesh, {"t": nsh("dp", None)}, cell.batch)["t"]
        kv_len = ShapeDtype((), torch.int32)
        # the step writes at kv_len: the cache's last entry, so that the
        # step attends over all of it
        return Lowered(
            cfg, cell, mesh, step,
            (model, _nest(_meta(c_abs)), cell.seq - 1, _meta(tok)),
            (p_abs, c_abs, kv_len, tok), (p_sh, c_sh, scalar, tok_sh),
            (tok, logits, c_abs), (tok_sh, logit_sh, c_sh))
    if cell.kind == "prefill":
        step = make_prefill_step(cfg, mesh, cell.seq)
        b_abs = I.batch_specs(cfg, cell)
        b_sh = _fix_batch(mesh, I.batch_shardings(cfg, cell, mesh),
                          cell.batch)
        names = ("tokens", "extra_embeds", "enc_frames")
        args = tuple(b_abs.get(n) for n in names)
        return Lowered(
            cfg, cell, mesh, step, (model, *_meta(args)), (p_abs, *args),
            (p_sh, *(b_sh.get(n) for n in names)), (logits, c_abs),
            (logit_sh, c_sh))
    raise ValueError(cell.kind)


def _terms(flops: float, n_bytes: float) -> dict:
    return {"compute_s": flops / PEAK_FLOPS, "memory_s": n_bytes / HBM_BW,
            "collective_s": 0.0 / LINK_BW}


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             overrides: dict | None = None) -> dict:
    rec = {"arch": arch, "shape": shape_name,
           "mesh": "2x16x16" if multi_pod else "16x16",
           "devices": 512 if multi_pod else 256}
    if overrides:
        rec["overrides"] = {k: str(v) for k, v in overrides.items()}
    if arch != "aba-pipeline":
        cfg = get_config(arch)
        ok, why = I.cell_applicable(cfg, shape_name)
        if not ok:
            rec.update(status="skipped", reason=why)
            return rec
    try:
        chips = rec["devices"]
        if arch == "aba-pipeline":
            mesh, _fn, args, spec = lower_aba_cell(shape_name,
                                                   multi_pod=multi_pod)
            dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
            rec.update(
                status="ok", flops_per_device=None, bytes_per_device=None,
                reason=UNCOUNTED_ABA, unknown_trip_whiles=0,
                collective_bytes_per_device={},
                memory=dict(
                    argument_bytes=device_bytes(
                        args, (NamedSharding(mesh, (dp, None)),)),
                    output_bytes=device_bytes(
                        ShapeDtype((spec["n"],), torch.int32),
                        NamedSharding(mesh, (dp,))),
                    temp_bytes=None),
                terms=None, dominant=None,
                model_flops_total=aba_model_flops(spec, mesh),
                counted_flops_total=None, useful_flops_ratio=None)
            return rec
        low = lower_cell(arch, shape_name, multi_pod=multi_pod,
                         overrides=overrides)
        t0 = time.perf_counter()
        with CostCounter() as counter:
            low.step(*low.inputs)
        count_s = time.perf_counter() - t0
        flops = counter.flops / chips
        bytes_acc = counter.bytes / chips
        mf = model_flops(low.cfg, low.cell, low.args[0])
        terms = _terms(flops, bytes_acc)
        rec.update(
            status="ok", count_s=round(count_s, 2),
            flops_per_device=flops, bytes_per_device=bytes_acc,
            unknown_trip_whiles=counter.unknown_trip_whiles,
            flops_by_op=dict(counter.flops_by_op),
            collective_bytes_per_device={},
            memory=dict(
                argument_bytes=device_bytes(low.args, low.in_shardings),
                output_bytes=device_bytes(low.outs, low.out_shardings),
                temp_bytes=None),
            terms=terms, dominant=max(terms, key=terms.get),
            model_flops_total=mf,
            counted_flops_total=float(counter.flops),
            useful_flops_ratio=(mf / counter.flops) if counter.flops
            else None)
    except Exception as e:  # record and continue -- these ARE the bugs
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   trace=traceback.format_exc()[-4000:])
    return rec


def all_cells(multi_pod_levels=(False, True)):
    for arch in ARCHS:
        for shape in I.SHAPES:
            for mp in multi_pod_levels:
                yield arch, shape, mp
    for shape in ABA_CELLS:
        for mp in multi_pod_levels:
            yield "aba-pipeline", shape, mp


def _write(results, out):
    with open(out + ".tmp", "w") as f:
        json.dump(results, f, indent=1)
    os.replace(out + ".tmp", out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default="dryrun_results.json")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, or --all")

    try:
        with open(args.out) as f:
            results = json.load(f)
    except (OSError, ValueError):
        results = []
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results}

    if args.all:
        cells = list(all_cells((False, True) if args.both_meshes
                               else (args.multi_pod,)))
    else:
        cells = [(args.arch, args.shape, args.multi_pod)]

    for arch, shape, mp in cells:
        mesh_name = "2x16x16" if mp else "16x16"
        if (arch, shape, mesh_name) in done:
            print(f"[skip-cached] {arch} {shape} {mesh_name}", flush=True)
            continue
        print(f"[run] {arch} {shape} {mesh_name}", flush=True)
        rec = run_cell(arch, shape, multi_pod=mp)
        line = {k: rec.get(k) for k in
                ("status", "count_s", "dominant", "error")}
        print(f"  -> {line}", flush=True)
        results.append(rec)
        _write(results, args.out)


if __name__ == "__main__":
    main()
