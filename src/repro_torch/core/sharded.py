"""ABA across a device mesh: the data-parallel shards as the first level of
the hierarchy (paper Section 4.4), in PyTorch.

Counterpart of ``repro/core/sharded.py``.  Each data-parallel shard runs
the local ABA core on its own rows and makes ``k / n_shards`` local
anticlusters; the global label is ``shard_offset * k_local + local``.  The
shard level needs no communication, so where JAX runs one ``shard_map``
program the port runs a host loop over the shards: shard ``s`` takes rows
``[s * n_local, (s + 1) * n_local)`` with their categories, fairness codes,
mask and carried prices to its mesh device
(:func:`repro_torch.sharding.shard_devices`), solves there on the same
four branches as the reference's ``local_fn`` (stream, flat ``aba_core``,
batched ``hierarchical_core``, ``batched=False``), and its outputs come
back to the caller's device.  No ``torch.distributed`` process group is
involved.  A mesh may name one device for several shards: their solves
then run one after another on it, with the same labels.

The outputs keep JAX's layout: labels ``(n,)``; with ``return_state``,
per-level prices ``(S, G_l, k_l)``, ``moment_sum`` ``(S, d)`` and
``moment_count`` ``(S,)``.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch._device import DTYPE, as_float, resolve_device
from repro_torch.core.aba import aba_core, aba_stream
from repro_torch.core.assignment import AuctionConfig
from repro_torch.core.hierarchical import (default_plan, hierarchical_core,
                                           plan_price_shapes)
from repro_torch.sharding.specs import resolve_data_axes, shard_devices

__all__ = ["sharded_price_shapes", "sharded_core"]


def sharded_price_shapes(plan: tuple[int, ...],
                         n_shards: int) -> tuple[tuple[int, ...], ...]:
    """Per-level price-stack shapes carried by a sharded session.

    Each level's per-shard shape (:func:`plan_price_shapes`) gains a leading
    shard axis: level l is ``(n_shards, prod(plan[:l-1]), plan[l-1])``.
    """
    return tuple((n_shards,) + s for s in plan_price_shapes(plan))


def _on_device(dev: torch.device):
    """``dev`` as the current CUDA device (a no-op on the CPU)."""
    return torch.cuda.device(dev) if dev.type == "cuda" \
        else contextlib.nullcontext()


def _local_solve(xs, k_local, plan, chunk_size, batched, cl, n_categories,
                 fl, n_fair_codes, vl, p_local, dev, kw):
    """One shard's solve on ``dev``: ``(local labels, per-level prices,
    mu)``, the four branches of the reference's ``local_fn``."""
    p0 = None if p_local is None else p_local[0]
    ckw = dict(categories=cl, n_categories=n_categories, fair_codes=fl,
               n_fair_codes=n_fair_codes, device=dev, **kw)
    if len(plan) == 1 and chunk_size is not None:
        # each shard streams its local rows, constraints and mask included
        local, st = aba_stream(xs, k_local, chunk_size, valid_mask=vl,
                               prices=p0, return_state=True, **ckw)
        return local, (st["prices"],), st["mu"]
    if len(plan) == 1:
        ckw.update(categories=None if cl is None else cl[None],
                   fair_codes=None if fl is None else fl[None])
        local, st = aba_core(xs[None], k_local,
                             None if vl is None else vl[None], prices=p0,
                             return_state=True, **ckw)
        return local[0], (st["prices"],), st["mu"][0]
    if batched:
        local, st = hierarchical_core(xs, plan, batched=True,
                                      chunk_size=chunk_size, prices=p_local,
                                      return_state=True, **ckw)
        return local, st["prices"], st["mu"]
    # the legacy per-group levels: no state threading (benchmarks)
    ckw.pop("fair_codes"), ckw.pop("n_fair_codes")
    local = hierarchical_core(xs, plan, batched=False, chunk_size=chunk_size,
                              **ckw)
    p_out = tuple(torch.zeros(s, dtype=DTYPE, device=dev)
                  for s in plan_price_shapes(plan))
    return local, p_out, xs.mean(dim=0)


def sharded_core(x, k: int, mesh, *, data_axes="auto", max_k: int = 512,
                 variant: str = "auto", solver: str = "auction",
                 auction_config: AuctionConfig = AuctionConfig(),
                 batched: bool = True, chunk_size: int | None = None,
                 categories=None, n_categories: int = 0, fair_codes=None,
                 n_fair_codes: int = 0, valid_mask=None, prices=None,
                 return_state: bool = False, device=None):
    """Partition ``x`` (n, d) into k anticlusters over ``mesh``'s
    data-parallel shards; returns (n,) int32 labels on ``device``.

    The reference's contract: ``k`` must be divisible by the shard count,
    and ``n`` too (pad the dataset and pass ``valid_mask``); each shard owns
    ``n / n_shards`` consecutive rows.  ``data_axes`` follows
    :func:`repro_torch.sharding.resolve_data_axes`.  ``chunk_size`` streams
    each shard's flat level (or the first level of its plan);
    ``categories`` / ``fair_codes`` stratify each shard's rows exactly
    (Section 4.3 per shard); ``valid_mask`` needs a flat per-shard plan.
    ``prices`` warm-starts every shard's per-level auctions from carried
    stacks of the shapes :func:`sharded_price_shapes` gives (None, or
    zeros, is the cold start).  ``return_state`` also returns ``{"prices":
    per-level (S, G_l, k_l), "moment_sum": (S, d) per-shard feature sums
    over valid rows, "moment_count": (S,)}``.  ``device=None`` is the CUDA
    device; the shards run on their mesh devices.
    """
    axes = resolve_data_axes(mesh, data_axes)
    n_shards = math.prod(mesh.shape[a] for a in axes)
    if k % n_shards:
        raise ValueError(f"k={k} must be divisible by shard count {n_shards}")
    home = resolve_device(device)
    xf = as_float(x, home)
    n, d = xf.shape
    if n % n_shards:
        raise ValueError(
            f"n={n} rows must be divisible by shard count {n_shards} "
            "(pad the dataset and mark the padding with valid_mask)")
    k_local = k // n_shards
    plan = default_plan(k_local, max_k=max_k)
    if valid_mask is not None and len(plan) > 1:
        raise NotImplementedError(
            f"valid_mask needs a flat per-shard plan (k/n_shards={k_local} "
            f"resolved to {plan}); raise max_k or drop the padding rows")
    if categories is not None and n_categories <= 0:
        raise ValueError("n_categories must be set with categories")
    if (not batched) and (return_state or prices is not None):
        raise NotImplementedError(
            "price/state threading requires batched=True levels")
    if prices is not None and len(prices) != len(plan):
        raise ValueError(
            f"prices carries {len(prices)} levels for a {len(plan)}-level "
            f"per-shard plan {plan}")
    kw = dict(variant=variant, solver=solver, auction_config=auction_config)
    cats = None if categories is None else \
        torch.as_tensor(categories, device=home).long()
    codes = None if fair_codes is None else \
        torch.as_tensor(fair_codes, device=home).long()
    vm = None if valid_mask is None else \
        torch.as_tensor(valid_mask, device=home).bool()
    p_in = None if prices is None else tuple(as_float(p, home)
                                             for p in prices)
    n_local = n // n_shards

    labels, p_outs, msums, mcnts = [], [], [], []
    for s, dev in enumerate(shard_devices(mesh, axes)):
        dev = resolve_device(dev)
        rows = slice(s * n_local, (s + 1) * n_local)

        def part(t):
            return None if t is None else t[rows].to(dev)

        vl = part(vm)
        with _on_device(dev):
            local, p_out, mu = _local_solve(
                xf[rows].to(dev), k_local, plan, chunk_size, batched,
                part(cats), n_categories, part(codes), n_fair_codes, vl,
                None if p_in is None else tuple(p[s].to(dev) for p in p_in),
                dev, kw)
            cnt = (torch.tensor(float(n_local), dtype=DTYPE, device=dev)
                   if vl is None else vl.sum(dtype=DTYPE))
            # the shard's offset is its row-major index over the data axes
            labels.append((s * k_local + local).to(torch.int32).to(home))
            p_outs.append(tuple(p.to(home) for p in p_out))
            msums.append((mu * cnt).to(home))
            mcnts.append(cnt.to(home))
    out = torch.cat(labels)
    if return_state:
        return out, {"prices": tuple(torch.stack(level)
                                     for level in zip(*p_outs)),
                     "moment_sum": torch.stack(msums),
                     "moment_count": torch.stack(mcnts)}
    return out

