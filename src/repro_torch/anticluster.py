"""The spec-driven front door for Euclidean anticlustering, in PyTorch.

Counterpart of ``repro/anticluster.py``::

    from repro_torch.anticluster import anticluster

    res = anticluster(x, k=256, chunk_size="auto")   # on the CUDA device
    res.labels, res.cluster_sizes, res.balanced, res.gap

``_route`` picks the execution route from the spec and the input's shape:
``"flat"`` (the dense core at G = 1), ``"stream"`` (the chunked core, taken
for an int ``chunk_size`` or, with ``"auto"``, from 65536 rows on, where the
default solver is upgraded to the matrix-free ``"auction_fused"``) or
``"stacked"`` (a (G, M, D) input through the dense core).

Not ported yet, and raising ``NotImplementedError`` with the title of the
ROADMAP Queue 1 item that brings them: ``categories`` / ``fairness`` /
``valid_mask`` ("Section 4.3 and masks"), hierarchical plans, i.e. k >
``max_k`` or a tuple plan, and ``kplus_moments > 1`` ("Hierarchical route
and k-plus"), ``mesh`` ("Mesh route"), the ``greedy`` and ``scipy`` solvers
("Remaining solvers"), ``telemetry`` ("Consumers") and the engine
("Sessions and updates").
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch._device import DTYPE, resolve_device
from repro_torch.core.aba import aba_core, aba_stream
from repro_torch.core.assignment import AuctionConfig, get_solver
from repro_torch.core.objective import (cluster_sizes, diversity_per_cluster,
                                        dual_certificate)

__all__ = ["AnticlusterSpec", "AnticlusterResult", "anticluster",
           "AnticlusterEngine"]

# Streaming auto-selection, as in the JAX front door: from _AUTO_STREAM_MIN
# rows on, chunk_size="auto" streams ~_AUTO_CHUNK_ROWS rows per chunk.
_AUTO_STREAM_MIN = 1 << 16   # 65536 rows
_AUTO_CHUNK_ROWS = 1 << 13   # 8192 rows per chunk


def _not_ported(feature: str, item: str):
    """Raise for ``feature``, naming its ROADMAP Queue 1 item by title."""
    raise NotImplementedError(f"{feature} is not ported to PyTorch yet "
                              f"(ROADMAP Queue 1: {item})")


@dataclasses.dataclass(frozen=True, eq=False)
class AnticlusterSpec:
    """Frozen configuration for :func:`anticluster`: the fields and checks
    of the JAX spec.  Values outside the ported slice raise."""

    k: int
    variant: str = "auto"
    categories: Any = None
    n_categories: int = 0
    fairness: Any = None
    solver: str = "auction"
    auction_config: AuctionConfig = AuctionConfig()
    plan: Any = "auto"
    chunk_size: Any = None
    max_k: int = 512
    mesh: Any = None
    data_axes: Any = "auto"
    valid_mask: Any = None
    kplus_moments: int = 1
    dtype: Any = DTYPE
    batched: bool = True
    stats: bool = True
    update_threshold: float = 0.25
    telemetry: bool = False

    def __post_init__(self):
        if self.k < 1:
            raise ValueError(f"k={self.k} must be >= 1")
        if not 0.0 <= self.update_threshold <= 1.0:
            raise ValueError(
                f"update_threshold={self.update_threshold} must be in [0, 1]")
        if isinstance(self.plan, tuple) and math.prod(self.plan) != self.k:
            raise ValueError(
                f"prod(plan)={math.prod(self.plan)} != k={self.k}")
        if self.plan is not None and not isinstance(self.plan, tuple) \
                and self.plan != "auto":
            raise ValueError(f'plan must be "auto", a tuple, or None; '
                             f"got {self.plan!r}")
        if self.chunk_size is not None and self.chunk_size != "auto" and \
                (not isinstance(self.chunk_size, int)
                 or self.chunk_size < 1):
            raise ValueError(f'chunk_size must be None, "auto", or a '
                             f"positive int; got {self.chunk_size!r}")
        if self.fairness is not None and self.categories is not None:
            raise ValueError("categories= and fairness= are mutually "
                             "exclusive")
        for name in ("categories", "fairness", "valid_mask"):
            if getattr(self, name) is not None:
                _not_ported(f"{name}=", "Section 4.3 and masks")
        if self.mesh is not None:
            _not_ported("mesh=", "Mesh route")
        if self.kplus_moments > 1:
            _not_ported("kplus_moments > 1",
                        "Hierarchical route and k-plus")
        if (isinstance(self.plan, tuple) and len(self.plan) > 1) or \
                (self.plan == "auto" and self.k > self.max_k):
            _not_ported(f"a hierarchical plan (k={self.k}, max_k="
                        f"{self.max_k}, plan={self.plan!r})",
                        "Hierarchical route and k-plus")
        if self.telemetry:
            _not_ported("telemetry=True", "Consumers")
        get_solver(self.solver)  # unknown names and unported solvers raise

    def evolve(self, **changes) -> "AnticlusterSpec":
        """A new spec with ``changes`` applied, validated like a new one."""
        if not changes:
            return self
        valid = {f.name for f in dataclasses.fields(self)}
        unknown = sorted(set(changes) - valid)
        if unknown:
            raise TypeError(
                f"unknown AnticlusterSpec field(s) {unknown}; valid fields "
                f"are {sorted(valid)}")
        return dataclasses.replace(self, **changes)

    def resolve_plan(self) -> tuple[int, ...]:
        """The plan: always flat, ``(k,)``, in the ported slice."""
        return self.plan if isinstance(self.plan, tuple) else (self.k,)

    def resolve_chunk(self, n: int, k: int) -> int | None:
        """Concrete chunk size for ``n`` rows, or None (dense)."""
        if self.chunk_size is None:
            return None
        if self.chunk_size == "auto":
            if n < _AUTO_STREAM_MIN:
                return None
            return max(k, _AUTO_CHUNK_ROWS)
        return int(self.chunk_size)


@dataclasses.dataclass(frozen=True)
class AnticlusterResult:
    """Labels plus the resolved route and quality statistics.

    The JAX result's fields (but the engine's ``updated``), as tensors on
    the run's device, plus ``route`` (``"flat"``, ``"stream"`` or
    ``"stacked"``).  ``dual_bound`` / ``gap``
    are the LP-dual certificate from the auction's prices
    (``spec.stats=True``); ``gap >= 0``, near zero when the assignment
    step converged.
    """

    labels: torch.Tensor          # (n,) or (G, M) int32 in [0, k)
    cluster_sizes: torch.Tensor   # (k,) or (G, k) int32
    diversity_sd: torch.Tensor    # () or (G,)
    diversity_range: torch.Tensor  # () or (G,)
    k: int = 1
    plan: tuple[int, ...] = ()
    solver: str = "auction"
    variant: str = "auto"
    dual_bound: Any = None
    gap: Any = None
    route: str = "flat"

    @property
    def balanced(self) -> bool:
        """Constraint (2): all sizes in {floor(n/k), ceil(n/k)}."""
        sizes = np.asarray(self.cluster_sizes.cpu())
        n = sizes.sum(axis=-1, keepdims=True)
        return bool(np.all(sizes >= n // self.k)
                    and np.all(sizes <= -(-n // self.k)))


class AnticlusterEngine:
    """The warm-startable session API: not ported yet."""

    def __init__(self, *args, **kwargs):
        _not_ported("AnticlusterEngine", "Sessions and updates")


def _resolve_spec(spec, overrides: dict) -> AnticlusterSpec:
    if spec is None:
        return AnticlusterSpec(**overrides)
    return spec.evolve(**overrides)


def _route(spec: AnticlusterSpec, shape: tuple[int, ...]):
    """Static dispatch: ``(mode, plan, solver, chunk)`` with ``mode`` in
    ``"stacked"`` | ``"stream"`` | ``"flat"`` and ``solver`` the registry
    name after the at-scale upgrade."""
    if len(shape) not in (2, 3):
        raise ValueError(f"x must be (n, d) or (G, M, D), got {shape}")
    plan = spec.resolve_plan()
    if len(shape) == 3:
        if spec.chunk_size is not None and spec.chunk_size != "auto":
            raise NotImplementedError(
                "chunk_size streaming needs flat (n, d) input; stacked "
                "(G, M, D) batches stay dense")
        if spec.chunk_size is not None and shape[1] >= _AUTO_STREAM_MIN:
            warnings.warn(
                f"chunk_size streaming does not apply to stacked (G, M, D) "
                f"input; running the dense core on {shape}", RuntimeWarning,
                stacklevel=3)
        return "stacked", plan, spec.solver, None
    chunk = spec.resolve_chunk(shape[0], spec.k)
    solver = spec.solver
    if spec.chunk_size == "auto" and solver == "auction" and chunk is not None:
        # at scale the matrix-free factored auction is the default engine
        solver = "auction_fused"
    return ("stream" if chunk is not None else "flat"), plan, solver, chunk


def _call_core(x, spec: AnticlusterSpec, mode: str, solver: str, chunk,
               return_state: bool = False):
    """Run one cold solve on the route's core.  The state's ``"prices"`` is
    the per-level tuple (a 1-tuple here), as in the JAX front door."""
    kw = dict(variant=spec.variant, solver=solver,
              auction_config=spec.auction_config,
              return_state=return_state, device=x.device)
    if mode == "stacked":
        out = aba_core(x, spec.k, **kw)
    elif mode == "stream":
        out = aba_stream(x, spec.k, chunk, **kw)
    else:
        out = aba_core(x[None], spec.k, **kw)
    if not return_state:
        return out[0] if mode == "flat" else out
    labels, st = out
    if mode == "flat":
        return labels[0], {"prices": (st["prices"],), "mu": st["mu"][0]}
    return labels, {"prices": (st["prices"],), "mu": st["mu"]}


def _result_stats(x, labels, k: int, diversity: bool = True):
    """Per-group (sizes, diversity sd, diversity range)."""
    squeeze = x.dim() == 2
    if squeeze:
        x, labels = x[None], labels[None]
    G, M, D = x.shape
    seg = (labels.long() + k * torch.arange(G, device=x.device)[:, None])
    seg = seg.reshape(-1)
    sizes = cluster_sizes(seg, G * k).view(G, k)
    if diversity:
        div = diversity_per_cluster(x.reshape(-1, D), seg, G * k).view(G, k)
        sd = div.std(dim=1, correction=0)
        rng = div.amax(dim=1) - div.amin(dim=1)
    else:
        sd = rng = x.new_zeros((G,))
    if squeeze:
        return sizes[0], sd[0], rng[0]
    return sizes, sd, rng


def _certificate(x, labels, prices: tuple, mode: str, k: int):
    """(dual_bound, gap) from the carried prices, re-centred per group."""
    last = prices[-1]
    last = last - last.amax(dim=-1, keepdim=True)
    return dual_certificate(x, labels,
                            last if mode == "stacked" else last.reshape(-1), k)


def anticluster(x, spec: AnticlusterSpec | None = None, device=None,
                **overrides) -> AnticlusterResult:
    """Partition ``x`` into ``spec.k`` anticlusters per the spec.

    ``x`` is (n, d) rows or a stacked (G, M, D) batch, as a numpy array or
    a tensor; ``spec`` an :class:`AnticlusterSpec`, with keyword
    ``overrides`` applied on top (or used alone: ``anticluster(x, k=10)``).
    ``device=None`` runs on the CUDA device and raises where there is none;
    pass ``device="cpu"`` for the plain PyTorch path.
    """
    spec = _resolve_spec(spec, overrides)
    dev = resolve_device(device)
    x = (x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x)))
    x = x.to(device=dev, dtype=spec.dtype)
    mode, plan, solver, chunk = _route(spec, tuple(x.shape))
    out = _call_core(x, spec, mode, solver, chunk, return_state=spec.stats)
    labels, st = out if spec.stats else (out, None)
    xf = x.to(DTYPE)
    sizes, sd, rng = _result_stats(xf, labels, spec.k, diversity=spec.stats)
    bound, gap = (None, None) if st is None else _certificate(
        xf, labels, st["prices"], mode, spec.k)
    return AnticlusterResult(
        labels=labels, cluster_sizes=sizes, diversity_sd=sd,
        diversity_range=rng, k=spec.k, plan=plan, solver=solver,
        variant=spec.variant, dual_bound=bound, gap=gap, route=mode)
