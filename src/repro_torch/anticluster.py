"""The spec-driven front door for Euclidean anticlustering, in PyTorch.

Counterpart of ``repro/anticluster.py``::

    from repro_torch.anticluster import anticluster

    res = anticluster(x, k=256, chunk_size="auto")   # on the CUDA device
    res.labels, res.cluster_sizes, res.balanced, res.gap

``_route`` picks the execution route from the spec and the input's shape:
``"flat"`` (the dense core at G = 1), ``"stream"`` (the chunked core, taken
for an int ``chunk_size`` or, with ``"auto"``, from 65536 rows on, where the
default solver is upgraded to the matrix-free ``"auction_fused"`` unless
categories are given: their quota mask cannot be factored),
``"stacked"`` (a (G, M, D) input through the dense core) or ``"hier"``
(Section 4.4: a plan of more than one level, given as a tuple or resolved
by ``plan="auto"`` for k > ``max_k``; the chunk and the solver upgrade
are decided for the plan's first level).  Every route takes
``categories`` / ``fairness`` (Section 4.3, one or several attributes);
all but ``"hier"`` take ``valid_mask`` (padding rows).
``kplus_moments > 1`` appends the k-plus moment features to flat
unmasked input before any route.

:class:`AnticlusterEngine` is the session API for repeated same-shape
solves: ``partition`` (the cold solve, bitwise ``anticluster``),
``repartition`` (every batch LAP warm-started from the carried
:class:`ABAState` prices), ``dispatch_repartition`` (the same solve
enqueued from a worker thread on a side CUDA stream) and ``update``
(delta updates, :mod:`repro_torch.incremental`).

Not ported yet, and raising ``NotImplementedError`` with the title of the
ROADMAP Queue 1 item that brings them: ``mesh`` ("Mesh route") and
``telemetry`` ("Consumers").
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import math
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch._device import DTYPE, resolve_device
from repro_torch.core.aba import aba_core, aba_stream
from repro_torch.core.assignment import AuctionConfig, get_solver
from repro_torch.core.hierarchical import (default_plan, hierarchical_core,
                                           plan_price_shapes)
from repro_torch.core.kplus import kplus_augment
from repro_torch.core.objective import (cluster_sizes, diversity_per_cluster,
                                        dual_certificate, segment_ids)

__all__ = ["AnticlusterSpec", "AnticlusterResult", "anticluster",
           "ABAState", "AnticlusterEngine", "PendingRepartition"]

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
        if self.fairness is not None:
            if self.categories is not None:
                raise ValueError("categories= and fairness= are mutually "
                                 "exclusive")
            _fairness_attrs(self.fairness)  # validate shape and dtype
        if self.mesh is not None:
            _not_ported("mesh=", "Mesh route")
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
        """The concrete hierarchy plan this spec dispatches to: ``(k,)``
        for ``plan=None``, the tuple as given, or ``default_plan(k,
        max_k)`` for ``"auto"``."""
        if self.plan is None:
            return (self.k,)
        if isinstance(self.plan, tuple):
            return self.plan
        return default_plan(self.k, max_k=self.max_k)

    def resolve_chunk(self, n: int, k: int) -> int | None:
        """Concrete chunk size for ``n`` rows of a level with ``k``
        anticlusters, or None (dense)."""
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

    The JAX result's fields, as tensors on the run's device, plus
    ``route`` (``"flat"``, ``"stream"``, ``"stacked"`` or ``"hier"``).
    ``dual_bound`` / ``gap`` are the LP-dual certificate from the auction's
    prices (``spec.stats=True``); ``gap >= 0``, near zero when the
    assignment step converged.  ``updated`` is True only for a result of
    the incremental path of :meth:`AnticlusterEngine.update`.
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
    updated: bool = False

    @property
    def n_valid(self):
        """Non-padding rows (per group for stacked input)."""
        return np.asarray(self.cluster_sizes.cpu()).sum(axis=-1)

    @property
    def balanced(self) -> bool:
        """Constraint (2): all sizes in {floor(n/k), ceil(n/k)}."""
        sizes = np.asarray(self.cluster_sizes.cpu())
        n = sizes.sum(axis=-1, keepdims=True)
        return bool(np.all(sizes >= n // self.k)
                    and np.all(sizes <= -(-n // self.k)))


@dataclasses.dataclass(frozen=True)
class ABAState:
    """The carried solver state of one anticlustering session (tensors).

    * ``prices``: the auction's dual prices, one tensor per hierarchy level
      (level l is ``(prod(plan[:l-1]), plan[l-1])``; flat, streamed and
      stacked runs carry a 1-tuple), re-centred per group.  A zeroed tuple
      is exactly the cold start.
    * ``moment_sum`` / ``moment_count``: the running centrality moments
      (feature sums and valid-row counts, per group for stacked input).
    * ``prev_labels``: the previous assignment, ``-1`` before the first.

    It pickles like any dataclass of tensors.
    """

    prices: tuple
    moment_sum: torch.Tensor
    moment_count: torch.Tensor
    prev_labels: torch.Tensor


def _host(a) -> np.ndarray:
    """``a`` (array, sequence or tensor on any device) as a numpy array."""
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _fairness_attrs(fairness) -> list:
    """``AnticlusterSpec.fairness`` as a list of integer attribute arrays,
    one per protected attribute, validated as in the JAX front door.

    Accepted forms: a dict (attribute name -> codes, in insertion order), a
    list or tuple of arrays, one 1-D array or sequence, or a 2-D ``(n, A)``
    array whose last axis is the attribute axis.  (For stacked (G, M, D)
    input pass a list or dict of (G, M) arrays.)
    """
    if isinstance(fairness, dict):
        items = list(fairness.values())
    elif isinstance(fairness, (list, tuple)):
        items = list(fairness)
        if items and np.ndim(_host(items[0])) == 0:
            items = [fairness]  # one attribute given as a plain sequence
    else:
        arr = _host(fairness)
        items = ([arr[..., a] for a in range(arr.shape[-1])]
                 if arr.ndim == 2 else [arr])
    if not items:
        raise ValueError("fairness= needs at least one attribute")
    attrs = []
    for a, item in enumerate(items):
        arr = _host(item)
        if not np.issubdtype(arr.dtype, np.integer):
            raise ValueError(
                f"fairness attribute {a} must be integer-coded, got dtype "
                f"{arr.dtype} (encode the levels as 0..C-1)")
        if arr.size and int(arr.min()) < 0:
            raise ValueError(f"fairness attribute {a} has negative codes")
        if attrs and arr.shape != attrs[0].shape:
            raise ValueError(
                f"fairness attributes disagree on shape: {arr.shape} vs "
                f"{attrs[0].shape}")
        attrs.append(arr)
    return attrs


def _resolve_constraints(spec: AnticlusterSpec):
    """``(categories, n_categories, fair_codes, n_fair_codes)`` as the cores
    take them (int64 tensors on the CPU, or None), from ``spec.categories``
    or ``spec.fairness``.

    One attribute (or plain ``categories=``) resolves to constraint (5)
    exactly: ``fair_codes`` stays None.  Several resolve to the joint
    mixed-radix cell as the rearrangement's category and per-attribute
    offset codes into one shared ``sum(C_a)``-wide quota axis.
    """
    if spec.fairness is None:
        if spec.categories is None:
            return None, spec.n_categories, None, 0
        cats = _host(spec.categories).astype(np.int64)
        n_categories = spec.n_categories
        if n_categories <= 0:
            n_categories = int(cats.max()) + 1
        return torch.from_numpy(cats), n_categories, None, 0
    attrs = [a.astype(np.int64) for a in _fairness_attrs(spec.fairness)]
    sizes = [int(a.max()) + 1 if a.size else 1 for a in attrs]
    if len(attrs) == 1:
        return torch.from_numpy(attrs[0]), sizes[0], None, 0
    joint = np.zeros(attrs[0].shape, np.int64)
    for a, s in zip(attrs, sizes):
        joint = joint * s + a
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    codes = np.stack([a + o for a, o in zip(attrs, offs)], axis=-1)
    return (torch.from_numpy(joint), int(np.prod(sizes)),
            torch.from_numpy(codes), int(sum(sizes)))


def _resolve_spec(spec, overrides: dict) -> AnticlusterSpec:
    if spec is None:
        return AnticlusterSpec(**overrides)
    return spec.evolve(**overrides)


def _route(spec: AnticlusterSpec, shape: tuple[int, ...],
           has_categories: bool, has_valid_mask: bool):
    """Static dispatch: ``(mode, plan, solver, chunk)`` with ``mode`` in
    ``"stacked"`` | ``"hier"`` | ``"stream"`` | ``"flat"``, ``solver`` the
    registry name after the at-scale upgrade, which categories keep off
    (the quota mask cannot be factored, so the plain auction stays the
    stratified default), and ``chunk`` the concrete row count of the
    (first) level, or None.  The JAX function's rules and errors, without
    the mesh."""
    if len(shape) not in (2, 3):
        raise ValueError(f"x must be (n, d) or (G, M, D), got {shape}")
    plan = spec.resolve_plan()
    streamable = len(shape) == 2
    if spec.chunk_size is not None and not streamable \
            and spec.chunk_size != "auto":
        raise NotImplementedError(
            "chunk_size streaming needs flat (n, d) input; stacked "
            "(G, M, D) batches stay dense")
    if spec.chunk_size is not None and len(shape) == 3 \
            and shape[1] >= _AUTO_STREAM_MIN:
        warnings.warn(
            f"chunk_size streaming does not apply to stacked (G, M, D) "
            f"input; running the dense core on {shape}", RuntimeWarning,
            stacklevel=3)

    def chunk_for(n_level: int, k_level: int) -> int | None:
        return spec.resolve_chunk(n_level, k_level) if streamable else None

    n = shape[0]
    solver = spec.solver
    if spec.chunk_size == "auto" and solver == "auction" and streamable \
            and not has_categories and chunk_for(n, plan[0]) is not None:
        # at scale the matrix-free factored auction is the default engine
        solver = "auction_fused"
    if len(shape) == 3:
        if len(plan) > 1:
            raise NotImplementedError(
                "stacked (G, M, D) input requires a flat plan "
                f"(got plan={plan}); hierarchy nests via repeated calls")
        return "stacked", plan, solver, None
    if len(plan) > 1:
        if has_valid_mask:
            raise NotImplementedError(
                "hierarchical plans do not support valid_mask; drop the "
                "padding rows instead")
        return "hier", plan, solver, chunk_for(n, plan[0])
    chunk = chunk_for(n, spec.k)
    return ("stream" if chunk is not None else "flat"), plan, solver, chunk


def _call_core(x, spec: AnticlusterSpec, mode: str, plan, solver: str,
               chunk, cats, n_categories: int, vm, codes=None,
               n_codes: int = 0, prices=None, return_state: bool = False):
    """Run one solve on the route's core.  ``cats`` / ``codes`` / ``vm``
    are the constraints from :func:`_resolve_constraints` and the valid
    mask, on ``x``'s device.  ``prices`` is the per-level tuple of an
    :class:`ABAState` (None: the cold start).  The state's ``"prices"`` is
    the per-level tuple (a 1-tuple but on the ``"hier"`` route), as in the
    JAX front door."""
    kw = dict(variant=spec.variant, categories=cats,
              n_categories=n_categories, fair_codes=codes,
              n_fair_codes=n_codes, solver=solver,
              auction_config=spec.auction_config,
              return_state=return_state, device=x.device)
    if mode == "hier":
        return hierarchical_core(x, plan, batched=spec.batched,
                                 chunk_size=chunk, prices=prices, **kw)
    kw["prices"] = None if prices is None else prices[0]
    if mode == "stacked":
        out = aba_core(x, spec.k, vm, **kw)
    elif mode == "stream":
        out = aba_stream(x, spec.k, chunk, valid_mask=vm, **kw)
    else:
        kw.update(categories=None if cats is None else cats[None],
                  fair_codes=None if codes is None else codes[None])
        out = aba_core(x[None], spec.k, None if vm is None else vm[None],
                       **kw)
    if not return_state:
        return out[0] if mode == "flat" else out
    labels, st = out
    if mode == "flat":
        return labels[0], {"prices": (st["prices"],), "mu": st["mu"][0]}
    return labels, {"prices": (st["prices"],), "mu": st["mu"]}


def _result_stats(x, labels, k: int, valid_mask=None,
                  diversity: bool = True):
    """Per-group (sizes, diversity sd, diversity range); padding rows of
    ``valid_mask`` go to a dump segment, out of every statistic."""
    squeeze = x.dim() == 2
    if squeeze:
        x, labels = x[None], labels[None]
        valid_mask = None if valid_mask is None else valid_mask[None]
    G, M, D = x.shape
    seg = segment_ids(labels, k, valid_mask)
    sizes = cluster_sizes(seg, G * k + 1)[:G * k].view(G, k)
    if diversity:
        div = diversity_per_cluster(x.reshape(-1, D), seg,
                                    G * k + 1)[:G * k].view(G, k)
        sd = div.std(dim=1, correction=0)
        rng = div.amax(dim=1) - div.amin(dim=1)
    else:
        sd = rng = x.new_zeros((G,))
    if squeeze:
        return sizes[0], sd[0], rng[0]
    return sizes, sd, rng


def _cluster_prices(prices: tuple, mode: str) -> torch.Tensor:
    """Per-global-cluster duals from a per-level price tuple, re-centred
    per group: ``(G, k)`` on the stacked route, else ``(k,)``.  A
    hierarchical run's last level is ``(prod(plan[:-1]), k_last)``, and its
    global labels are ``g * k_last + sub``: the row-major reshape is the
    global clusters' order."""
    last = prices[-1]
    last = last - last.amax(dim=-1, keepdim=True)
    return last if mode == "stacked" else last.reshape(-1)


def _certificate(x, labels, prices: tuple, mode: str, k: int, vm=None):
    """(dual_bound, gap) from the carried prices."""
    return dual_certificate(x, labels, _cluster_prices(prices, mode), k,
                            valid_mask=vm)


def _result(x, labels, prices, spec: AnticlusterSpec, mode: str, plan,
            solver: str, vm=None, updated: bool = False):
    """The :class:`AnticlusterResult` of a solve: statistics (per
    ``spec.stats``) and, given the per-level ``prices``, the
    certificate."""
    xf = x.to(DTYPE)
    sizes, sd, rng = _result_stats(xf, labels, spec.k, vm,
                                   diversity=spec.stats)
    bound, gap = (None, None)
    if spec.stats and prices is not None:
        bound, gap = _certificate(xf, labels, prices, mode, spec.k, vm)
    return AnticlusterResult(
        labels=labels, cluster_sizes=sizes, diversity_sd=sd,
        diversity_range=rng, k=spec.k, plan=plan, solver=solver,
        variant=spec.variant, dual_bound=bound, gap=gap, route=mode,
        updated=updated)


def _on(a, dev, dtype) -> torch.Tensor:
    """``a`` (array or tensor) as a tensor of ``dtype`` (None: its own) on
    ``dev``."""
    a = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return a.to(device=dev, dtype=dtype)


def anticluster(x, spec: AnticlusterSpec | None = None, device=None,
                **overrides) -> AnticlusterResult:
    """Partition ``x`` into ``spec.k`` anticlusters per the spec.

    ``x`` is (n, d) rows or a stacked (G, M, D) batch, as a numpy array or
    a tensor; ``spec`` an :class:`AnticlusterSpec`, with keyword
    ``overrides`` applied on top (or used alone: ``anticluster(x, k=10)``).
    ``device=None`` runs on the CUDA device and raises where there is none;
    pass ``device="cpu"`` for the plain PyTorch path.  With
    ``kplus_moments > 1`` the solve and the statistics see the k-plus
    augmented rows (flat, unmasked input only).
    """
    spec = _resolve_spec(spec, overrides)
    dev = resolve_device(device)
    x = _rows(x, dev)
    if spec.kplus_moments > 1:
        if x.dim() != 2 or spec.valid_mask is not None:
            raise NotImplementedError(
                "kplus_moments needs flat unmasked (n, d) input (the moment "
                "statistics are computed over the row axis)")
        x = kplus_augment(x, spec.kplus_moments)
    x = x.to(spec.dtype)
    cats, n_categories, codes, n_codes = _resolve_constraints(spec)
    cats, codes = (None if t is None else t.to(dev) for t in (cats, codes))
    vm = (None if spec.valid_mask is None
          else _on(spec.valid_mask, dev, torch.bool))
    mode, plan, solver, chunk = _route(spec, tuple(x.shape),
                                       cats is not None, vm is not None)
    out = _call_core(x, spec, mode, plan, solver, chunk, cats, n_categories,
                     vm, codes, n_codes, return_state=spec.stats)
    labels, st = out if spec.stats else (out, None)
    return _result(x, labels, None if st is None else st["prices"], spec,
                   mode, plan, solver, vm)


def _rows(x, dev) -> torch.Tensor:
    """The caller's (n, d) or (G, M, D) rows on ``dev`` as JAX's
    ``jnp.asarray`` reads them (its default 32-bit mode reads float64 as
    float32); the cast to ``spec.dtype`` is the caller's."""
    x = _on(x, dev, None)
    if x.dtype == torch.float64:
        x = x.float()
    if x.dim() not in (2, 3):
        raise ValueError(f"x must be (n, d) or (G, M, D), got "
                         f"{tuple(x.shape)}")
    return x


def _shape(x_or_shape) -> tuple[int, ...]:
    if isinstance(x_or_shape, (tuple, list, torch.Size)):
        return tuple(int(s) for s in x_or_shape)
    return tuple(x_or_shape.shape)


class AnticlusterEngine:
    """Warm-startable session API for repeated same-shape solves.

    One engine per repeated workload (per-epoch mini-batch partitions, a
    CV harness, a serving lane).  ``partition(x)`` is the cold start, with
    the labels of ``anticluster(x, spec)`` bit for bit; ``repartition(x,
    state)`` starts every batch LAP at every hierarchy level from the
    previous run's final prices (:class:`ABAState`): the auction's
    re-entry probe at those prices picks, per LAP, the epsilon phases it
    runs; the assignment stays eps-optimal.  On the card the
    warm solve is the same kernels as the cold one: ``auction_phase_dense``
    with carried prices, per-group phase skips and a seeded first round
    (flat, stacked and hierarchical routes), ``bid_top2`` and
    ``auction_phase`` with ``skip`` (stream route); no LAP reads back to
    the host.

    The JAX engine compiles one executable per input signature; here the
    engine builds one solve closure per ``(shape, dtype, per-call mask)``
    signature, and :attr:`compile_count` counts them (1 across same-shape
    epochs).  ``dispatch_repartition`` enqueues a solve from one worker
    thread per engine on a side CUDA stream, so the caller's thread is free
    while the host enqueues the solve's launches.

    ``device=None`` runs on the CUDA device (raising where there is none);
    ``device="cpu"`` runs the plain PyTorch path.  Not supported (use the
    one-shot :func:`anticluster`): ``kplus_moments > 1``,
    ``batched=False``.
    """

    def __init__(self, spec: AnticlusterSpec | None = None, device=None,
                 **overrides):
        spec = _resolve_spec(spec, overrides)
        if spec.kplus_moments > 1:
            raise NotImplementedError(
                "kplus_moments augmentation is host-side; use the one-shot "
                "anticluster()")
        if not spec.batched:
            raise NotImplementedError(
                "the engine requires the batched level engine "
                "(spec.batched=True)")
        get_solver(spec.solver)  # fail fast
        self.spec = spec
        self.device = resolve_device(device)
        cats, self._n_categories, codes, self._n_codes = \
            _resolve_constraints(spec)
        self._cats, self._codes = (None if t is None else t.to(self.device)
                                   for t in (cats, codes))
        self._vm = (None if spec.valid_mask is None
                    else _on(spec.valid_mask, self.device, torch.bool))
        self._fns: dict = {}
        self._routes: dict = {}  # (shape, has_vm) -> (mode, plan, solver, chunk)
        self._built = 0
        self._worker: concurrent.futures.ThreadPoolExecutor | None = None
        self._stream = None

    @property
    def compile_count(self) -> int:
        """Solve closures built so far, one per ``(shape, dtype, per-call
        mask)`` signature: 1 across same-shape epochs."""
        return self._built

    def _routed(self, shape: tuple[int, ...], has_vm: bool | None = None):
        if has_vm is None:
            has_vm = self._vm is not None
        key = (shape, has_vm)
        routed = self._routes.get(key)
        if routed is None:
            routed = _route(self.spec, shape, self._cats is not None, has_vm)
            self._routes[key] = routed
        return routed

    def price_shapes(self, shape) -> tuple[tuple[int, ...], ...]:
        """Per-level price shapes of the state carried for input ``shape``."""
        shape = _shape(shape)
        mode, plan, _solver, _chunk = self._routed(shape)
        if mode == "stacked":
            return ((shape[0], self.spec.k),)
        if mode == "hier":
            return plan_price_shapes(plan)
        return ((1, self.spec.k),)

    def state_shardings(self, x_or_shape):
        """None: the port has no mesh sessions (``mesh=`` raises)."""
        return None

    def init_state(self, x_or_shape) -> ABAState:
        """A zeroed (cold-start) state for ``x`` / its shape."""
        shape = _shape(x_or_shape)
        dev = self.device
        prices = tuple(torch.zeros(s, dtype=DTYPE, device=dev)
                       for s in self.price_shapes(shape))
        if len(shape) == 3:
            G, M, D = shape
            return ABAState(prices, torch.zeros((G, D), device=dev),
                            torch.zeros((G,), device=dev),
                            torch.full((G, M), -1, dtype=torch.int32,
                                       device=dev))
        n, d = shape
        return ABAState(prices, torch.zeros((d,), device=dev),
                        torch.zeros((), device=dev),
                        torch.full((n,), -1, dtype=torch.int32, device=dev))

    def partition(self, x, *, valid_mask=None):
        """Cold solve, the labels of ``anticluster(x, spec)`` bit for bit.
        Returns ``(result, state)``.  It runs the cold schedule, which
        ``repartition`` from a zeroed state (``init_state``) equals bit for
        bit: there every instance is cold, and the re-entry probe at zero
        prices is the first round's own reduction.  The cold schedule
        skips the probe's launches."""
        return self._dispatch(x, None, valid_mask, False).wait()

    def repartition(self, x, state: ABAState, *, valid_mask=None):
        """Warm solve of same-shape ``x`` from ``state``'s prices; returns
        ``(result, new_state)``.  A zeroed state (``init_state``) gives
        ``partition``'s labels bit for bit.  ``valid_mask`` marks padding
        rows per call (the labels' shape), with the same solve closure for
        every padding pattern; it excludes ``spec.valid_mask``."""
        return self._dispatch(x, state, valid_mask, False).wait()

    def overlap_capable(self, x_or_shape) -> bool:
        """Whether :meth:`dispatch_repartition` can overlap for this input:
        False iff the route's solver solves on the host
        (``Solver.host_callback``, e.g. ``"scipy"``)."""
        _mode, _plan, solver, _chunk = self._routed(_shape(x_or_shape))
        return not get_solver(solver).host_callback

    def dispatch_repartition(self, x, state: ABAState, *, valid_mask=None):
        """Non-blocking :meth:`repartition`: validate here, then enqueue the
        solve from the engine's worker thread on a side CUDA stream that
        first waits for the caller's current stream; return a
        :class:`PendingRepartition` at once.  Its ``wait()`` gives
        ``repartition(x, state)``'s result bit for bit (the same kernels in
        the same order).  Raises ``RuntimeError`` when
        :meth:`overlap_capable` is False."""
        if not self.overlap_capable(_shape(x)):
            solver = self._routed(_shape(x))[2]
            raise RuntimeError(
                f"solver {solver!r} solves on the host and cannot be "
                "dispatched asynchronously (the solve occupies the host "
                "thread -- no overlap is possible); check "
                "engine.overlap_capable(x) and use the synchronous "
                "repartition() instead")
        return self._dispatch(x, state, valid_mask, True)

    def update(self, x, state: ABAState, *, added=None, removed=None):
        """Absorb a delta into a live partition without a full re-solve:
        ``removed`` names departing rows of ``x`` (indices or an (n,) bool
        mask), ``added`` is an (m, d) block of arriving rows.  Returns
        ``(result, new_x, new_state)`` with ``new_x = concat(x[kept],
        added)``; see :func:`repro_torch.incremental.engine_update`."""
        from repro_torch import incremental
        return incremental.engine_update(self, x, state, added=added,
                                         removed=removed)

    def close(self) -> None:
        """Stop the engine's worker thread (``dispatch_repartition``
        starts it), after the solves it holds; the engine stays usable and
        starts a new one on the next dispatch."""
        if self._worker is not None:
            self._worker.shutdown(wait=True)
            self._worker = None

    def _rows(self, x) -> torch.Tensor:
        return _rows(x, self.device).to(self.spec.dtype)

    def _dispatch(self, x, state, valid_mask, asynchronous: bool):
        """Validate, resolve the route and run (or enqueue) the solve."""
        spec = self.spec
        x = self._rows(x)
        shape = tuple(x.shape)
        vm = self._vm
        per_call_mask = valid_mask is not None
        if per_call_mask:
            if self._vm is not None:
                raise ValueError(
                    "spec.valid_mask and a per-call valid_mask are mutually "
                    "exclusive; build the engine without spec.valid_mask to "
                    "pass masks per call")
            vm = _on(valid_mask, self.device, torch.bool)
            if tuple(vm.shape) != shape[:-1]:
                raise ValueError(
                    f"valid_mask shape {tuple(vm.shape)} does not match the "
                    f"label shape {shape[:-1]} of input {shape}")
        mode, plan, solver, _chunk = self._routed(shape, vm is not None)
        prices = None  # the cold start (partition)
        if state is not None:
            if not isinstance(state, ABAState):
                raise TypeError(
                    f"a single-device engine carries ABAState, got "
                    f"{type(state).__name__} (build states with "
                    "engine.init_state / previous repartition calls)")
            expected = self.price_shapes(shape)
            got = tuple(tuple(p.shape) for p in state.prices)
            if got != expected:
                raise ValueError(
                    f"state prices {got} do not match the {expected} this "
                    f"engine carries for input shape {shape} (state from a "
                    "different shape/plan?)")
            prices = tuple(_on(p, self.device, DTYPE) for p in state.prices)
        key = (shape, str(spec.dtype), per_call_mask)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = self._build(shape, per_call_mask)
        pending = PendingRepartition(self, x, vm, mode, plan, solver)
        if not asynchronous:
            pending._out = fn(x, prices, vm)
            return pending
        side = start = None
        if self.device.type == "cuda":
            if self._stream is None:
                self._stream = torch.cuda.Stream(self.device)
            side = self._stream
            start = torch.cuda.Event()
            start.record(torch.cuda.current_stream(self.device))
            for t in (x, vm, *(prices or ())):
                if t is not None:
                    t.record_stream(side)

        def run():
            if side is None:
                return fn(x, prices, vm), None
            with torch.cuda.device(self.device), torch.cuda.stream(side):
                side.wait_event(start)
                out = fn(x, prices, vm)
                end = torch.cuda.Event()
                end.record(side)
            return out, end

        if self._worker is None:
            self._worker = concurrent.futures.ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="anticluster-engine")
        pending._future = self._worker.submit(run)
        return pending

    def _build(self, shape: tuple[int, ...], per_call_mask: bool):
        """The solve closure of one signature: the core with the carried
        prices, then the state refresh (prices re-centred per group, the
        centrality moments as ``mu * count``)."""
        spec = self.spec
        mode, plan, solver, chunk = self._routed(
            shape, True if per_call_mask else None)
        cats, ncats = self._cats, self._n_categories
        codes, ncodes = self._codes, self._n_codes
        self._built += 1

        def body(x, prices, vm):
            labels, st = _call_core(x, spec, mode, plan, solver, chunk, cats,
                                    ncats, vm, codes, ncodes, prices=prices,
                                    return_state=True)
            # the auction is invariant to a uniform shift: re-centre so the
            # carried state stays bounded over epochs
            new_prices = tuple(p - p.amax(dim=-1, keepdim=True)
                               for p in st["prices"])
            if mode == "stacked":
                cnt = (x.new_full((shape[0],), float(shape[1]), dtype=DTYPE)
                       if vm is None else vm.sum(dim=1, dtype=DTYPE))
            else:
                cnt = (x.new_tensor(float(shape[0]), dtype=DTYPE)
                       if vm is None else vm.sum(dtype=DTYPE))
            return labels, new_prices, st["mu"] * cnt[..., None], cnt

        return body


class PendingRepartition:
    """A repartition in flight (:meth:`AnticlusterEngine.dispatch_repartition`)
    or already run (:meth:`AnticlusterEngine.repartition`).

    ``ready()`` polls without blocking: the worker has enqueued the solve
    and the card has run it.  ``wait()`` joins the worker (re-raising its
    exception), synchronizes on the solve's end event and finishes the
    result exactly as ``repartition`` does; it is idempotent.
    """

    def __init__(self, engine, x, vm, mode, plan, solver):
        self._engine = engine
        self._x, self._vm = x, vm
        self._mode, self._plan, self._solver = mode, plan, solver
        self._out = None
        self._future: concurrent.futures.Future | None = None
        self._done: tuple | None = None

    def ready(self) -> bool:
        """True iff the solve has finished (non-blocking)."""
        if self._done is not None or self._future is None:
            return True
        if not self._future.done():
            return False
        end = None if self._future.exception() else self._future.result()[1]
        return end is None or end.query()

    def wait(self) -> tuple[AnticlusterResult, ABAState]:
        """Sync, compute the statistics (per spec) and return ``(result,
        state)``."""
        if self._done is not None:
            return self._done
        out = self._out
        if self._future is not None:
            out, end = self._future.result()
            if end is not None:
                end.synchronize()
                # the outputs were allocated on the side stream: keep their
                # memory from reuse until the caller's stream is done
                caller = torch.cuda.current_stream(self._engine.device)
                labels, prices, msum, mcnt = out
                for t in (labels, msum, mcnt, *prices):
                    t.record_stream(caller)
        labels, prices, msum, mcnt = out
        engine = self._engine
        result = _result(self._x, labels, prices, engine.spec, self._mode,
                         self._plan, self._solver, self._vm)
        state = ABAState(prices=prices, moment_sum=msum, moment_count=mcnt,
                         prev_labels=labels)
        self._done = (result, state)
        self._x = self._vm = self._out = self._future = None
        return self._done
