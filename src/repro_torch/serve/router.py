"""Async anticlustering serving tier: continuous batching over engine pools.

Counterpart of ``repro/serve/router.py``, in PyTorch.  Three things differ
from the JAX router, none of them in behaviour: lanes are placed
round-robin over the ``torch.cuda.device_count()`` CUDA devices (or on the
CPU for a ``device="cpu"`` router); requests are coerced with the port's
float32 ``as_float`` onto the router's device; and a served ticket is
resolved only after its tensors are complete on the lane's stream, so a
client thread never sees labels the card is still writing.  On the card
every stacked and solo lane call runs ``auction_phase_dense`` (one launch
a LAP at the group's G), a live partition's update one launch at G = B.
A mesh spec serves each request on a warm sharded lane (the engine's own
shard placement owns the mesh's devices), one request at a time.

The production shape of the paper's repeated-workload story
(:class:`AnticlusterRouter`): clients ``submit`` ``(n, d)`` feature
matrices and get a :class:`Ticket` back; a bounded admission queue feeds
**continuous batching** -- pending requests are admitted into the *next*
in-flight stacked lane call instead of only stacking bursts that happen to
arrive together.

Admission groups requests three ways:

* **Row buckets.**  Requests whose row counts land in the same
  power-of-two bucket are padded to the bucket with a per-call
  ``valid_mask``, so near-shapes share ONE lane (one solve closure)
  instead of one per distinct ``n``.  Padding is restricted to requests
  whose unpadded solve uses the base (non-interleave) rearrangement -- the
  masked core skips the Section-4.2 interleave, so only there is the
  padded solve the unpadded one's (bitwise on the CPU; on the card a
  stacked level rounds differently at G > 1, ROADMAP P4, so there it is
  held to exact balance and the objective).  Interleave-regime requests
  still stack, but only with exact shape twins.
* **Group buckets.**  A formed batch stacks its requests on the core's
  group axis, padded to a power-of-two width by repeating the last
  request (same as the synchronous service) -- a fluctuating batch size
  maps onto a handful of lane shapes.
* **Sequential lanes.**  Hierarchical-plan and mesh specs cannot stack
  (the group axis needs a flat plan; the mesh uses its own placement
  axis): their requests serve one-at-a-time on warm solo lanes.  For
  hierarchical plans this is a *degraded* path -- it is surfaced by the
  ``degraded_sequential`` metric and a one-time ``RuntimeWarning`` instead
  of silently losing throughput.

Robustness: the queue is bounded (``submit`` raises
:class:`Rejected`("queue_full") -- backpressure, never OOM), requests
carry optional deadlines and are shed at admission when expired
(:class:`Rejected`("deadline")), closing the router rejects pending
work (:class:`Rejected`("shutdown")), and an engine error while serving
resolves the affected tickets with that exception (re-raised by
``Ticket.result``; counted in ``ServiceMetrics.errored``) instead of
killing the worker -- the loop keeps serving.  Throughput: per-spec
:class:`EnginePool` lanes are placed round-robin across the CUDA devices,
so concurrent lanes solve on different cards.  Observability:
:meth:`AnticlusterRouter.metrics` returns a :class:`ServiceMetrics`
snapshot (queue depth, warm-hit rate, stack/row occupancy, per-lane
solve-closure counts, degraded-path counters, latency percentiles).

The synchronous ``partition`` / ``partition_many`` are thin wrappers over
``submit`` (see :class:`repro_torch.serve.AnticlusterService`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch._device import as_float, resolve_device
from repro_torch.anticluster import (AnticlusterEngine, AnticlusterResult,
                                     AnticlusterSpec, _mesh_shards,
                                     _resolve_spec)

__all__ = ["AnticlusterRouter", "EnginePool", "Rejected", "ServiceMetrics",
           "Ticket"]

# A request is row-padded only when its unpadded solve would use the base
# rearrangement: variant "auto" interleaves at n // k <= 8 (mirrors
# ``repro_torch.core.aba.aba_core``), and the masked core skips interleave,
# so padding an interleave-regime request would change its labels.
_INTERLEAVE_RATIO = 8


class Rejected(RuntimeError):
    """Typed rejection outcome of a serving request.

    ``reason`` is one of:

    * ``"queue_full"`` -- backpressure: the bounded admission queue was at
      ``max_queue`` (raised synchronously by ``submit``; the request was
      never admitted).  Burst admission via ``partition_many`` is
      all-or-nothing: a burst that does not fit whole is rejected whole,
      and every request in it counts toward
      ``ServiceMetrics.rejected_full``.
    * ``"deadline"`` -- the request's deadline expired before a lane picked
      it up; it was shed at admission and its ticket resolves rejected.
    * ``"shutdown"`` -- the router was closed while the request was
      pending.
    """

    def __init__(self, reason: str):
        super().__init__(reason)
        self.reason = reason


class Ticket:
    """Handle for one submitted request.

    ``done()`` is non-blocking; ``result()`` blocks until the request is
    served (re-raising the :class:`Rejected` outcome if it was shed, or
    the engine's exception if serving it errored) -- under a background
    worker it waits, without one it *drives* the router's queue inline,
    so the sync wrappers never need a thread.  ``submitted_at`` /
    ``completed_at`` are router-clock stamps and ``latency`` their
    difference: the load benchmark's SLO numbers come straight from
    tickets.
    """

    __slots__ = ("_router", "_event", "_result", "_rejection", "_error",
                 "submitted_at", "completed_at")

    def __init__(self, router: "AnticlusterRouter", submitted_at: float):
        self._router = router
        self._event = threading.Event()
        self._result: AnticlusterResult | None = None
        self._rejection: Rejected | None = None
        self._error: BaseException | None = None
        self.submitted_at = submitted_at
        self.completed_at: float | None = None

    def done(self) -> bool:
        """True once the request was served or rejected (non-blocking)."""
        return self._event.is_set()

    @property
    def rejection(self) -> Rejected | None:
        """The :class:`Rejected` outcome, or None (pending / served)."""
        return self._rejection

    @property
    def error(self) -> BaseException | None:
        """The exception serving this request raised, or None."""
        return self._error

    @property
    def latency(self) -> float | None:
        """Seconds from submission to completion (None while pending)."""
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def result(self, timeout: float | None = None) -> AnticlusterResult:
        """The request's :class:`AnticlusterResult` (blocks until served).

        Raises the ticket's :class:`Rejected` if the request was shed, the
        engine's exception if serving it errored, and ``TimeoutError`` if
        ``timeout`` seconds pass first.  Without a background worker the
        timeout is best-effort: the calling thread drives the queue and
        only checks the clock between ``step()`` calls, so one step (a
        first call's kernel build, or a large stacked solve of other
        requests' groups) can overrun the budget before ``TimeoutError`` is
        raised.
        """
        self._router._fulfil(self, timeout)
        if self._rejection is not None:
            raise self._rejection
        if self._error is not None:
            raise self._error
        return self._result

    def _resolve(self, result=None, rejection=None, error=None, at=None):
        self._result = result
        self._rejection = rejection
        self._error = error
        self.completed_at = at
        self._event.set()


@dataclasses.dataclass(frozen=True)
class ServiceMetrics:
    """Point-in-time observability snapshot of a router.

    Counters are lifetime totals since construction; ``queue_depth`` and
    ``lane_compile_counts`` (each lane engine's solve closures) are
    current.  The derived properties are the
    serving-tier SLO signals: ``warm_hit_rate`` (fraction of lane calls
    that warm-started from carried prices), ``stack_occupancy`` (real
    requests per stacked group slot -- how much of the batching headroom
    traffic actually uses), ``row_occupancy`` (real rows per padded row
    slot -- the cost of row-bucket admission), and ``shed_rate``.
    ``errored`` counts requests whose serve raised (their tickets carry
    the exception); a rejected ``partition_many`` burst adds every one of
    its requests to ``rejected_full``.  The live-partition lane reports
    ``update_calls`` / ``update_fallbacks`` (deltas that fell back to a
    full repartition; ``update_fallback_rate`` derives the ratio -- a
    rising rate means deltas outgrew ``spec.update_threshold``) and the
    current ``live_partitions`` count.
    """

    queue_depth: int
    submitted: int
    completed: int
    shed_deadline: int
    rejected_full: int
    errored: int
    stacked_calls: int
    solo_calls: int
    warm_calls: int
    cold_calls: int
    degraded_sequential: int
    group_slots: int
    group_filled: int
    row_slots: int
    row_filled: int
    lane_compile_counts: dict[str, int]
    devices: int
    # the live-partition (delta-update) lane; defaults keep older
    # positional/partial constructions working
    update_calls: int = 0
    update_fallbacks: int = 0
    live_partitions: int = 0
    # request-latency / queue-wait percentiles (seconds) over the router's
    # retained sample window (``repro_torch.obs.Histogram``); 0.0 before any
    # request completes.  Latency is submit -> ticket resolution; queue
    # wait is submit -> the serve that picked the request up.
    latency_p50: float = 0.0
    latency_p99: float = 0.0
    queue_wait_p50: float = 0.0
    queue_wait_p99: float = 0.0

    @property
    def update_fallback_rate(self) -> float:
        return (self.update_fallbacks / self.update_calls
                if self.update_calls else 0.0)

    @property
    def warm_hit_rate(self) -> float:
        calls = self.warm_calls + self.cold_calls
        return self.warm_calls / calls if calls else 0.0

    @property
    def stack_occupancy(self) -> float:
        return self.group_filled / self.group_slots if self.group_slots \
            else 0.0

    @property
    def row_occupancy(self) -> float:
        return self.row_filled / self.row_slots if self.row_slots else 0.0

    @property
    def shed_rate(self) -> float:
        finished = self.completed + self.shed_deadline
        return self.shed_deadline / finished if finished else 0.0


def _on_device(device: torch.device):
    """The lane's CUDA device as the current one (a no-op on the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _complete(device: torch.device) -> None:
    """Wait until the work enqueued on the device's current stream is
    complete (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


@dataclasses.dataclass
class _Lane:
    """One warm serving lane: an engine, its carried state, its device."""

    engine: AnticlusterEngine
    state: Any = None
    device: Any = None
    calls: int = 0


class EnginePool:
    """Per-spec pool of warm engine lanes, placed round-robin over devices.

    Each lane key (an input signature bucket) owns one
    :class:`AnticlusterEngine` plus its carried state.  On a CUDA router
    successive *new* lanes go to the ``torch.cuda.device_count()`` devices
    round-robin -- a lane's inputs and state live on its device, so lanes
    solve on different cards without any cross-device chatter; on a CPU
    router every lane is on the CPU.  Mesh specs pin no lane: the engine's
    shards run on the mesh's devices, and its inputs and state live on the
    router's device.

    ``lane()`` does not lock: the router calls it under its metrics lock,
    which is what lets ``AnticlusterRouter.metrics`` iterate ``lanes``
    concurrently with serving.
    """

    def __init__(self, spec: AnticlusterSpec, device=None):
        self.spec = spec
        self.lanes: dict[tuple, _Lane] = {}
        dev = resolve_device(device)
        self._devices = ([torch.device("cuda", i)
                          for i in range(torch.cuda.device_count())]
                         if dev.type == "cuda" and spec.mesh is None
                         else [dev])
        self._next_device = 0

    @property
    def device_count(self) -> int:
        return len(self._devices)

    def lane(self, key: tuple) -> _Lane:
        lane = self.lanes.get(key)
        if lane is None:
            device = self._devices[self._next_device % len(self._devices)]
            self._next_device += 1
            lane = _Lane(engine=AnticlusterEngine(self.spec, device=device),
                         device=device)
            self.lanes[key] = lane
        return lane


@dataclasses.dataclass
class _Request:
    x: Any                      # (n, d) float32 tensor on the router's device
    n: int
    d: int
    ticket: Ticket
    deadline_at: float | None   # absolute router-clock time, or None
    key: tuple                  # admission key (what can batch together)
    bucket: int                 # padded row count (== n when not padded)
    op: str = "solve"           # "solve" | "open" | "update"
    payload: Any = None         # ("update": the (added, removed) delta)


class AnticlusterRouter:
    """Admission-controlled async front end over warm anticluster lanes.

    Args:
      spec: the :class:`AnticlusterSpec` every request is solved under
        (keyword ``overrides`` compose via ``AnticlusterSpec.evolve``).
        Specs with ``categories`` / ``valid_mask`` are per-dataset rather
        than per-request concepts and are rejected; a ``mesh`` spec serves
        requests one at a time on warm sharded lanes.
      max_group: cap on the stacked group axis per lane call; pending
        same-bucket requests beyond it wait for the next call.
      max_queue: bound on admitted-but-unserved requests; ``submit`` above
        it raises :class:`Rejected`("queue_full") synchronously.
      row_buckets: pad near-shapes to power-of-two row buckets so they
        share lanes (False restores exact-shape-only stacking).
      background: serve from a daemon worker thread (started lazily on the
        first ``submit``).  False leaves driving to the caller:
        ``Ticket.result`` / ``drain`` / ``step`` pump the queue inline --
        deterministic and thread-free, which is what the sync
        :class:`repro.serve.AnticlusterService` wrapper and the tier-1
        tests use.
      clock: the router's time source (monotonic seconds) for deadlines
        and latency stamps; injectable so tests shed deterministically.
      device: ``None`` serves on the CUDA devices (raising where there is
        none); ``"cpu"`` serves on the CPU (the plain PyTorch path).
    """

    def __init__(self, spec: AnticlusterSpec | None = None, *,
                 max_group: int = 32, max_queue: int = 1024,
                 row_buckets: bool = True, background: bool = True,
                 clock: Callable[[], float] = time.monotonic, device=None,
                 **overrides):
        spec = _resolve_spec(spec, overrides)
        self.device = resolve_device(device)
        if spec.categories is not None or spec.fairness is not None \
                or spec.valid_mask is not None:
            raise NotImplementedError(
                "the serving tier solves anonymous flat (n, d) requests; "
                "categories/fairness/valid_mask are per-dataset concepts -- "
                "use AnticlusterEngine directly")
        if max_group < 1:
            raise ValueError(f"max_group={max_group} must be >= 1")
        if max_queue < 1:
            raise ValueError(f"max_queue={max_queue} must be >= 1")
        self.spec = spec
        self.max_group = max_group
        self.max_queue = max_queue
        self.row_buckets = row_buckets
        self._clock = clock
        self._background = background
        self._plan = spec.resolve_plan()
        # stacked (G, M, D) execution needs a flat per-request plan, no mesh
        # (the shard axis is placement, the group axis is batching), and a
        # dense solve (an explicit int chunk_size bans stacked input)
        self._stackable = (len(self._plan) == 1 and spec.mesh is None
                           and not isinstance(spec.chunk_size, int))
        self._is_hier = len(self._plan) > 1 and spec.mesh is None
        self._shards = _mesh_shards(spec)  # 1 when meshless
        self._pool = EnginePool(spec, self.device)
        self._queue: collections.deque[_Request] = collections.deque()
        self._cv = threading.Condition()
        self._serve_mutex = threading.Lock()  # one batch former at a time
        self._worker: threading.Thread | None = None
        self._closed = False
        self._warned_degraded = False
        # metrics counters (guarded by self._cv)
        self._submitted = 0
        self._completed = 0
        self._shed_deadline = 0
        self._rejected_full = 0
        self._errored = 0
        self._stacked_calls = 0
        self._solo_calls = 0
        self._warm_calls = 0
        self._cold_calls = 0
        self._degraded_sequential = 0
        self._group_slots = 0
        self._group_filled = 0
        self._row_slots = 0
        self._row_filled = 0
        self._update_calls = 0
        self._update_fallbacks = 0
        # latency/queue-wait reservoirs: internally locked, recorded outside
        # self._cv (histogram recording must not lengthen the metrics lock)
        self._lat_hist = obs.Histogram()
        self._qwait_hist = obs.Histogram()
        # live named partitions (the delta-update lane).  _live_names is
        # the synchronous reservation set (admission-time duplicate/unknown
        # checks); _live maps name -> IncrementalPartition once the open
        # has been served.  Both guarded by self._cv; the partitions
        # themselves are only touched under _serve_mutex.
        self._live_names: set[str] = set()
        self._live: dict[str, Any] = {}

    # -- admission ----------------------------------------------------------

    @property
    def lane_count(self) -> int:
        """Number of live (engine, state) lanes -- one per signature bucket."""
        return len(self._pool.lanes)

    @property
    def _lanes(self) -> dict:
        return self._pool.lanes

    def _coerce(self, x) -> torch.Tensor:
        shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
        if len(shape) != 2:
            raise ValueError(
                f"requests are (n, d) feature matrices; got shape "
                f"{tuple(shape)}")
        if shape[0] < self.spec.k:
            raise ValueError(
                f"request has n={shape[0]} rows < spec.k={self.spec.k}")
        if self._shards > 1 and shape[0] % self._shards \
                and len(self._plan) > 1:
            # flat per-shard plans auto-pad uneven rows inside the engine
            # (masked zero rows; see AnticlusterEngine._solve_shape), so
            # only the composition the engine itself cannot mask -- a
            # multi-level per-shard plan -- is rejected here, at admission:
            # by the time a lane solves, the ticket is the only way out,
            # and an async failure is a worse surface than a synchronous one
            raise ValueError(
                f"request has n={shape[0]} rows, not divisible by the "
                f"mesh shard count {self._shards}, and the per-shard plan "
                f"{self._plan} is hierarchical (mesh lanes can auto-pad "
                "uneven rows only under a flat per-shard plan; raise "
                "max_k or pad the request)")
        return as_float(x, self.device)

    def _admission(self, n: int, d: int) -> tuple[tuple, int]:
        """(admission key, padded row bucket) for an ``(n, d)`` request.

        Requests sharing a key may be served by one stacked lane call.
        """
        if not self._stackable:
            return ("seq", n, d), n
        spec = self.spec
        paddable = self.row_buckets and (
            spec.variant == "base"
            or (spec.variant == "auto" and n // spec.k > _INTERLEAVE_RATIO))
        if paddable:
            bucket = 1 << (n - 1).bit_length()  # next pow2 >= n
            if spec.resolve_chunk(bucket, self._plan[0]) is not None:
                # at streaming scale the flat chunked path beats a padded
                # dense stack; serve solo (the solo lane streams)
                return ("seq", n, d), n
            return ("pad", bucket, d), bucket
        return ("exact", n, d), n

    def submit(self, x, deadline: float | None = None) -> Ticket:
        """Admit one ``(n, d)`` request; returns its :class:`Ticket`.

        ``deadline`` is a seconds-from-now latency budget: a request still
        queued when it expires is shed (its ticket resolves
        :class:`Rejected`("deadline")).  Raises
        :class:`Rejected`("queue_full") synchronously when the bounded
        queue is full -- backpressure, by construction never OOM.
        """
        xa = self._coerce(x)
        with self._cv:
            return self._submit_locked(xa, deadline)

    def _submit_locked(self, xa, deadline: float | None, *,
                       op: str = "solve", key: tuple | None = None,
                       payload: Any = None) -> Ticket:
        if self._closed:
            raise Rejected("shutdown")
        if len(self._queue) >= self.max_queue:
            self._rejected_full += 1
            raise Rejected("queue_full")
        now = self._clock()
        n, d = map(int, xa.shape) if xa is not None else (0, 0)
        if key is None:
            key, bucket = self._admission(n, d)
        else:
            bucket = n
        ticket = Ticket(self, now)
        self._queue.append(_Request(
            x=xa, n=n, d=d, ticket=ticket,
            deadline_at=None if deadline is None else now + deadline,
            key=key, bucket=bucket, op=op, payload=payload))
        self._submitted += 1
        obs.event("serve/admit", n=n, d=d, op=op,
                  queue_depth=len(self._queue))
        if self._background and (self._worker is None
                                 or not self._worker.is_alive()):
            self._worker = threading.Thread(
                target=self._worker_loop, name="anticluster-router",
                daemon=True)
            self._worker.start()
        self._cv.notify()
        return ticket

    # -- sync wrappers ------------------------------------------------------

    def partition(self, x) -> AnticlusterResult:
        """Serve one request synchronously: ``submit(x).result()``."""
        return self.submit(x).result()

    def partition_many(self, requests) -> list[AnticlusterResult]:
        """Serve a burst synchronously; results align with request order.

        Admission is atomic -- every request enters the queue before any
        batch is formed -- so batching is deterministic: same-bucket
        requests stack together exactly as the old synchronous service
        stacked same-shape bursts (continuous batching then extends the
        same behaviour to requests that arrive *while* a call is in
        flight).
        """
        xs = [self._coerce(x) for x in requests]
        with self._cv:
            if len(xs) + len(self._queue) > self.max_queue:
                self._rejected_full += len(xs)  # every request of the burst
                raise Rejected("queue_full")
            tickets = [self._submit_locked(xa, None) for xa in xs]
        return [t.result() for t in tickets]

    # -- live partitions (the delta-update lane) -----------------------------

    def open_partition(self, name: str, x,
                       deadline: float | None = None) -> Ticket:
        """Admit ``x`` as the named *live* partition; returns its Ticket.

        A live partition stays resident after its solve: subsequent
        :meth:`submit_update` calls absorb row arrivals/departures through
        :meth:`repro.anticluster.AnticlusterEngine.update` instead of
        re-solving.  The name is reserved synchronously (a duplicate
        ``open_partition`` raises ``ValueError`` immediately, not on the
        ticket); open and update ops on one name share the admission key
        ``("update", name)``, so the queue's FIFO order IS the partition's
        op order.  Mesh specs have no delta path and raise here.
        """
        if self.spec.mesh is not None:
            raise NotImplementedError(
                "mesh lanes do not support delta updates; submit() full "
                "requests instead")
        xa = self._coerce(x)
        with self._cv:
            if name in self._live_names:
                raise ValueError(
                    f"live partition {name!r} is already open")
            ticket = self._submit_locked(xa, deadline, op="open",
                                         key=("update", name))
            self._live_names.add(name)
            return ticket

    def submit_update(self, name: str, added=None, removed=None,
                      deadline: float | None = None) -> Ticket:
        """Admit a delta against the named live partition.

        ``added`` is an (m, d) block of arriving rows; ``removed`` names
        departing rows of the partition's *current* row order (int indices
        or a bool mask) -- :meth:`AnticlusterEngine.update` semantics,
        including the loud over-threshold fallback (``result.updated`` is
        False for that call and ``ServiceMetrics.update_fallbacks``
        counts it).  Raises ``ValueError`` synchronously when ``name`` was
        never opened (or already closed).
        """
        with self._cv:
            if name not in self._live_names:
                raise ValueError(
                    f"live partition {name!r} is not open (open_partition "
                    "first)")
            added_a = (None if added is None
                       else as_float(added, self.device))
            return self._submit_locked(None, deadline, op="update",
                                       key=("update", name),
                                       payload=(added_a, removed))

    def live_partition(self, name: str):
        """The named :class:`repro_torch.incremental.IncrementalPartition`.

        Available once the open ticket resolved; ``KeyError`` otherwise.
        Treat it as read-only (``.labels``, ``.x``, ``.result``) -- mutate
        through :meth:`submit_update`, which serializes with serving.
        """
        with self._cv:
            part = self._live.get(name)
        if part is None:
            raise KeyError(
                f"live partition {name!r} is not open (or its open has "
                "not been served yet)")
        return part

    def partition_labels(self, name: str):
        """Current labels of the named live partition (see live_partition)."""
        return self.live_partition(name).labels

    def close_partition(self, name: str) -> None:
        """Release the named live partition (its name becomes reusable).

        Updates still queued for it resolve with an error; drain first for
        a clean shutdown of the name.
        """
        with self._cv:
            self._live_names.discard(name)
            self._live.pop(name, None)

    # -- serving ------------------------------------------------------------

    def step(self) -> bool:
        """Form and serve one admission group; False when the queue is idle.

        The worker thread's unit of work, public so callers without a
        background worker (tests, the sync wrappers) can drive the queue
        deterministically.  A group's requests are popped from the queue
        before serving, so an engine error must not escape with their
        tickets unresolved: it is caught here, the group's pending tickets
        resolve with the exception (``Ticket.result`` re-raises it,
        ``ServiceMetrics.errored`` counts it), and the worker loop keeps
        serving.
        """
        with self._serve_mutex:
            with self._cv:
                group = self._take_group_locked()
            if group is None:
                return False
            try:
                self._serve(group)
            except Exception as exc:
                now = self._clock()
                pending = [r for r in group if not r.ticket.done()]
                with self._cv:
                    self._errored += len(pending)
                for r in pending:
                    r.ticket._resolve(error=exc, at=now)
            return True

    def drain(self) -> None:
        """Serve until the queue is empty (inline; safe alongside a worker)."""
        while self.step():
            pass

    def _fulfil(self, ticket: Ticket, timeout: float | None) -> None:
        if ticket.done():
            return
        worker = self._worker
        if worker is not None and worker.is_alive() \
                and worker is not threading.current_thread():
            if not ticket._event.wait(timeout):
                raise TimeoutError(
                    f"request not served within {timeout} s")
            return
        stop_at = None if timeout is None else time.monotonic() + timeout
        while not ticket.done():
            # best-effort: checked before every step, but a single step
            # (a first call's kernel build, someone else's large stacked
            # group) can overrun the budget -- see Ticket.result
            if stop_at is not None and time.monotonic() > stop_at:
                raise TimeoutError(f"request not served within {timeout} s")
            if not self.step():
                if ticket.done():
                    return
                raise RuntimeError(
                    "ticket is unresolved but the queue is idle (router "
                    "closed?)")

    def _take_group_locked(self) -> list[_Request] | None:
        """Shed expired requests, then pop the head's admission group."""
        now = self._clock()
        kept: collections.deque[_Request] = collections.deque()
        while self._queue:
            r = self._queue.popleft()
            if r.deadline_at is not None and now > r.deadline_at:
                self._shed_deadline += 1
                r.ticket._resolve(rejection=Rejected("deadline"), at=now)
            else:
                kept.append(r)
        self._queue = kept
        if not self._queue:
            return None
        head = self._queue.popleft()
        group = [head]
        rest: collections.deque[_Request] = collections.deque()
        while self._queue:
            r = self._queue.popleft()
            if r.key == head.key and len(group) < self.max_group:
                group.append(r)
            else:
                rest.append(r)
        self._queue = rest
        if len(group) > 1 and head.key[0] == "seq" and self._is_hier:
            self._degraded_sequential += len(group)
            if not self._warned_degraded:
                self._warned_degraded = True
                warnings.warn(
                    f"hierarchical plan {self._plan} cannot stack requests "
                    "on the group axis: a burst of "
                    f"{len(group)} same-shape requests degrades to "
                    "sequential warm solves (counted in "
                    "ServiceMetrics.degraded_sequential; use a flat plan "
                    "-- plan=None or max_k >= k -- for stacked serving)",
                    RuntimeWarning, stacklevel=3)
        return group

    def _serve(self, group: list[_Request]) -> None:
        now = self._clock()
        for r in group:
            wait = now - r.ticket.submitted_at
            self._qwait_hist.record(wait)
            obs.event("serve/queue_wait", wait=wait, n=r.n)
        head = group[0]
        if head.key[0] == "update":
            # one live partition's ops, in FIFO order (the admission key
            # pins the name, _take_group_locked keeps arrival order)
            for r in group:
                self._serve_live(r)
            return
        if head.key[0] == "seq":
            for r in group:
                self._serve_solo(r)
            return
        if len(group) == 1 and head.n == head.bucket:
            # an exact-fit singleton takes the plain flat lane (identical
            # labels either way; keeps single-stream traffic off the
            # stacked lanes)
            self._serve_solo(head)
            return
        self._serve_stacked(group)

    def _resolve_served(self, r: "_Request", result, at: float) -> None:
        """Resolve a served ticket, recording its end-to-end latency."""
        self._lat_hist.record(at - r.ticket.submitted_at)
        r.ticket._resolve(result=result, at=at)

    def _serve_live(self, r: _Request) -> None:
        """Apply one live-partition op (runs under ``_serve_mutex``).

        An exception (unknown name after close, a bad delta shape) escapes
        to ``step``, which resolves the ticket with it and counts it in
        ``errored`` -- same containment as every other serve path.
        """
        from repro_torch.incremental import IncrementalPartition
        name = r.key[1]
        if r.op == "open":
            with self._cv:
                lane = self._pool.lane(("live", name))
            with _on_device(lane.device):
                part = IncrementalPartition(r.x.to(lane.device),
                                            engine=lane.engine)
                _complete(lane.device)
            lane.calls += 1
            with self._cv:
                self._live[name] = part
                self._cold_calls += 1
                self._solo_calls += 1
                self._completed += 1
            self._resolve_served(r, part.result, self._clock())
            return
        with self._cv:
            part = self._live.get(name)
        if part is None:
            raise KeyError(
                f"live partition {name!r} was closed (or its open "
                "errored) before this update was served")
        added, removed = r.payload
        device = part.engine.device
        with obs.span("serve/update", partition=name), _on_device(device):
            res = part.update(
                added=None if added is None else added.to(device),
                removed=removed)
            _complete(device)
        with self._cv:
            self._update_calls += 1
            if not res.updated:
                self._update_fallbacks += 1
            self._completed += 1
        self._resolve_served(r, res, self._clock())

    def _serve_solo(self, r: _Request) -> None:
        res, _warm = self._call_lane(("solo", (r.n, r.d)), r.x, None)
        with self._cv:
            self._solo_calls += 1
            self._completed += 1
        self._resolve_served(r, res, self._clock())

    def _serve_stacked(self, group: list[_Request]) -> None:
        head = group[0]
        G, rows, d = len(group), head.bucket, head.d
        gbucket = 1 << (G - 1).bit_length()  # pad bursts to pow2 widths
        xs = [r.x if r.n == rows
              else torch.cat([r.x, r.x.new_zeros((rows - r.n, d))])
              for r in group]
        xs += [xs[-1]] * (gbucket - G)
        stack = torch.stack(xs)
        vm = None
        if any(r.n < rows for r in group):
            m = np.zeros((gbucket, rows), np.bool_)
            for g, r in enumerate(group):
                m[g, :r.n] = True
            m[G:] = m[G - 1]  # group-padding repeats the last request
            vm = torch.from_numpy(m)
        res, _warm = self._call_lane(("stack", (rows, d), gbucket), stack, vm)
        with self._cv:
            self._stacked_calls += 1
            self._completed += len(group)
            self._group_slots += gbucket
            self._group_filled += G
            self._row_slots += G * rows
            self._row_filled += sum(r.n for r in group)
        now = self._clock()
        for g, r in enumerate(group):
            self._resolve_served(r, AnticlusterResult(
                labels=res.labels[g][:r.n],
                cluster_sizes=res.cluster_sizes[g],
                diversity_sd=res.diversity_sd[g],
                diversity_range=res.diversity_range[g],
                k=res.k, plan=res.plan, solver=res.solver,
                variant=res.variant,
                dual_bound=None if res.dual_bound is None
                else res.dual_bound[g],
                gap=None if res.gap is None else res.gap[g],
                route=res.route), now)

    def _call_lane(self, key: tuple, x, vm):
        with self._cv:
            # lane insertion mutates the pool's dict under the same lock
            # metrics() iterates it with (engine construction is cheap --
            # compilation happens in repartition, outside the lock)
            lane = self._pool.lane(key)
        x = x.to(lane.device)
        if vm is not None:
            vm = vm.to(lane.device)
        warm = lane.state is not None
        state = lane.state
        if state is None:
            state = lane.engine.init_state(tuple(x.shape))
        with obs.span("serve/solve", lane=str(key), warm=warm), \
                _on_device(lane.device):
            res, lane.state = lane.engine.repartition(x, state,
                                                      valid_mask=vm)
            # resolve no ticket before its tensors are complete
            _complete(lane.device)
        lane.calls += 1
        with self._cv:
            if warm:
                self._warm_calls += 1
            else:
                self._cold_calls += 1
        return res, warm

    # -- lifecycle ----------------------------------------------------------

    def _worker_loop(self) -> None:
        while True:
            with self._cv:
                while not self._queue and not self._closed:
                    self._cv.wait()
                if self._closed and not self._queue:
                    return
            while self.step():
                pass

    def close(self) -> None:
        """Stop serving: reject pending requests with Rejected("shutdown")."""
        with self._cv:
            self._closed = True
            now = self._clock()
            while self._queue:
                r = self._queue.popleft()
                r.ticket._resolve(rejection=Rejected("shutdown"), at=now)
            self._cv.notify_all()
        worker, self._worker = self._worker, None
        if worker is not None and worker.is_alive() \
                and worker is not threading.current_thread():
            worker.join(timeout=60.0)

    def __enter__(self) -> "AnticlusterRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- observability ------------------------------------------------------

    def metrics(self) -> ServiceMetrics:
        """A :class:`ServiceMetrics` snapshot (thread-safe)."""
        with self._cv:
            return ServiceMetrics(
                queue_depth=len(self._queue),
                submitted=self._submitted,
                completed=self._completed,
                shed_deadline=self._shed_deadline,
                rejected_full=self._rejected_full,
                errored=self._errored,
                stacked_calls=self._stacked_calls,
                solo_calls=self._solo_calls,
                warm_calls=self._warm_calls,
                cold_calls=self._cold_calls,
                degraded_sequential=self._degraded_sequential,
                group_slots=self._group_slots,
                group_filled=self._group_filled,
                row_slots=self._row_slots,
                row_filled=self._row_filled,
                lane_compile_counts={
                    str(k): lane.engine.compile_count
                    for k, lane in self._pool.lanes.items()},
                devices=self._pool.device_count,
                update_calls=self._update_calls,
                update_fallbacks=self._update_fallbacks,
                live_partitions=len(self._live),
                latency_p50=self._lat_hist.percentile(50),
                latency_p99=self._lat_hist.percentile(99),
                queue_wait_p50=self._qwait_hist.percentile(50),
                queue_wait_p99=self._qwait_hist.percentile(99))
