"""Host-side structured tracing: spans, instant events, latency histograms.

A copy of ``repro/obs/trace.py`` (pure Python), so that the port imports
nothing of the JAX package; the JSONL it exports keeps the reference's
schema, which ``tools/trace_report.py`` reads.

The recorder is deliberately boring technology -- monotonic-clock spans in a
thread-safe in-memory buffer, exported as JSONL -- because the interesting
constraints are all *cost* constraints:

* **Off-by-default and cheap when off.**  Every instrumented call site goes
  through the module-level :func:`span` / :func:`event` helpers, which cost
  one global read and (for spans) return a shared no-op context manager when
  no trace is installed.  No call site launches a kernel or reads from the
  card for the recorder: a span's attributes are host values, or tensors
  that are read only when the trace is exported.
* **Thread-safe.**  The serving router completes requests on a background
  worker while callers submit from their own threads; the event buffer takes
  a lock per *completed* span (not per running one) and span nesting is
  tracked per-thread with ``threading.local`` stacks, so concurrent spans
  never see each other's parents.
* **Nesting without bookkeeping at the call site.**  ``with span("a"):``
  inside ``with span("b"):`` records ``a.parent == b.id`` automatically.
  For spans that *cross* threads or stack frames (the engine's async
  dispatch -> wait) use :meth:`Trace.begin` / :meth:`Span.finish` -- the
  span captures its parent at begin time but is not pushed on any stack.

Events are plain dicts (``name, ts, dur, id, parent, thread, attrs``);
``ts`` is seconds since the trace was created, ``dur`` is 0.0 for instant
events.  ``tools/trace_report.py`` summarizes the JSONL.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
from contextlib import contextmanager


def _jsonable(v):
    """Best-effort conversion of an attr value to a JSON-serializable one."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    item = getattr(v, "item", None)  # numpy scalars, one-element tensors
    if item is not None:
        try:
            return _jsonable(item())
        except Exception:
            pass
    if isinstance(v, (list, tuple)):
        return [_jsonable(e) for e in v]
    return repr(v)


class Span:
    """One timed region.  Use as a context manager (stacked, from
    :meth:`Trace.span`) or begin/finish explicitly (:meth:`Trace.begin`)."""

    __slots__ = ("name", "attrs", "_trace", "_t0", "_parent", "_id",
                 "_stacked", "_done")

    def __init__(self, trace: "Trace", name: str, attrs: dict,
                 parent, stacked: bool):
        self.name = name
        self.attrs = attrs
        self._trace = trace
        self._parent = parent
        self._id = next(trace._ids)
        self._stacked = stacked
        self._done = False
        self._t0 = trace._clock()

    def set(self, **attrs) -> "Span":
        """Attach/overwrite attributes on a running span."""
        self.attrs.update(attrs)
        return self

    def __enter__(self) -> "Span":
        if self._stacked:
            stack = self._trace._stack()
            self._parent = stack[-1]._id if stack else None
            stack.append(self)
            self._t0 = self._trace._clock()  # exclude stack bookkeeping
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    def finish(self, **attrs) -> None:
        """Close the span (idempotent) and record it into the trace."""
        if self._done:
            return
        self._done = True
        t1 = self._trace._clock()
        if attrs:
            self.attrs.update(attrs)
        if self._stacked:
            stack = self._trace._stack()
            if stack and stack[-1] is self:
                stack.pop()
            elif self in stack:          # mis-nested exit; stay consistent
                stack.remove(self)
        self._trace._record(self.name, self._t0, t1, self._id,
                            self._parent, self.attrs)


class _NopSpan:
    """Shared do-nothing span for the disabled path (allocation-free)."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def set(self, **attrs):
        return self

    def finish(self, **attrs):
        return None


_NOP = _NopSpan()


class Trace:
    """A thread-safe span/event recorder on a monotonic clock.

    ``clock`` is injectable (tests pin timings with a fake clock); it must
    be monotonic non-decreasing.  Completed events live in :attr:`events`
    in completion order.
    """

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._ids = itertools.count(1)   # CPython-atomic id allocator
        self.events: list[dict] = []
        self._t0 = clock()

    # -- span lifecycle ---------------------------------------------------
    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def span(self, name: str, **attrs) -> Span:
        """A stacked span: ``with trace.span("engine/solve", k=8): ...``.
        Parent is whatever span is open on this thread at ``__enter__``."""
        return Span(self, name, attrs, parent=None, stacked=True)

    def begin(self, name: str, **attrs) -> Span:
        """An async (non-stacked) span: starts now, parented under the
        current thread's open span, closed later via :meth:`Span.finish`
        (possibly from another thread)."""
        stack = self._stack()
        parent = stack[-1]._id if stack else None
        return Span(self, name, attrs, parent=parent, stacked=False)

    def event(self, name: str, **attrs) -> None:
        """An instant event (``dur == 0``) under the current open span."""
        now = self._clock()
        stack = self._stack()
        parent = stack[-1]._id if stack else None
        self._record(name, now, now, next(self._ids), parent, attrs)

    def _record(self, name, t0, t1, sid, parent, attrs) -> None:
        ev = {"name": name, "ts": t0 - self._t0, "dur": t1 - t0, "id": sid,
              "parent": parent, "thread": threading.get_ident(),
              "attrs": attrs}
        with self._lock:
            self.events.append(ev)

    # -- export -----------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self.events)

    def snapshot(self) -> list[dict]:
        """A consistent copy of the completed events."""
        with self._lock:
            return list(self.events)

    def export_jsonl(self, path: str) -> int:
        """Write one JSON object per completed event; returns the count."""
        events = self.snapshot()
        with open(path, "w") as f:
            for ev in events:
                out = dict(ev)
                out["attrs"] = {k: _jsonable(v)
                                for k, v in ev["attrs"].items()}
                f.write(json.dumps(out) + "\n")
        return len(events)


class Histogram:
    """Thread-safe bounded reservoir for latency-style samples.

    Keeps the last ``max_samples`` values in a ring (plus exact running
    count/sum), so percentiles over a smoke run are *exact* -- which is what
    lets the router tests pin ``latency_p50`` on a fake clock -- while a
    long-lived service degrades gracefully to a sliding window.
    """

    __slots__ = ("_lock", "_ring", "_pos", "_count", "_sum")

    def __init__(self, max_samples: int = 4096):
        if max_samples <= 0:
            raise ValueError("max_samples must be positive")
        self._lock = threading.Lock()
        self._ring: list[float] = [0.0] * max_samples
        self._pos = 0
        self._count = 0
        self._sum = 0.0

    def record(self, value: float) -> None:
        v = float(value)
        with self._lock:
            self._ring[self._pos % len(self._ring)] = v
            self._pos += 1
            self._count += 1
            self._sum += v

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def mean(self) -> float:
        with self._lock:
            return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Exact percentile of the retained window (nearest-rank); 0.0 when
        empty.  ``q`` in [0, 100]."""
        with self._lock:
            n = min(self._pos, len(self._ring))
            if n == 0:
                return 0.0
            vals = sorted(self._ring[:n])
        rank = max(1, min(n, -(-int(q * n) // 100)))  # ceil(q*n/100) clamped
        return vals[rank - 1]


# -- module-level switch ---------------------------------------------------
# _ACTIVE is read unlocked on the hot path: a torn read is impossible for a
# single reference assignment in CPython, and enable/disable are control
# operations, not data-path ones.
_ACTIVE: Trace | None = None


def enabled() -> bool:
    """True when a trace is installed (instrumentation will record)."""
    return _ACTIVE is not None


def active() -> Trace | None:
    """The installed :class:`Trace`, or None."""
    return _ACTIVE


def enable(trace: Trace | None = None) -> Trace:
    """Install ``trace`` (a fresh one by default) as the active recorder."""
    global _ACTIVE
    if trace is None:
        trace = Trace()
    _ACTIVE = trace
    return trace


def disable() -> Trace | None:
    """Uninstall and return the active trace (None when none was active)."""
    global _ACTIVE
    trace, _ACTIVE = _ACTIVE, None
    return trace


def span(name: str, **attrs):
    """Open a stacked span on the active trace; a shared no-op when
    tracing is disabled (the call site never branches)."""
    t = _ACTIVE
    return t.span(name, **attrs) if t is not None else _NOP


def begin(name: str, **attrs):
    """Begin an async span on the active trace (no-op when disabled)."""
    t = _ACTIVE
    return t.begin(name, **attrs) if t is not None else _NOP


def event(name: str, **attrs) -> None:
    """Record an instant event on the active trace (no-op when disabled)."""
    t = _ACTIVE
    if t is not None:
        t.event(name, **attrs)


@contextmanager
def tracing(path: str | None = None, clock=time.perf_counter):
    """Scoped tracing: install a fresh :class:`Trace`, restore the previous
    one on exit, and (optionally) export the JSONL to ``path``.

    >>> with tracing("TRACE.jsonl") as trace: ...
    """
    global _ACTIVE
    prev = _ACTIVE
    trace = enable(Trace(clock=clock))
    try:
        yield trace
    finally:
        _ACTIVE = prev
        if path is not None:
            trace.export_jsonl(path)
