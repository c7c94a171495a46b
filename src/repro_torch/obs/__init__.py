"""``repro_torch.obs``: tracing, metrics and profiling of the port.

Counterpart of ``repro.obs``, with the same import surface:

* tracing -- :func:`span` / :func:`begin` / :func:`event` instrument the
  front door, the engine, the delta update and the serving router; enable
  with :func:`tracing` (scoped, JSONL export) or :func:`enable`; summarize
  with ``tools/trace_report.py``.  Disabled tracing is a single global read
  per call site and adds no kernel launch and no read from the card.
* metrics -- :class:`Histogram` backs the router's latency / queue-wait
  percentiles (``ServiceMetrics.latency_p50`` etc.).
* profiling -- :func:`memory_profile` (the caching allocator's peak over
  one run of the call on the card) and :func:`peak_rss_bytes` /
  :func:`rss_sampling` (host side).
* solver telemetry -- the auction's stats (rounds per epsilon phase, the
  schedule, the warm re-entry decisions) surface through
  ``AnticlusterSpec(telemetry=True)``; :func:`summarize_auction_telemetry`
  folds them to a small dict that span attrs and reports can carry.
"""

from __future__ import annotations

from .trace import (Histogram, Span, Trace, active, begin, disable, enable,
                    enabled, event, span, tracing)
from .memory import (MemoryProfile, RssSample, current_rss_bytes,
                     memory_profile, peak_rss_bytes, rss_sampling, sample_rss)

__all__ = [
    "Histogram", "Span", "Trace", "active", "begin", "disable", "enable",
    "enabled", "event", "span", "tracing",
    "MemoryProfile", "RssSample", "current_rss_bytes", "memory_profile",
    "peak_rss_bytes", "rss_sampling", "sample_rss",
    "summarize_auction_telemetry",
]


def summarize_auction_telemetry(tele) -> dict | None:
    """Fold a solver telemetry pytree (see ``repro_torch.core.assignment``:
    ``rounds (B?, P)``, ``eps``, ``warm``, ``skipped`` stacked over batches)
    into a small JSON-friendly summary dict; None for None input."""
    if tele is None:
        return None
    import numpy as np

    rounds = np.asarray(tele["rounds"])
    if rounds.ndim == 1:                  # single solve: add a batch axis
        rounds = rounds[None]
    per_phase = rounds.sum(axis=0)
    out = {
        "batches": int(rounds.shape[0]),
        "phases": int(rounds.shape[1]),
        "rounds_total": int(rounds.sum()),
        "rounds_per_phase": [int(r) for r in per_phase],
    }
    warm = tele.get("warm")
    if warm is not None and np.asarray(warm).size:
        out["warm_fraction"] = float(np.asarray(warm).mean())
    skipped = tele.get("skipped")
    if skipped is not None and np.asarray(skipped).size:
        out["skipped_fraction"] = float(np.asarray(skipped).mean())
    eps = tele.get("eps")
    if eps is not None and np.asarray(eps).size:
        e = np.asarray(eps, dtype=np.float64)
        # eps axis layout: (..., P, B) or (P, B); reduce to per-phase means
        flat = e.reshape(-1, e.shape[-2], e.shape[-1]) if e.ndim >= 2 \
            else e.reshape(1, -1, 1)
        out["eps_first"] = float(flat[..., 0, :].mean())
        out["eps_last"] = float(flat[..., -1, :].mean())
    return out
