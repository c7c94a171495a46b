"""Memory profiling: the card's measured footprint of a call, and host RSS.

Counterpart of ``repro/obs/memory.py``.  Two views:

* :func:`memory_profile` measures what one call of ``fn`` allocates on the
  CUDA device.  XLA can say what a jitted call *would* allocate without
  running it (``lower().compile().memory_analysis()``); PyTorch has no such
  analysis, so here the call RUNS once: the caching allocator's peak is
  reset, the call runs and is synchronized, and ``temp_bytes`` is the peak
  allocated during the call less the bytes allocated before it.
  ``argument_bytes`` / ``output_bytes`` are the sizes of the tensors among
  the arguments and in the result.  On the CPU there is no such counter:
  the profile has ``available=False`` and ``-1`` counts, as the reference
  reports on builds without an analysis.  (ROADMAP departure P5.)
* :func:`peak_rss_bytes` / :func:`rss_sampling` read the host side -- the
  process high-water mark (``VmHWM``) and a sampled during-call peak --
  copied from the reference.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from contextlib import contextmanager

import torch


@dataclasses.dataclass(frozen=True)
class MemoryProfile:
    """Measured footprint of one call on the card (bytes; -1 unknown)."""

    temp_bytes: int = -1           # scratch: live memory beyond args/outputs
    argument_bytes: int = -1
    output_bytes: int = -1
    generated_code_bytes: int = -1
    available: bool = False

    @property
    def total_bytes(self) -> int:
        """Sum of the known components (-1 when none is known)."""
        known = [b for b in (self.temp_bytes, self.argument_bytes,
                             self.output_bytes, self.generated_code_bytes)
                 if b >= 0]
        return sum(known) if known else -1


def _tensor_bytes(obj) -> int:
    """Bytes of the distinct tensors in ``obj`` (nested tuples, lists,
    dicts, dataclasses; other leaves count 0)."""
    seen: set[int] = set()

    def walk(o) -> int:
        if isinstance(o, torch.Tensor):
            key = o.untyped_storage().data_ptr() if o.numel() else id(o)
            if key in seen:
                return 0
            seen.add(key)
            return o.numel() * o.element_size()
        if isinstance(o, (tuple, list)):
            return sum(walk(e) for e in o)
        if isinstance(o, dict):
            return sum(walk(e) for e in o.values())
        if dataclasses.is_dataclass(o) and not isinstance(o, type):
            return sum(walk(getattr(o, f.name))
                       for f in dataclasses.fields(o))
        return 0

    return walk(obj)


def _device_of(args, kwargs) -> torch.device | None:
    """Where the call runs: the device of the first tensor among the
    arguments, else a ``device=`` argument, else the current CUDA device
    when one exists, else None."""
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.Tensor):
            return a.device
    if isinstance(kwargs.get("device"), (str, torch.device)):
        return torch.device(kwargs["device"])
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    return None


def memory_profile(fn, *args, **kwargs) -> MemoryProfile:
    """Run ``fn(*args, **kwargs)`` once and measure its footprint on the
    CUDA device it runs on (see :func:`_device_of`).  A call on the CPU
    (or on a machine without a CUDA device) is not run: its profile has
    ``available=False`` and ``-1`` counts."""
    dev = _device_of(args, kwargs)
    if dev is None or dev.type != "cuda":
        return MemoryProfile()
    torch.cuda.synchronize(dev)
    before = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = fn(*args, **kwargs)
    torch.cuda.synchronize(dev)
    peak = torch.cuda.max_memory_allocated(dev)
    return MemoryProfile(
        temp_bytes=max(peak - before, 0),
        argument_bytes=_tensor_bytes((args, kwargs)),
        output_bytes=_tensor_bytes(out),
        available=True)


def _read_status_kb(field: str) -> int:
    """A ``/proc/self/status`` field in kB, or -1 off-Linux."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith(field + ":"):
                    return int(line.split()[1])
    except Exception:
        pass
    return -1


def current_rss_bytes() -> int:
    """Current resident set size in bytes (-1 when unavailable)."""
    kb = _read_status_kb("VmRSS")
    return kb * 1024 if kb >= 0 else -1


def peak_rss_bytes() -> int:
    """Process peak RSS (high-water mark) in bytes; -1 when unavailable."""
    kb = _read_status_kb("VmHWM")
    if kb >= 0:
        return kb * 1024
    try:
        import resource
        # Linux reports ru_maxrss in kB
        return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    except Exception:
        return -1


class RssSample:
    """Mutable holder filled by :func:`rss_sampling`."""

    __slots__ = ("peak_bytes", "samples")

    def __init__(self):
        self.peak_bytes = -1
        self.samples = 0


@contextmanager
def rss_sampling(interval_s: float = 0.01):
    """Sample current RSS on a daemon thread for the duration of the block;
    yields an :class:`RssSample` whose ``peak_bytes`` is the observed
    maximum (plus one final sample at exit)."""
    sample = RssSample()
    stop = threading.Event()

    def _poll():
        while not stop.is_set():
            rss = current_rss_bytes()
            if rss > sample.peak_bytes:
                sample.peak_bytes = rss
            sample.samples += 1
            stop.wait(interval_s)

    t = threading.Thread(target=_poll, daemon=True)
    t.start()
    try:
        yield sample
    finally:
        stop.set()
        t.join(timeout=5.0)
        rss = current_rss_bytes()
        if rss > sample.peak_bytes:
            sample.peak_bytes = rss
        sample.samples += 1


def sample_rss(fn, *args, interval_s: float = 0.01, **kwargs):
    """Run ``fn(*args, **kwargs)`` under RSS sampling; returns
    ``(result, peak_rss_bytes_during_call)``."""
    with rss_sampling(interval_s) as s:
        out = fn(*args, **kwargs)
    return out, s.peak_bytes


# re-exported for callers that want to timestamp samples themselves
monotonic = time.monotonic
