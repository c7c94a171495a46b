"""The overlapped anticlustered-minibatch pipeline, in PyTorch.

Counterpart of ``repro/train/pipeline.py``.  The paper's headline ML
application -- one anticluster per SGD mini-batch -- pays off at scale
only if the per-epoch partition hides behind the training compute.
:class:`ABAPipeline` makes that overlap structural:

* it owns one warm :class:`repro_torch.anticluster.AnticlusterEngine`
  session for the whole run (one solve closure, every epoch warm-started:
  the :class:`repro_torch.data.minibatch.ABABatchSequencer` contract);
* at the *start* of epoch ``t`` it dispatches epoch ``t+1``'s
  re-partition without blocking
  (:meth:`AnticlusterEngine.dispatch_repartition`: the engine's worker
  thread enqueues the solve on a side CUDA stream), so the solve runs
  while the consumer trains; the epoch boundary does the one wait;
* the label / batch buffers are **double-buffered**: the current epoch's
  schedule reads one slot while the in-flight solve's results land in the
  other; the slots flip at the epoch boundary;
* mini-batches come out of an iterator: ``for epoch in
  pipeline.epochs(E, features=...): for idx in epoch: ...``.

Determinism is bit for bit the sequencer's: batch membership comes from
the same engine route (``_auto_or_flat_spec``) and the same schedule
function (``build_batch_schedule``), the per-epoch batch order from the
same counter-based rng (``epoch_order``), on one device and on a mesh.

When overlap is impossible -- a host-callback solver like ``"scipy"``
occupies the host thread while it solves (``Solver.host_callback``) -- the
pipeline falls back **loudly** (one ``RuntimeWarning``) to synchronous
sequencing: the same results, no overlap.

The spans ``pipeline/wait`` (the consumer's stall at an epoch boundary),
``pipeline/epoch`` (the consumer's whole epoch: the time the dispatched
solve had) and the event ``pipeline/dispatch`` are recorded when
:mod:`repro_torch.obs` tracing is enabled.
"""

from __future__ import annotations

import warnings
from typing import Any, Callable

import numpy as np
import torch

from repro_torch import obs
from repro_torch.anticluster import AnticlusterEngine
from repro_torch.core.objective import diversity_per_cluster
from repro_torch.data.minibatch import (_auto_or_flat_spec, _shape,
                                        build_batch_schedule, epoch_order)

__all__ = ["ABAPipeline", "PipelineEpoch"]


class PipelineEpoch:
    """One epoch's mini-batch schedule (iterable of batch index arrays).

    Yields ``len(self)`` numpy index arrays into the dataset, in the
    epoch's deterministic order.  ``gathered(data)`` is the convenience
    iterator over ``data[idx]`` slices for array-like datasets.  While this
    epoch is consumed, the *next* epoch's partition is already in flight
    (unless the pipeline fell back to synchronous mode).
    """

    def __init__(self, index: int, batches, order: np.ndarray):
        self.index = int(index)
        self.order = order
        self._batches = batches

    def __len__(self) -> int:
        return len(self.order)

    def __iter__(self):
        for b in self.order:
            yield self._batches[b]

    def gathered(self, data):
        """Yield ``data[idx]`` per batch (token rows, images, ...)."""
        for idx in self:
            yield data[idx]


class _SyncSolve:
    """Deferred *synchronous* repartition (the loud-fallback twin of
    :class:`repro_torch.anticluster.PendingRepartition`): nothing runs at
    construction; ``wait()`` runs the blocking ``repartition`` at the epoch
    boundary, exactly where the sequencer would."""

    def __init__(self, engine, x, state):
        self._engine, self._x, self._state = engine, x, state

    def wait(self):
        return self._engine.repartition(self._x, self._state)


class ABAPipeline:
    """Warm-session anticlustered mini-batches with epoch-overlapped solves.

    Args (mirroring :class:`~repro_torch.data.minibatch.ABABatchSequencer`):
      features: (N, D) embedding (numpy array or tensor) anticlustered into
        K = N // batch_size batches.  The constructor's cold partition
        builds the engine's one solve closure; every later epoch
        warm-starts it (``engine.compile_count`` stays 1).
      batch_size: examples per step.
      seed: drives the per-epoch batch-order permutation (bit-identical to
        the sequencer's).
      chunk_size / max_k / mesh / data_axes: forwarded to the engine spec
        exactly as the sequencer forwards them (a mesh session dispatches
        its shards' solves the same way).
      solver: optional LAP backend override (registry name).  Host-callback
        backends (``"scipy"``) force the loud synchronous fallback.
      device: ``None`` runs on the CUDA device (raising where there is
        none); ``"cpu"`` runs the plain PyTorch path.

    The engine runs with ``stats=False``: the diversity statistics are
    work outside the solve that does not change labels; call
    :meth:`diversity_stats` when you want the numbers.
    """

    def __init__(self, features, batch_size: int, *, max_k: int = 512,
                 seed: int = 0, chunk_size="auto", mesh=None,
                 data_axes="auto", solver: str | None = None, device=None):
        n = _shape(features)[0]
        self.batch_size = batch_size
        self.k = max(n // batch_size, 1)
        self.n_used = self.k * batch_size
        self.seed = seed
        spec = _auto_or_flat_spec(self.k, max_k, chunk_size, mesh=mesh,
                                  data_axes=data_axes).evolve(stats=False)
        if solver is not None:
            spec = spec.evolve(solver=solver)
        self.engine = AnticlusterEngine(spec, device=device)
        x0 = features[:self.n_used]
        self.result, self._state = self.engine.partition(x0)
        # double buffer: two (labels, batches) slots; the active one feeds
        # the current epoch's schedule, the other receives the in-flight
        # solve's results at the boundary, then they flip.
        self._slots: list[Any] = [None, None]
        self._active = 0
        self._fill_slot(self._active, self.result.labels.cpu().numpy())
        self.overlapped = bool(self.engine.overlap_capable(_shape(x0)))
        self._warned_sync = False

    # -- buffers -----------------------------------------------------------

    def _fill_slot(self, slot: int, labels: np.ndarray) -> None:
        self._slots[slot] = (labels, build_batch_schedule(labels, self.k))

    def _flip_to(self, labels: np.ndarray) -> None:
        back = 1 - self._active
        self._fill_slot(back, labels)
        self._active = back

    @property
    def labels(self) -> np.ndarray:
        """Current epoch's anticluster labels (the active buffer)."""
        return self._slots[self._active][0]

    @property
    def batches(self):
        """Current epoch's batch membership (the active buffer)."""
        return self._slots[self._active][1]

    def __len__(self) -> int:
        return self.k

    # -- stats -------------------------------------------------------------

    def diversity_stats(self, features):
        """(sd, range) of per-batch diversity under the current labels."""
        f = self.engine._rows(features[:self.n_used])
        div = diversity_per_cluster(
            f, torch.from_numpy(self.labels.astype(np.int64)).to(f.device),
            self.k).cpu().numpy()
        return float(div.std()), float(div.max() - div.min())

    # -- the iterator API --------------------------------------------------

    def epochs(self, n_epochs: int, *,
               features: Callable[[int], Any] | None = None,
               start_epoch: int = 0):
        """Yield :class:`PipelineEpoch` schedules for ``n_epochs`` epochs.

        ``features``: optional per-epoch embedding provider; ``features(e)``
        is warm-repartitioned to produce epoch ``e``'s batch membership for
        ``e > start_epoch`` (epoch ``start_epoch`` uses the current
        partition, like the sequencer's ``epoch(0)``).  The solve for epoch
        ``e+1`` is dispatched *before* epoch ``e`` is handed out, so it runs
        while the consumer trains; the epoch boundary is the one wait.
        ``None`` keeps batch membership static (no further solves) -- only
        the batch *order* rotates.

        With a host-callback solver the overlap is impossible; one
        ``RuntimeWarning`` fires and each solve runs synchronously at its
        epoch boundary instead (same bits, no overlap).
        """
        end = start_epoch + n_epochs
        pending = [None]
        try:
            yield from self._epochs(start_epoch, end, features, pending)
        finally:
            if pending[0] is not None:
                # the consumer abandoned the generator mid-flight: finish
                # the dispatched solve so that self._state is the state it
                # returns, not the one it consumed
                with obs.span("pipeline/wait", abandoned=True):
                    self.result, self._state = pending[0].wait()
                self._flip_to(self.result.labels.cpu().numpy())
                pending[0] = None

    def _epochs(self, start_epoch, end, features, pending):
        for e in range(start_epoch, end):
            if pending[0] is not None:
                # the epoch-boundary wait: how long the consumer stalled on
                # the overlapped solve (0 when it finished during training)
                with obs.span("pipeline/wait", epoch=e,
                              overlapped=self.overlapped):
                    self.result, self._state = pending[0].wait()
                self._flip_to(self.result.labels.cpu().numpy())
            pending[0] = None
            if features is not None and e + 1 < end:
                x_next = features(e + 1)[:self.n_used]
                obs.event("pipeline/dispatch", epoch=e + 1,
                          overlapped=self.overlapped)
                if self.overlapped:
                    pending[0] = self.engine.dispatch_repartition(
                        x_next, self._state)
                else:
                    if not self._warned_sync:
                        warnings.warn(
                            f"solver {self.engine.spec.solver!r} executes "
                            "via a host callback: epoch partitions cannot "
                            "overlap with training; falling back to "
                            "synchronous sequencing (same results, no "
                            "overlap)", RuntimeWarning, stacklevel=2)
                        self._warned_sync = True
                    pending[0] = _SyncSolve(self.engine, x_next, self._state)
            # the span brackets the consumer's whole epoch (the generator
            # resumes here when the next epoch is requested), so its length
            # is the training time the dispatched solve had to overlap with
            with obs.span("pipeline/epoch", epoch=e):
                yield PipelineEpoch(e, self.batches,
                                    epoch_order(self.seed, e, self.k))
