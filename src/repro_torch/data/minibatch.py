"""ABA mini-batch sequencing for SGD, in PyTorch -- the paper's headline ML
application.

Counterpart of ``repro/data/minibatch.py``.  Each anticluster is one
mini-batch: K = steps per epoch, so every batch is a diverse,
representative sample of the dataset (Section 1).  ABA is deterministic,
so the batch schedule is reproducible bit for bit after a restart.

The sequencer owns ONE :class:`repro_torch.anticluster.AnticlusterEngine`
for the whole training run: the initial partition builds the engine's
solve closure once, and per-epoch re-partitions (``epoch(i, features=...)``
/ ``refresh``) warm-start the auction from the carried :class:`ABAState`
(``engine.compile_count`` stays 1 across epochs).  At epoch scale
(``chunk_size="auto"``, from 65536 rows) the solve is the stream route
with ``"auction_fused"``: on the card every LAP is one ``bid_top2`` span
launch and one ``auction_phase`` launch a phase.  The numpy parts
(:func:`build_batch_schedule`, :func:`epoch_order`,
:func:`random_sequencer_batches`) are the reference's, bit for bit.

With ``mesh=`` (a :class:`repro_torch.sharding.Mesh`) the engine is a
sharded session: each data-parallel shard re-partitions its own rows from
its own carried prices (:class:`repro_torch.anticluster.ShardedABAState`),
the shards being the first level of the hierarchy.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch.anticluster import AnticlusterEngine, AnticlusterSpec
from repro_torch.core.objective import diversity_per_cluster
from repro_torch.sharding.specs import resolve_data_axes


def _auto_or_flat_spec(k: int, max_k: int, chunk_size="auto", mesh=None,
                       data_axes="auto") -> AnticlusterSpec:
    """Auto-plan spec, falling back to the flat path when k is unfactorable.

    ``default_plan`` enforces its max_k contract by raising ``ValueError``
    (e.g. prime k > max_k).  Here k is derived from the data size, not
    chosen by the user, so a slow-but-correct flat solve beats a crash --
    but loudly.  ``chunk_size`` defaults to "auto": epoch-scale datasets
    stream the full-data level in fixed-size chunks; small datasets stay
    dense.  ``mesh`` distributes the solve (shard-local streaming composes);
    a k that cannot be placed on the mesh (not divisible by the shard
    count, or an unfactorable per-shard k) falls back to the local flat
    solve, again loudly.
    """
    if mesh is not None:
        resolve_data_axes(mesh, data_axes)  # bad axes raise; no fallback
    spec = AnticlusterSpec(k=k, plan="auto", max_k=max_k,
                           chunk_size=chunk_size, mesh=mesh,
                           data_axes=data_axes)
    try:
        spec.resolve_plan()
        return spec
    except ValueError:
        where = ("placement on the mesh" if mesh is not None
                 else f"hierarchical plan with factors <= {max_k}")
        warnings.warn(
            f"k={k} has no {where}; falling back to the flat single-level "
            "single-device solve (slower at this k)",
            RuntimeWarning, stacklevel=3)
        return spec.evolve(plan=None, mesh=None)


def build_batch_schedule(labels: np.ndarray, k: int):
    """Anticluster labels -> per-batch index arrays (the batch membership).

    One batch per anticluster, rows in stable-sort order: a (k, n/k) array
    when k divides n, else a ragged list of per-batch index arrays
    (floor/ceil sizes -- a grown sequencer).
    """
    labels = np.asarray(labels)
    order = np.argsort(labels, kind="stable")
    sizes = np.bincount(labels, minlength=k)
    if sizes.min() == sizes.max():
        # anticluster sizes are all exactly batch_size when K | N; a
        # 2D array keeps the historical batches contract
        return order.reshape(k, -1)
    # floor/ceil batch sizes: the schedule is ragged (list of index arrays)
    return np.split(order, np.cumsum(sizes)[:-1])


def epoch_order(seed: int, epoch_idx: int, k: int) -> np.ndarray:
    """The deterministic per-epoch batch order (counter-based rng): the
    permutation depends only on ``(seed, epoch_idx)``."""
    return np.random.default_rng(seed * 100003 + epoch_idx).permutation(k)


def _shape(a) -> tuple[int, ...]:
    return tuple(a.shape) if isinstance(a, torch.Tensor) \
        else tuple(np.shape(a))


def _dtype_kind(a) -> tuple[str, str]:
    """(numpy dtype kind, dtype name) of an array or a tensor."""
    if isinstance(a, torch.Tensor):
        name = str(a.dtype).replace("torch.", "")
        if a.dtype == torch.bool:
            return "b", name
        if a.dtype.is_complex:
            return "c", name
        return ("f" if a.dtype.is_floating_point else "i"), name
    dt = np.asarray(a).dtype
    return dt.kind, str(dt)


class ABABatchSequencer:
    """Deterministic diverse mini-batch schedule over a dataset.

    Holds one :class:`AnticlusterEngine` for the training run.  The
    constructor's cold partition builds the engine's solve closure; every
    later re-partition (``refresh`` / ``epoch(i, features=...)`` on drifted
    embeddings) reuses it with warm-started auction prices
    (``self.engine.compile_count == 1``).

    Args:
      features: (N, D) embedding used for anticlustering (a numpy array or
        a tensor).
      batch_size: examples per step; K = floor(N / batch_size) anticlusters.
      chunk_size: streaming execution for epoch-scale feature sets (see
        ``AnticlusterSpec.chunk_size``); "auto" engages only at scale.
      mesh: optional :class:`repro_torch.sharding.Mesh` -- the engine
        carries per-shard warm prices (``ShardedABAState``) across epochs,
        so each data-parallel shard re-partitions its own rows.  K must be
        divisible by the shard count (else a loud flat fallback).
      data_axes: mesh axes sharding the rows ("auto": whichever of
        ('pod', 'data') the mesh has; explicit absent axes raise).
      device: ``None`` runs on the CUDA device (raising where there is
        none); ``"cpu"`` runs the plain PyTorch path.
    """

    def __init__(self, features, batch_size: int, *, max_k: int = 512,
                 seed: int = 0, chunk_size="auto", mesh=None,
                 data_axes="auto", device=None):
        n = _shape(features)[0]
        self.batch_size = batch_size
        self.k = max(n // batch_size, 1)
        self.n_used = self.k * batch_size
        self.seed = seed
        self.engine = AnticlusterEngine(
            _auto_or_flat_spec(self.k, max_k, chunk_size, mesh=mesh,
                               data_axes=data_axes), device=device)
        self.result, self.state = self.engine.partition(
            features[:self.n_used])
        self._features = features
        self._sig = ((self.n_used,) + _shape(features)[1:],
                     str(self.engine.spec.dtype).replace("torch.", ""))
        self._rebuild_batches()

    def _check_signature(self, features):
        """Refuse features that don't match the engine's signature.

        The engine keys its solve closures by (shape, dtype): a refresh
        with a different row count or width would silently build another
        one (the carried flat prices are ``(1, k)``, independent of n and
        d, so the state check alone cannot catch it).  Raise up front with
        the expected signature instead; build a fresh sequencer for a
        genuinely new geometry.
        """
        shape, dtype = self._sig
        got = _shape(features)
        kind, name = _dtype_kind(features)
        if kind not in "fiu":
            raise TypeError(
                f"features dtype {name} is not numeric; the engine solves "
                f"{dtype} embeddings")
        if got[0] < shape[0] or got[1:] != shape[1:]:
            raise ValueError(
                f"features of shape {got} do not match the engine's "
                f"compiled signature {shape} (>= {shape[0]} rows of "
                f"trailing shape {shape[1:]}): a refresh must keep the "
                "partition geometry -- build a new ABABatchSequencer for a "
                "different dataset shape")

    def _rebuild_batches(self):
        self.batches = build_batch_schedule(
            self.result.labels.cpu().numpy(), self.k)

    def refresh(self, features):
        """Warm re-partition on updated (same-shape) features.

        The carried :class:`ABAState` warm-starts every batch LAP; the
        engine's solve closure is reused as-is.  Features whose shape or
        dtype don't match the signature raise up front.  Returns the new
        :class:`AnticlusterResult`.
        """
        self._check_signature(features)
        self.result, self.state = self.engine.repartition(
            features[:self.n_used], self.state)
        self._features = features
        self._rebuild_batches()
        return self.result

    def grow(self, added):
        """Absorb newly arrived examples into the live batch schedule.

        Routes through :meth:`AnticlusterEngine.update`: the arrivals are
        placed by the restricted warm-price auction against the carried
        per-batch centroids (one ``auction_phase_dense`` launch on the
        card) instead of re-solving the whole epoch; a delta above
        ``spec.update_threshold`` falls back to a full warm repartition,
        loudly.  K stays fixed; batch sizes become floor/ceil of the new
        N/K, so the schedule turns ragged.  Returns the new
        :class:`AnticlusterResult` (``.updated`` says which path ran).
        """
        self.result, new_x, self.state = self.engine.update(
            self._features[:self.n_used], self.state, added=added)
        self._features = new_x
        self.n_used = int(new_x.shape[0])
        # the grown geometry is the engine's signature from here on
        self._sig = ((self.n_used,) + tuple(new_x.shape[1:]), self._sig[1])
        self._rebuild_batches()
        return self.result

    def diversity_stats(self):
        """(sd, range) of the batches' diversity (the centroid-form sum of
        squared distances within each batch)."""
        f = self.engine._rows(self._features[:self.n_used])
        lab = np.zeros(self.n_used, np.int64)
        for b, idx in enumerate(self.batches):
            lab[idx] = b
        div = diversity_per_cluster(f, torch.from_numpy(lab).to(f.device),
                                    self.k).cpu().numpy()
        return float(div.std()), float(div.max() - div.min())

    def epoch(self, epoch_idx: int, features=None):
        """Batch index arrays for one epoch; order rotated deterministically.

        Pass ``features`` (same shape, drifted values) to warm re-partition
        first; omit it to reuse the existing batch membership.  Returns a
        list, so the re-partition happens eagerly.
        """
        if features is not None:
            self.refresh(features)
        return [self.batches[b]
                for b in epoch_order(self.seed, epoch_idx, self.k)]

    def __len__(self):
        return self.k


def random_sequencer_batches(n: int, batch_size: int, seed: int = 0):
    """Baseline: the standard random-shuffle batching."""
    k = n // batch_size
    rng = np.random.default_rng(seed)
    order = rng.permutation(k * batch_size)
    return order.reshape(k, batch_size)
