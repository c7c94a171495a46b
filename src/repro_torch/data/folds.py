"""Representative K-fold cross-validation via anticlustering, in PyTorch
(paper Section 1: Papenberg & Klau's CV application).

Counterpart of ``repro/data/folds.py``.  Each fold is an anticluster, so
folds mirror the full data distribution, and with ``categories`` (e.g.
class labels) the folds are also stratified exactly (constraint (5)).

Built on :class:`repro_torch.anticluster.AnticlusterEngine`: a CV harness
that rebuilds folds repeatedly passes one :func:`fold_engine` to every
:func:`aba_folds` call; one-off calls build a throwaway engine (the same
labels either way: a cold engine partition is bitwise the one-shot
``anticluster``).  At scale (``chunk_size="auto"``, from 65536 rows) the
folds stream; with categories the solver stays ``"auction"`` (the quota
mask cannot be factored), so on the card every LAP is one
``auction_phase_dense`` launch.
"""

from __future__ import annotations

import numpy as np

from repro_torch.anticluster import AnticlusterEngine, _host


def fold_engine(n_folds: int, *, categories=None, max_k: int = 512,
                chunk_size="auto", mesh=None, data_axes="auto",
                device=None) -> AnticlusterEngine:
    """An :class:`AnticlusterEngine` configured for ``n_folds`` CV folds.

    Reuse it across repeated ``aba_folds`` calls on same-shaped features
    (``aba_folds`` always runs the cold ``partition``, so fold labels stay
    reproducible run to run).  ``mesh`` builds the folds distributed (each
    data-parallel shard solves its own rows; ``categories`` then stratify
    per shard); ``n_folds`` must be divisible by the shard count or the
    engine falls back to the single-device flat solve with a
    ``RuntimeWarning``.  ``device=None`` is the CUDA device; ``"cpu"`` the
    plain path.
    """
    from repro_torch.data.minibatch import _auto_or_flat_spec
    spec = _auto_or_flat_spec(n_folds, max_k, chunk_size, mesh=mesh,
                              data_axes=data_axes).evolve(
        categories=categories)
    return AnticlusterEngine(spec, device=device)


def aba_folds(features, n_folds: int, *, categories=None, seed: int = 0,
              max_k: int = 512, engine: AnticlusterEngine | None = None,
              device=None):
    """Returns fold labels (N,) int32 in [0, n_folds), as a numpy array.

    Routes through the engine (and thereby the spec dispatcher), so
    ``n_folds`` larger than ``max_k`` takes the hierarchical plan, with
    ``categories`` too: the exact per-category constraint (5) holds for the
    final folds.  ``engine`` (from :func:`fold_engine`) lets repeated
    callers share one engine (a cold partition per call); when omitted a
    fresh engine is built per call on ``device``.
    """
    del seed  # ABA is deterministic; kept for API stability
    if engine is None:
        engine = fold_engine(n_folds, categories=categories, max_k=max_k,
                             chunk_size="auto", device=device)
    elif engine.spec.k != n_folds:
        raise ValueError(
            f"engine was built for k={engine.spec.k} folds but "
            f"n_folds={n_folds} was requested; build it with "
            f"fold_engine({n_folds}, ...)")
    elif (engine.spec.categories is None) != (categories is None) or (
            categories is not None
            and not np.array_equal(_host(engine.spec.categories),
                                   _host(categories))):
        raise ValueError(
            "engine stratification does not match this call: pass the same "
            "categories to fold_engine(...) and aba_folds(...)")
    res, _state = engine.partition(features)
    return res.labels.cpu().numpy()


def fold_partition(features, n_folds: int, *, max_k: int = 512,
                   chunk_size="auto", device=None):
    """Live representative folds: an :class:`IncrementalPartition`.

    For CV harnesses whose dataset changes between sweeps:
    ``part.update(added=..., removed=...)`` re-balances the folds through
    the delta path instead of rebuilding from scratch, and ``part.labels``
    / :func:`fold_splits` read the live assignment.  Stratification is not
    supported on the delta path -- stratified folds stay on
    :func:`aba_folds` + :func:`fold_engine`.
    """
    from repro_torch.data.minibatch import _auto_or_flat_spec
    from repro_torch.incremental import IncrementalPartition

    spec = _auto_or_flat_spec(n_folds, max_k, chunk_size)
    return IncrementalPartition(features, spec, device=device)


def fold_splits(labels, n_folds: int):
    """Yield (train_idx, val_idx) per fold (labels: an array or a
    tensor)."""
    labels = _host(labels)
    for f in range(n_folds):
        val = np.flatnonzero(labels == f)
        tr = np.flatnonzero(labels != f)
        yield tr, val
