"""The port's data consumers (``repro_torch.data``) against the JAX package
on the CPU: the mini-batch sequencer and K-fold cross-validation.

The numpy parts (``build_batch_schedule``, ``epoch_order``,
``random_sequencer_batches``) are bitwise the reference's on shared
labels.  The solves are held to quality (ROADMAP P1): exact balance,
constraint (5) exactly with categories, and the objective within 1e-3
relative of JAX's on the same input.  The guards (signatures, engine
mismatches, the unfactorable-k fallback, ``mesh=``) raise as the
reference's do.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.objective import objective_centroid as jax_objective
from repro.data import folds as jax_folds
from repro.data import minibatch as jax_mb

from repro_torch.anticluster import AnticlusterEngine
from repro_torch.core.objective import (balance_ok, diversity_per_cluster,
                                        objective_centroid)
from repro_torch.data import (ABABatchSequencer, aba_folds, fold_engine,
                              fold_partition, fold_splits, synthetic)
from repro_torch.data import minibatch as mb
from repro_torch.launch.mesh import make_host_mesh

CPU = "cpu"


def _data(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _objective(x, labels, k):
    return float(objective_centroid(torch.from_numpy(np.asarray(x)),
                                    torch.as_tensor(np.asarray(labels)), k))


def _jax_objective(x, labels, k):
    return float(jax_objective(jnp.asarray(x), jnp.asarray(labels), k))


def _close(a, b, rel=1e-3):
    return abs(a - b) <= rel * abs(b)


# ---------------------------------------------------------------------------
# The numpy parts, bitwise
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(120, 8), (125, 8), (97, 5)],
                         ids=["even", "ragged", "ragged-prime"])
def test_batch_schedule_bitwise(n, k):
    labels = np.random.default_rng(n).permutation(np.arange(n) % k)
    ours = mb.build_batch_schedule(labels, k)
    ref = jax_mb.build_batch_schedule(labels, k)
    assert type(ours) is type(ref)
    assert len(ours) == len(ref) == k
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,epoch", [(0, 0), (3, 7), (11, 2)])
def test_epoch_order_and_random_batches_bitwise(seed, epoch):
    np.testing.assert_array_equal(mb.epoch_order(seed, epoch, 37),
                                  jax_mb.epoch_order(seed, epoch, 37))
    np.testing.assert_array_equal(
        mb.random_sequencer_batches(1000, 64, seed),
        jax_mb.random_sequencer_batches(1000, 64, seed))


# ---------------------------------------------------------------------------
# The sequencer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [None, 128], ids=["flat", "stream"])
def test_sequencer_matches_jax(chunk):
    x = _data(650, 5, seed=1)
    seq = ABABatchSequencer(x, 40, chunk_size=chunk, device=CPU)
    ref = jax_mb.ABABatchSequencer(x, 40, chunk_size=chunk)
    assert (seq.k, seq.n_used, len(seq)) == (ref.k, ref.n_used, len(ref))
    assert seq.result.route == ("stream" if chunk else "flat")
    assert isinstance(seq.batches, np.ndarray)
    assert seq.batches.shape == np.asarray(ref.batches).shape
    lab = seq.result.labels.numpy()
    assert balance_ok(lab, seq.k)
    ofv = _objective(x[:seq.n_used], lab, seq.k)
    assert _close(ofv, _jax_objective(x[:ref.n_used], ref.result.labels,
                                      ref.k))
    # every epoch is a permutation of the same batches
    ep = seq.epoch(3)
    np.testing.assert_array_equal(np.sort(np.concatenate(ep)),
                                  np.arange(seq.n_used))
    # diverse batches beat the random-shuffle baseline
    sd, rng = seq.diversity_stats()
    rand = mb.random_sequencer_batches(seq.n_used, 40, 0)
    lab_r = np.zeros(seq.n_used, np.int64)
    for b, idx in enumerate(rand):
        lab_r[idx] = b
    dr = diversity_per_cluster(torch.from_numpy(x[:seq.n_used]),
                               torch.from_numpy(lab_r), seq.k).numpy()
    assert sd < float(dr.std()) and rng < float(dr.max() - dr.min())


def test_sequencer_same_schedule_twice_and_warm_epochs():
    x = _data(480, 4, seed=2)
    a = ABABatchSequencer(x, 32, device=CPU)
    b = ABABatchSequencer(x, 32, device=CPU)
    np.testing.assert_array_equal(a.batches, b.batches)
    drift = x + 0.01 * _data(480, 4, seed=3)
    for e in (1, 2):
        ea = a.epoch(e, features=drift)
        eb = b.epoch(e, features=drift)
        for u, v in zip(ea, eb):
            np.testing.assert_array_equal(u, v)
    assert a.engine.compile_count == 1
    assert a.result.balanced


def test_sequencer_signature_errors_match_jax():
    x = _data(256, 4, seed=4)
    seq = ABABatchSequencer(x, 32, device=CPU)
    ref = jax_mb.ABABatchSequencer(x, 32)
    for bad in (_data(200, 4), _data(256, 5)):
        with pytest.raises(ValueError) as ours:
            seq.refresh(bad)
        with pytest.raises(ValueError) as theirs:
            ref.refresh(bad)
        assert str(ours.value) == str(theirs.value)
    with pytest.raises(TypeError, match="not numeric"):
        seq.refresh(np.zeros((256, 4), dtype=bool))
    with pytest.raises(TypeError, match="not numeric"):
        ref.refresh(np.zeros((256, 4), dtype=bool))
    with pytest.raises(TypeError, match="not numeric"):
        seq.refresh(torch.zeros((256, 4), dtype=torch.bool))
    # more rows than the signature are fine (the extra rows are unused)
    seq.refresh(_data(300, 4, seed=5))


def test_sequencer_ragged_grow():
    x = _data(320, 4, seed=6)
    seq = ABABatchSequencer(x, 32, device=CPU)
    ref = jax_mb.ABABatchSequencer(x, 32)
    added = _data(13, 4, seed=7)
    res = seq.grow(added)
    jres = ref.grow(added)
    assert res.updated == jres.updated
    assert seq.n_used == ref.n_used == 333
    sizes = sorted(len(b) for b in seq.batches)
    assert sizes == sorted(len(b) for b in ref.batches)
    assert sizes[0] == 333 // 10 and sizes[-1] == -(-333 // 10)
    assert isinstance(seq.batches, list)
    np.testing.assert_array_equal(np.sort(np.concatenate(seq.batches)),
                                  np.arange(333))
    # the grown geometry is the signature from here on
    with pytest.raises(ValueError, match="signature"):
        seq.refresh(x)
    seq.refresh(seq._features.numpy() + 0.0)
    assert seq.engine.compile_count == 2


def test_unfactorable_k_falls_back_to_flat_loudly():
    with pytest.warns(RuntimeWarning, match="falling back"):
        spec = mb._auto_or_flat_spec(523, 512)
    with pytest.warns(RuntimeWarning, match="falling back"):
        ref = jax_mb._auto_or_flat_spec(523, 512)
    assert spec.plan is None and ref.plan is None
    assert spec.resolve_plan() == ref.resolve_plan() == (523,)
    with warnings.catch_warnings():
        warnings.simplefilter("error", RuntimeWarning)
        assert mb._auto_or_flat_spec(600, 512).resolve_plan() == \
            jax_mb._auto_or_flat_spec(600, 512).resolve_plan()


def test_mesh_raises_naming_the_mesh_route():
    """The mesh route is ported: the spec helper, the sequencer and the
    folds take a 1-shard port mesh and hold to JAX's 1-device mesh (the
    same plan; exact balance and the objective within 1e-3 relative)."""
    import jax
    from jax.sharding import Mesh
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    mesh = make_host_mesh(1, 1, device=CPU)
    spec = mb._auto_or_flat_spec(4, 512, mesh=mesh)
    assert spec.mesh is mesh
    assert spec.resolve_plan() == \
        jax_mb._auto_or_flat_spec(4, 512, mesh=jmesh).resolve_plan()
    x = _data(64, 3)
    seq = ABABatchSequencer(x, 16, mesh=mesh, device=CPU)
    jseq = jax_mb.ABABatchSequencer(x, 16, mesh=jmesh)
    assert seq.result.route == "mesh" and seq.result.plan == jseq.result.plan
    folds = aba_folds(x, 4, engine=fold_engine(4, mesh=mesh, device=CPU))
    jfolds = jax_folds.aba_folds(x, 4, engine=jax_folds.fold_engine(
        4, mesh=jmesh))
    for labels, ref in ((seq.result.labels.numpy(), jseq.result.labels),
                        (folds, jfolds)):
        ref = np.array(ref)
        assert balance_ok(labels, 4)
        assert _close(_objective(x, labels, 4), _jax_objective(x, ref, 4))


# ---------------------------------------------------------------------------
# Folds
# ---------------------------------------------------------------------------

def _assert_stratified(labels, cats, n_folds):
    """Constraint (5): each fold holds floor or ceil of every category's
    count over the folds."""
    for c in np.unique(cats):
        cnt = np.bincount(labels[cats == c], minlength=n_folds)
        total = int((cats == c).sum())
        assert cnt.min() >= total // n_folds
        assert cnt.max() <= -(-total // n_folds)


@pytest.mark.parametrize("n_folds,chunk", [(5, None), (10, None), (6, 120)],
                         ids=["5-dense", "10-dense", "6-stream"])
def test_folds_stratified_and_close_to_jax(n_folds, chunk):
    x = _data(600, 6, seed=n_folds)
    cats = np.random.default_rng(n_folds).integers(0, 3, 600)
    if chunk is None:
        labels = aba_folds(x, n_folds, categories=cats, device=CPU)
    else:
        eng = AnticlusterEngine(fold_engine(
            n_folds, categories=cats, device=CPU).spec.evolve(
                chunk_size=chunk), device=CPU)
        labels = aba_folds(x, n_folds, categories=cats, engine=eng)
        assert eng._routed(x.shape)[0] == "stream"
        assert eng._routed(x.shape)[2] == "auction"
    ref = jax_folds.aba_folds(x, n_folds, categories=cats)
    assert labels.dtype == np.int32 and labels.shape == (600,)
    assert balance_ok(labels, n_folds)
    _assert_stratified(labels, cats, n_folds)
    assert _close(_objective(x, labels, n_folds),
                  _jax_objective(x, ref, n_folds))
    seen = np.concatenate([val for _tr, val in fold_splits(labels, n_folds)])
    np.testing.assert_array_equal(np.sort(seen), np.arange(600))


def test_fold_engine_reuse_and_mismatch_errors_match_jax():
    x = _data(300, 4, seed=8)
    cats = np.random.default_rng(8).integers(0, 2, 300)
    eng = fold_engine(5, categories=cats, device=CPU)
    jeng = jax_folds.fold_engine(5, categories=cats)
    a = aba_folds(x, 5, categories=cats, engine=eng)
    b = aba_folds(x, 5, categories=cats, engine=eng)
    np.testing.assert_array_equal(a, b)    # a cold partition each call
    np.testing.assert_array_equal(a, aba_folds(x, 5, categories=cats,
                                               device=CPU))
    for kw in ({"n_folds": 4, "categories": cats},
               {"n_folds": 5, "categories": None},
               {"n_folds": 5, "categories": 1 - cats}):
        with pytest.raises(ValueError) as ours:
            aba_folds(x, engine=eng, **kw)
        with pytest.raises(ValueError) as theirs:
            jax_folds.aba_folds(x, engine=jeng, **kw)
        assert str(ours.value) == str(theirs.value)


def test_fold_partition_update_and_splits():
    x = _data(400, 5, seed=9)
    part = fold_partition(x, 8, device=CPU)
    ref = jax_folds.fold_partition(x, 8)
    assert _close(_objective(x, part.labels.numpy(), 8),
                  _jax_objective(x, ref.labels, 8))
    res = part.update(added=_data(4, 5, seed=10), removed=np.arange(4))
    assert res.updated and part.n == 400
    assert balance_ok(part.labels.numpy(), 8)
    splits = list(fold_splits(part.labels, 8))
    assert len(splits) == 8
    for tr, val in splits:
        assert len(tr) + len(val) == 400
        assert np.intersect1d(tr, val).size == 0


def test_data_entry_points_default_to_cuda():
    x = _data(128, 3)
    if torch.cuda.is_available():
        assert ABABatchSequencer(x, 16).result.labels.is_cuda
    else:
        for call in (lambda: ABABatchSequencer(x, 16),
                     lambda: aba_folds(x, 4),
                     lambda: fold_partition(x, 4)):
            with pytest.raises(RuntimeError, match="CUDA"):
                call()
    assert synthetic.make is not None
