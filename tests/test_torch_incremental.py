"""The port's delta updates (``AnticlusterEngine.update``,
``repro_torch.incremental``) against the JAX package on the CPU.

From the same carried state (a JAX session's, moved across with
``abastate_from_numpy``): kept rows keep their labels bit for bit,
balance is exact, and the objective is within 1e-3 relative of JAX's
``update`` (ROADMAP P1).  A zero delta and every fallback are bit for bit
the port's ``repartition`` of the post-delta rows with the carried state,
with JAX's ``RuntimeWarning``.  The host-side slot schedule is JAX's bit
for bit, ``delta_moments`` within 1e-5.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.anticluster import AnticlusterEngine as JaxEngine
from repro.core.aba import delta_moments as jax_delta_moments
from repro.incremental import _slot_schedule as jax_slot_schedule

from repro_torch import abastate_from_numpy
from repro_torch.anticluster import (ABAState, AnticlusterEngine,
                                     AnticlusterSpec, anticluster)
from repro_torch.core.aba import delta_moments
from repro_torch.core.objective import balance_ok, objective_centroid
from repro_torch.incremental import (IncrementalPartition, _carried_state,
                                     _slot_schedule)

CPU = "cpu"

ROUTES = {
    "flat": dict(k=8, plan=None),
    "fused": dict(k=8, plan=None, solver="auction_fused"),
    "hier": dict(k=6, plan=(2, 3)),
    "stream": dict(k=8, plan=None, chunk_size=64),
}


def _data(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _engine(**kw):
    return AnticlusterEngine(device=CPU, **kw)


def _objective(x, labels, k):
    return float(objective_centroid(torch.as_tensor(np.array(x)),
                                    torch.as_tensor(np.array(labels)), k))


def _counts_ok(labels, k):
    labels = np.array(labels)
    c = np.bincount(labels, minlength=k)
    n = len(labels)
    return c.min() >= n // k and c.max() <= -(-n // k)


def _jax_session(kw, x):
    """A JAX engine, its partition's state, and that state as the port's."""
    jeng = JaxEngine(**kw)
    _, jst = jeng.partition(jnp.asarray(x))
    return jeng, jst, abastate_from_numpy(jax.device_get(jst), CPU)


def _runtime_warnings(record):
    return [str(w.message) for w in record
            if issubclass(w.category, RuntimeWarning)]


# ---------------------------------------------------------------------------
# the host schedule and the moments, against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,r,m", [(8, 200, 0, 12), (8, 240, 8, 3),
                                     (16, 800, 40, 40), (5, 101, 7, 9),
                                     (32, 4096, 100, 60)])
def test_slot_schedule_equals_jax(k, n, r, m):
    rng = np.random.default_rng(n + m)
    labels = rng.permutation(np.arange(n) % k)
    keep = np.ones(n, bool)
    keep[rng.choice(n, size=r, replace=False)] = False
    sizes_kept = np.bincount(labels[keep], minlength=k)
    new_n = n - r + m
    args = (sizes_kept, m, new_n // k, -(-new_n // k))
    for got, want in zip(_slot_schedule(*args), jax_slot_schedule(*args)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_delta_moments_equal_jax():
    x = _data(300, 6, 1)
    added, removed = _data(17, 6, 2), x[:23]
    msum, mcnt = x.sum(0), np.float32(300)
    got = delta_moments(torch.from_numpy(msum), torch.tensor(mcnt),
                        added=torch.from_numpy(added),
                        removed=torch.from_numpy(removed))
    want = jax_delta_moments(jnp.asarray(msum), jnp.asarray(mcnt),
                             added=jnp.asarray(added),
                             removed=jnp.asarray(removed))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert float(got[1]) == 294.0


# ---------------------------------------------------------------------------
# the delta path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route", list(ROUTES))
def test_update_matches_jax_from_the_same_state(route):
    kw = ROUTES[route]
    x = _data(400, 5, 3)
    jeng, jst, state = _jax_session(kw, x)
    prev = state.prev_labels.numpy()
    added = _data(20, 5, 4)
    rem = np.sort(np.random.default_rng(5).choice(400, 20, replace=False))
    res, new_x, st2 = _engine(**kw).update(x, state, added=added,
                                           removed=rem)
    jres, jnew_x, _ = jeng.update(jnp.asarray(x), jst,
                                  added=jnp.asarray(added), removed=rem)
    assert res.updated and jres.updated
    keep = np.ones(400, bool)
    keep[rem] = False
    np.testing.assert_array_equal(res.labels[:380].numpy(), prev[keep])
    np.testing.assert_array_equal(new_x.numpy(), np.asarray(jnew_x))
    k = kw["k"]
    assert res.balanced and balance_ok(res.labels, k, 400)
    o, o_jax = _objective(new_x, res.labels, k), _objective(new_x,
                                                            jres.labels, k)
    assert abs(o - o_jax) / abs(o_jax) < 1e-3
    assert torch.equal(st2.prev_labels, res.labels)
    assert [p.shape for p in st2.prices] == [p.shape for p in state.prices]
    np.testing.assert_allclose(st2.prices[-1].amax(dim=-1).numpy(), 0.0)


@pytest.mark.parametrize("route", list(ROUTES))
def test_update_added_keeps_balance_and_kept_labels(route):
    eng = _engine(**ROUTES[route])
    x = _data(200, 5, 3)
    res0, st = eng.partition(x)
    res, new_x, st2 = eng.update(x, st, added=_data(12, 5, 4))
    assert res.updated and new_x.shape == (212, 5)
    assert torch.equal(res.labels[:200], res0.labels)
    assert torch.equal(new_x[:200], torch.from_numpy(x))
    assert _counts_ok(res.labels, eng.spec.k)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # fallback allowed
        res3, _, _ = eng.update(new_x, st2, removed=np.arange(6))
    assert _counts_ok(res3.labels, eng.spec.k)


def test_update_removed_only_keeps_labels_when_balanced():
    eng = _engine(k=8, plan=None)
    x = _data(240, 4, 5)
    res0, st = eng.partition(x)
    lab0 = res0.labels.numpy()
    rem = np.array([np.flatnonzero(lab0 == c)[0] for c in range(8)])
    res, new_x, _ = eng.update(x, st, removed=rem)
    keep = np.ones(240, bool)
    keep[rem] = False
    assert res.updated and new_x.shape == (232, 4)
    np.testing.assert_array_equal(res.labels.numpy(), lab0[keep])
    np.testing.assert_array_equal(new_x.numpy(), x[keep])


def test_update_removed_bool_mask_equals_indices():
    eng = _engine(k=5, plan=None)
    x = _data(150, 3, 9)
    _, st = eng.partition(x)
    rem = np.array([3, 50, 149])
    mask = np.zeros(150, bool)
    mask[rem] = True
    res_a, xa, _ = eng.update(x, st, removed=rem)
    res_b, xb, _ = eng.update(x, st, removed=torch.from_numpy(mask))
    assert torch.equal(res_a.labels, res_b.labels) and torch.equal(xa, xb)


@pytest.mark.parametrize("m", [1, 7, 20])
def test_update_add_then_remove_restores_balance(m):
    eng = _engine(k=6, plan=None)
    x = _data(120, 4, seed=m % 97)
    _, st = eng.partition(x)
    res1, x1, st1 = eng.update(x, st, added=_data(m, 4, seed=m))
    assert _counts_ok(res1.labels, 6)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)  # fallback allowed
        res2, x2, _ = eng.update(x1, st1, removed=np.arange(120, 120 + m))
    assert torch.equal(x2, torch.from_numpy(x))
    assert _counts_ok(res2.labels, 6)


def test_update_is_deterministic():
    eng = _engine(k=16, plan=None)
    x = _data(800, 8, 6)
    _, st = eng.partition(x)
    rem = np.sort(np.random.default_rng(8).choice(800, 40, replace=False))
    added = _data(40, 8, 7)
    a, _, sa = eng.update(x, st, added=added, removed=rem)
    b, _, sb = eng.update(x, st, added=added, removed=rem)
    assert a.updated and torch.equal(a.labels, b.labels)
    assert torch.equal(sa.prices[0], sb.prices[0])


def test_update_carries_certificate_when_stats():
    x = _data(200, 5, 14)
    added = _data(10, 5, 15)
    eng = _engine(k=8, plan=None)
    _, st = eng.partition(x)
    res, _, _ = eng.update(x, st, added=added)
    assert res.updated and float(res.gap) >= 0.0
    eng2 = _engine(k=8, plan=None, stats=False)
    _, st2 = eng2.partition(x)
    res2, _, _ = eng2.update(x, st2, added=added)
    assert res2.dual_bound is None and res2.gap is None


# ---------------------------------------------------------------------------
# a zero delta and the fallbacks: the port's repartition, bit for bit
# ---------------------------------------------------------------------------

def test_zero_delta_is_repartition_bitwise():
    eng = _engine(k=8, plan=None)
    x = _data(160, 4, 10)
    _, st = eng.partition(x)
    res_u, new_x, st_u = eng.update(x, st)
    res_r, st_r = eng.repartition(x, st)
    assert torch.equal(res_u.labels, res_r.labels)
    assert torch.equal(new_x, torch.from_numpy(x))
    for pu, pr in zip(st_u.prices, st_r.prices):
        assert torch.equal(pu, pr)


@pytest.mark.parametrize("case", ["threshold", "ceiling", "floor"])
def test_fallback_is_repartition_bitwise_with_jax_warning(case):
    kw = dict(k=6, plan=None, update_threshold=0.1 if case == "threshold"
              else 0.25)
    x = _data(120, 4, 13)
    jeng, jst, state = _jax_session(kw, x)
    prev = state.prev_labels.numpy()
    added = removed = None
    if case == "threshold":
        added = _data(40, 4, 12)       # 40 / 160 > 0.1
    elif case == "ceiling":
        removed = np.flatnonzero(prev == 0)[:15]
    else:                              # 12 rows short, 2 arrive
        removed = np.concatenate([np.flatnonzero(prev == c)[:3]
                                  for c in range(4)])
        added = _data(2, 4, 14)
    eng = _engine(**kw)
    with pytest.warns(RuntimeWarning) as record:
        res_u, new_x, _ = eng.update(x, state, added=added, removed=removed)
    with pytest.warns(RuntimeWarning) as jrecord:
        jeng.update(jnp.asarray(x), jst,
                    added=None if added is None else jnp.asarray(added),
                    removed=removed)
    assert _runtime_warnings(record) == _runtime_warnings(jrecord)
    assert "full warm repartition" in _runtime_warnings(record)[0]
    assert res_u.updated is False
    keep = np.ones(120, bool)
    if removed is not None:
        keep[removed] = False
    ref_x = torch.from_numpy(x[keep] if added is None
                             else np.concatenate([x[keep], added]))
    carried = _carried_state(
        state, ref_x.shape[0],
        None if added is None else torch.from_numpy(added),
        None if removed is None else torch.from_numpy(x[~keep]))
    res_r, _ = eng.repartition(ref_x, carried)
    assert torch.equal(res_u.labels, res_r.labels)
    assert torch.equal(new_x, ref_x)
    assert _counts_ok(res_u.labels, 6)


# ---------------------------------------------------------------------------
# guards
# ---------------------------------------------------------------------------

def test_update_guards():
    eng = _engine(k=4, plan=None)
    x = _data(64, 3, 16)
    _, st = eng.partition(x)
    with pytest.raises(TypeError, match="ABAState"):
        eng.update(x, {"prices": None})
    with pytest.raises(ValueError, match=r"added must be \(m, 3\)"):
        eng.update(x, st, added=np.ones((5, 7), np.float32))
    with pytest.raises(ValueError, match="must be unique"):
        eng.update(x, st, removed=np.array([1, 1, 2]))
    with pytest.raises(ValueError, match=r"in \[0, 64\)"):
        eng.update(x, st, removed=np.array([64]))
    with pytest.raises(ValueError, match="fewer than k"):
        eng.update(x, st, removed=np.arange(62))
    with pytest.raises(NotImplementedError, match="one group at a time"):
        eng.update(np.zeros((2, 64, 3), np.float32), st,
                   added=np.ones((1, 3)))
    cat_eng = _engine(k=4, plan=None, categories=np.zeros(64, np.int32),
                      n_categories=1)
    _, cat_st = cat_eng.partition(x)
    with pytest.raises(NotImplementedError, match="category-free"):
        cat_eng.update(x, cat_st, added=np.ones((2, 3), np.float32))
    masked = _engine(k=4, plan=None, valid_mask=np.ones(64, bool))
    _, m_st = masked.partition(x)
    with pytest.raises(NotImplementedError, match="valid_mask"):
        masked.update(x, m_st, added=np.ones((2, 3), np.float32))


def test_update_requires_prev_labels():
    eng = _engine(k=4, plan=None)
    x = _data(64, 3, 17)
    _, st = eng.partition(x)
    stale = ABAState(prices=st.prices, moment_sum=st.moment_sum,
                     moment_count=st.moment_count,
                     prev_labels=torch.full((64,), -1, dtype=torch.int32))
    with pytest.raises(ValueError, match="prev_labels"):
        eng.update(x, stale, added=np.ones((2, 3), np.float32))


# ---------------------------------------------------------------------------
# IncrementalPartition
# ---------------------------------------------------------------------------

def test_incremental_partition_lifecycle():
    x0 = _data(128, 4, 18)
    part = IncrementalPartition(x0, k=8, device=CPU)
    assert part.n == len(part) == 128 and part.k == 8
    assert torch.equal(part.labels, anticluster(x0, k=8, device=CPU).labels)
    res = part.update(added=_data(9, 4, 19))
    assert res.updated and part.n == 137 and res is part.result
    assert _counts_ok(part.labels, 8)
    res2 = part.update(removed=np.arange(5))
    assert part.n == 132 and _counts_ok(part.labels, 8)
    assert res2.labels.shape == (132,) and part.x.shape == (132, 4)
    res3 = part.repartition()
    assert _counts_ok(res3.labels, 8) and part.n == 132


def test_incremental_partition_engine_sharing_and_guards():
    eng = _engine(k=4, plan=None)
    a = IncrementalPartition(_data(64, 3, 20), engine=eng)
    b = IncrementalPartition(_data(64, 3, 21), engine=eng)
    assert eng.compile_count == 1
    a.update(added=_data(3, 3, 22))
    assert a.n == 67 and b.n == 64
    with pytest.raises(ValueError, match="not both"):
        IncrementalPartition(_data(64, 3), AnticlusterSpec(k=4), engine=eng)
