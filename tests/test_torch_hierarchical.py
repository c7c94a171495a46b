"""The hierarchical route (paper Section 4.4) and k-plus in the port, against
the JAX package.

Bitwise against JAX: the plan search (``default_plan`` / ``_plan_search``,
their errors too), ``plan_price_shapes``, ``_regroup``'s index matrix and
mask, and the route.  Within 1e-6 relative: ``kplus_augment`` and
``moment_spread`` (float64 sums in another order, then float32).  On
quality, as every solve of the port (its labels differ from JAX's, ROADMAP
departure P1): exact balance, constraint (5) exact, the objective within
1e-3 relative of JAX's, a finite gap >= 0.  Inside the port, bitwise: a
covering chunk equals the dense hierarchical route, and ``batched=False``
equals ``batched=True``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.anticluster import AnticlusterSpec as JaxSpec
from repro.anticluster import _route as jax_route
from repro.anticluster import anticluster as jax_anticluster
from repro.core import hierarchical as jax_hier
from repro.core import kplus as jax_kplus
from repro.core.objective import objective_centroid as jax_objective

from repro_torch.anticluster import AnticlusterSpec, _route, anticluster
from repro_torch.core import hierarchical as hier
from repro_torch.core.kplus import kplus_augment, moment_spread
from repro_torch.core.objective import objective_centroid

CPU = "cpu"

# (n, k, spec fields): plan (4, 6) at n = 600, d = 6, and three levels
# from the plan search, (5, 4, 5), at n = 2000
SHAPES = {"n600-plan4x6": (600, 24, {"plan": (4, 6)}),
          "n2000-k100-maxk9": (2000, 100, {"max_k": 9})}


def _data(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _cats(n, c, seed=1):
    return np.random.default_rng(seed).integers(0, c, size=n).astype(np.int32)


def _stratified(labels, attr, k):
    """Constraint (5): each level's count in every cluster within
    floor(|N|/k)..ceil(|N|/k)."""
    labels = np.asarray(labels)
    for v in np.unique(attr):
        cnt = np.bincount(labels[attr == v], minlength=k)
        size = int((attr == v).sum())
        if cnt.min() < size // k or cnt.max() > -(-size // k):
            return False
    return True


def _excess(labels, attrs, k):
    """The largest quota excess: max over the attributes' levels and the
    clusters of count - ceil(|N_level| / k)."""
    labels = np.asarray(labels)
    return max(int(np.bincount(labels[a == v], minlength=k).max())
               - -(-int((a == v).sum()) // k)
               for a in attrs for v in np.unique(a))


@pytest.mark.parametrize("max_k", [2, 3, 9, 30, 512])
def test_default_plan_matches_jax(max_k):
    """Every k up to 700 and a few large ones: the same plan, or the same
    ValueError (k prime, or a prime factor above max_k)."""
    for k in list(range(1, 701)) + [4096, 5000, 65536, 131072, 1 << 20,
                                    1009 * 4, 3 ** 11]:
        assert hier._plan_search(k, max_k) == jax_hier._plan_search(k, max_k)
        try:
            want = jax_hier.default_plan(k, max_k)
        except ValueError as e:
            with pytest.raises(ValueError, match="no factorization"):
                hier.default_plan(k, max_k)
            assert "no factorization" in str(e)
            continue
        assert hier.default_plan(k, max_k) == want
    with pytest.raises(ValueError, match="must be >= 1"):
        hier.default_plan(0, max_k)


@pytest.mark.parametrize("plan", [(24,), (4, 6), (5, 4, 5), (64, 64),
                                  (256, 512)])
def test_plan_price_shapes_matches_jax(plan):
    assert hier.plan_price_shapes(plan) == jax_hier.plan_price_shapes(plan)


@pytest.mark.parametrize("n,groups,seed", [(600, 4, 0), (2000, 5, 1),
                                           (97, 7, 2)])
def test_regroup_matches_jax_bitwise(n, groups, seed):
    """Random labels (uneven groups, some rows invalid): the index matrix
    and the mask equal JAX's."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, groups, size=n).astype(np.int32)
    valid = rng.random(n) > 0.1
    m = int(np.bincount(labels[valid], minlength=groups).max()) + 2
    idx, ok = hier._regroup(torch.from_numpy(labels), torch.from_numpy(valid),
                            groups, m)
    j_idx, j_ok = jax_hier._regroup(jnp.asarray(labels), jnp.asarray(valid),
                                    groups, m)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(j_ok))


def _variant_kw(name, n):
    """The spec fields of one variant of the solve on n rows."""
    return {"plain": {},
            "categories": {"categories": _cats(n, 3)},
            "fairness": {"fairness": [_cats(n, 3, seed=1),
                                      _cats(n, 2, seed=2)]},
            "chunk": {"chunk_size": 256},
            "fused": {"solver": "auction_fused"}}[name]


@pytest.mark.parametrize("variant", ["plain", "categories", "fairness",
                                     "chunk", "fused"])
@pytest.mark.parametrize("shape", list(SHAPES), ids=list(SHAPES))
def test_hierarchical_front_door_matches_jax_quality(shape, variant):
    """The ``"hier"`` route against the JAX front door on the same rows:
    JAX's resolved plan and solver, exact balance, constraint (5) exact
    under categories (the per-level quotas compose), under two fairness
    attributes a largest quota excess no worse than JAX's (best-effort in
    both packages, ROADMAP R6), the objective within 1e-3 relative of
    JAX's, a finite gap >= 0."""
    n, k, fields = SHAPES[shape]
    x = _data(n, 6)
    kw = {**fields, **_variant_kw(variant, n)}
    res = anticluster(x, k=k, device=CPU, **kw)
    want = jax_anticluster(jnp.asarray(x), k=k, **kw)
    assert res.route == "hier" and res.plan == want.plan
    assert len(res.plan) == (2 if shape.startswith("n600") else 3)
    assert res.solver == want.solver and res.balanced
    labels = res.labels.numpy()
    assert sorted(np.bincount(labels, minlength=k).tolist()) == \
        sorted(np.asarray(want.cluster_sizes).tolist())
    if "categories" in kw:
        assert _stratified(labels, kw["categories"], k)
    if "fairness" in kw:  # several attributes: no worse than JAX (R6)
        assert _excess(labels, kw["fairness"], k) <= \
            _excess(np.asarray(want.labels), kw["fairness"], k)
    ofv = float(objective_centroid(torch.from_numpy(x), res.labels, k))
    j_ofv = float(jax_objective(jnp.asarray(x), want.labels, k))
    assert abs(ofv - j_ofv) <= 1e-3 * abs(j_ofv), (ofv, j_ofv)
    gap = float(res.gap)
    assert np.isfinite(gap) and gap >= 0.0


@pytest.mark.parametrize("shape,solver", [
    ("n600-plan4x6", "auction"), ("n600-plan4x6", "auction_fused"),
    ("n2000-k100-maxk9", "auction")])
def test_covering_chunk_equals_dense_hierarchical_bitwise(shape, solver):
    """A chunk that covers every row streams level 1 as one chunk: the
    labels are the dense hierarchical route's, bit for bit."""
    n, k, fields = SHAPES[shape]
    x = _data(n, 6, seed=4)
    dense = anticluster(x, k=k, device=CPU, solver=solver, **fields)
    streamed = anticluster(x, k=k, device=CPU, solver=solver, chunk_size=n,
                           **fields)
    assert torch.equal(dense.labels, streamed.labels)


@pytest.mark.parametrize("variant", ["plain", "categories"])
@pytest.mark.parametrize("shape", ["n600-plan4x6"])
def test_unbatched_levels_equal_batched_bitwise(shape, variant):
    """``batched=False`` (one G = 1 solve a group) gives the labels of the
    stacked level solve, as the JAX docstring promises.  (Without the
    statistics: their certificate needs the level's prices, which only the
    stacked solve carries, in both packages.)"""
    n, k, fields = SHAPES[shape]
    x = _data(n, 6, seed=5)
    kw = {**fields, **_variant_kw(variant, n)}
    one = anticluster(x, k=k, device=CPU, stats=False, **kw)
    per_group = anticluster(x, k=k, device=CPU, batched=False, stats=False,
                            **kw)
    assert torch.equal(one.labels, per_group.labels)


def test_unbatched_levels_raise_as_jax():
    x = _data(200, 3)
    codes = np.zeros((200, 2), np.int32)
    for kw in ({"return_state": True}, {"prices": ((0,),)},
               {"categories": np.zeros(200, np.int32), "n_categories": 1,
                "fair_codes": codes, "n_fair_codes": 2}):
        with pytest.raises(NotImplementedError):
            jax_hier.hierarchical_core(jnp.asarray(x), (2, 2), batched=False,
                                       **kw)
        with pytest.raises(NotImplementedError):
            hier.hierarchical_core(x, (2, 2), batched=False, device=CPU, **kw)
    with pytest.raises(ValueError, match="prod"):
        hier.hierarchical_core(x, (20, 20), device=CPU)


def test_core_state_and_warm_prices_from_jax():
    """``hierarchical_core`` itself against JAX's on three levels: int32
    labels, exactly balanced, the objective within 1e-3 relative, the
    state's per-level price shapes and level-1 centroid as JAX's.  Then
    JAX's per-level prices warm-start the port's levels: exact balance,
    the objective within 1e-3 relative of the cold run's."""
    n, k, fields = SHAPES["n2000-k100-maxk9"]
    plan = hier.default_plan(k, fields["max_k"])
    x = _data(n, 6, seed=6)
    xt = torch.from_numpy(x)
    j_labels, j_st = jax_hier.hierarchical_core(jnp.asarray(x), plan,
                                                return_state=True)
    cold, st = hier.hierarchical_core(x, plan, return_state=True, device=CPU)
    assert cold.dtype == torch.int32 and cold.shape == (n,)
    assert [tuple(p.shape) for p in st["prices"]] == \
        [tuple(p.shape) for p in j_st["prices"]] == \
        list(hier.plan_price_shapes(plan))
    np.testing.assert_allclose(st["mu"].numpy(), np.asarray(j_st["mu"]),
                               rtol=1e-5, atol=1e-6)
    o_cold = float(objective_centroid(xt, cold, k))
    j_ofv = float(jax_objective(jnp.asarray(x), j_labels, k))
    assert abs(o_cold - j_ofv) <= 1e-3 * abs(j_ofv), (o_cold, j_ofv)
    prices = tuple(torch.tensor(np.asarray(p)) for p in j_st["prices"])
    warm = hier.hierarchical_core(x, plan, prices=prices, device=CPU)
    for labels in (cold, warm):
        sizes = np.bincount(labels.numpy(), minlength=k)
        assert sizes.min() == n // k and sizes.max() == -(-n // k)
    o_warm = float(objective_centroid(xt, warm, k))
    assert abs(o_warm - o_cold) <= 1e-3 * o_cold


@pytest.mark.parametrize("shape,kw", [
    ((4096, 8), {"max_k": 16}),
    ((4096, 8), {"plan": (16, 16)}),
    ((65536, 8), {"chunk_size": "auto", "max_k": 16}),
    ((65536, 8), {"chunk_size": "auto", "plan": (4, 64)}),
    ((65536, 8), {"chunk_size": 1000, "max_k": 16}),
    ((65535, 8), {"chunk_size": "auto", "max_k": 16}),
])
@pytest.mark.parametrize("has_categories", [False, True])
def test_hierarchical_route_matches_jax(shape, kw, has_categories):
    ours = _route(AnticlusterSpec(k=256, **kw), shape, has_categories, False)
    theirs = jax_route(JaxSpec(k=256, **kw), shape, has_categories, False)
    assert ours == theirs and ours[0] == "hier"


@pytest.mark.parametrize("shape,kw,mask", [
    ((3, 64, 8), {"max_k": 16}, False),
    ((4096, 8), {"plan": (16, 16)}, True),
])
def test_hierarchical_route_raises_as_jax(shape, kw, mask):
    """A stacked input with a hierarchical plan, and a valid_mask under
    one, raise NotImplementedError in both packages."""
    for spec, route in ((AnticlusterSpec(k=256, **kw), _route),
                        (JaxSpec(k=256, **kw), jax_route)):
        with pytest.raises(NotImplementedError):
            route(spec, shape, False, mask)


def test_valid_mask_with_a_plan_raises_as_jax():
    x = _data(64, 4)
    vm = np.ones(64, bool)
    with pytest.raises(NotImplementedError, match="valid_mask"):
        jax_anticluster(jnp.asarray(x), k=4, plan=(2, 2), valid_mask=vm)
    with pytest.raises(NotImplementedError, match="valid_mask"):
        anticluster(x, k=4, plan=(2, 2), valid_mask=vm, device=CPU)


@pytest.mark.parametrize("moments", [1, 2, 3])
def test_kplus_augment_matches_jax(moments):
    x = _data(500, 5, seed=7) * 3 + 1
    got = kplus_augment(torch.from_numpy(x), moments)
    want = jax_kplus.kplus_augment(x, moments)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("moment", [2, 3])
def test_moment_spread_matches_jax(moment):
    x = _data(600, 4, seed=8)
    labels = np.random.default_rng(9).permutation(np.arange(600) % 12)
    got = moment_spread(torch.from_numpy(x), torch.from_numpy(labels), 12,
                        moment)
    want = jax_kplus.moment_spread(x, labels, 12, moment)
    assert got == pytest.approx(want, rel=1e-6)


def test_kplus_front_door_matches_jax_quality():
    """``kplus_moments=2`` through the flat route: the augmented rows'
    objective within 1e-3 relative of JAX's, exact balance, and the
    variance spread below that of the same call without k-plus."""
    n, k = 600, 12
    x = _data(n, 5, seed=10)
    res = anticluster(x, k=k, kplus_moments=2, device=CPU)
    want = jax_anticluster(jnp.asarray(x), k=k, kplus_moments=2)
    assert res.route == "flat" and res.balanced
    xa = kplus_augment(torch.from_numpy(x), 2)
    ofv = float(objective_centroid(xa, res.labels, k))
    j_ofv = float(jax_objective(jnp.asarray(xa.numpy()), want.labels, k))
    assert abs(ofv - j_ofv) <= 1e-3 * abs(j_ofv), (ofv, j_ofv)
    plain = anticluster(x, k=k, device=CPU)
    xt = torch.from_numpy(x)
    assert moment_spread(xt, res.labels, k) < \
        moment_spread(xt, plain.labels, k)
    assert moment_spread(xt, res.labels, k) == pytest.approx(
        jax_kplus.moment_spread(x, res.labels.numpy(), k), rel=1e-6)


def test_kplus_float64_input_as_jax():
    """float64 rows reach the solve as JAX reads them (float32, its default
    32-bit mode) before k-plus augments them: in each package the labels
    of float64 input equal those of the same rows given as float32."""
    x = _data(120, 4, seed=11).astype(np.float64) * 3
    x32 = x.astype(np.float32)
    kw = dict(k=6, kplus_moments=2)
    got = anticluster(x, device=CPU, **kw)
    assert torch.equal(got.labels, anticluster(x32, device=CPU, **kw).labels)
    np.testing.assert_array_equal(
        np.asarray(jax_anticluster(x, **kw).labels),
        np.asarray(jax_anticluster(x32, **kw).labels))


def test_kplus_needs_flat_unmasked_input_as_jax():
    x = _data(64, 4)
    for xx, kw in ((np.stack([x, x]), {}),
                   (x, {"valid_mask": np.ones(64, bool)})):
        with pytest.raises(NotImplementedError, match="kplus_moments"):
            jax_anticluster(jnp.asarray(xx), k=4, kplus_moments=2, **kw)
        with pytest.raises(NotImplementedError, match="kplus_moments"):
            anticluster(xx, k=4, kplus_moments=2, device=CPU, **kw)
