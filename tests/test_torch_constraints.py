"""Section 4.3 categories, multi-attribute fairness and ``valid_mask`` in the
port, against the JAX package.

Bitwise against JAX: the rearrangement (``categorical_sort_order``), the
constraint resolution of the front door (``_resolve_constraints``), the
route and the numpy oracle ``aba_reference``.  Within 1e-5 (allclose): the
masked statistics and dual certificate.  Within one float32 ulp: the eps
schedule of a masked LAP.  On quality, as every solve of the port (its
labels differ from JAX's, ROADMAP departure P1): exact balance, constraint
(5) exact for one attribute, the objective within 1e-3 relative of JAX's,
and the multi-attribute quota spread no worse than JAX's.  Inside the
port, bitwise: the streaming core with ``chunk_size >= n`` equals the dense
core, constraints included.
"""

import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.anticluster import AnticlusterSpec as JaxSpec
from repro.anticluster import _result_stats as jax_result_stats
from repro.anticluster import _resolve_constraints as jax_resolve
from repro.anticluster import _route as jax_route
from repro.anticluster import anticluster as jax_anticluster
from repro.core.assignment import AuctionConfig as JaxConfig
from repro.core.assignment import _NEG as JAX_NEG
from repro.core.assignment import _eps_schedule as jax_eps_schedule
from repro.core.objective import dual_certificate as jax_certificate
from repro.core.objective import objective_centroid as jax_objective

from repro_torch.anticluster import (AnticlusterSpec, _resolve_constraints,
                                     _result_stats, _route, anticluster)
from repro_torch.core import aba
from repro_torch.core.aba import (aba_core, aba_reference, aba_stream,
                                  categorical_sort_order)
from repro_torch.core.objective import dual_certificate, objective_centroid
from repro_torch.kernels import ops

# the module (the package exports a function under the same name)
jax_aba = importlib.import_module("repro.core.aba")

CPU = "cpu"


def _data(n, d, seed=0):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


def _cats(shape, c, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, c, size=shape).astype(np.int32)


def _spread(labels, attr, k):
    """Max over the attribute's levels of (max - min) per-cluster count."""
    labels = np.asarray(labels)
    return max(int(np.ptp(np.bincount(labels[attr == v], minlength=k)))
               for v in np.unique(attr))


def _excess(labels, attrs, k):
    """The largest quota excess: max over the attributes' levels and the
    clusters of count - ceil(|N_level| / k)."""
    labels = np.asarray(labels)
    return max(int(np.bincount(labels[a == v], minlength=k).max())
               - -(-int((a == v).sum()) // k)
               for a in attrs for v in np.unique(a))


def _size_spread(labels, k):
    return int(np.ptp(np.bincount(np.asarray(labels), minlength=k)))


def _balanced(labels, k, n=None):
    cnt = np.bincount(np.asarray(labels), minlength=k)
    n = len(labels) if n is None else n
    return cnt.min() >= n // k and cnt.max() <= -(-n // k)


def _stratified(labels, cats, k):
    """Constraint (5): each category's count per cluster within
    floor(|N_c|/k)..ceil(|N_c|/k)."""
    labels = np.asarray(labels)
    for v in np.unique(cats):
        cnt = np.bincount(labels[cats == v], minlength=k)
        n_v = int((cats == v).sum())
        if cnt.min() < n_v // k or cnt.max() > -(-n_v // k):
            return False
    return True


def _ofv(x, labels, k):
    return float(objective_centroid(torch.from_numpy(np.asarray(x)),
                                    torch.as_tensor(np.asarray(labels)), k))


# ---------------------------------------------------------------------------
# bitwise against JAX: the rearrangement, the resolution, the route
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("M,C,k", [(300, 3, 7), (512, 5, 16), (257, 2, 32),
                                   (64, 1, 8), (100, 12, 3)])
def test_categorical_sort_order_matches_jax(G, M, C, k):
    cats = _cats((G, M), C, seed=M + C)
    onehot = np.eye(C, dtype=np.int64)[cats]
    rank = ((np.cumsum(onehot, axis=1) - onehot)
            * onehot).sum(axis=-1)
    counts = onehot.sum(axis=1)
    want = np.asarray(jax_aba.categorical_sort_order(
        jnp.asarray(cats), jnp.asarray(rank, jnp.int32),
        jnp.asarray(counts, jnp.int32), k))
    got = categorical_sort_order(torch.from_numpy(cats),
                                 torch.from_numpy(rank),
                                 torch.from_numpy(counts), k)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def _resolve_cases():
    a1, a2, a3 = _cats(90, 3, 1), _cats(90, 2, 2), _cats(90, 13, 3)
    stacked = [_cats((2, 45), 3, 4), _cats((2, 45), 2, 5)]
    return {
        "categories": {"categories": a1},
        "categories n_categories": {"categories": a1, "n_categories": 5},
        "one attribute": {"fairness": [a1]},
        "one attribute bare": {"fairness": a3},
        "three attributes": {"fairness": {"class": a1, "sex": a2,
                                          "age": a3}},
        "(n, A) array": {"fairness": np.stack([a1, a2, a3], axis=-1)},
        "stacked two": {"fairness": stacked},
    }


@pytest.mark.parametrize("case", list(_resolve_cases()))
def test_resolve_constraints_matches_jax(case):
    kw = _resolve_cases()[case]
    ours = _resolve_constraints(AnticlusterSpec(k=4, **kw))
    theirs = jax_resolve(JaxSpec(k=4, **kw))
    for a, b in zip(ours, theirs):
        if b is None:
            assert a is None
        elif isinstance(b, int):
            assert a == b
        else:
            assert a.dtype == torch.int64
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_one_attribute_is_exactly_categories():
    x = _data(420, 5, 7)
    cats = _cats(420, 5, 8)
    a = anticluster(x, k=6, categories=cats, device=CPU)
    b = anticluster(x, k=6, fairness=[cats], device=CPU)
    c = anticluster(x, k=6, fairness={"only": cats}, chunk_size=420,
                    device=CPU)
    assert torch.equal(a.labels, b.labels) and torch.equal(a.labels, c.labels)


@pytest.mark.parametrize("shape,kw", [
    ((65536, 8), {"chunk_size": "auto"}),
    ((253680, 22), {"chunk_size": "auto"}),
    ((65536, 8), {"chunk_size": "auto", "solver": "auction_fused"}),
    ((4096, 8), {"chunk_size": 512}),
    ((3, 64, 8), {}),
])
@pytest.mark.parametrize("has_categories", [False, True])
def test_route_keeps_auction_under_categories(shape, kw, has_categories):
    """Route only (no solve): under categories the at-scale upgrade to
    "auction_fused" stays off, as in JAX."""
    ours = _route(AnticlusterSpec(k=256, **kw), shape, has_categories, False)
    theirs = jax_route(JaxSpec(k=256, **kw), shape, has_categories, False)
    assert ours == theirs
    if has_categories and kw.get("solver") is None:
        assert ours[2] == "auction"


@pytest.mark.parametrize("k,C", [(5, 3), (8, 4)])
def test_reference_oracle_matches_jax(k, C):
    x = _data(200, 4, k)
    cats = _cats(200, C, k + 1)
    for kw in ({}, {"categories": cats}, {"variant": "interleave"}):
        np.testing.assert_array_equal(aba_reference(x, k, **kw),
                                      jax_aba.aba_reference(x, k, **kw))


# ---------------------------------------------------------------------------
# masked statistics and certificate, allclose 1e-5
# ---------------------------------------------------------------------------

def _masked_inputs(G, M, D, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(G, M, D)).astype(np.float32)
    labels = rng.integers(0, k, size=(G, M)).astype(np.int32)
    vm = rng.random((G, M)) < 0.8
    prices = rng.normal(size=(G, k)).astype(np.float32)
    return x, labels, vm, prices


@pytest.mark.parametrize("G", [1, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_masked_certificate_and_stats_match_jax(G, masked):
    k = 6
    x, labels, vm, prices = _masked_inputs(G, 150, 5, k, seed=G)
    vm = vm if masked else None
    flat = G == 1
    pick = (lambda a: a[0]) if flat else (lambda a: a)
    args = [pick(a) for a in (x, labels, prices)]
    m = None if vm is None else pick(vm)
    ours = dual_certificate(*(torch.from_numpy(a) for a in args), k,
                            valid_mask=None if m is None
                            else torch.from_numpy(m))
    theirs = jax_certificate(*(jnp.asarray(a) for a in args), k,
                             valid_mask=None if m is None else jnp.asarray(m))
    for a, b in zip(ours, theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)
    ours = _result_stats(torch.from_numpy(args[0]),
                         torch.from_numpy(args[1]), k,
                         None if m is None else torch.from_numpy(m))
    theirs = jax_result_stats(jnp.asarray(args[0]), jnp.asarray(args[1]), k,
                              None if m is None else jnp.asarray(m))
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(theirs[0]))
    for a, b in zip(ours[1:], theirs[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the cores' quality against the JAX core (P1)
# ---------------------------------------------------------------------------

def _constraint_case(name, n, seed):
    """(categories, n_categories, fair_codes, n_fair_codes, valid_mask,
    the attributes whose spread is checked) for one flat problem."""
    cls, sex, age = (_cats(n, 3, seed), _cats(n, 2, seed + 1),
                     _cats(n, 4, seed + 2))
    vm = np.arange(n) < n - n // 9
    if name == "categories":
        return cls, 3, None, 0, None, [cls]
    if name == "categories+mask":
        return cls, 3, None, 0, vm, [cls]
    if name == "mask":
        return None, 0, None, 0, vm, []
    spec = AnticlusterSpec(k=2, fairness={"cls": cls, "sex": sex,
                                          "age": age})
    joint, n_joint, codes, n_codes = _resolve_constraints(spec)
    return (joint.numpy(), n_joint, codes.numpy(), n_codes, None,
            [cls, sex, age])


CASES = ["categories", "categories+mask", "mask", "fairness3"]


def _jax_labels(x, k, cats, n_cats, codes, n_codes, vm, variant="base"):
    j = lambda a: None if a is None else jnp.asarray(a)[None]  # noqa: E731
    return np.asarray(jax_aba.aba_core(
        jnp.asarray(x)[None], k, j(vm), variant=variant, categories=j(cats),
        n_categories=n_cats, fair_codes=j(codes), n_fair_codes=n_codes)[0])


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("n,k", [(480, 8), (363, 6)])
@pytest.mark.parametrize("core", ["dense", "stream"])
def test_core_quality_matches_jax(case, n, k, core):
    """Each core (the stream one in chunks of 96 rows) against the JAX
    dense core on the same input."""
    x = _data(n, 5, seed=n + k)
    cats, n_cats, codes, n_codes, vm, attrs = _constraint_case(case, n, k)
    kw = dict(n_categories=n_cats, n_fair_codes=n_codes, device=CPU)
    if core == "dense":
        ours = aba_core(x[None], k, None if vm is None else vm[None],
                        categories=None if cats is None else cats[None],
                        fair_codes=None if codes is None else codes[None],
                        **kw)[0].numpy()
    else:
        ours = aba_stream(x, k, 96, categories=cats, fair_codes=codes,
                          valid_mask=vm, **kw).numpy()
    theirs = _jax_labels(x, k, cats, n_cats, codes, n_codes, vm)
    real = np.ones(n, bool) if vm is None else vm
    if case == "categories+mask":
        # reference fault R7: the padding's virtual category can put dummy
        # rows into a full block mid-scan, so the real rows' sizes may
        # spread by 2 in both packages
        assert _size_spread(ours[real], k) <= max(
            1, _size_spread(theirs[real], k))
    else:
        assert _balanced(ours[real], k) and _balanced(theirs[real], k)
    if case in ("categories", "categories+mask"):
        assert _stratified(ours[real], cats[real], k)
    if case == "fairness3":  # best-effort quotas: see the test below
        assert _excess(ours, attrs, k) <= _excess(theirs, attrs, k) + 1
    o_ours = _ofv(x[real], ours[real], k)
    o_theirs = float(jax_objective(jnp.asarray(x[real]),
                                   jnp.asarray(theirs[real]), k))
    assert abs(o_ours - o_theirs) <= 1e-3 * o_theirs


def test_multi_attribute_excess_no_worse_than_jax():
    """Multi-attribute quotas are best-effort in both packages: a tail
    batch with no mask-free assignment overflows a quota.  Which one
    depends on the tie-breaks of every earlier LAP, which differ between
    the packages (P1), so on one draw either may overflow more (n = 363,
    k = 6 of the test above: 2 against 1).  Summed over eight seeded draws
    the port's largest quota excess is no worse than JAX's."""
    ours, theirs = [], []
    for seed in range(4):
        for n, k in [(363, 6), (480, 8)]:
            x = _data(n, 5, seed=1000 + seed)
            cats, n_cats, codes, n_codes, _, attrs = _constraint_case(
                "fairness3", n, seed)
            lab = aba_core(x[None], k, categories=cats[None],
                           n_categories=n_cats, fair_codes=codes[None],
                           n_fair_codes=n_codes, device=CPU)[0].numpy()
            ours.append(_excess(lab, attrs, k))
            theirs.append(_excess(_jax_labels(x, k, cats, n_cats, codes,
                                              n_codes, None), attrs, k))
    assert sum(ours) <= sum(theirs), (ours, theirs)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("solver", ["auction", "auction_fused"])
def test_stream_covering_chunk_equals_dense_bitwise(case, solver):
    n, k = 364, 7
    x = _data(n, 5, seed=11)
    cats, n_cats, codes, n_codes, vm, _ = _constraint_case(case, n, 12)
    kw = dict(n_categories=n_cats, n_fair_codes=n_codes, solver=solver,
              return_state=True, device=CPU)
    dense, dst = aba_core(
        x[None], k, None if vm is None else vm[None],
        categories=None if cats is None else cats[None],
        fair_codes=None if codes is None else codes[None], **kw)
    for chunk in (n, n + 13):
        lab, st = aba_stream(x, k, chunk, categories=cats, fair_codes=codes,
                             valid_mask=vm, **kw)
        assert torch.equal(lab, dense[0])
        assert torch.equal(st["prices"], dst["prices"])
        assert torch.equal(st["mu"], dst["mu"][0])


@pytest.mark.parametrize("n,k,chunk,C", [(400, 8, 96, 4), (600, 6, 128, 3),
                                         (512, 16, 130, 5)])
def test_stream_chunks_keep_the_invariants(n, k, chunk, C):
    """Below a covering chunk the labels may differ from the dense core's,
    but balance and constraint (5) stay exact (the rank pass is
    integer-exact: the order equals the dense core's)."""
    x = _data(n, 5, 20)
    cats = _cats(n, C, 21)
    res = anticluster(x, k=k, categories=cats, chunk_size=chunk, device=CPU)
    assert res.route == "stream" and res.solver == "auction"
    assert _balanced(res.labels.numpy(), k)
    assert _stratified(res.labels.numpy(), cats, k)
    dense = anticluster(x, k=k, categories=cats, device=CPU)
    o_s, o_d = _ofv(x, res.labels, k), _ofv(x, dense.labels, k)
    assert abs(o_s - o_d) <= 1e-3 * o_d


@pytest.mark.parametrize("seed", [1, 2])
def test_multi_attribute_stream_no_worse_than_dense(seed):
    n, k = 360, 6
    x = _data(n, 4, seed)
    fair = {"a1": _cats(n, 3, seed + 30), "a2": _cats(n, 2, seed + 60)}
    dense = anticluster(x, k=k, fairness=fair, device=CPU).labels.numpy()
    stream = anticluster(x, k=k, fairness=fair, chunk_size=100,
                         device=CPU).labels.numpy()
    assert _balanced(stream, k)
    for a in fair.values():
        assert _spread(stream, a, k) <= max(1, _spread(dense, a, k))


def test_stream_mask_chunks_front_door():
    n, k = 512, 8
    x = _data(n, 4, 40)
    vm = np.arange(n) < 470
    res = anticluster(x, k=k, valid_mask=vm, chunk_size=128, device=CPU)
    assert res.route == "stream" and int(res.n_valid) == 470
    assert res.balanced and _balanced(res.labels.numpy()[vm], k)


def test_padding_rows_do_not_change_the_real_rows():
    """x padded with far-away rows under valid_mask (the mesh-padding use):
    the real rows stay exactly balanced, the statistics count only them,
    and the objective stays within 5e-3 of the unpadded call's."""
    n, k = 300, 6
    x = _data(n, 4, 9)
    xp = np.concatenate([x, np.full((84, 4), 7.7, np.float32)])
    vm = np.arange(n + 84) < n
    pad = anticluster(xp, k=k, valid_mask=vm, device=CPU)
    plain = anticluster(x, k=k, device=CPU)
    lab = pad.labels.numpy()[:n]
    assert int(pad.n_valid) == n and pad.balanced and _balanced(lab, k)
    np.testing.assert_array_equal(pad.cluster_sizes.numpy(),
                                  np.bincount(lab, minlength=k))
    o_pad, o_plain = _ofv(x, lab, k), _ofv(x, plain.labels, k)
    assert abs(o_pad - o_plain) <= 5e-3 * o_plain
    assert np.isfinite(float(pad.gap)) and float(pad.gap) >= 0.0


def test_padding_with_categories_keeps_constraint_5():
    """Padding under categories: constraint (5) stays exact on the real
    rows; their sizes spread no more than the JAX front door's on the same
    input (reference fault R7: 49..51 for n = 300, k = 6 there)."""
    n, k = 300, 6
    x = _data(n, 4, 9)
    cats = _cats(n, 3, 10)
    xp = np.concatenate([x, np.full((84, 4), 7.7, np.float32)])
    vm = np.arange(n + 84) < n
    catp = np.concatenate([cats, np.zeros(84, np.int32)])
    pad = anticluster(xp, k=k, categories=catp, valid_mask=vm, device=CPU)
    ref = jax_anticluster(xp, k=k, categories=catp, valid_mask=vm)
    lab = pad.labels.numpy()[:n]
    assert int(pad.n_valid) == n and _stratified(lab, cats, k)
    assert _size_spread(lab, k) <= max(
        1, _size_spread(np.asarray(ref.labels)[:n], k))


def test_stacked_route_with_categories_and_mask():
    G, M, k = 3, 200, 8
    x = np.stack([_data(M, 5, s) for s in range(G)])
    cats = _cats((G, M), 3, 5)
    vm = np.ones((G, M), bool)
    vm[1, 170:] = False
    res = anticluster(x, k=k, categories=cats, valid_mask=vm, device=CPU)
    assert res.route == "stacked" and res.solver == "auction"
    np.testing.assert_array_equal(res.n_valid, [200, 170, 200])
    for g in range(G):
        lab = res.labels[g].numpy()[vm[g]]
        assert _balanced(lab, k) and _stratified(lab, cats[g][vm[g]], k)
        one = aba_core(x[g][None], k, vm[g][None],
                       categories=cats[g][None], n_categories=3, device=CPU)
        assert torch.equal(one[0], res.labels[g])
    assert bool(torch.all(torch.isfinite(res.gap)))


def test_categorical_quality_against_the_exact_oracle():
    x = _data(300, 4, 6)
    cats = _cats(300, 3, 7)
    ours = anticluster(x, k=5, categories=cats, device=CPU).labels.numpy()
    oracle = aba_reference(x, 5, categories=cats)
    assert _stratified(ours, cats, 5) and _stratified(oracle, cats, 5)
    o_ours, o_ref = _ofv(x, ours, 5), _ofv(x, oracle, 5)
    assert abs(o_ours - o_ref) / o_ref < 5e-3


# ---------------------------------------------------------------------------
# the masked LAP: its eps schedule (reference fault R6) and the solver
# ---------------------------------------------------------------------------

def _masked_phases(monkeypatch):
    """Every dense LAP of a categorical solve, recorded: (cost, its (P, G)
    eps schedule)."""
    calls = []
    inner = ops.auction_phase_dense

    def recorded(cost, prices, eps, *args, **kw):
        calls.append((cost.clone(), eps.clone()))
        return inner(cost, prices, eps, *args, **kw)

    monkeypatch.setattr(ops, "auction_phase_dense", recorded)
    x = _data(512, 5, 3)
    fair = {"a": _cats(512, 3, 4), "b": _cats(512, 2, 5),
            "c": _cats(512, 5, 6)}
    anticluster(x, k=16, fairness=fair, device=CPU)
    return calls


def test_masked_eps_schedule_equals_the_reference_span_formula(monkeypatch):
    """The port's schedule (per instance, float32(float64(span) * f_p) on
    the device, P3), one (P, G) schedule a LAP's dispatch, equals the
    reference's float32 span formula on the same masked cost within one
    ulp.  The mask's -1e9 enters the span, so a masked LAP's eps runs
    from ~1.25e8 down to ~1e9 / (4 k): reference fault R6, kept."""
    calls = _masked_phases(monkeypatch)
    n_phases = JaxConfig().n_phases
    masked = 0
    for lap in range(len(calls)):
        cost = jnp.asarray(calls[lap][0].numpy())
        finite = jnp.where(cost <= JAX_NEG / 2, 0.0, cost)
        span = jnp.maximum(finite.max(axis=(1, 2))
                           - finite.min(axis=(1, 2)), 1e-6)
        want = np.asarray(jax_eps_schedule(span, cost.shape[1], JaxConfig()))
        got = calls[lap][1].numpy()
        assert got.shape == (n_phases, cost.shape[0])
        ulps = np.abs(got.view(np.int32).astype(np.int64)
                      - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= 1, (lap, got, want)
        if bool((cost == aba._MASK_COST).any()):
            masked += 1
            k = cost.shape[1]
            assert 1.0e8 < got[0, 0] < 1.3e8
            assert 0.9e9 / (4 * k) < got[-1, 0] < 1.1e9 / (4 * k)
    assert masked > 0


def test_masked_lap_takes_no_masked_cell_when_it_can(monkeypatch):
    """A masked LAP's eps-optimal assignment is within n * eps_lo = span / 4
    of the optimum, below the mask's 1e9: where an assignment avoiding
    every masked cell exists (scipy's exact LAP on the cost says so), the
    auction's takes no masked cell either."""
    from scipy.optimize import linear_sum_assignment

    from repro_torch.core.assignment import auction_solve
    calls = _masked_phases(monkeypatch)
    checked = 0
    # one dispatch a LAP; a copy, as the solves below record more
    for cost, _ in list(calls):
        c = cost[0].numpy().astype(np.float64)
        if not (c == aba._MASK_COST).any():
            continue
        r, col = linear_sum_assignment(c, maximize=True)
        if (c[r, col] == aba._MASK_COST).any():
            continue  # no mask-free assignment: the best-effort case
        assign = auction_solve(cost[0], device=CPU).numpy()
        assert not (c[np.arange(len(assign)), assign] == aba._MASK_COST).any()
        checked += 1
    assert checked > 0


# ---------------------------------------------------------------------------
# the checks of the cores and the spec, and what still raises
# ---------------------------------------------------------------------------

def test_core_argument_errors_match_jax():
    x = _data(64, 4)
    cats = _cats(64, 3)
    with pytest.raises(ValueError, match="n_categories must be set"):
        aba_core(x[None], 4, categories=cats[None], device=CPU)
    with pytest.raises(ValueError, match="fair_codes requires categories"):
        aba_stream(x, 4, 32, fair_codes=cats[:, None], device=CPU)
    with pytest.raises(ValueError, match="n_fair_codes must be set"):
        aba_stream(x, 4, 32, categories=cats, n_categories=3,
                   fair_codes=cats[:, None], device=CPU)


def test_spec_checks_fairness():
    cats = _cats(100, 3)
    with pytest.raises(ValueError, match="mutually exclusive"):
        AnticlusterSpec(k=4, categories=cats, fairness=[cats])
    with pytest.raises(ValueError, match="integer-coded"):
        AnticlusterSpec(k=4, fairness=[np.linspace(0, 1, 100)])
    with pytest.raises(ValueError, match="disagree on shape"):
        AnticlusterSpec(k=4, fairness=[cats, _cats(90, 2)])
    with pytest.raises(ValueError, match="negative"):
        AnticlusterSpec(k=4, fairness=[cats - 1])
