"""The Assignment-Based Anticlustering algorithm (paper Section 4), in PyTorch.

Counterpart of ``repro/core/aba.py``: the dense core :func:`aba_core` on a
``(G, M, D)`` stack and the streaming core :func:`aba_stream` on flat
``(n, d)`` rows.  Both run the centrality sort, the Section 4.2 interleave
or Section 4.3 categorical rearrangement and the Algorithm-1 batch scan,
with ``valid_mask`` padding and multi-attribute quota codes, and every
batch goes through the one :func:`_assign_batch`, so ``aba_stream`` with
``chunk_size >= n`` gives labels bit-identical to ``aba_core(x[None])[0]``.
:func:`aba_reference` is the numpy oracle with an exact LAP;
:func:`delta_moments` down-dates the carried centrality moments of a
session (``repro_torch.incremental``).

The scans are Python loops.  The streaming core pulls each chunk's rows
through the ``gather_rows`` kernel.  On the card every epsilon phase of a
LAP is one kernel launch: ``auction_phase_dense`` on the batch's cost stack
with the ``"auction"`` solver (and with any solver under the quota mask,
which cannot be factored), ``auction_phase`` with ``"auction_fused"``.

Solver telemetry is not ported yet and raises with its ROADMAP Queue 1
item's title ("Remaining solvers").
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch._device import as_float, resolve_device
from repro_torch.core.assignment import AuctionConfig, get_solver
from repro_torch.kernels.ops import gather_rows

_MASK_COST = -1e9  # the Section 4.3 quota mask's cost, as in the reference


def interleave_permutation(n: int, k: int) -> np.ndarray:
    """Section 4.2 rearrangement of *positions* 0..n-1 of the sorted list.

    Splits the sorted list into k sublists (short ones first when k does not
    divide n) and round-robins through them; the n - floor(n/k)*k leftovers
    (one per long sublist, nearest the global centroid) go to the end.
    """
    q, r = divmod(n, k)
    if q == 0:
        return np.arange(n)
    n_short = k - r  # sublists of length q; the remaining r have length q+1
    lengths = np.array([q] * n_short + [q + 1] * r)
    starts = np.concatenate([[0], np.cumsum(lengths)[:-1]])
    rounds = starts[None, :] + np.arange(q)[:, None]  # (q, k) round-robin
    perm = rounds.reshape(-1)
    if r:
        leftovers = starts[n_short:] + q
        perm = np.concatenate([perm, leftovers])
    return perm.astype(np.int32)


def categorical_sort_order(categories: torch.Tensor,
                           rank_in_cat: torch.Tensor,
                           cat_counts: torch.Tensor, k: int) -> torch.Tensor:
    """Section 4.3: the order by (incomplete, block, category, pos).

    ``categories`` / ``rank_in_cat`` are (G, M) in centrality-sorted order
    (``rank_in_cat`` is each object's 0-based position among the objects of
    its category), ``cat_counts`` is (G, n_categories).  Returns the (G, M)
    int64 permutation that rearranges each group: full k-blocks alternate
    across categories by block index, incomplete tail blocks come last in
    the same alternating order.

    torch has no ``lexsort``; the key tuple is unique per row (a category's
    ranks are distinct), so one mixed-radix int64 key sorted gives the
    reference's permutation exactly.
    """
    categories, rank_in_cat = categories.long(), rank_in_cat.long()
    n_cat = cat_counts.shape[-1]
    block = rank_in_cat // k
    pos = rank_in_cat % k
    n_g = cat_counts.long().gather(1, categories)
    incomplete = ((block + 1) * k > n_g).long()
    n_blocks = categories.shape[1] // k + 1  # every block index is below it
    key = ((incomplete * n_blocks + block) * n_cat + categories) * k + pos
    return torch.argsort(key, dim=1, stable=True)


def _rank_in_category(cat_sorted: torch.Tensor, n_categories: int,
                      run: torch.Tensor):
    """(G, m) category stream -> (each row's rank within its category,
    counting the ``run`` (G, C) rows of each category before the stream;
    ``run`` plus the stream's counts).  One (G, m, C) one-hot cumsum,
    integer-exact, so a stream ranked in chunks equals it ranked whole."""
    onehot = F.one_hot(cat_sorted, n_categories)
    local = torch.cumsum(onehot, dim=1) - onehot
    rank = (run.gather(1, cat_sorted)
            + local.gather(2, cat_sorted[..., None])[..., 0])
    return rank, run + onehot.sum(dim=1)


def _constraints(categories, n_categories: int, fair_codes,
                 n_fair_codes: int, dev):
    """The Section 4.3 inputs as int64 tensors: ``(categories, codes,
    n_codes)`` with ``codes`` (..., A) the quota codes (A = 1: the category
    itself), or None without categories.  The JAX core's checks."""
    if fair_codes is not None and categories is None:
        raise ValueError("fair_codes requires categories (the joint "
                         "attribute cell drives the 4.3 rearrangement)")
    if categories is None:
        return None
    if n_categories <= 0:
        raise ValueError("n_categories must be set with categories")
    cat = torch.as_tensor(categories, device=dev).long()
    if fair_codes is None:
        return cat, cat[..., None], n_categories
    if n_fair_codes <= 0:
        raise ValueError("n_fair_codes must be set with fair_codes")
    return cat, torch.as_tensor(fair_codes, device=dev).long(), n_fair_codes


def _quota_bounds(codes: torch.Tensor, valid: torch.Tensor, n_codes: int,
                  k: int) -> torch.Tensor:
    """(G, M, A) codes, (G, M) 0/1 validity -> (G, n_codes) quotas
    ``ceil(|N_code| / k)`` over the valid rows."""
    G, _, A = codes.shape
    size = codes.new_zeros((G, n_codes)).scatter_add_(
        1, codes.reshape(G, -1), valid[..., None].expand(-1, -1, A)
        .reshape(G, -1))
    return (size + k - 1) // k


def _first_quota_counts(cb: torch.Tensor, real: torch.Tensor,
                        n_codes: int) -> torch.Tensor:
    """(G, k, n_codes) per-cluster code counts after the first batch, whose
    row i opens cluster i; ``cb`` (G, k, A) codes, ``real`` (G, k) bool."""
    G, k, A = cb.shape
    return cb.new_zeros((G, k, n_codes)).scatter_add_(
        2, cb, real[..., None].expand(-1, -1, A).long())


def _as_mask(valid_mask, dev) -> torch.Tensor:
    return torch.as_tensor(valid_mask, device=dev).bool()


def _telemetry_not_ported(telemetry: bool):
    if telemetry:
        raise NotImplementedError(
            "telemetry= is not ported to PyTorch yet (ROADMAP Queue 1: "
            "Remaining solvers)")


def _centrality(xf: torch.Tensor, vm: torch.Tensor | None = None):
    """(G, M, D) -> per-group centroid (G, D), squared distance (G, M).
    Under a (G, M) ``vm`` the centroid is the valid rows' and padding rows
    are at distance -inf, so that they sort last."""
    if vm is None:
        mu = xf.mean(dim=1)
        return mu, ((xf - mu[:, None, :]) ** 2).sum(dim=-1)
    w = vm.to(xf.dtype)
    mu = (xf * w[..., None]).sum(dim=1) / w.sum(dim=1).clamp(min=1.0)[:, None]
    dist = ((xf - mu[:, None, :]) ** 2).sum(dim=-1)
    return mu, torch.where(vm, dist, -math.inf)


def _use_interleave(variant: str, n: int, k: int) -> bool:
    if variant not in ("auto", "base", "interleave"):
        raise ValueError(f"unknown variant {variant!r}")
    return variant == "interleave" or (variant == "auto" and n // k <= 8)


def _assign_batch(solver_obj, fused: bool, config, cents, counts, xb,
                  is_real, prices=None, cat_counts=None, cb=None, ub=None):
    """One Algorithm-1 batch on a (G, k, ...) stack: solve the LAP against
    the current centroids and fold the rows into the running means.

    ``is_real`` is (G, k) bool, or None when every row is real.  With
    Section 4.3 constraints, ``cb`` (G, k, A) holds each row's quota codes,
    ``ub`` (G, n_codes) the quotas and ``cat_counts`` (G, k, n_codes) each
    cluster's count of every code: a cluster is closed for a real row (its
    cost ``_MASK_COST``) once any of the row's codes is at its quota, which
    with A = 1 is constraint (5).  The mask cannot be factored, so the
    caller passes ``fused`` False with it.  Returns ``(cents, counts,
    cat_counts, assign, prices)``; the assignment is int64.
    """
    if fused:
        # matrix-free: each auction phase is one auction_phase launch
        assign, p_out = solver_obj.factored(xb, cents, is_real=is_real,
                                            config=config, prices=prices)
    else:
        # reduced cost: the row constant ||x||^2 is dropped (LAP-invariant)
        cost = (-2.0 * torch.einsum("gid,gjd->gij", xb, cents)
                + (cents * cents).sum(dim=-1)[:, None, :])
        if is_real is not None:
            cost = torch.where(is_real[..., None], cost, 0.0)
        if ub is not None:
            G, k, A = cb.shape
            # closed[g, i, j]: cluster j holds its quota of one of row i's
            # codes
            at_quota = (cat_counts >= ub[:, None, :]).transpose(1, 2)
            closed = at_quota.gather(
                1, cb.reshape(G, -1, 1).expand(-1, -1, k)
            ).view(G, k, A, k).any(dim=2)
            if is_real is not None:
                closed &= is_real[..., None]
            cost = torch.where(closed, _MASK_COST, cost)
        assign, p_out = solver_obj.solve(cost, config, prices)
    real = (torch.ones_like(assign) if is_real is None else is_real.long())
    new_counts = counts.scatter_add(1, assign, real)
    a3 = assign[..., None].expand(-1, -1, xb.shape[-1])
    delta = xb - cents.gather(1, a3)
    if is_real is not None:
        delta = torch.where(is_real[..., None], delta, 0.0)
    upd = torch.zeros_like(cents).scatter_add_(1, a3, delta)
    cents = cents + upd / new_counts.clamp(min=1)[..., None].to(cents.dtype)
    if ub is not None:
        G, k, n_codes = cat_counts.shape
        slot = (assign[..., None] * n_codes + cb).reshape(G, -1)
        cat_counts = cat_counts.reshape(G, -1).scatter_add(
            1, slot, real[..., None].expand_as(cb).reshape(G, -1)
        ).view(G, k, n_codes)
    return cents, new_counts, cat_counts, assign, p_out


def aba_core(x, k: int, valid_mask=None, *, variant: str = "base",
             categories=None, n_categories: int = 0, fair_codes=None,
             n_fair_codes: int = 0, solver: str = "auction",
             auction_config: AuctionConfig = AuctionConfig(), prices=None,
             return_state: bool = False, telemetry: bool = False,
             device=None):
    """Assignment-Based Anticlustering on a ``(G, M, D)`` stack of problems.

    Each step of the batch scan solves the whole ``(G, k, k)`` LAP stack
    with one solver call.  ``valid_mask`` ((G, M) bool) marks padding rows
    False: they stay out of the centroid, the quotas and every cluster's
    count, and their labels are arbitrary in [0, k); the interleave
    rearrangement is skipped under it.  ``categories`` ((G, M) ints in
    [0, n_categories)) applies Section 4.3 per group; ``fair_codes``
    ((G, M, A) offset codes into one ``n_fair_codes``-wide quota axis)
    replaces its quotas with one per attribute level, the rearrangement
    still following ``categories`` (the joint cell).  A factored solver
    runs its dense ``solve`` under the quota mask.  ``prices`` ((G, k))
    warm-starts every batch LAP from the same carried vector;
    ``return_state`` also returns ``{"prices": (G, k) final prices of the
    last batch, "mu": (G, D)}``.  Returns (G, M) int32 labels in [0, k).
    """
    _telemetry_not_ported(telemetry)
    dev = resolve_device(device)
    xf = as_float(x, dev)
    G, M, D = xf.shape
    if k > M:
        raise ValueError(f"k={k} > M={M}")
    solver_obj = get_solver(solver)
    interleave = _use_interleave(variant, M, k)
    p_in = None if prices is None else as_float(prices, dev)
    vm = None if valid_mask is None else _as_mask(valid_mask, dev)
    quota = _constraints(categories, n_categories, fair_codes, n_fair_codes,
                         dev)

    mu, dist = _centrality(xf, vm)
    order = torch.argsort(-dist, dim=1, stable=True)
    if quota is not None:
        cat_sorted = quota[0].gather(1, order)
        if vm is not None:  # padding takes a virtual category, sorted last
            cat_sorted = torch.where(vm.gather(1, order), cat_sorted,
                                     n_categories - 1)
        rank, cat_counts = _rank_in_category(
            cat_sorted, n_categories, cat_sorted.new_zeros((G, n_categories)))
        order = order.gather(1, categorical_sort_order(cat_sorted, rank,
                                                       cat_counts, k))
    elif interleave and vm is None:
        order = order[:, torch.as_tensor(interleave_permutation(M, k),
                                         dtype=torch.int64, device=dev)]

    n_batches = -(-M // k)
    pad = n_batches * k - M
    if pad:
        order = torch.cat([order, order.new_full((G, pad), M)], dim=1)
    real = order < M
    if vm is not None:
        real &= torch.cat([vm, vm.new_zeros((G, 1))], dim=1).gather(1, order)
    batches = order.view(G, n_batches, k)
    real = real.view(G, n_batches, k)
    all_real = real.all(dim=2).all(dim=0).tolist()
    x_ext = torch.cat([xf, xf.new_zeros((G, 1, D))], dim=1)

    def rows_of(b):
        return x_ext.gather(1, batches[:, b, :, None].expand(-1, -1, D))

    cents = rows_of(0)
    counts = real[:, 0].long()
    labels = [torch.arange(k, device=dev).expand(G, k)]
    ub = cat_counts = None
    if quota is not None:
        _, codes, n_codes = quota
        A = codes.shape[-1]
        codes_ext = torch.cat([codes, codes.new_zeros((G, 1, A))], dim=1)

        def codes_of(b):
            return codes_ext.gather(1, batches[:, b, :, None].expand(-1, -1,
                                                                     A))

        valid = (torch.ones((G, M), dtype=torch.int64, device=dev)
                 if vm is None else vm.long())
        ub = _quota_bounds(codes, valid, n_codes, k)
        cat_counts = _first_quota_counts(codes_of(0), real[:, 0], n_codes)
    p_out = (xf.new_zeros((G, k)) if p_in is None else p_in)
    fused = solver_obj.factored is not None and ub is None
    for b in range(1, n_batches):
        cents, counts, cat_counts, assign, p_out = _assign_batch(
            solver_obj, fused, auction_config, cents, counts, rows_of(b),
            None if all_real[b] else real[:, b], prices=p_in,
            cat_counts=cat_counts, cb=None if ub is None else codes_of(b),
            ub=ub)
        labels.append(assign)
    out = torch.zeros((G, M + 1), dtype=torch.int64, device=dev).scatter_(
        1, order, torch.cat(labels, dim=1))[:, :M].to(torch.int32)
    if return_state:
        return out, {"prices": p_out, "mu": mu}
    return out


def aba_stream(x, k: int, chunk_size: int, *, variant: str = "base",
               categories=None, n_categories: int = 0, fair_codes=None,
               n_fair_codes: int = 0, valid_mask=None,
               solver: str = "auction",
               auction_config: AuctionConfig = AuctionConfig(), prices=None,
               return_state: bool = False, telemetry: bool = False,
               device=None):
    """Streaming ABA on flat ``(n, d)`` rows: Algorithm 1 in chunks.

    The centrality pass accumulates the centroid and the distances chunk by
    chunk, and the batch scan pulls ``chunk_size`` rows (rounded down to a
    multiple of k) at a time through one ``gather_rows`` launch, so the
    working set beyond the input is O(chunk_size * d + k * d) floats plus
    the O(n) order and label vectors.  ``categories`` ((n,)),
    ``fair_codes`` ((n, A)) and ``valid_mask`` ((n,)) are those of
    :func:`aba_core`: the Section 4.3 rank-in-category runs chunk by chunk
    on per-category running counts (one (chunk, C) one-hot cumsum each),
    integer-exact, and each chunk's quota codes are gathered beside its
    rows.  With ``chunk_size >= n`` the labels are bit-identical to
    ``aba_core(x[None], k)[0]`` with the same arguments.

    Unlike the JAX core, the last chunk is not padded with all-dummy
    sentinel batches: a Python loop has no fixed trip count to fill.  So the
    returned ``state["prices"]`` ((1, k)) are those of the last real batch,
    as in the dense core.
    """
    _telemetry_not_ported(telemetry)
    dev = resolve_device(device)
    xf = as_float(x, dev)
    n, d = xf.shape
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    solver_obj = get_solver(solver)
    interleave = _use_interleave(variant, n, k)
    p_in = None if prices is None else as_float(prices, dev)
    vm = None if valid_mask is None else _as_mask(valid_mask, dev)
    quota = _constraints(categories, n_categories, fair_codes, n_fair_codes,
                         dev)
    cpb = max(1, int(chunk_size) // k)  # batches per chunk
    chunk = cpb * k
    spans = range(0, n, chunk)

    if int(chunk_size) >= n or n <= chunk:
        # one covering chunk: the dense core's own ops, for bit parity
        mu3, dist3 = _centrality(xf[None], None if vm is None else vm[None])
        mu, dist = mu3[0], dist3[0]
    else:
        total = xf.new_zeros((d,))
        for s in spans:
            xc = xf[s:s + chunk]
            total += (xc if vm is None else xc * vm[s:s + chunk, None]).sum(0)
        mu = total / (n if vm is None else vm.sum().clamp(min=1))
        dist = torch.cat([((xf[s:s + chunk] - mu) ** 2).sum(dim=-1)
                          for s in spans])
        if vm is not None:  # padding sorts to the end
            dist = torch.where(vm, dist, -math.inf)
    order = torch.argsort(-dist, stable=True)
    if quota is not None:
        cat_sorted = quota[0][order]
        if vm is not None:  # padding takes a virtual category, sorted last
            cat_sorted = torch.where(vm[order], cat_sorted, n_categories - 1)
        run = cat_sorted.new_zeros((1, n_categories))
        ranks = []
        for s in spans:
            rank, run = _rank_in_category(cat_sorted[None, s:s + chunk],
                                          n_categories, run)
            ranks.append(rank)
        order = order[categorical_sort_order(
            cat_sorted[None], torch.cat(ranks, dim=1), run, k)[0]]
    elif interleave and vm is None:
        order = order[torch.as_tensor(interleave_permutation(n, k),
                                      dtype=torch.int64, device=dev)]

    n_batches = -(-n // k)
    pad = n_batches * k - n
    if pad:
        order = torch.cat([order, order.new_full((pad,), n)])
    real = order < n
    if vm is not None:
        real &= vm[order.clamp(max=n - 1)]
    batches = order.view(n_batches, k)
    real = real.view(n_batches, k)
    all_real = real.all(dim=1).tolist()

    # Sentinel indices (== n) are clipped by the gathers to the last row;
    # every consumer of a dummy row masks it with is_real, so the clipped
    # values and codes never reach a label.
    cents = gather_rows(xf, batches[0])[None]   # (1, k, d)
    counts = real[0].long()[None]
    labels = [torch.arange(k, device=dev)]
    ub = cat_counts = None
    if quota is not None:
        _, codes, n_codes = quota
        valid = (torch.ones((n,), dtype=torch.int64, device=dev)
                 if vm is None else vm.long())
        ub = _quota_bounds(codes[None], valid[None], n_codes, k)
        cat_counts = _first_quota_counts(codes[batches[0].clamp(max=n - 1)]
                                         [None], real[0][None], n_codes)
    p_out = (xf.new_zeros((1, k)) if p_in is None else p_in)
    fused = solver_obj.factored is not None and ub is None
    for c0 in range(1, n_batches, cpb):
        bs = batches[c0:c0 + cpb]
        nb = bs.shape[0]
        xc = gather_rows(xf, bs.reshape(-1)).view(nb, k, d)
        cc = None if ub is None else codes[bs.clamp(max=n - 1)]
        for j in range(nb):
            b = c0 + j
            cents, counts, cat_counts, assign, p_out = _assign_batch(
                solver_obj, fused, auction_config, cents, counts,
                xc[j][None], None if all_real[b] else real[b][None],
                prices=p_in, cat_counts=cat_counts,
                cb=None if cc is None else cc[j][None], ub=ub)
            labels.append(assign[0])
    out = torch.zeros((n + 1,), dtype=torch.int64, device=dev).scatter_(
        0, order, torch.cat(labels))[:n].to(torch.int32)
    if return_state:
        return out, {"prices": p_out, "mu": mu}
    return out


def delta_moments(moment_sum, moment_count, added=None, removed=None):
    """Merge arrivals and departures into carried centrality moments.

    ``moment_sum`` ((d,) feature sum over valid rows) and ``moment_count``
    (() valid-row count) are the running moments the engine's ``ABAState``
    carries behind the level-1 centrality sort.  ``added`` / ``removed``
    are the delta's row blocks ((m, d) / (r, d)); the result equals the
    post-delta rows' moments up to float summation order.
    """
    moment_sum = torch.as_tensor(moment_sum).float()
    moment_count = torch.as_tensor(moment_count).float()
    if removed is not None and removed.shape[0]:
        moment_sum = moment_sum - removed.float().sum(dim=0)
        moment_count = moment_count - float(removed.shape[0])
    if added is not None and added.shape[0]:
        moment_sum = moment_sum + added.float().sum(dim=0)
        moment_count = moment_count + float(added.shape[0])
    return moment_sum, moment_count


def aba_reference(x: np.ndarray, k: int, *, variant: str = "base",
                  categories: np.ndarray | None = None) -> np.ndarray:
    """Algorithm 1 transcribed in numpy with an exact LAP (scipy's
    ``linear_sum_assignment``): the quality oracle of the tests, a copy of
    the JAX package's, with the same ``_MASK_COST`` quota mask."""
    from scipy.optimize import linear_sum_assignment

    x = np.asarray(x, np.float64)
    n = x.shape[0]
    mu = x.mean(axis=0)
    dist = ((x - mu) ** 2).sum(axis=1)
    order = np.argsort(-dist, kind="stable")

    if categories is not None:
        categories = np.asarray(categories)
        g_count = np.bincount(categories)
        ub = -(-g_count // k)
        pieces_full, pieces_tail = [], []
        per_cat = {g: order[categories[order] == g]
                   for g in range(len(g_count))}
        max_blocks = max((len(v) + k - 1) // k for v in per_cat.values())
        for b in range(max_blocks):
            for g, idxs in per_cat.items():
                blk = idxs[b * k:(b + 1) * k]
                (pieces_full if len(blk) == k else pieces_tail).append(blk)
        order = np.concatenate([p for p in pieces_full + pieces_tail
                                if len(p)])
    elif variant == "interleave" or (variant == "auto" and n // k <= 8):
        order = order[interleave_permutation(n, k)]

    labels = np.full(n, -1, np.int64)
    labels[order[:k]] = np.arange(min(k, n))
    cents = x[order[:k]].copy()
    counts = np.ones(min(k, n), np.int64)
    cat_counts = None
    if categories is not None:
        cat_counts = np.zeros((k, len(g_count)), np.int64)
        np.add.at(cat_counts, (labels[order[:k]], categories[order[:k]]), 1)

    b = 1
    while b * k < n:
        idx = order[b * k:(b + 1) * k]
        xb = x[idx]
        cost = ((xb[:, None, :] - cents[None, :, :]) ** 2).sum(-1)
        if categories is not None:
            cb = categories[idx]
            full = cat_counts[:, cb].T >= ub[cb][:, None]
            cost[full] = _MASK_COST
        rows, cols = linear_sum_assignment(cost, maximize=True)
        for r, c in zip(rows, cols):
            counts[c] += 1
            cents[c] += (xb[r] - cents[c]) / counts[c]
            labels[idx[r]] = c
            if cat_counts is not None:
                cat_counts[c, categories[idx[r]]] += 1
        b += 1
    return labels.astype(np.int32)
