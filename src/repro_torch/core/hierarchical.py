"""Hierarchical decomposition of ABA (paper Section 4.4), in PyTorch.

Counterpart of ``repro/core/hierarchical.py``.  K = K_1 x ... x K_L:
level 1 runs ABA on the full data with K_1 (the G = 1 dense core, or the
streaming core with ``chunk_size``); every later level runs ABA
independently on each group of the level before, as ONE stacked
``aba_core`` call on a ``(G, M, D)`` stack, so that each batch of the scan
solves the whole ``(G, k_l, k_l)`` LAP stack with one solver call (on the
card one ``auction_phase_dense`` launch a LAP with the dense solver, one
``bid_top2`` span and one ``auction_phase`` launch a phase with the
factored one).

Groups whose sizes differ by one (Proposition 1) are gathered into a
``(G, M)`` index matrix with a validity mask by :func:`_regroup`.  Total
work O(N * sum_l K_l^2), smallest for balanced factors (Lemma 1):
:func:`default_plan` picks them.  Categories and fairness codes stratify
at every level; since ``ceil(ceil(n/a)/b) == ceil(n/(ab))`` (and likewise
for floor), the final K = prod(plan) anticlusters satisfy the global
constraint (5) exactly.

The JAX package's deprecated shims ``hierarchical_aba`` and ``aba_auto``
are not ported: the front door ``repro_torch.anticluster.anticluster``
takes ``plan=`` and ``plan="auto"``.
"""

from __future__ import annotations

import math

import torch

from repro_torch._device import as_float, resolve_device
from repro_torch.core.aba import aba_core, aba_stream
from repro_torch.core.assignment import AuctionConfig


def _plan_search(k: int, max_k: int) -> tuple[int, ...] | None:
    """Balanced factorization with backtracking; None if none is admissible."""
    if k <= max_k:
        return (k,)
    n_levels = 2
    while k ** (1.0 / n_levels) > max_k:
        n_levels += 1
    target = k ** (1.0 / n_levels)
    cands, seen = [], set()
    for d in range(2, math.isqrt(k) + 1):
        for cand in (d, k // d):
            if k % cand == 0 and 2 <= cand <= max_k and cand not in seen:
                seen.add(cand)
                cands.append(cand)
    # stable sort keeps the legacy greedy preference among equidistant factors
    cands.sort(key=lambda c: abs(c - target))
    for cand in cands:
        rest = _plan_search(k // cand, max_k)
        if rest is not None:
            return (cand,) + rest
    return None


def default_plan(k: int, max_k: int = 512) -> tuple[int, ...]:
    """Balanced factorization of k per Lemma 1, every factor <= ``max_k``.

    Raises ValueError where no factorization of k into factors <= max_k
    exists (k prime, or with an unavoidable prime factor > max_k), rather
    than scheduling the full k x k auction the hierarchy is to prevent.
    """
    if k < 1:
        raise ValueError(f"k={k} must be >= 1")
    plan = _plan_search(k, max_k)
    if plan is None:
        raise ValueError(
            f"k={k} has no factorization with every factor <= max_k={max_k} "
            f"(prime factor too large); raise max_k or choose an adjacent k")
    return plan


def plan_price_shapes(plan: tuple[int, ...]) -> tuple[tuple[int, int], ...]:
    """Per-level warm-start price shapes for :func:`hierarchical_core`:
    level 1 is ``(1, plan[0])``, level l ``(prod(plan[:l-1]), plan[l-1])``
    (1-based)."""
    shapes, groups = [], 1
    for k_l in plan:
        shapes.append((groups, k_l))
        groups *= k_l
    return tuple(shapes)


def _regroup(glabels: torch.Tensor, valid: torch.Tensor, n_groups: int,
             m_new: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``(n_groups, m_new)`` padded index matrix of the rows of each
    group, in row order, and its validity mask; padding entries are ``n``.
    Bitwise the JAX ``_regroup``: a stable sort of the group keys (invalid
    rows last) and each group's run of it."""
    n = glabels.shape[0]
    dev = glabels.device
    key = torch.where(valid, glabels.long(), n_groups)  # padding sorts last
    order = torch.argsort(key, stable=True)
    counts = torch.zeros((n_groups,), dtype=torch.int64, device=dev)
    counts.scatter_add_(0, torch.where(valid, glabels.long(), 0),
                        valid.long())
    starts = torch.cumsum(counts, 0) - counts
    slots = torch.arange(m_new, device=dev)
    pos = starts[:, None] + slots[None, :]
    new_valid = slots[None, :] < counts[:, None]
    idx = torch.where(new_valid, order[pos.clamp(max=n - 1)], n)
    return idx, new_valid


def hierarchical_core(x, plan: tuple[int, ...], *, variant: str = "auto",
                      categories=None, n_categories: int = 0,
                      fair_codes=None, n_fair_codes: int = 0,
                      solver: str = "auction",
                      auction_config: AuctionConfig = AuctionConfig(),
                      batched: bool = True, chunk_size: int | None = None,
                      prices=None, return_state: bool = False, device=None):
    """ABA with L = len(plan) levels on ``(n, d)`` rows; (n,) int32 labels
    in [0, prod(plan)).

    Level 1 is the G = 1 ``aba_core`` with ``variant`` (``aba_stream`` with
    ``chunk_size``, which only level 1 needs: the later levels work on
    n / K_1-row groups); each later level is one stacked ``aba_core`` call
    with ``variant="base"`` on the level's ``(G, M, D)`` group stack.
    ``batched=False`` solves the groups of a level one G = 1 call at a time
    instead (the JAX ``vmap``), with the same labels.  ``categories`` /
    ``n_categories`` and ``fair_codes`` / ``n_fair_codes`` (see
    ``aba_core``) stratify every level.  ``prices`` is a per-level tuple of
    warm-start prices of the shapes :func:`plan_price_shapes` gives;
    ``return_state`` also returns ``{"prices": per-level tuple, "mu": (d,)
    level-1 centroid}``.  Both, and ``fair_codes``, need ``batched=True``.
    """
    plan = tuple(int(k) for k in plan)
    dev = resolve_device(device)
    xf = as_float(x, dev)
    n, d = xf.shape
    k_total = math.prod(plan)
    if k_total > n:
        raise ValueError(f"prod(plan)={k_total} > n={n}")
    if (not batched) and (return_state or prices is not None):
        raise NotImplementedError(
            "price/state threading requires batched=True levels")
    if (not batched) and fair_codes is not None:
        raise NotImplementedError(
            "fair_codes requires the batched=True level engine")
    kw = dict(n_categories=n_categories, solver=solver,
              auction_config=auction_config, device=dev)
    cat = None if categories is None else \
        torch.as_tensor(categories, device=dev).long()
    codes = None if fair_codes is None else \
        torch.as_tensor(fair_codes, device=dev).long()

    def extended(t):  # one zero row at index n: the padding's gather source
        return None if t is None else torch.cat(
            [t, t.new_zeros((1, *t.shape[1:]))])

    x_ext, cat_ext, codes_ext = extended(xf), extended(cat), extended(codes)

    def p_in(level):
        return None if prices is None else prices[level]

    if chunk_size is not None:
        glabels, st1 = aba_stream(
            xf, plan[0], chunk_size, variant=variant, categories=cat,
            fair_codes=codes, n_fair_codes=n_fair_codes, prices=p_in(0),
            return_state=True, **kw)
        mu1 = st1["mu"]
    else:
        glabels, st1 = aba_core(
            xf[None], plan[0], variant=variant,
            categories=None if cat is None else cat[None],
            fair_codes=None if codes is None else codes[None],
            n_fair_codes=n_fair_codes, prices=p_in(0), return_state=True,
            **kw)
        glabels, mu1 = glabels[0], st1["mu"][0]
    p_levels = [st1["prices"]]
    n_groups = plan[0]
    m = -(-n // n_groups)  # upper bound on a group's size
    every_row = torch.ones((n,), dtype=torch.bool, device=dev)

    for li, k_l in enumerate(plan[1:], start=1):
        idx, valid = _regroup(glabels, every_row, n_groups, m)
        xg = x_ext[idx]  # (G, M, D)
        cg = None if cat is None else cat_ext[idx]
        fg = None if codes is None else codes_ext[idx]
        if batched:
            sub, st_l = aba_core(xg, k_l, valid, variant="base",
                                 categories=cg, fair_codes=fg,
                                 n_fair_codes=n_fair_codes, prices=p_in(li),
                                 return_state=True, **kw)
            p_levels.append(st_l["prices"])
        else:
            sub = torch.cat([aba_core(
                xg[g:g + 1], k_l, valid[g:g + 1], variant=variant,
                categories=None if cg is None else cg[g:g + 1], **kw)
                for g in range(n_groups)])
        new_global = (torch.arange(n_groups, device=dev)[:, None] * k_l
                      + sub.long())
        # padding entries (index n) land in the dropped slot n
        glabels = torch.zeros((n + 1,), dtype=torch.int64,
                              device=dev).scatter_(
            0, idx.reshape(-1),
            torch.where(valid, new_global, 0).reshape(-1))[:n]
        n_groups *= k_l
        m = -(-m // k_l)
    glabels = glabels.to(torch.int32)
    if return_state:
        return glabels, {"prices": tuple(p_levels), "mu": mu1}
    return glabels
