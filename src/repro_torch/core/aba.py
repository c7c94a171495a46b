"""The Assignment-Based Anticlustering algorithm (paper Section 4), in PyTorch.

Counterpart of ``repro/core/aba.py``: the dense core :func:`aba_core` on a
``(G, M, D)`` stack and the streaming core :func:`aba_stream` on flat
``(n, d)`` rows.  Both run the centrality sort, the Section 4.2 interleave
rearrangement and the Algorithm-1 batch scan, and every batch goes through
the one :func:`_assign_batch`, so ``aba_stream`` with ``chunk_size >= n``
gives labels bit-identical to ``aba_core(x[None])[0]``.

The scans are Python loops.  The streaming core pulls each chunk's rows
through the ``gather_rows`` kernel, and with the ``"auction_fused"`` solver
every bidding round is one ``bid_top2`` kernel launch.

Not ported yet (ROADMAP Queue 1 item 3): ``categories`` / ``fair_codes``
(Section 4.3), ``valid_mask`` and solver telemetry; they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import as_float, resolve_device
from repro_torch.core.assignment import AuctionConfig, get_solver
from repro_torch.kernels.ops import gather_rows


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


def _not_ported(**features):
    for name, value in features.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported to PyTorch yet (ROADMAP Queue 1 "
                f"item {8 if name == 'telemetry' else 3})")


def _centrality(xf: torch.Tensor):
    """(G, M, D) -> per-group centroid (G, D), squared distance (G, M)."""
    mu = xf.mean(dim=1)
    return mu, ((xf - mu[:, None, :]) ** 2).sum(dim=-1)


def _use_interleave(variant: str, n: int, k: int) -> bool:
    if variant not in ("auto", "base", "interleave"):
        raise ValueError(f"unknown variant {variant!r}")
    return variant == "interleave" or (variant == "auto" and n // k <= 8)


def _assign_batch(solver_obj, fused: bool, config, cents, counts, xb,
                  is_real, prices=None):
    """One Algorithm-1 batch on a (G, k, ...) stack: solve the LAP against
    the current centroids and fold the rows into the running means.

    ``is_real`` is (G, k) bool, or None when every row is real.  Returns
    ``(cents, counts, assign, prices)``; the assignment is int64.
    """
    if fused:
        # matrix-free: each auction round is one bid_top2 launch
        assign, p_out = solver_obj.factored(xb, cents, is_real=is_real,
                                            config=config, prices=prices)
    else:
        # reduced cost: the row constant ||x||^2 is dropped (LAP-invariant)
        cost = (-2.0 * torch.einsum("gid,gjd->gij", xb, cents)
                + (cents * cents).sum(dim=-1)[:, None, :])
        if is_real is not None:
            cost = torch.where(is_real[..., None], cost, 0.0)
        assign, p_out = solver_obj.solve(cost, config, prices)
    real = (torch.ones_like(assign) if is_real is None else is_real.long())
    new_counts = counts.scatter_add(1, assign, real)
    a3 = assign[..., None].expand(-1, -1, xb.shape[-1])
    delta = xb - cents.gather(1, a3)
    if is_real is not None:
        delta = torch.where(is_real[..., None], delta, 0.0)
    upd = torch.zeros_like(cents).scatter_add_(1, a3, delta)
    cents = cents + upd / new_counts.clamp(min=1)[..., None].to(cents.dtype)
    return cents, new_counts, assign, p_out


def aba_core(x, k: int, valid_mask=None, *, variant: str = "base",
             categories=None, n_categories: int = 0, fair_codes=None,
             n_fair_codes: int = 0, solver: str = "auction",
             auction_config: AuctionConfig = AuctionConfig(), prices=None,
             return_state: bool = False, telemetry: bool = False,
             device=None):
    """Assignment-Based Anticlustering on a ``(G, M, D)`` stack of problems.

    Each step of the batch scan solves the whole ``(G, k, k)`` LAP stack
    with one solver call.  ``prices`` ((G, k)) warm-starts every batch LAP
    from the same carried vector; ``return_state`` also returns
    ``{"prices": (G, k) final prices of the last batch, "mu": (G, D)}``.
    Returns (G, M) int32 labels in [0, k).
    """
    _not_ported(valid_mask=valid_mask, categories=categories,
                fair_codes=fair_codes, telemetry=telemetry)
    dev = resolve_device(device)
    xf = as_float(x, dev)
    G, M, D = xf.shape
    if k > M:
        raise ValueError(f"k={k} > M={M}")
    solver_obj = get_solver(solver)
    p_in = None if prices is None else as_float(prices, dev)

    mu, dist = _centrality(xf)
    order = torch.argsort(-dist, dim=1, stable=True)
    if _use_interleave(variant, M, k):
        order = order[:, torch.as_tensor(interleave_permutation(M, k),
                                         dtype=torch.int64, device=dev)]

    n_batches = -(-M // k)
    pad = n_batches * k - M
    if pad:
        order = torch.cat([order, order.new_full((G, pad), M)], dim=1)
    batches = order.view(G, n_batches, k)
    x_ext = torch.cat([xf, xf.new_zeros((G, 1, D))], dim=1)

    def rows_of(b):
        idx = batches[:, b]
        return x_ext.gather(1, idx[..., None].expand(-1, -1, D)), idx

    cents, first = rows_of(0)
    counts = (first < M).long()
    labels = [torch.arange(k, device=dev).expand(G, k)]
    p_out = (xf.new_zeros((G, k)) if p_in is None else p_in)
    fused = solver_obj.factored is not None
    for b in range(1, n_batches):
        xb, idx = rows_of(b)
        is_real = None if (b + 1) * k <= M else idx < M
        cents, counts, assign, p_out = _assign_batch(
            solver_obj, fused, auction_config, cents, counts, xb, is_real,
            prices=p_in)
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
    the O(n) order and label vectors.  With ``chunk_size >= n`` the labels
    are bit-identical to ``aba_core(x[None], k)[0]``.

    Unlike the JAX core, the last chunk is not padded with all-dummy
    sentinel batches: a Python loop has no fixed trip count to fill.  So the
    returned ``state["prices"]`` ((1, k)) are those of the last real batch,
    as in the dense core.
    """
    _not_ported(valid_mask=valid_mask, categories=categories,
                fair_codes=fair_codes, telemetry=telemetry)
    dev = resolve_device(device)
    xf = as_float(x, dev)
    n, d = xf.shape
    if k > n:
        raise ValueError(f"k={k} > n={n}")
    solver_obj = get_solver(solver)
    p_in = None if prices is None else as_float(prices, dev)
    cpb = max(1, int(chunk_size) // k)  # batches per chunk
    chunk = cpb * k

    if int(chunk_size) >= n or n <= chunk:
        # one covering chunk: the dense core's own ops, for bit parity
        mu3, dist3 = _centrality(xf[None])
        mu, dist = mu3[0], dist3[0]
    else:
        total = xf.new_zeros((d,))
        for s in range(0, n, chunk):
            total += xf[s:s + chunk].sum(dim=0)
        mu = total / n
        dist = torch.cat([((xf[s:s + chunk] - mu) ** 2).sum(dim=-1)
                          for s in range(0, n, chunk)])
    order = torch.argsort(-dist, stable=True)
    if _use_interleave(variant, n, k):
        order = order[torch.as_tensor(interleave_permutation(n, k),
                                      dtype=torch.int64, device=dev)]

    n_batches = -(-n // k)
    pad = n_batches * k - n
    if pad:
        order = torch.cat([order, order.new_full((pad,), n)])
    batches = order.view(n_batches, k)

    # Sentinel indices (== n) are clipped by the gather to the last row;
    # every consumer of a dummy row masks it with is_real, so the clipped
    # values never reach a label.
    cents = gather_rows(xf, batches[0])[None]   # (1, k, d)
    counts = (batches[0] < n).long()[None]
    labels = [torch.arange(k, device=dev)]
    p_out = (xf.new_zeros((1, k)) if p_in is None else p_in)
    fused = solver_obj.factored is not None
    for c0 in range(1, n_batches, cpb):
        bs = batches[c0:c0 + cpb]
        nb = bs.shape[0]
        xc = gather_rows(xf, bs.reshape(-1)).view(nb, k, d)
        for j in range(nb):
            b = c0 + j
            is_real = None if (b + 1) * k <= n else (bs[j] < n)[None]
            cents, counts, assign, p_out = _assign_batch(
                solver_obj, fused, auction_config, cents, counts,
                xc[j][None], is_real, prices=p_in)
            labels.append(assign[0])
    out = torch.zeros((n + 1,), dtype=torch.int64, device=dev).scatter_(
        0, order, torch.cat(labels))[:n].to(torch.int32)
    if return_state:
        return out, {"prices": p_out, "mu": mu}
    return out
