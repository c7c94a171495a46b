"""Delta updates on live partitions, in PyTorch.

Counterpart of ``repro/incremental.py``.  A live partition absorbs a delta
without a full re-solve: departures free capacity in their clusters and
down-date the carried centrality moments; arrivals are placed by a small
restricted assignment over only the open capacity, every other row's
label and every other cluster's dual price frozen.

With ``n'`` post-delta rows each of the k clusters may hold ``floor(n'/k)``
or ``ceil(n'/k)`` rows.  Given the kept rows' label counts ``sizes_c``,
cluster ``c`` exposes ``cap_c = ceil' - sizes_c`` open slots, of which the
first ``lo_c = max(0, floor' - sizes_c)`` are mandatory.  Arrivals are
sorted by centrality against the carried global moments (far first) and
split into ``B = max_c cap_c`` batches over a rank-indexed slot schedule
(:func:`_slot_schedule`): batch ``b`` owns each cluster's rank-``b`` open
slot, so no batch sees a duplicate column.  One ``(B, k, k)`` LAP stack,
warm-started from the partition's per-cluster prices, places everything
at once (:func:`_delta_assign`): on the card one ``auction_phase_dense``
launch at G = B, whose re-entry probe lets near-equilibrium clusters run
only the final epsilon phase.

A delta beyond ``spec.update_threshold`` of the post-delta rows, a cluster
left above the new ceiling, too few arrivals to refill the floors, or a
restricted solve that breaks balance falls back, with a
``RuntimeWarning`` naming the reason, to a full warm repartition that is
bit for bit ``AnticlusterEngine.repartition`` of the post-delta rows with
the carried state (:func:`_carried_state`).

Every reduction here adds in a fixed order (a one-hot product, a sum over
the batch axis, integer counts), so an update on the card gives the same
labels run after run: ``index_add_`` / ``scatter_add_`` on float32 add in
no fixed order there, which would flip auction ties.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch._device import DTYPE
from repro_torch.anticluster import (ABAState, AnticlusterEngine,
                                     AnticlusterResult, AnticlusterSpec,
                                     _cluster_prices, _host, _on,
                                     _resolve_spec, _result)
from repro_torch.core.aba import delta_moments
from repro_torch.core.assignment import get_solver

__all__ = ["IncrementalPartition", "engine_update"]


def _slot_schedule(sizes_kept: np.ndarray, m: int, floor_new: int,
                   ceil_new: int):
    """Host-side rank-indexed batch schedule for the arriving rows.

    Batch ``b`` owns each cluster's rank-``b`` open slot -- present while
    ``b < cap_c``, *mandatory* (must take a real row) while ``b < lo_c`` --
    so no batch ever sees two slots of the same cluster, and the earliest
    batches carry every floor-restoring slot.  Real rows are front-loaded:
    batch ``b`` gets its mandatory quota first, then the leftover arrivals
    in batch order, so far-first sorted rows land early (the paper's
    extreme-rows-pick-first idiom).

    Returns ``(slot_map (B, k) int32 cluster-or--1, mandatory (B, k) bool,
    idx (B, k) sorted-row index or m for dummies, inv_b (m,), inv_j (m,))``
    with ``idx[inv_b[s], inv_j[s]] == s`` for every sorted row ``s``.
    Feasibility (``cap_c >= 0``, ``sum lo <= m <= sum cap``) is the
    caller's pre-check.
    """
    k = sizes_kept.shape[0]
    cap = ceil_new - sizes_kept
    lo = np.maximum(floor_new - sizes_kept, 0)
    B = max(int(cap.max(initial=0)), 1)
    b_idx = np.arange(B)[:, None]
    open_ = b_idx < cap[None, :]
    slot_map = np.where(open_, np.arange(k)[None, :], -1).astype(np.int32)
    mandatory = b_idx < lo[None, :]
    s_b = open_.sum(axis=1)
    rows_b = mandatory.sum(axis=1)
    leftover = m - int(rows_b.sum())
    for b in range(B):
        take = min(leftover, int(s_b[b] - rows_b[b]))
        rows_b[b] += take
        leftover -= take
    starts = np.concatenate([[0], np.cumsum(rows_b)[:-1]])
    idx = np.full((B, k), m, np.int32)
    inv_b = np.empty((m,), np.int32)
    inv_j = np.empty((m,), np.int32)
    for b in range(B):
        r = int(rows_b[b])
        idx[b, :r] = starts[b] + np.arange(r)
        inv_b[starts[b]:starts[b] + r] = b
        inv_j[starts[b]:starts[b] + r] = np.arange(r)
    return slot_map, mandatory, idx, inv_b, inv_j


def _delta_assign(x_kept, labels_kept, added, cluster_prices, msum, mcnt,
                  slot_map, mandatory, idx, inv_b, inv_j, *, k: int,
                  solver: str, config):
    """Batched frozen-price placement of the arriving rows.

    Solves one ``(B, k, k)`` LAP stack over the :func:`_slot_schedule`
    batches, the shape the ABA core solves a row batch at, so the delta
    costs ``B`` batch LAPs against the full solve's ``n'/k``.  Returns
    ``(added_labels (m,) int32, new_cluster_prices (k,), sizes_final (k,)
    int32)``; ``added_labels`` is -1 where a row landed on a void slot
    (never, unless the round-capped auction leaves a tangle: the caller's
    balance check catches it).  The schedule's tensors are on the rows'
    device.
    """
    m, d = added.shape
    dev = added.device
    # per-cluster sizes and sums of the kept rows, in a fixed order: a
    # one-hot (k, n) product (TF32 is off) and an integer-exact row sum
    onehot = (labels_kept.long()[None, :]
              == torch.arange(k, device=dev)[:, None]).to(DTYPE)
    sizes = onehot.sum(dim=1)
    mu = (onehot @ x_kept) / sizes.clamp(min=1.0)[:, None]

    # centrality sort against the carried (post-delta) global moments: the
    # most distant arrivals pick their clusters first
    mean = msum / mcnt.clamp(min=1.0)
    order = torch.argsort(-((added - mean[None]) ** 2).sum(dim=-1),
                          stable=True)
    srt = torch.cat([added[order], added.new_zeros((1, d))])
    rows = srt[idx.long()]                                # (B, k, d)
    is_dummy = idx == m                                   # (B, k) rows
    void = slot_map < 0                                   # (B, k) columns
    mu_b = mu[slot_map.long().clamp(min=0)]               # (B, k, d)
    # maximize ||x - mu||^2; ||x||^2 is a per-row constant and drops,
    # leaving the batch LAP's reduced benefit (core/aba.py)
    val = (-2.0 * torch.einsum("bid,bjd->bij", rows, mu_b)
           + (mu_b * mu_b).sum(dim=-1)[:, None, :])
    # span-scaled penalty, not the quota mask's -1e9 (ROADMAP R6): the
    # baseline dummy / void value 0 is folded into the span
    real = (~is_dummy[:, :, None]) & (~void[:, None, :])
    hi = torch.where(real, val, -torch.inf).amax().clamp(min=0.0)
    lo_v = torch.where(real, val, torch.inf).amin().clamp(max=0.0)
    pen = -(4.0 * (hi - lo_v).clamp(min=1e-6) + 1.0)
    val = torch.where(
        is_dummy[:, :, None],
        torch.where(mandatory[:, None, :] & ~void[:, None, :], pen, 0.0),
        torch.where(void[:, None, :], pen, val))
    p0 = torch.where(void, 0.0,
                     cluster_prices[slot_map.long().clamp(min=0)])
    assign, p_out = get_solver(solver).solve(val.contiguous(), config, p0)

    col = assign[inv_b.long(), inv_j.long()]              # (m,) sorted order
    srt_labels = slot_map[inv_b.long(), col]
    added_labels = torch.empty((m,), dtype=torch.int32,
                               device=dev).scatter_(0, order, srt_labels)
    # fold the final batch duals back to one price per cluster (the mean
    # over its open slots): a batch holds each cluster once, so the sum
    # over the batch axis is the per-cluster sum, in a fixed order;
    # clusters with no open slot keep their frozen price
    p_sum = torch.where(void, 0.0, p_out).sum(dim=0)
    cnt = (~void).sum(dim=0).to(DTYPE)
    new_cp = torch.where(cnt > 0, p_sum / cnt.clamp(min=1.0),
                         cluster_prices)
    placed = torch.where(added_labels >= 0, 1, 0).to(torch.int32)
    sizes_final = sizes.to(torch.int32).index_add_(
        0, added_labels.long().clamp(min=0), placed)
    return added_labels, new_cp, sizes_final


def _carried_state(state: ABAState, new_n: int, added_x,
                   removed_x) -> ABAState:
    """The post-delta warm state the fallback hands to ``repartition``:
    the prices verbatim (one dual per cluster per level, independent of
    n), the moments delta-merged (:func:`delta_moments`), ``prev_labels``
    reset to -1 (they index the pre-delta row order)."""
    msum, mcnt = delta_moments(state.moment_sum, state.moment_count,
                               added=added_x, removed=removed_x)
    return ABAState(prices=state.prices, moment_sum=msum, moment_count=mcnt,
                    prev_labels=torch.full((new_n,), -1, dtype=torch.int32,
                                           device=msum.device))


def _removed_mask(removed, n: int) -> np.ndarray:
    """``removed`` (indices or an (n,) bool mask) -> the (n,) keep mask."""
    keep = np.ones((n,), bool)
    if removed is None:
        return keep
    rem = _host(removed)
    if rem.dtype == np.bool_:
        if rem.shape != (n,):
            raise ValueError(
                f"a bool removed mask must be ({n},), got {rem.shape}")
        return ~rem
    rem = rem.astype(np.int64).reshape(-1)
    if rem.size:
        if rem.min() < 0 or rem.max() >= n:
            raise ValueError(
                f"removed indices must lie in [0, {n}), got range "
                f"[{rem.min()}, {rem.max()}]")
        if np.unique(rem).size != rem.size:
            raise ValueError("removed indices must be unique")
        keep[rem] = False
    return keep


def engine_update(engine: AnticlusterEngine, x, state: ABAState, *,
                  added=None, removed=None):
    """:meth:`AnticlusterEngine.update`: ``(result, new_x, new_state)``.

    Flat, streamed and hierarchical category-free sessions only; stacked,
    categorical and masked sessions raise ``NotImplementedError``
    (repartition instead).
    """
    spec = engine.spec
    x = engine._rows(x)
    shape = tuple(x.shape)
    if len(shape) != 2:
        raise NotImplementedError(
            "update() takes a flat (n, d) live partition; stacked (G, M, D) "
            "sessions update one group at a time")
    n, d = shape
    mode, plan, solver, _chunk = engine._routed(shape)
    if engine._cats is not None:
        raise NotImplementedError(
            "categorical/fairness quotas pin per-stratum balance, which a "
            "local slot patch cannot restore; update() is category-free -- "
            "repartition")
    if engine._vm is not None:
        raise NotImplementedError(
            "spec.valid_mask sessions carry padding rows; drop the padding "
            "and update the unmasked rows instead")
    if not isinstance(state, ABAState):
        raise TypeError(
            f"update() carries ABAState, got {type(state).__name__} (build "
            "states with engine.partition / previous update calls)")

    added_x = None
    if added is not None:
        added_x = _on(added, x.device, None)
        if added_x.dim() != 2 or (added_x.shape[0]
                                  and added_x.shape[1] != d):
            raise ValueError(
                f"added must be (m, {d}) to match x, got "
                f"{tuple(added_x.shape)}")
        added_x = added_x.to(spec.dtype)
        if added_x.shape[0] == 0:
            added_x = None
    keep = _removed_mask(removed, n)
    r = int((~keep).sum())
    m = 0 if added_x is None else int(added_x.shape[0])

    if m == 0 and r == 0:
        # a zero delta IS a repartition
        res, new_state = engine.repartition(x, state)
        return res, x, new_state

    new_n = n - r + m
    if new_n < spec.k:
        raise ValueError(
            f"the delta leaves n={new_n} rows, fewer than k={spec.k}")

    dev = x.device
    kept_idx = torch.from_numpy(np.flatnonzero(keep)).to(dev)
    removed_x = (None if r == 0 else
                 x[torch.from_numpy(np.flatnonzero(~keep)).to(dev)])
    x_kept = x if r == 0 else x[kept_idx]
    new_x = x_kept if m == 0 else torch.cat([x_kept, added_x])

    def _fallback(reason: str):
        warnings.warn(
            f"update(added={m}, removed={r}) on n={n}: {reason}; falling "
            "back to a full warm repartition of the post-delta rows "
            "(bit-for-bit identical to repartition() with the carried "
            "prices)", RuntimeWarning, stacklevel=4)
        res, st = engine.repartition(
            new_x, _carried_state(state, new_n, added_x, removed_x))
        return res, new_x, st

    frac = (m + r) / new_n
    if frac > spec.update_threshold:
        return _fallback(
            f"delta fraction {frac:.3f} exceeds "
            f"update_threshold={spec.update_threshold}")

    prev = _host(state.prev_labels)
    if prev.shape != (n,) or (prev < 0).any() or (prev >= spec.k).any():
        raise ValueError(
            "state carries no labels for these rows (prev_labels unset or "
            "from a different shape); run partition()/repartition() first")

    k = spec.k
    floor_new, ceil_new = new_n // k, -(-new_n // k)
    sizes_kept = np.bincount(prev[keep], minlength=k)
    if sizes_kept.max(initial=0) > ceil_new:
        return _fallback(
            "a cluster exceeds the new size ceiling after the departures "
            "(balance cannot be restored locally)")
    if int(np.maximum(floor_new - sizes_kept, 0).sum()) > m:
        return _fallback(
            "too few arrivals to refill every cluster to the new floor "
            "(balance cannot be restored locally)")

    labels_kept = torch.from_numpy(prev[keep].astype(np.int32)).to(dev)
    prices = tuple(p.to(device=dev, dtype=DTYPE) for p in state.prices)
    cp = _cluster_prices(prices, mode)  # (k,) global duals
    msum, mcnt = delta_moments(state.moment_sum.to(dev),
                               state.moment_count.to(dev),
                               added=added_x, removed=removed_x)
    if m == 0:
        # departures only: every kept row keeps its label, duals untouched
        # (the feasibility checks above guarantee balance already holds)
        new_labels, new_cp = labels_kept, cp
    else:
        sched = [torch.from_numpy(a).to(dev) for a in _slot_schedule(
            sizes_kept, m, floor_new, ceil_new)]
        added_labels, new_cp, sizes_final = _delta_assign(
            x_kept.to(DTYPE), labels_kept, added_x.to(DTYPE), cp, msum,
            mcnt, *sched, k=k, solver=solver, config=spec.auction_config)
        sizes_np = _host(sizes_final)
        if bool((added_labels < 0).any()) or sizes_np.min() < floor_new \
                or sizes_np.max() > ceil_new:
            # the round-capped auction can (rarely) leave a row or dummy on
            # the wrong slot; a local patch that breaks balance is worthless
            return _fallback(
                "the restricted assignment could not restore balance "
                "locally")
        new_labels = torch.cat([labels_kept, added_labels])

    # only the last level's prices index global clusters (labels compose
    # as g * k_last + sub); earlier levels carry over
    last = new_cp.reshape(prices[-1].shape)
    last = last - last.amax(dim=-1, keepdim=True)
    new_prices = tuple(prices[:-1]) + (last,)
    new_state = ABAState(prices=new_prices, moment_sum=msum,
                         moment_count=mcnt, prev_labels=new_labels)
    result = _result(new_x, new_labels, new_prices, spec, mode, plan, solver,
                     updated=True)
    return result, new_x, new_state


class IncrementalPartition:
    """A live partition: owns the running rows, labels and state, and
    absorbs deltas in place.  ``x``'s row order after an update is
    ``concat(kept rows in their order, added rows)``.

        live = IncrementalPartition(x0, k=16, device="cpu")
        live.update(added=fresh_rows)            # restricted warm placement
        live.update(removed=np.arange(8))        # departures free capacity

    Pass a spec / overrides (a private engine is built on ``device``) or
    share an ``engine=`` across partitions.  Everything is
    :meth:`AnticlusterEngine.update` semantics, the over-threshold fallback
    included.
    """

    def __init__(self, x, spec: AnticlusterSpec | None = None, *,
                 engine: AnticlusterEngine | None = None, device=None,
                 **overrides):
        if engine is not None:
            if spec is not None or overrides:
                raise ValueError(
                    "pass spec/overrides or a prebuilt engine, not both")
            self.engine = engine
        else:
            self.engine = AnticlusterEngine(_resolve_spec(spec, overrides),
                                            device=device)
        self._x = self.engine._rows(x)
        self.result, self.state = self.engine.partition(self._x)

    @property
    def x(self) -> torch.Tensor:
        """The current (n, d) rows, post-delta row order."""
        return self._x

    @property
    def labels(self) -> torch.Tensor:
        return self.result.labels

    @property
    def k(self) -> int:
        return self.engine.spec.k

    @property
    def n(self) -> int:
        return int(self._x.shape[0])

    def __len__(self) -> int:
        return self.n

    def update(self, added=None, removed=None) -> AnticlusterResult:
        """Absorb a delta in place; returns (and stores) the new result."""
        result, self._x, self.state = self.engine.update(
            self._x, self.state, added=added, removed=removed)
        self.result = result
        return result

    def repartition(self) -> AnticlusterResult:
        """Force a full warm re-solve of the current rows."""
        self.result, self.state = self.engine.repartition(self._x,
                                                          self.state)
        return self.result
