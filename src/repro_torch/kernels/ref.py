"""Plain PyTorch versions of the port's kernels (the correctness contract).

The CPU path of every kernel wrapper runs these, and ``chip_smoke.py``
holds each CUDA kernel against them on the card.  Counterparts of
``repro/kernels/ref.py`` (``cdist_ref``, ``bid_top2_ref``,
``ssm_scan_ref``) and of the takes behind ``repro.kernels.ops``'s
``gather_rows`` / ``cdist(idx=)`` / ``bid_top2(idx=)``.  Every gather here
clips its indices to ``[0, n - 1]``, as the TPU kernels do.

The plain versions of the two phase kernels are the auction's Python
round loop :func:`auction_rounds`: over :func:`factored_top2` for
``auction_phase`` (the ``"auction_fused"`` solver, the stream route; one
phase a call) and over :func:`top2` of ``cost - p`` for
``auction_phase_dense`` (the ``"auction"`` solver, the flat and stacked
routes; every phase of a LAP's schedule a call).  The solvers run them
on CPU tensors and under ``ops.forced_path("ref")``; on the card they
launch the kernels.
"""

from __future__ import annotations

import math

import torch

_NEG = -1e30  # sentinel "minus infinity" that survives f32 arithmetic

# Bidding rounds between two tests of the phase predicate.  Each test is a
# device-to-host read that drains the launch queue; a phase runs tens to
# hundreds of rounds.  Chosen on the H100 by timing R = 1, 8, 16, 32 in
# turns on one streaming chunk (PERF.md): R = 8 was fastest, 16 % under
# R = 1, with 2 % more rounds, the no-op ones.
_CHECK_EVERY = 8

# bidding rounds auction_rounds ran in this process, no-op rounds too; the
# phase kernel's are summed on the card (kernels.auction_phase.totals)
rounds_executed = 0

# device -> int64 [bids, single-bidder rounds] of auction_rounds: the
# unassigned rows of each group at each round's start, summed on the device
# (read by bid_totals).  A round after a group converged adds nothing, so
# these equal the phase kernel's counts of the same phases.
_bid_totals: dict[torch.device, torch.Tensor] = {}


def bid_totals() -> dict:
    """Bids and rounds with a single bidder (per group) that
    :func:`auction_rounds` ran since :func:`reset_bid_totals`, summed over
    devices (a read from each device)."""
    out = {"bids": 0, "single_bidder_rounds": 0}
    for t in _bid_totals.values():
        b, s = t.tolist()
        out["bids"] += b
        out["single_bidder_rounds"] += s
    return out


def reset_bid_totals() -> None:
    for t in _bid_totals.values():
        t.zero_()


def top2(values: torch.Tensor):
    """Last-axis (best value, best index, second value) of a (..., n) tensor.

    Ties go to the lowest index; when the maximum occurs twice the second
    value equals the first.  Indices are int64.
    """
    j1 = values.argmax(dim=-1)
    v1 = values.gather(-1, j1[..., None])[..., 0]
    v2 = values.scatter(-1, j1[..., None], _NEG).amax(dim=-1)
    return v1, j1, v2


def cdist_ref(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(m, d), (n, d) -> (m, n) squared Euclidean distances,
    ``||x_i||^2 - 2 x_i.c_j + ||c_j||^2``."""
    x = x.float()
    c = c.float()
    xn = (x * x).sum(dim=1)[:, None]
    cn = (c * c).sum(dim=1)[None, :]
    return xn - 2.0 * (x @ c.T) + cn


def bid_top2_ref(x: torch.Tensor, c: torch.Tensor, prices: torch.Tensor):
    """Top-2 of ``-2 x_i.c_j + ||c_j||^2 - p_j`` over j, per row i.

    Takes (m, d), (k, d), (k,) or the stacked (G, m, d), (G, k, d), (G, k).
    The stacked form solves each group with the same call as the flat form,
    so a group's result does not depend on G.
    """
    if x.dim() == 3:
        outs = [bid_top2_ref(x[g], c[g], prices[g]) for g in range(x.shape[0])]
        return tuple(torch.stack(t) for t in zip(*outs))
    x = x.float()
    c = c.float()
    vals = -2.0 * (x @ c.T) + (c * c).sum(dim=1)[None, :] - prices[None, :]
    return top2(vals)


def bid_top2_span_ref(x: torch.Tensor, c: torch.Tensor):
    """The factored auction's span bids: ``bid_top2_ref(x, c, 0)`` and
    ``bid_top2_ref(-x, c, 2 ||c||^2)``, two calls, group by group on a
    stack, so that a group's norms (and bits) do not depend on G."""
    if x.dim() == 3:
        outs = [bid_top2_span_ref(x[g], c[g]) for g in range(x.shape[0])]
        return tuple(tuple(torch.stack(t) for t in zip(*slot))
                     for slot in zip(*outs))
    c = c.float()
    pn = 2.0 * (c * c).sum(dim=1)
    return (bid_top2_ref(x, c, torch.zeros_like(pn)),
            bid_top2_ref(-x, c, pn))


def gather_rows_ref(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[clip(idx, 0, n - 1)]`` as float32: (n, d), (m,) -> (m, d)."""
    return x[idx.long().clamp(0, x.shape[0] - 1)].float()


def cdist_gather_ref(x: torch.Tensor, idx: torch.Tensor,
                     c: torch.Tensor) -> torch.Tensor:
    """``cdist_ref(x[clip(idx)], c)``: (n, d), (m,), (nc, d) -> (m, nc)."""
    return cdist_ref(gather_rows_ref(x, idx), c)


def bid_top2_gather_ref(x: torch.Tensor, idx: torch.Tensor, c: torch.Tensor,
                        prices: torch.Tensor):
    """``bid_top2_ref(x[clip(idx)], c, prices)``: (n, d), (m,), (k, d),
    (k,) -> (v1, j1, v2), each (m,)."""
    return bid_top2_ref(gather_rows_ref(x, idx), c, prices)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """float32, or float64 where it already is: the scan's plain versions
    keep float64 for ``torch.autograd.gradcheck``."""
    return t if t.dtype == torch.float64 else t.float()


def ssm_scan_chunk_ref(dt, b_in, c_out, x_in, a_mat, h0):
    """The selective scan in time-major layout, one step at a time:
    ``h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t``, ``y_t = <h_t, C_t>``.

    dt, x_in (C, B, di); b_in, c_out (C, B, ds); a_mat (di, ds); h0
    (B, di, ds).  Returns (y (C, B, di), h_final (B, di, ds)).
    """
    a = _wide(a_mat)
    h = _wide(h0).clone()
    ys = []
    for t in range(dt.shape[0]):
        dt_t = _wide(dt[t])
        da = torch.exp(dt_t[:, :, None] * a[None])
        h = h * da + (dt_t * _wide(x_in[t]))[:, :, None] * _wide(b_in[t])[:, None, :]
        ys.append((h * _wide(c_out[t])[:, None, :]).sum(dim=-1))
    y = (torch.stack(ys) if ys else
         torch.zeros(dt.shape, dtype=torch.float32, device=dt.device))
    return y, h


def ssm_scan_ref(dt, b_in, c_out, x_in, a_mat):
    """The selective scan from ``h0 = 0``: dt, x_in (B, S, di); b_in, c_out
    (B, S, ds); a_mat (di, ds).  Returns (y (B, S, di), h_final
    (B, di, ds))."""
    bsz, _, di = dt.shape
    h0 = torch.zeros((bsz, di, a_mat.shape[1]), dtype=torch.float32,
                     device=dt.device)
    y, h = ssm_scan_chunk_ref(*(t.transpose(0, 1) for t in
                                (dt, b_in, c_out, x_in)), a_mat, h0)
    return y.transpose(0, 1).contiguous(), h


def ssm_scan_chunk_bwd_ref(dt, b_in, c_out, x_in, a_mat, h0, dy, dh):
    """The selective scan's gradient in time-major layout, step by step.

    The forward recurrence again for every ``h_{t-1}``, then the reverse
    walk ``g_t = dy_t C_t + exp(dt_{t+1} A) g_{t+1}`` (``g_t``: the loss's
    gradient with respect to ``h_t``), seeded with ``dh`` (its gradient
    with respect to h_final); with ``w_t = g_t h_{t-1} exp(dt_t A)`` and
    ``du_t = <g_t, B_t>``, the step's terms are ``dC_t = sum_i dy_t h_t``,
    ``dB_t = sum_i g_t dt_t x_t``, ``dx_t = du_t dt_t``, ``d(dt)_t = du_t
    x_t + <w_t, A>`` and ``dA += w_t dt_t`` (over batch and time).

    dt, x_in, dy (C, B, di); b_in, c_out (C, B, ds); a_mat (di, ds); h0,
    dh (B, di, ds).  Returns (ddt, db, dc, dx, da, dh0) of the inputs'
    shapes, float32 (float64 for float64 inputs).  The plain version of ``csrc/ssm_scan_bwd.cu``
    (written out, not autograd of :func:`ssm_scan_chunk_ref`).
    """
    a = _wide(a_mat)
    hs = [_wide(h0)]
    for t in range(dt.shape[0]):
        dt_t = _wide(dt[t])
        hs.append(hs[-1] * torch.exp(dt_t[:, :, None] * a)
                  + (dt_t * _wide(x_in[t]))[:, :, None]
                  * _wide(b_in[t])[:, None, :])
    g_next = _wide(dh).clone()
    da = torch.zeros_like(a)
    ddt, db, dc, dx = ([None] * dt.shape[0] for _ in range(4))
    for t in reversed(range(dt.shape[0])):
        dt_t, x_t, dy_t = _wide(dt[t]), _wide(x_in[t]), _wide(dy[t])
        b_t, c_t = _wide(b_in[t]), _wide(c_out[t])
        decay = torch.exp(dt_t[:, :, None] * a)
        g = dy_t[:, :, None] * c_t[:, None, :] + g_next
        dc[t] = (dy_t[:, :, None] * hs[t + 1]).sum(1)
        db[t] = (g * (dt_t * x_t)[:, :, None]).sum(1)
        du = (g * b_t[:, None, :]).sum(-1)
        w = g * hs[t] * decay
        da = da + (w * dt_t[:, :, None]).sum(0)
        ddt[t] = du * x_t + (w * a).sum(-1)
        dx[t] = du * dt_t
        g_next = decay * g

    def stack(parts, like):
        return (torch.stack(parts) if parts else
                torch.zeros(like.shape, dtype=a.dtype, device=like.device))

    return (stack(ddt, dt), stack(db, b_in), stack(dc, c_out), stack(dx, x_in),
            da, g_next)


def ssm_scan_bwd_ref(dt, b_in, c_out, x_in, a_mat, dy, dh):
    """The gradient of :func:`ssm_scan_ref` (from ``h0 = 0``): dt, x_in, dy
    (B, S, di); b_in, c_out (B, S, ds); a_mat (di, ds); dh (B, di, ds) ->
    (ddt, db, dc, dx, da), float32, by :func:`ssm_scan_chunk_bwd_ref`."""
    bsz, _, di = dt.shape
    h0 = torch.zeros((bsz, di, a_mat.shape[1]), dtype=_wide(a_mat).dtype,
                     device=dt.device)
    ddt, db, dc, dx, da, _ = ssm_scan_chunk_bwd_ref(
        *(t.transpose(0, 1) for t in (dt, b_in, c_out, x_in)), a_mat, h0,
        dy.transpose(0, 1), dh)
    return (*(t.transpose(0, 1).contiguous() for t in (ddt, db, dc, dx)),
            da)


def auction_rounds(top2_fn, prices, eps, max_rounds: int,
                   fixed_rounds: int = 0, skip=None, seed_top2=None,
                   return_rounds: bool = False):
    """One epsilon phase of batched Jacobi forward auction (maximization).

    ``top2_fn(prices)`` returns the per-row ``(v1, j1, v2)`` of
    ``cost - prices``, each (B, n).  ``prices`` / ``eps`` are (B, n) / (B,).
    Every row starts unassigned, except in instances marked by ``skip``
    ((B,) bool), whose rows start on the identity and so never bid.
    ``seed_top2`` is the first round's reduction, already computed by the
    caller at the incoming prices.  Returns ``(row_to_col, prices)``, and
    with ``return_rounds`` also the (B,) int64 rounds each instance ran, as
    the phase kernels write them to ``rounds_g``: the rounds that began
    with an unassigned row of the instance (the no-op rounds between two
    tests of the predicate are not counted), the seeded round always, and
    ``fixed_rounds`` when that is > 0.  The count stays on the device.
    """
    global rounds_executed
    B, n = prices.shape
    dev = prices.device
    ran = (torch.zeros(B, dtype=torch.int64, device=dev)
           if return_rounds and not fixed_rounds else None)
    rows = torch.arange(n, device=dev).expand(B, n)
    # Column n of these buffers is a dump slot: a scatter to it is the JAX
    # ``mode="drop"``, and an unassigned row (-1) reads it as "no object".
    assign_ext = torch.full((B, n + 1), -1, dtype=torch.int64, device=dev)
    assign = assign_ext[:, :n]
    if skip is not None:
        assign.copy_(torch.where(skip[:, None], rows, -1))
    eps = eps[:, None]
    counts = _bid_totals.get(dev)
    if counts is None:
        counts = _bid_totals[dev] = torch.zeros(2, dtype=torch.int64,
                                                device=dev)

    # The round below is the JAX round with fewer launches (this loop is
    # launch-bound) and the same results: rows that hold an object bid
    # -inf, below the NEG floor of every object's best bid, so they are
    # never the best bidder; and the lost-object test reads got_bid through
    # the dump column, which is False.
    def body(prices, top2, seeded=False):
        bidders = (assign < 0).sum(dim=1)
        counts.add_(torch.stack((bidders.sum(), (bidders == 1).sum())))
        if ran is not None:
            ran.add_(1 if seeded else bidders > 0)
        v1, j1, v2 = top2
        # Bid: raise the favourite object's price past the runner-up by eps.
        bids = v1 + prices.gather(1, j1) - v2 + eps
        bid_val = bids.masked_fill_(assign >= 0, -math.inf)
        # Per-object best bid, and the lowest row that made it.
        best = prices.new_full((B, n), _NEG).scatter_reduce_(
            1, j1, bid_val, "amax", include_self=True)
        cand = torch.where(bid_val >= best.gather(1, j1), rows, n)
        winner = torch.full((B, n + 1), n, dtype=torch.int64,
                            device=dev).scatter_reduce_(
            1, j1, cand, "amin", include_self=True)
        got_bid = winner < n  # (B, n + 1); the dump column is False
        # A row whose object got a bid loses it.  (It did not bid, so it
        # cannot be the winner.)
        assign.masked_fill_(got_bid.gather(1, assign.remainder(n + 1)), -1)
        winner = winner[:, :n]
        assign_ext.scatter_(1, winner, rows)  # winners take their objects
        return torch.where(got_bid[:, :n], best, prices)

    it = 0
    if seed_top2 is not None:
        prices = body(prices, seed_top2, seeded=True)
        it = 1
    if fixed_rounds:
        for _ in range(max(fixed_rounds - it, 0)):
            prices = body(prices, top2_fn(prices))
        rounds_executed += fixed_rounds
        if return_rounds:
            return assign, prices, torch.full((B,), fixed_rounds,
                                              dtype=torch.int64, device=dev)
        return assign, prices
    while it < max_rounds and bool((assign < 0).any()):
        for _ in range(min(_CHECK_EVERY, max_rounds - it)):
            prices = body(prices, top2_fn(prices))
            it += 1
    rounds_executed += it
    if return_rounds:
        return assign, prices, ran
    return assign, prices


def factored_top2(x, c, is_real, bid_top2=bid_top2_ref):
    """The factored bidding reduction at prices p: ``bid_top2(x, c, p)`` for
    the real rows ((G, n) bool ``is_real``, or None), the top-2 of ``-p``
    for the dummy rows.  ``bid_top2`` is the plain version, or a kernel the
    loop is to run over."""
    def top2_fn(p):
        v1, j1, v2 = bid_top2(x, c, p)
        if is_real is not None:
            # dummy rows all see value -p: one (G,) top-2 per group
            dv1, dj1, dv2 = top2(-p)
            v1 = torch.where(is_real, v1, dv1[:, None])
            j1 = torch.where(is_real, j1, dj1[:, None])
            v2 = torch.where(is_real, v2, dv2[:, None])
        return v1, j1, v2
    return top2_fn


def auction_phase_ref(x, c, is_real, prices, eps, max_rounds: int,
                      fixed_rounds: int = 0, skip=None, seed_top2=None,
                      return_rounds: bool = False):
    """The plain version of the ``auction_phase`` kernel: the Python round
    loop over the plain factored reduction (see ``kernels.auction_phase``).
    ``return_rounds`` also returns the (1, G) rounds of each group."""
    out = auction_rounds(factored_top2(x, c, is_real), prices, eps,
                         max_rounds, fixed_rounds, skip, seed_top2,
                         return_rounds)
    return (*out[:2], out[2][None]) if return_rounds else out


def dense_top2(cost):
    """The dense bidding reduction at prices p: :func:`top2` of
    ``cost - p`` over the objects, for a (B, n, n) cost stack."""
    def top2_fn(p):
        return top2(cost - p[:, None, :])
    return top2_fn


def auction_phase_dense_ref(cost, prices, eps, max_rounds: int,
                            fixed_rounds: int = 0, skip=None, seed_top2=None,
                            return_rounds: bool = False):
    """The plain version of the ``auction_phase_dense`` kernel: the Python
    round loop over the dense reduction (see ``kernels.auction_phase``),
    once for each of the P phases of the (P, G) schedule ``eps``.  Each
    phase starts with every row unassigned (but in the groups ``skip[p]``
    marks) and with the prices of the phase before; ``seed_top2`` is the
    first phase's first reduction.  Returns the last phase's
    ``(assign, prices)``, and with ``return_rounds`` the (P, G) rounds of
    every phase and group (see :func:`auction_rounds`)."""
    top2_fn = dense_top2(cost)
    rounds = []
    for p in range(eps.shape[0]):
        out = auction_rounds(
            top2_fn, prices, eps[p], max_rounds, fixed_rounds,
            None if skip is None else skip[p],
            seed_top2 if p == 0 else None, return_rounds)
        assign, prices = out[:2]
        rounds.extend(out[2:])
    if return_rounds:
        return assign, prices, torch.stack(rounds)
    return assign, prices
