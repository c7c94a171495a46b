"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips where no CUDA device is
present.  The file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.anticluster import AnticlusterEngine, anticluster
from repro_torch.core import assignment as asg
from repro_torch.core.aba import _MASK_COST, aba_core, aba_stream
from repro_torch.core.objective import balance_ok
import repro_torch.kernels as K
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels import auction_phase as phase_kernel
from repro_torch.kernels.bid_top2 import bid_top2 as cuda_bid_top2
from repro_torch.kernels.bid_top2 import bid_top2_span as cuda_bid_top2_span
from repro_torch.kernels.cdist import cdist as cuda_cdist
from repro_torch.kernels.gather import STAGES as GATHER_STAGES
from repro_torch.kernels.gather import bid_top2_gather as cuda_bid_gather
from repro_torch.kernels.gather import (
    bid_top2_gather_prev as cuda_bid_gather_prev,
    bid_top2_gather_timed as cuda_bid_gather_timed)
from repro_torch.kernels.gather import cdist_gather as cuda_cdist_gather
from repro_torch.kernels.gather import gather_rows as cuda_gather_rows
from repro_torch.kernels.ref import (bid_top2_gather_ref, bid_top2_ref,
                                     cdist_gather_ref, cdist_ref,
                                     gather_rows_ref, ssm_scan_chunk_bwd_ref,
                                     ssm_scan_chunk_ref, ssm_scan_ref)
from repro_torch.kernels.ssm_scan import (ssm_scan_bwd, ssm_scan_chunk,
                                          ssm_scan_train)
from repro_torch.models import layers as L
from repro_torch.models import registry as model_registry
from repro_torch.models import transformer as MT
from repro_torch.models.mamba import Mamba, mamba_defs
from repro_torch.models import moe as MOE
from repro_torch.serve import Generator


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _int_inputs(seed, m, k, d, G):
    gen = torch.Generator().manual_seed(seed)

    def r(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen).float()

    return r(-2, 3, (G, m, d)), r(-1, 2, (G, k, d)), r(-2, 3, (G, k))


@pytest.mark.cuda
@pytest.mark.parametrize("G,m,k,d", [(1, 256, 256, 22), (1, 256, 256, 32),
                                     (4, 256, 256, 32), (1, 37, 37, 5),
                                     (1, 64, 513, 200), (2, 9, 1, 7)])
def test_cuda_bid_top2_vs_plain(cuda, G, m, k, d):
    x, c, p = (t.to(cuda) for t in _int_inputs(G * m + k, m, k, d, G))
    n0 = _build.launches["bid_top2"]
    got = cuda_bid_top2(x, c, p)
    assert _build.launches["bid_top2"] == n0 + 1
    want = bid_top2_ref(x, c, p)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    xf = x + torch.randn_like(x)
    got = cuda_bid_top2(xf, c, p)
    w1, wj, w2 = bid_top2_ref(xf, c, p)
    scale = w1.abs().max().item()
    torch.testing.assert_close(got[0], w1, rtol=1e-5, atol=1e-4 * scale)
    torch.testing.assert_close(got[2], w2, rtol=1e-5, atol=1e-4 * scale)
    clear = (w1 - w2) > 1e-4 * scale
    assert torch.equal(got[1][clear], wj[clear])


@pytest.mark.cuda
@pytest.mark.parametrize("G,m,k,d", [(1, 1, 256, 22), (3, 37, 256, 22),
                                     (1, 4097, 256, 22), (1, 300, 513, 22),
                                     (1, 300, 256, 1), (3, 130, 300, 200),
                                     (1, 4097, 513, 200)])
def test_cuda_bid_top2_uneven_tiles(cuda, G, m, k, d):
    """Shapes the grid splits unevenly: one row, rows past the last full
    CTA of either tile (2 and 32 rows), k past one pass or past what stays
    in shared memory, d = 1 and 200, G = 3; exact on integers.  On floats
    the staged path (c 4 bytes off the TMA's 16-byte grid) gives the bits
    of the bulk copy, and the first 64 rows of the wide tile those of the
    narrow one."""
    x, c, p = (t.to(cuda) for t in _int_inputs(G * m + k + d, m, k, d, G))
    got = _counted("bid_top2", cuda_bid_top2, x, c, p)
    for g, w in zip(got, bid_top2_ref(x, c, p)):
        assert torch.equal(g, w)
    xf, cf = torch.randn_like(x), torch.randn_like(c)
    shifted = torch.randn(cf.numel() + 1, device=cuda)[1:].view(cf.shape)
    shifted.copy_(cf)
    assert shifted.data_ptr() % 16 != 0
    got = cuda_bid_top2(xf, cf, p)
    for g, w in zip(got, cuda_bid_top2(xf, shifted, p)):
        assert torch.equal(g, w)
    for g, w in zip(got, cuda_bid_top2(xf[:, :64].contiguous(), cf, p)):
        assert torch.equal(g[:, :64], w)


@pytest.mark.cuda
@pytest.mark.parametrize("G,n,d,dummies", [(1, 256, 22, 0), (3, 256, 22, 16),
                                           (1, 64, 200, 0), (2, 4097, 5, 3)])
def test_cuda_bid_top2_span_equals_two_calls(cuda, G, n, d, dummies):
    """The span's pair in one launch is bitwise the two separate calls,
    bid_top2(x, c, 0) and bid_top2(-x, c, 2 ||c||^2), also with zero
    (dummy) rows.  c is integer-valued, so that ||c||^2 is exact in any
    order and the prices given to the second call are the launch's own."""
    gen = torch.Generator().manual_seed(G * n + d)
    x = torch.randn((G, n, d), generator=gen).to(cuda)
    c = torch.randint(-4, 5, (G, n, d), generator=gen).float().to(cuda)
    if dummies:
        x[:, n - dummies:] = 0.0
    prices = 2.0 * (c * c).sum(dim=-1)
    pair = _counted("bid_top2", cuda_bid_top2_span, x, c)
    want = (cuda_bid_top2(x, c, torch.zeros_like(prices)),
            cuda_bid_top2(-x, c, prices))
    for got_slot, want_slot in zip(pair, want):
        for g, w in zip(got_slot, want_slot):
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 22, 32, 33, 200])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_cuda_gather_rows_bitwise(cuda, d, idx_dtype):
    """Bitwise, out-of-range indices clipped, every word width; also from a
    source whose rows start off the 8- and 16-byte grid (a view)."""
    x = torch.randn(2537, d, device=cuda)
    idx = torch.randint(-50, 2600, (8192,), device=cuda, dtype=idx_dtype)
    n0 = _build.launches["gather_rows"]
    got = cuda_gather_rows(x, idx)
    assert _build.launches["gather_rows"] == n0 + 1
    assert torch.equal(got, gather_rows_ref(x, idx))
    shifted = torch.randn(2537 * d + 1, device=cuda)[1:].view(2537, d)
    assert shifted.data_ptr() % 8 == 4
    assert torch.equal(cuda_gather_rows(shifted, idx),
                       gather_rows_ref(shifted, idx))
    with pytest.raises(ValueError):
        cuda_gather_rows(x.double(), idx)


@pytest.mark.cuda
def test_cuda_stream_path_launches_kernels_and_matches_plain(cuda):
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(4096, 22)).astype(np.float32))
    kw = dict(k=64, chunk_size=1024, solver="auction_fused", device=cuda)
    n0 = dict(_build.launches)
    res = anticluster(x.to(cuda), **kw)
    laps = 4096 // 64 - 1  # every batch after the first, cold: 4 phases
    assert _build.launches["gather_rows"] > n0["gather_rows"]
    assert _build.launches["bid_top2"] - n0["bid_top2"] == laps  # the span
    assert _build.launches["auction_phase"] - n0["auction_phase"] == 4 * laps
    with ops.forced_path("ref"):
        n1 = dict(_build.launches)
        plain = anticluster(x.to(cuda), **kw)
        assert _build.launches == n1
    for r in (res, plain):
        assert balance_ok(r.labels.cpu(), 64)
    assert torch.equal(anticluster(x.to(cuda), **kw).labels, res.labels)


def _counted(name, fn, *args, **kw):
    """fn(*args, **kw), checking that it launched kernel ``name`` once."""
    n0 = _build.launches[name]
    out = fn(*args, **kw)
    assert _build.launches[name] == n0 + 1
    return out


def _assert_cdist_close(got, want, x_rows, c):
    """Within 1e-5 (||x||^2 + ||c||^2) + 1e-6 per entry (the sums run in
    another order than the plain version's)."""
    tol = 1e-5 * ((x_rows * x_rows).sum(1)[:, None]
                  + (c * c).sum(1)[None, :]) + 1e-6
    assert ((got - want).abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(2000, 256, 22), (333, 70, 32),
                                   (64, 5, 200), (1, 1, 1)])
def test_cuda_cdist_vs_plain(cuda, m, n, d):
    x, c, _ = (t[0].to(cuda) for t in _int_inputs(m + n + d, m, n, d, 1))
    got = _counted("cdist", cuda_cdist, x, c)
    assert torch.equal(got, cdist_ref(x, c))
    xf, cf = torch.randn_like(x), torch.randn_like(c)
    _assert_cdist_close(_counted("cdist", cuda_cdist, xf, cf),
                        cdist_ref(xf, cf), xf, cf)
    lead = _counted("cdist", K.cdist, xf.reshape(1, m, d), cf)
    assert torch.equal(lead[0], cuda_cdist(xf, cf))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [22, 32, 200])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_cuda_cdist_gather_vs_plain(cuda, d, idx_dtype):
    x, c, _ = (t[0].to(cuda) for t in _int_inputs(d, 2537, 256, d, 1))
    idx = torch.randint(-50, 2600, (3000,), device=cuda, dtype=idx_dtype)
    got = _counted("cdist_gather", cuda_cdist_gather, x, idx, c)
    assert torch.equal(got, cdist_gather_ref(x, idx, c))
    xf, cf = torch.randn_like(x), torch.randn_like(c)
    got = _counted("cdist_gather", K.cdist, xf, cf, idx=idx)
    assert torch.equal(got, cuda_cdist(cuda_gather_rows(xf, idx), cf))


def _off_grid(t, words):
    """A copy of ``t`` whose data starts ``words`` float32 words past a
    256-byte boundary: 1 puts it off the 16- and 8-byte grids."""
    shifted = torch.empty(t.numel() + words, dtype=t.dtype,
                          device=t.device)[words:]
    return shifted.view(t.shape).copy_(t)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 33, 3000, 8192, 65541])
@pytest.mark.parametrize("k", [1, 37, 256, 513])
@pytest.mark.parametrize("d", [1, 5, 22, 32, 200, 512])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("layout", ["aligned", "c_off_grid", "x_off_grid"])
def test_cuda_bid_top2_gather_vs_plain(cuda, m, k, d, idx_dtype, layout):
    """Indices out of range on both sides; c off the 16-byte grid (the
    threads stage it, not the TMA), or x off the 8-byte grid (4-byte
    copies where d is even); d = 32 pads c's rows, d = 512 stages c in
    passes and feature tiles.  Four ways: bitwise the plain version on
    integers, bitwise bid_top2 of gather_rows on floats, a second launch
    bitwise the first, and the previous design bitwise this one."""
    x, c, p = (t[0].to(cuda) for t in _int_inputs(k * d + m, 2537, k, d, 1))
    gen = torch.Generator().manual_seed(m * 7 + k * d)
    idx = torch.randint(-50, 2600, (m,), generator=gen).to(cuda, idx_dtype)
    if layout == "c_off_grid":
        c = _off_grid(c, 1)
    elif layout == "x_off_grid":
        x = _off_grid(x, 1)
    got = _counted("bid_top2_gather", cuda_bid_gather, x, idx, c, p)
    for g, w in zip(got, bid_top2_gather_ref(x, idx, c, p)):
        assert torch.equal(g, w)
    xf = x + torch.randn(x.shape, generator=gen).to(cuda)
    if layout == "x_off_grid":
        xf = _off_grid(xf, 1)
    got = _counted("bid_top2_gather", K.bid_top2, xf, c, p, idx=idx)
    again = _counted("bid_top2_gather", cuda_bid_gather, xf, idx, c, p)
    prev = _counted("bid_top2_gather", cuda_bid_gather_prev, xf, idx, c, p)
    want = cuda_bid_top2(cuda_gather_rows(xf, idx), c, p)
    for g, w, a, o in zip(got, want, again, prev):
        assert torch.equal(g, w) and torch.equal(a, g) and torch.equal(o, g)


@pytest.mark.cuda
def test_cuda_bid_top2_gather_timed(cuda):
    """The timed instantiation (measurement only) gives the kernel's
    outputs and one row of stamps a CTA: every tile taken once, each stage
    a share of the CTA's cycles."""
    x, c, p = (t[0].to(cuda) for t in _int_inputs(3, 2537, 256, 22, 1))
    idx = torch.randint(-50, 2600, (65536,), device=cuda)
    out, stamps = _counted("bid_top2_gather", cuda_bid_gather_timed, x, idx,
                           c, p)
    for g, w in zip(out, cuda_bid_gather(x, idx, c, p)):
        assert torch.equal(g, w)
    assert stamps.shape[1] == len(GATHER_STAGES) == 8
    assert 1 <= stamps.shape[0] <= 65536 // 32
    assert int(stamps[:, 7].sum()) == 65536 // 32
    assert bool((stamps[:, :6] >= 0).all())
    assert bool((stamps[:, :6].sum(1) <= stamps[:, 6]).all())


@pytest.mark.cuda
def test_cuda_wide_rows_take_gather_then_unfused_kernel(cuda):
    """d > 512: gather_rows, then the unfused kernel, as in the reference's
    dispatch table."""
    x, c, p = (t[0].to(cuda) for t in _int_inputs(5, 300, 40, 600, 1))
    idx = torch.randint(0, 300, (100,), device=cuda)
    n0 = dict(_build.launches)
    dist = K.cdist(x, c, idx=idx)
    bids = K.bid_top2(x, c, p, idx=idx)
    moved = {k: v - n0[k] for k, v in _build.launches.items()}
    assert moved == {"gather_rows": 2, "cdist": 1, "bid_top2": 1,
                     "cdist_gather": 0, "bid_top2_gather": 0, "ssm_scan": 0,
                     "ssm_scan_bwd": 0, "auction_phase": 0,
                     "auction_phase_dense": 0}
    assert torch.equal(dist, cdist_gather_ref(x, idx, c))
    for g, w in zip(bids, bid_top2_gather_ref(x, idx, c, p)):
        assert torch.equal(g, w)


def _ssm_inputs(lead, di, ds, device):
    gen = torch.Generator().manual_seed(di * ds)
    dt = torch.randn(*lead, di, generator=gen).abs() * 0.1
    b, c = (torch.randn(*lead, ds, generator=gen) for _ in range(2))
    x = torch.randn(*lead, di, generator=gen)
    a = -torch.randn(di, ds, generator=gen).abs()
    return [t.to(device) for t in (dt, b, c, x, a)]


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,s,di,ds", [(2, 64, 512, 16), (3, 37, 100, 8),
                                         (1, 20, 64, 24), (2, 9, 48, 64),
                                         (2, 5, 130, 1), (1, 33, 200, 17),
                                         (1, 100, 64, 64), (4, 17, 70, 16),
                                         (65537, 2, 3, 2)])
def test_cuda_ssm_scan_vs_plain(cuda, bsz, s, di, ds):
    """Within rtol 1e-4 / atol 1e-4 (exp and the sum order of y_t differ),
    in both layouts, and from a nonzero h0; d_inner past the last full
    64-channel CTA, S past the last full 16-step tile or under one tile,
    d_state from 1 to 64, more batches than a grid's y axis holds."""
    args = _ssm_inputs((bsz, s), di, ds, cuda)
    y, h = _counted("ssm_scan", K.ssm_scan, *args)
    want_y, want_h = ssm_scan_ref(*args)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
    tm = [t.transpose(0, 1).contiguous() for t in args[:4]]
    h0 = torch.randn(bsz, di, ds, device=cuda)
    y, h = _counted("ssm_scan", ssm_scan_chunk, *tm, args[4], h0)
    want_y, want_h = ssm_scan_chunk_ref(*tm, args[4], h0)
    torch.testing.assert_close(y, want_y, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, want_h, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError):
        K.ssm_scan(args[0].transpose(0, 1), *args[1:])


def _phase_cases(G, n, d, integer, device):
    """Inputs of one phase on a (G, n, d) stack and the runs to compare:
    cold; warm prices with ``skip`` on group 0 and the seed reduction;
    ``fixed_rounds``; a ``max_rounds`` cap that stops the phase early."""
    gen = torch.Generator().manual_seed(G * n * d + integer)
    if integer:
        x = torch.randint(-2, 3, (G, n, d), generator=gen).float()
        c = torch.randint(-1, 2, (G, n, d), generator=gen).float()
    else:
        x = torch.randn((G, n, d), generator=gen)
        c = torch.randn((G, n, d), generator=gen) * 1.5
    is_real = torch.ones((G, n), dtype=torch.bool)
    is_real[-1, n - max(1, n // 4):] = False  # the last group has dummy rows
    warm = torch.rand((G, n), generator=gen) * d
    eps = torch.rand((G,), generator=gen) * 0.5 + 0.05
    x, c, is_real, warm, eps = (t.to(device) for t in (x, c, is_real, warm,
                                                       eps))
    zero = torch.zeros_like(warm)
    skip = torch.zeros((G,), dtype=torch.bool, device=device)
    skip[0] = G > 1
    seed = ref.factored_top2(x, c, is_real, cuda_bid_top2)(warm)
    big = 50 * n + 1000
    return (x, c, is_real), [
        dict(prices=zero, eps=eps, max_rounds=big),
        dict(prices=warm, eps=eps, max_rounds=big, skip=skip,
             seed_top2=seed),
        dict(prices=zero, eps=eps, max_rounds=big, fixed_rounds=7),
        dict(prices=warm, eps=eps, max_rounds=big, fixed_rounds=5,
             seed_top2=seed),
        dict(prices=zero, eps=eps, max_rounds=3)]


# the crossover of a timed launch: None launches the kernel's own entry
# (its own rule); 0 sends every round to the CTA path, 32 every round of
# up to 32 bidders to the one-warp path
THRESHOLDS = [None, 0, 32]


@pytest.mark.cuda
@pytest.mark.parametrize("G,n,d", [(1, 8, 5), (1, 256, 22), (3, 48, 5),
                                   (1, 512, 200)])
@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_cuda_auction_phase_equals_python_loop(cuda, monkeypatch, G, n, d,
                                               integer, threshold):
    """The phase kernel against the Python round loop over the bid_top2
    kernel, tested every round: assignments and prices bitwise, the same
    rounds, bids and single-bidder rounds.  Integer inputs make value and
    bid ties common."""
    (x, c, is_real), runs = _phase_cases(G, n, d, integer, cuda)
    for kw in runs:
        _check_phase_kernel(monkeypatch, x, c, is_real, kw, threshold)


def _check_phase_kernel(monkeypatch, x, c, is_real, kw, threshold=None):
    """One launch of the phase kernel (its timed instantiation with this
    crossover unless ``threshold`` is None) against the Python round loop
    over the bid_top2 kernel, its predicate tested every round.  Returns
    the timed launch's trace of group 0's rounds (bidders, cycles, warp
    path, the cycles of the steps), or None."""
    monkeypatch.setattr(ref, "_CHECK_EVERY", 1)
    t0, r0, b0 = phase_kernel.totals(), ref.rounds_executed, ref.bid_totals()
    trace = None
    if threshold is None:
        got = _counted("auction_phase", phase_kernel.auction_phase, x, c,
                       is_real, **kw)
    else:
        *got, trace = _counted("auction_phase",
                               phase_kernel.auction_phase_timed, x, c,
                               is_real, **kw, trace_rounds=kw["max_rounds"],
                               threshold=threshold)
    t1 = phase_kernel.totals()
    want = ref.auction_rounds(ref.factored_top2(x, c, is_real,
                                                cuda_bid_top2), **kw)
    b1 = ref.bid_totals()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert t1["rounds"] - t0["rounds"] == ref.rounds_executed - r0
    for key in ("bids", "single_bidder_rounds"):
        assert t1[key] - t0[key] == b1[key] - b0[key], key
    assert t1["bids"] > t0["bids"]
    if trace is None:
        return None
    trace = trace[trace[:, 0] >= 0].cpu()
    assert bool((trace[:, 1] > 0).all()) and bool((trace[:, 3:] >= 0).all())
    if threshold >= 0:  # the path each round took; a seeded round: the CTA's
        warp = trace[:, 0] <= threshold
        warp[0] &= kw.get("seed_top2") is None
        assert torch.equal(trace[:, 2] == 1, warp)
    if x.shape[0] == 1:  # every round of the phase is traced
        assert int(trace[:, 0].sum()) == t1["bids"] - t0["bids"]
    return trace


def _runs(flags):
    """(first index, length) of each run of True in a 1-D bool tensor."""
    out, start = [], None
    for i, f in enumerate(flags.tolist() + [False]):
        if f and start is None:
            start = i
        elif not f and start is not None:
            out.append((start, i - start))
            start = None
    return out


def _warp_case(case, device):
    """Inputs of one phase that puts the one-warp path through ``case``,
    its crossover, and a check of the trace that the case happened."""
    gen = torch.Generator().manual_seed(len(case))
    zero = torch.zeros((1, 8), device=device)
    eps = torch.full((1,), 0.5, device=device)
    if case == "lone_chain":
        # a cold phase at a small eps: long chains of one bidder at the
        # main shape, under the kernel's own crossover
        x = torch.randn((1, 256, 22), generator=gen)
        c = torch.randn((1, 256, 22), generator=gen) * 1.5
        kw = dict(prices=torch.zeros((1, 256)), eps=torch.full((1,), 0.05),
                  max_rounds=50 * 256 + 1000)

        def happened(tr):
            return max(n for _, n in _runs(tr[:, 0] == 1)) >= 10
        return (x, c, None), kw, None, happened
    if case in ("equal_bids", "max_rounds", "fixed_rounds"):
        # eight equal rows: every round its bidders bid the same on one
        # object, and the lowest of them wins it
        x = torch.randint(-2, 3, (1, 1, 3), generator=gen).float().expand(
            1, 8, 3).contiguous()
        c = torch.randint(-1, 2, (1, 8, 3), generator=gen).float()
        kw = dict(prices=zero, eps=eps, max_rounds=1000)
        if case == "max_rounds":
            kw["max_rounds"] = 3
        elif case == "fixed_rounds":
            kw["fixed_rounds"] = 3

        def happened(tr):
            return int(tr[0, 0]) == 8 and bool((tr[:, 2] == 1).all()) and (
                case == "equal_bids" or len(tr) == 3 and int(tr[2, 0]) > 1)
        return (x, c, None), kw, 32, happened
    if case == "dummy_lone":
        # group 0 all dummy rows: every round one row settles, the last
        # round has one dummy bidder; group 1 real
        x = torch.randn((2, 8, 3), generator=gen)
        c = torch.randn((2, 8, 3), generator=gen)
        is_real = torch.ones((2, 8), dtype=torch.bool)
        is_real[0] = False
        kw = dict(prices=torch.zeros((2, 8)), eps=torch.full((2,), 0.5),
                  max_rounds=1000)

        def happened(tr):
            return int(tr[-1, 0]) == 1 and int(tr[-1, 2]) == 1
        return (x, c, is_real), kw, None, happened
    assert case == "cta_then_warp"
    # many bidders on the CTA path, then the one-warp path to the end (the
    # count of unassigned rows never rises, so the warp path, once taken,
    # hands the CTA back only when the phase ends)
    x = torch.randn((1, 256, 22), generator=gen)
    c = torch.randn((1, 256, 22), generator=gen)
    kw = dict(prices=torch.zeros((1, 256)), eps=torch.full((1,), 0.1),
              max_rounds=50 * 256 + 1000)

    def happened(tr):
        warp = tr[:, 2] == 1
        return bool(warp.any()) and not bool(warp[0]) and bool(
            warp[int(warp.int().argmax()):].all())
    return (x, c, None), kw, 4, happened


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["lone_chain", "equal_bids", "max_rounds",
                                  "fixed_rounds", "dummy_lone",
                                  "cta_then_warp"])
def test_cuda_auction_phase_warp_path(cuda, monkeypatch, case):
    """The one-warp path of small rounds against the Python loop, bitwise,
    through the timed launch, whose trace shows that the case happened."""
    (x, c, is_real), kw, threshold, happened = _warp_case(case, cuda)
    x, c = x.to(cuda), c.to(cuda)
    is_real = None if is_real is None else is_real.to(cuda)
    kw = {k: v.to(cuda) if torch.is_tensor(v) else v for k, v in kw.items()}
    trace = _check_phase_kernel(monkeypatch, x, c, is_real, kw,
                                -1 if threshold is None else threshold)
    assert happened(trace), trace[:40].tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("max_rounds", [50 * 8192 + 1000, 40])
@pytest.mark.parametrize("threshold", THRESHOLDS)
def test_cuda_auction_phase_state_in_device_memory(cuda, monkeypatch,
                                                   max_rounds, threshold):
    """n = 8192: the per-row state does not fit in shared memory and lives
    in device memory; one phase to its end, and one cut by the cap."""
    gen = torch.Generator().manual_seed(8192)
    x, c = (torch.randn((1, 8192, 5), generator=gen).to(cuda)
            for _ in range(2))
    kw = dict(prices=torch.zeros((1, 8192), device=cuda),
              eps=torch.full((1,), 2.0, device=cuda), max_rounds=max_rounds)
    _check_phase_kernel(monkeypatch, x, c, None, kw, threshold)


@pytest.mark.cuda
def test_cuda_auction_phase_checks_operands(cuda):
    (x, c, is_real), runs = _phase_cases(1, 8, 5, False, cuda)
    kw = runs[0]
    with pytest.raises(ValueError):
        phase_kernel.auction_phase(x, c, is_real.float(), **kw)
    with pytest.raises(ValueError):
        phase_kernel.auction_phase(x.transpose(1, 2).contiguous(), c,
                                   is_real, **kw)
    with pytest.raises(ValueError):
        phase_kernel.auction_phase(x, c, is_real,
                                   **{**kw, "eps": kw["eps"].double()})
    with pytest.raises(ValueError):
        phase_kernel.auction_phase(x[:, :, :4], c[:, :, :4], is_real, **kw)


# ---------------------------------------------------------------------------
# the dense phase kernel (auction_phase_dense.cu) and the routes that run it
# ---------------------------------------------------------------------------

def _dense_cases(G, n, integer, device):
    """A (G, n, n) cost stack as ``_assign_batch`` builds it (the last
    group's last rows are dummies: zeroed), and the launches to compare,
    each a (P, G) eps schedule: four phases cold; four warm, with the
    first three phases skipped in group 0 and the second in group 1, and
    the seed reduction; four with ``fixed_rounds``; one warm with
    ``fixed_rounds`` and the seed; four with a ``max_rounds`` cap that
    stops every phase early; one phase cold."""
    gen = torch.Generator().manual_seed(G * n + integer)
    if integer:
        cost = torch.randint(-3, 4, (G, n, n), generator=gen).float()
    else:
        cost = torch.randn((G, n, n), generator=gen) * 5
    cost[-1, n - n // 4:] = 0.0
    warm = torch.rand((G, n), generator=gen) * 3
    eps = (torch.rand((G,), generator=gen) * 0.5 + 0.05) * torch.tensor(
        [8.0, 4.0, 2.0, 1.0])[:, None]
    cost, warm, eps = (t.to(device) for t in (cost, warm, eps))
    zero = torch.zeros_like(warm)
    skip = torch.zeros((4, G), dtype=torch.bool, device=device)
    skip[:3, 0] = G > 1
    skip[1, 1 % G] = G > 1
    seed = ref.dense_top2(cost)(warm)
    big = 50 * n + 1000
    return cost, [
        dict(prices=zero, eps=eps, max_rounds=big),
        dict(prices=warm, eps=eps, max_rounds=big, skip=skip,
             seed_top2=seed),
        dict(prices=zero, eps=eps, max_rounds=big, fixed_rounds=7),
        dict(prices=warm, eps=eps[3:], max_rounds=big, fixed_rounds=5,
             seed_top2=seed),
        dict(prices=zero, eps=eps, max_rounds=3),
        dict(prices=zero, eps=eps[:1], max_rounds=big)]


def _check_dense_kernel(monkeypatch, cost, kw):
    """One launch of the dense phase kernel (all the phases of ``kw``'s
    schedule) against the Python round loop over ``ref.top2`` of
    ``cost - p``, phase after phase, its predicate tested every round:
    assignments and prices bitwise, the same rounds, bids and
    single-bidder rounds."""
    monkeypatch.setattr(ref, "_CHECK_EVERY", 1)
    t0, r0, b0 = phase_kernel.totals(), ref.rounds_executed, ref.bid_totals()
    got = _counted("auction_phase_dense", phase_kernel.auction_phase_dense,
                   cost, **kw)
    t1 = phase_kernel.totals()
    want = ref.auction_phase_dense_ref(cost, **kw)
    b1 = ref.bid_totals()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert t1["rounds"] - t0["rounds"] == ref.rounds_executed - r0
    for key in ("bids", "single_bidder_rounds"):
        assert t1[key] - t0[key] == b1[key] - b0[key], key
    assert t1["bids"] > t0["bids"]
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("G,n", [(1, 1), (1, 5), (1, 8), (3, 48), (1, 100),
                                 (1, 250), (1, 256), (4, 256), (2, 130),
                                 (1, 512)])
@pytest.mark.parametrize("integer", [False, True])
def test_cuda_auction_phase_dense_equals_python_loop(cuda, monkeypatch, G, n,
                                                     integer):
    """The dense phase kernel against the Python loop, bitwise, on launches
    of four phases (cold; warm with skips and the seed; fixed rounds; a
    cap) and of one; n = 1, n off the float4 grid (5, 100, 130, 250: one
    column a lane, the rows staged by the threads), every cost row staged
    in shared memory (n <= 130), all but some (250: 222 of them; 256: 217;
    512: 104), the warp path's and the CTA path's sizes, G up to 4, dummy
    rows; integer costs make value and bid ties common."""
    cost, runs = _dense_cases(G, n, integer, cuda)
    for kw in runs:
        _check_dense_kernel(monkeypatch, cost, kw)
    # a stack 4 bytes off the 16-byte grid takes the one-column-a-lane path
    shifted = torch.empty(cost.numel() + 1, device=cuda)[1:].view(cost.shape)
    shifted.copy_(cost)
    _check_dense_kernel(monkeypatch, shifted, runs[0])


@pytest.mark.cuda
@pytest.mark.parametrize("max_rounds", [50 * 8192 + 1000, 40])
def test_cuda_auction_phase_dense_state_in_device_memory(cuda, monkeypatch,
                                                         max_rounds):
    """n = 8192 (a 256 MB cost): the per-row state does not fit in shared
    memory and lives in device memory, 7 cost rows are staged; one phase to
    its end, one cut."""
    gen = torch.Generator().manual_seed(8193)
    cost = (torch.randn((1, 8192, 8192), generator=gen) * 5).to(cuda)
    kw = dict(prices=torch.zeros((1, 8192), device=cuda),
              eps=torch.full((1, 1), 2.0, device=cuda), max_rounds=max_rounds)
    _check_dense_kernel(monkeypatch, cost, kw)


@pytest.mark.cuda
def test_cuda_auction_phase_dense_checks_operands(cuda):
    cost, runs = _dense_cases(2, 8, False, cuda)
    kw = runs[0]
    with pytest.raises(ValueError):
        phase_kernel.auction_phase_dense(cost.double(), **kw)
    with pytest.raises(ValueError):
        phase_kernel.auction_phase_dense(cost.transpose(1, 2), **kw)
    with pytest.raises(ValueError):
        phase_kernel.auction_phase_dense(cost[:, :, :4], **kw)
    with pytest.raises(ValueError):
        phase_kernel.auction_phase_dense(
            cost, **{**kw, "prices": kw["prices"].cpu()})
    with pytest.raises(ValueError):  # a schedule is (P, G)
        phase_kernel.auction_phase_dense(cost, **{**kw, "eps": kw["eps"][0]})


def _route_run(x, dev, **kw):
    """anticluster on the card: (result, dense launches, plain rounds)."""
    n0 = _build.launches["auction_phase_dense"]
    r0 = ref.rounds_executed
    res = anticluster(x, device=dev, **kw)
    return (res, _build.launches["auction_phase_dense"] - n0,
            ref.rounds_executed - r0)


@pytest.mark.cuda
def test_cuda_flat_and_stacked_routes_launch_the_dense_kernel(cuda):
    """The default spec's flat route and the stacked route run every LAP,
    all four of its phases, as one auction_phase_dense launch and no round
    of the Python loop; both balanced."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(2048, 22)).astype(np.float32))
    res, dense, plain = _route_run(x.to(cuda), cuda, k=64)
    assert (res.route, res.solver) == ("flat", "auction")
    assert dense == 2048 // 64 - 1 and plain == 0
    assert balance_ok(res.labels.cpu(), 64)
    xs = torch.from_numpy(rng.normal(size=(3, 500, 7)).astype(np.float32))
    res, dense, plain = _route_run(xs.to(cuda), cuda, k=32)
    assert (res.route, res.solver) == ("stacked", "auction")
    assert dense == -(-500 // 32) - 1 and plain == 0
    for g in range(3):
        assert balance_ok(res.labels[g].cpu(), 32)


@pytest.mark.cuda
def test_cuda_flat_route_labels_equal_forced_plain_path(cuda):
    """The flat route's labels through the dense kernel are bitwise those
    of the same call with every phase in the Python loop
    (``ops.forced_path("ref")``), dummy rows in the last batch included;
    so are the dense core's final prices.  (Not the gap: its cluster sums
    use ``index_add_``, which adds in no fixed order on the card.)"""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(2000, 22)).astype(np.float32))
    x = x.to(cuda)
    res, dense, plain = _route_run(x, cuda, k=64)
    assert dense > 0 and plain == 0
    _, state = aba_core(x[None], 64, return_state=True, device=cuda)
    with ops.forced_path("ref"):
        ref_res, dense_ref, plain_ref = _route_run(x, cuda, k=64)
        _, ref_state = aba_core(x[None], 64, return_state=True, device=cuda)
    assert dense_ref == 0 and plain_ref > 0
    assert torch.equal(res.labels, ref_res.labels)
    assert torch.equal(state["prices"], ref_state["prices"])


@pytest.mark.cuda
@pytest.mark.parametrize("m,nc,d", [(1, 1, 1), (31, 127, 22), (33, 129, 22),
                                    (100_003, 256, 22), (4097, 130, 33),
                                    (70, 5, 200), (257, 258, 1),
                                    (65, 384, 33)])
def test_cuda_cdist_off_tile_edges(cuda, m, nc, d):
    """cdist at shapes off every edge of its tiles (32 rows, 128 columns,
    float4 column groups, 24-feature stages) and with more tiles than the
    card holds CTAs: exact on integers, within the tolerance on floats."""
    x, c, _ = (t[0].to(cuda) for t in _int_inputs(m * nc + d, m, nc, d, 1))
    assert torch.equal(_counted("cdist", cuda_cdist, x, c), cdist_ref(x, c))
    xf, cf = torch.randn_like(x), torch.randn_like(c)
    _assert_cdist_close(cuda_cdist(xf, cf), cdist_ref(xf, cf), xf, cf)


@pytest.mark.cuda
@pytest.mark.parametrize("m,nc,d", [(8192, 256, 22), (33, 129, 1),
                                    (1, 1, 33), (3001, 130, 200),
                                    (5000, 7, 22)])
@pytest.mark.parametrize("idx_dtype", [torch.int32, torch.int64])
def test_cuda_cdist_gather_off_tile_edges(cuda, m, nc, d, idx_dtype):
    """cdist_gather at the same edges, with negative and out-of-range
    indices: bitwise cdist(gather_rows(x, idx), c) on floats, and the plain
    version on integers."""
    x, c, _ = (t[0].to(cuda) for t in _int_inputs(m + nc * d, 2537, nc, d, 1))
    idx = torch.randint(-60, 2600, (m,), device=cuda, dtype=idx_dtype)
    got = _counted("cdist_gather", cuda_cdist_gather, x, idx, c)
    assert torch.equal(got, cdist_gather_ref(x, idx, c))
    xf, cf = torch.randn_like(x), torch.randn_like(c)
    assert torch.equal(cuda_cdist_gather(xf, idx, cf),
                       cuda_cdist(cuda_gather_rows(xf, idx), cf))


# ---------------------------------------------------------------------------
# Section 4.3: the dense phase kernel on masked costs, the constrained routes
# ---------------------------------------------------------------------------

def _masked_cost(G, n, closed, seed, device):
    """A (G, n, n) cost as ``_assign_batch`` builds it under the quota mask:
    Gaussian values times 5, a ``closed`` share of the cells at
    ``_MASK_COST`` (a whole row too: a row with no open cluster), and the
    last group's last rows dummies (zero, never masked)."""
    gen = torch.Generator().manual_seed(seed)
    cost = torch.randn((G, n, n), generator=gen) * 5
    cost = torch.where(torch.rand((G, n, n), generator=gen) < closed,
                       _MASK_COST, cost)
    cost[0, 0] = _MASK_COST
    cost[-1, n - n // 8:] = 0.0
    return cost.to(device)


def _masked_schedule(cost):
    """The solver's eps schedule of a masked cost: its span includes the
    mask (reference fault R6), so eps runs from ~1.25e8 to ~1e9 / (4n)."""
    finite = torch.where(cost <= asg._NEG / 2, 0.0, cost)
    span = (finite.amax(dim=(1, 2)) - finite.amin(dim=(1, 2))).clamp(min=1e-6)
    return asg._eps_schedule(span, cost.shape[1], asg.AuctionConfig())


@pytest.mark.cuda
@pytest.mark.parametrize("G,n", [(1, 16), (3, 48), (1, 256), (2, 256),
                                 (1, 512)])
@pytest.mark.parametrize("closed", [0.05, 0.6])
def test_cuda_auction_phase_dense_masked_costs(cuda, monkeypatch, G, n,
                                               closed):
    """The masked LAP's own four-phase schedule (values near -1e9, eps 1e6
    to 1e8, prices near 1e8 where ties are everywhere) in one launch, then
    each phase alone from the prices of the one before, then a warm
    re-solve of the whole schedule with skips and seed: the dense phase
    kernel bitwise the Python loop, with the same rounds, bids and
    single-bidder rounds."""
    cost = _masked_cost(G, n, closed, G * n + int(closed * 100), cuda)
    sched = _masked_schedule(cost)
    assert float(sched[0].min()) > 1e8
    zero = torch.zeros((G, n), device=cuda)
    _, whole = _check_dense_kernel(
        monkeypatch, cost, dict(prices=zero, eps=sched,
                                max_rounds=50 * n + 1000))
    prices = zero
    for p in range(sched.shape[0]):
        _, prices = _check_dense_kernel(
            monkeypatch, cost, dict(prices=prices, eps=sched[p:p + 1],
                                    max_rounds=50 * n + 1000))
    assert torch.equal(prices, whole)
    assert float(prices.abs().max()) > 1e6
    skip = torch.zeros_like(sched, dtype=torch.bool)
    skip[:-1, 0] = G > 1
    warm = dict(prices=prices, eps=sched, max_rounds=50 * n + 1000,
                skip=skip, seed_top2=ref.dense_top2(cost)(prices))
    _check_dense_kernel(monkeypatch, cost, warm)


def _constrained_run(x, dev, **kw):
    """anticluster on the card: (result, launches by kernel, plain rounds)."""
    before = dict(_build.launches)
    r0 = ref.rounds_executed
    res = anticluster(x, device=dev, **kw)
    used = {name: _build.launches[name] - before[name] for name in before}
    return res, used, ref.rounds_executed - r0


def _constraint_kwargs(case, shape):
    """The constraint of ``case`` for labels of ``shape``, from a seed."""
    rng = np.random.default_rng(shape[-1])
    cls = rng.integers(0, 3, size=shape).astype(np.int32)
    if case == "categories":
        return {"categories": cls}
    if case == "fairness":
        return {"fairness": {"cls": cls,
                             "sex": rng.integers(0, 2, size=shape),
                             "age": rng.integers(0, 13, size=shape)}}
    n = shape[-1]
    return {"valid_mask": np.broadcast_to(np.arange(n) < n - n // 10,
                                          shape).copy()}


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["categories", "fairness", "valid_mask"])
@pytest.mark.parametrize("route", ["flat", "stream", "stacked"])
def test_cuda_constrained_routes_equal_forced_plain_path(cuda, case, route):
    """Every constrained route with the dense solver runs each LAP as one
    auction_phase_dense launch and no round of the Python loop, the
    stream route's chunks through gather_rows, and its labels
    are bitwise those of the same call with every phase in the loop
    (``ops.forced_path("ref")``)."""
    n, k, G = 1024, 32, 3
    rng = np.random.default_rng(3)
    shape = (G, n) if route == "stacked" else (n,)
    x = torch.from_numpy(rng.normal(size=shape + (6,)).astype(np.float32))
    x = x.to(cuda)
    kw = dict(k=k, **_constraint_kwargs(case, shape))
    if route == "stream":
        kw["chunk_size"] = 256
    res, used, plain = _constrained_run(x, cuda, **kw)
    assert res.route == route and res.solver == "auction" and plain == 0
    assert used["auction_phase_dense"] == n // k - 1
    assert used["gather_rows"] == (5 if route == "stream" else 0)
    with ops.forced_path("ref"):
        ref_res, ref_used, ref_plain = _constrained_run(x, cuda, **kw)
    assert not any(ref_used.values()) and ref_plain > 0
    assert torch.equal(res.labels, ref_res.labels)
    assert res.balanced


@pytest.mark.cuda
def test_cuda_categorical_stream_covering_chunk_equals_dense(cuda):
    """On the card too the categorical stream core with chunk_size >= n
    gives the flat core's labels bit for bit (the chunk's rows come through
    gather_rows, the dense core's through a gather of its own)."""
    n, k = 4096, 64
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.normal(size=(n, 8)).astype(np.float32)).to(cuda)
    cats = torch.from_numpy(rng.integers(0, 3, size=n)).to(cuda)
    dense = aba_core(x[None], k, categories=cats[None], n_categories=3,
                     device=cuda)[0]
    n0 = _build.launches["gather_rows"]
    stream = aba_stream(x, k, n, categories=cats, n_categories=3,
                        device=cuda)
    assert _build.launches["gather_rows"] > n0
    assert torch.equal(stream, dense)


@pytest.mark.cuda
@pytest.mark.parametrize("threshold", [-1, 0, 32])
def test_cuda_auction_phase_dense_timed(cuda, threshold):
    """The dense kernel's timed instantiation (measurement only) gives the
    launch's result bitwise, on a masked cost's four phases, and traces
    every round of group 0 over them: bidders summing to the bids, the path
    set by ``threshold`` (-1: the kernel's rule), the bidders on staged
    rows (at n = 256 the kernel stages 217 of the 256 rows)."""
    cost = _masked_cost(1, 256, 0.05, 7, cuda)
    kw = dict(prices=torch.zeros((1, 256), device=cuda),
              eps=_masked_schedule(cost), max_rounds=50 * 256 + 1000)
    want = phase_kernel.auction_phase_dense(cost, **kw)
    t0 = phase_kernel.totals()
    *got, trace = _counted("auction_phase_dense",
                           phase_kernel.auction_phase_dense_timed, cost, **kw,
                           trace_rounds=4 * kw["max_rounds"],
                           threshold=threshold)
    t1 = phase_kernel.totals()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    trace = trace[trace[:, 0] >= 0].cpu()
    assert trace.shape[1] == 7
    assert len(trace) == t1["rounds"] - t0["rounds"]
    assert int(trace[:, 0].sum()) == t1["bids"] - t0["bids"]
    assert bool((trace[:, 1] > 0).all()) and bool((trace[:, 3:] >= 0).all())
    assert bool((trace[:, 6] <= trace[:, 0]).all())
    assert 0 < int(trace[:, 6].sum()) < int(trace[:, 0].sum())
    if threshold >= 0:
        assert torch.equal(trace[:, 2] == 1, trace[:, 0] <= threshold)


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"chunk_size": 512},
                                {"categories": "class"},
                                {"solver": "auction_fused"}],
                         ids=["dense", "chunk", "categories", "fused"])
def test_cuda_hierarchical_route_equals_forced_plain_path(cuda, kw):
    """The hierarchical route (plan (8, 16)) runs every LAP of both levels
    through the phase kernels, one launch a LAP with the dense solver and
    one span and four phases a LAP with the factored one, at G = 1 and at
    G = 8 alike, and no round of the Python loop; with the dense solver
    its labels are bitwise those of the forced plain path."""
    n, plan = 4096, (8, 16)
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32)).to(cuda)
    if kw.get("categories"):
        kw = {"categories": rng.integers(0, 3, size=n).astype(np.int32)}
    res, used, plain = _constrained_run(x, cuda, k=128, plan=plan, **kw)
    laps = n // 8 - 1 + n // 128 - 1
    assert res.route == "hier" and res.plan == plan and plain == 0
    assert res.balanced
    if kw.get("solver") == "auction_fused":
        assert used["bid_top2"] == laps and used["auction_phase"] == 4 * laps
        return
    assert used["auction_phase_dense"] == laps
    with ops.forced_path("ref"):
        ref_res, ref_used, ref_plain = _constrained_run(x, cuda, k=128,
                                                        plan=plan, **kw)
    assert not any(ref_used.values()) and ref_plain > 0
    assert torch.equal(res.labels, ref_res.labels)


@pytest.mark.cuda
@pytest.mark.parametrize("G", [1, 64])
def test_cuda_span_group_does_not_depend_on_G(cuda, G):
    """At the hierarchical route's span shapes (m = k = 64, d = 32): each
    group of the stacked launch is bitwise the same group launched alone,
    and both slots agree with the plain pair on the card to bid_top2's
    tolerance, the argmax equal where the top-2 gap is clear."""
    gen = torch.Generator().manual_seed(G)
    x = torch.randn((G, 64, 32), generator=gen).to(cuda)
    c = (torch.randn((G, 64, 32), generator=gen) * 3).to(cuda)
    pair = _counted("bid_top2", cuda_bid_top2_span, x, c)
    for g in range(G):
        alone = cuda_bid_top2_span(x[g:g + 1], c[g:g + 1])
        for got_slot, want_slot in zip(pair, alone):
            for t, w in zip(got_slot, want_slot):
                assert torch.equal(t[g], w[0])
    for (v1, j1, v2), (w1, wj, w2) in zip(pair, ref.bid_top2_span_ref(x, c)):
        scale = w1.abs().max()
        tol = 1e-4 * scale + 1e-5 * torch.maximum(w1.abs(), w2.abs())
        assert ((v1 - w1).abs() <= tol).all() and ((v2 - w2).abs() <= tol).all()
        clear = (w1 - w2) > 1e-4 * scale
        assert torch.equal(j1[clear], wj[clear])


def _session_run(x, dev, kw, delta=None):
    """A cold partition, a warm repartition of drifted rows, and (with
    ``delta`` = (added, removed)) an update of the warm session, on the
    card: (warm result, update result or None, launches by kernel of the
    warm call and the update, plain rounds)."""
    eng = AnticlusterEngine(device=dev, **kw)
    _, state = eng.partition(x)
    x2 = x + 0.05 * torch.sin(x)
    before = dict(_build.launches)
    r0 = ref.rounds_executed
    warm, state = eng.repartition(x2, state)
    upd = None
    if delta is not None:
        upd, _, _ = eng.update(x2, state, added=delta[0], removed=delta[1])
    used = {name: _build.launches[name] - before[name] for name in before}
    return warm, upd, used, ref.rounds_executed - r0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["flat", "hier", "stream"])
def test_cuda_warm_session_equals_forced_plain_path(cuda, route):
    """A warm repartition (carried prices, the re-entry probe, per-group
    phase skips, the seeded first round) and an update of its session
    (one dense launch on the (B, k, k) delta stack) run through the phase
    kernels and no round of the Python loop; with the dense solver their
    labels are bitwise those of the forced plain path; the stream route's
    warm LAPs take two bid_top2 launches (the span, and the re-entry
    probe at the carried prices) and four phases each."""
    n, k = 4096, 64
    rng = np.random.default_rng(21)
    x = torch.from_numpy(rng.normal(size=(n, 6)).astype(np.float32)).to(cuda)
    kw = {"flat": dict(k=k), "hier": dict(k=128, plan=(8, 16)),
          "stream": dict(k=k, chunk_size=512,
                         solver="auction_fused")}[route]
    added = torch.from_numpy(rng.normal(size=(40, 6)).astype(np.float32))
    delta = (added.to(cuda), np.sort(rng.choice(n, 40, replace=False)))
    warm, upd, used, plain = _session_run(x, cuda, kw, delta)
    assert warm.balanced and upd.balanced and upd.updated and plain == 0
    if route == "stream":
        laps = n // k - 1
        assert used["bid_top2"] == 2 * laps
        assert used["auction_phase"] == 4 * laps
        assert used["auction_phase_dense"] == 1  # the delta's stack
        return
    laps = (n // k - 1 if route == "flat"
            else n // 8 - 1 + n // 128 - 1)
    assert used["auction_phase_dense"] == laps + 1
    with ops.forced_path("ref"):
        ref_warm, ref_upd, ref_used, ref_plain = _session_run(x, cuda, kw,
                                                              delta)
    assert not any(ref_used.values()) and ref_plain > 0
    assert torch.equal(warm.labels, ref_warm.labels)
    assert torch.equal(upd.labels, ref_upd.labels)


@pytest.mark.cuda
def test_cuda_dispatch_repartition_equals_repartition(cuda):
    """The dispatched solve (a worker thread, a side stream that waits on
    the caller's) gives repartition's labels and prices bitwise, and its
    launches are counted."""
    rng = np.random.default_rng(22)
    x = torch.from_numpy(rng.normal(size=(4096, 22)).astype(np.float32))
    eng = AnticlusterEngine(k=64, device=cuda)
    _, state = eng.partition(x.to(cuda))
    x2 = (x + 0.05 * torch.randn(x.shape, generator=torch.Generator()
                                 .manual_seed(3))).to(cuda)
    n0 = _build.launches["auction_phase_dense"]
    pending = eng.dispatch_repartition(x2, state)
    res_d, st_d = pending.wait()
    assert pending.ready()
    assert _build.launches["auction_phase_dense"] - n0 == 4096 // 64 - 1
    res_r, st_r = eng.repartition(x2, state)
    assert torch.equal(res_d.labels, res_r.labels)
    assert torch.equal(st_d.prices[0], st_r.prices[0])


def _loop_rounds(kw):
    """The factored phase by the Python round loop over the CUDA bid_top2
    kernel, with its exact per-group rounds, (1, G)."""
    out = ref.auction_rounds(
        ref.factored_top2(kw["x"], kw["c"], kw["is_real"], cuda_bid_top2),
        kw["prices"], kw["eps"], kw["max_rounds"], kw["fixed_rounds"],
        kw["skip"], kw["seed_top2"], return_rounds=True)
    return out[0], out[1], out[2][None]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["cold", "warm", "fixed_rounds",
                                  "max_rounds"])
def test_cuda_phase_kernels_rounds_g_equal_the_plain_count(cuda, monkeypatch,
                                                           case):
    """The kernels' per-phase, per-group ``rounds_g`` equal the plain
    twins' exact counts (the rounds that began with an unassigned row of
    the group, the seeded round, ``fixed_rounds``), so their ``amax(1)``
    is the telemetry's ``rounds``: the dense kernel on a G = 3 stack (with
    a cold group beside two warm ones), and the factored one phase by
    phase on a G = 3 stack."""
    rng = np.random.default_rng(31)
    G, n, d = 3, 96, 8
    x = torch.from_numpy(rng.normal(size=(G, n, d)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(G, n, d)).astype(np.float32))
    x, c = x.to(cuda), c.to(cuda)
    cost = -2.0 * torch.einsum("gid,gjd->gij", x, c) \
        + (c * c).sum(-1)[:, None, :]
    cfg = {"fixed_rounds": asg.AuctionConfig(fixed_rounds=30),
           "max_rounds": asg.AuctionConfig(max_rounds=9)}.get(
               case, asg.AuctionConfig())
    prices = None
    if case == "warm":
        _, prices = asg.auction_solve(cost, return_prices=True, device=cuda)
        prices = prices.clone()
        prices[0] = 0.0
    calls = {"auction_phase_dense": [], "auction_phase": []}
    for name in calls:
        def recorded(*a, _inner=getattr(ops, name), _calls=calls[name],
                     **kw):
            _calls.append((a, {**kw, "return_rounds": True}))
            return _inner(*a, **kw)
        monkeypatch.setattr(ops, name, recorded)
    _, _, st = asg.auction_solve(cost, cfg, prices=prices, return_stats=True,
                                 device=cuda)
    _, _, fst = asg.auction_solve_factored(x, c, config=cfg, prices=prices,
                                           return_stats=True, device=cuda)
    monkeypatch.undo()
    (a, kw), = calls["auction_phase_dense"]
    got = phase_kernel.auction_phase_dense(*a, **kw)
    want = ref.auction_phase_dense_ref(*a, **kw)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(st["rounds"].long(), got[2].amax(1))
    if case == "warm":
        assert bool(st["warm"][1:].all()) and not bool(st["warm"][0])
    assert len(calls["auction_phase"]) == 4
    rounds = []
    for a, kw in calls["auction_phase"]:
        got = phase_kernel.auction_phase(*a, **kw)
        x_, c_, is_real, p, eps, max_rounds, fixed_rounds = a
        want = ref.auction_rounds(
            ref.factored_top2(x_, c_, is_real, cuda_bid_top2), p, eps,
            max_rounds, fixed_rounds, kw["skip"], kw["seed_top2"],
            return_rounds=True)
        for g, w in zip(got, (*want[:2], want[2][None])):
            assert torch.equal(g, w)
        rounds.append(got[2])
    assert torch.equal(fst["rounds"].long(), torch.cat(rounds).amax(1))


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"chunk_size": 1024,
                                     "solver": "auction_fused"}],
                         ids=["flat", "stream"])
def test_cuda_telemetry_rounds_equal_the_kernels_totals(cuda, kw):
    """An engine with ``telemetry=True`` on the card: labels bitwise the
    ``telemetry=False`` engine's, and the rounds its telemetry sums equal
    the rounds the phase kernels counted on the card, cold and warm."""
    rng = np.random.default_rng(32)
    x = torch.from_numpy(rng.normal(size=(4096, 12)).astype(np.float32))
    x = x.to(cuda)
    eng = AnticlusterEngine(k=64, telemetry=True, device=cuda, **kw)
    plain = AnticlusterEngine(k=64, device=cuda, **kw)
    state = plain_state = None
    for call in ("partition", "repartition", "repartition"):
        phase_kernel.reset_totals()
        if state is None:
            res, state = eng.partition(x)
        else:
            res, state = eng.repartition(x, state)
        rounds = int(eng.last_telemetry["rounds"].sum())
        assert rounds > 0 and rounds == phase_kernel.totals()["rounds"], call
        if plain_state is None:
            want, plain_state = plain.partition(x)
        else:
            want, plain_state = plain.repartition(x, plain_state)
        assert torch.equal(res.labels, want.labels), call


@pytest.mark.cuda
def test_cuda_sequencer_and_folds(cuda):
    """The sequencer at epoch scale on the card (the stream route with
    ``"auction_fused"``): exact batch sizes, the same schedule twice, a
    warm epoch, a ragged ``grow``; then stratified folds."""
    from repro_torch.data import ABABatchSequencer, aba_folds
    rng = np.random.default_rng(33)
    x = rng.normal(size=(65536, 8)).astype(np.float32)
    seq = ABABatchSequencer(x, 512, device=cuda)
    assert seq.result.route == "stream"
    assert seq.result.solver == "auction_fused"
    assert seq.batches.shape == (128, 512)
    again = ABABatchSequencer(x, 512, device=cuda)
    assert np.array_equal(seq.batches, again.batches)
    batches = seq.epoch(1, features=x + 0.01 * rng.normal(size=x.shape)
                        .astype(np.float32))
    assert all(len(b) == 512 for b in batches)
    seq.grow(rng.normal(size=(300, 8)).astype(np.float32))
    sizes = {len(b) for b in seq.batches}
    assert sizes == {65836 // 128, 65836 // 128 + 1}
    cats = rng.integers(0, 3, 4096)
    labels = aba_folds(x[:4096], 5, categories=cats, device=cuda)
    for v in range(3):
        cnt = np.bincount(labels[cats == v], minlength=5)
        assert cnt.max() - cnt.min() <= 1


@pytest.mark.cuda
def test_cuda_router_burst_and_live_partition(cuda):
    """The router on the card: a burst stacked on one lane, every ticket
    balanced and within 1e-3 of its one-shot objective, its lanes on CUDA
    devices; a live partition's update is one dense launch."""
    from repro_torch.core.objective import objective_centroid
    from repro_torch.serve import AnticlusterRouter
    rng = np.random.default_rng(34)
    xs = [torch.from_numpy(rng.normal(size=(int(m), 6)).astype(np.float32))
          for m in rng.integers(700, 1024, 6)]
    with AnticlusterRouter(k=16, plan=None, max_group=8) as r:
        results = r.partition_many(xs)
        m = r.metrics()
        assert m.stacked_calls == 1 and m.devices == torch.cuda.device_count()
        assert all(lane.device.type == "cuda" for lane in r._lanes.values())
        for x, res in zip(xs, results):
            assert res.balanced and res.labels.is_cuda
            one = anticluster(x, k=16, plan=None, device=cuda)
            got = float(objective_centroid(x.to(cuda), res.labels, 16))
            want = float(objective_centroid(x.to(cuda), one.labels, 16))
            assert abs(got - want) <= 1e-3 * abs(want)
        r.open_partition("live", xs[0]).result(timeout=300)
        n0 = _build.launches["auction_phase_dense"]
        res = r.submit_update("live", added=xs[1][:10],
                              removed=np.arange(10)).result(timeout=300)
        assert res.updated and res.balanced
        assert _build.launches["auction_phase_dense"] - n0 == 1


@pytest.mark.cuda
@pytest.mark.parametrize("kw,kernel", [
    ({}, "auction_phase_dense"),
    ({"chunk_size": 2048, "solver": "auction_fused"}, "auction_phase")])
def test_cuda_two_shard_mesh_equals_its_shard_solves(cuda, kw, kernel):
    """A 2-shard mesh with both shards on the card: labels bitwise the two
    shards solved one by one plus the offset, each shard's labels in its
    own range, exact balance; the shards' LAPs launch the phase kernel."""
    from repro_torch.launch.mesh import make_host_mesh
    rng = np.random.default_rng(40)
    x = torch.from_numpy(rng.normal(size=(8192, 22)).astype(np.float32))
    mesh = make_host_mesh(2, 1, device=cuda)
    n0 = _build.launches[kernel]
    res = anticluster(x, k=64, mesh=mesh, device=cuda, **kw)
    launched = _build.launches[kernel] - n0
    assert res.route == "mesh" and res.plan == (2, 32) and res.balanced
    assert launched >= 2 * (4096 // 32 - 1)
    labels = res.labels.cpu().numpy()
    for s in range(2):
        rows = slice(s * 4096, (s + 1) * 4096)
        part = anticluster(x[rows], k=32, device=cuda, **kw)
        assert np.array_equal(labels[rows],
                              s * 32 + part.labels.cpu().numpy())
        assert labels[rows].min() >= s * 32 and labels[rows].max() < s * 32 + 32


@pytest.mark.cuda
def test_cuda_mesh_engine_zeroed_state_equals_oneshot(cuda):
    """A 2-shard mesh engine on the card: ``partition`` and a zeroed
    ``ShardedABAState`` give the one-shot mesh labels bitwise; a warm
    repartition keeps exact balance with per-shard prices."""
    from repro_torch.anticluster import ShardedABAState
    from repro_torch.launch.mesh import make_host_mesh
    rng = np.random.default_rng(41)
    x = torch.from_numpy(rng.normal(size=(4097, 16)).astype(np.float32))
    mesh = make_host_mesh(2, 1, device=cuda)
    one = anticluster(x, k=32, mesh=mesh, device=cuda)
    eng = AnticlusterEngine(k=32, mesh=mesh, device=cuda)
    res, state = eng.partition(x)
    assert isinstance(state, ShardedABAState)
    assert state.prices[0].shape == (2, 1, 16)
    assert torch.equal(res.labels, one.labels)
    res0, _ = eng.repartition(x, eng.init_state(x))
    assert torch.equal(res0.labels, one.labels)
    res1, state = eng.repartition(x + 0.05, state)
    assert res1.balanced and res1.labels.shape == (4097,)
    assert eng.compile_count == 1


@pytest.mark.cuda
def test_cuda_pipeline_equals_sequencer(cuda):
    """``ABAPipeline`` on the card: each epoch's labels and batches bitwise
    an ``ABABatchSequencer``'s on the same drifted features, the solves
    dispatched from the engine's worker thread."""
    from repro_torch.data import ABABatchSequencer
    from repro_torch.train import ABAPipeline
    rng = np.random.default_rng(42)
    x = rng.normal(size=(8192, 12)).astype(np.float32)
    drift = [x + 0.01 * e * rng.normal(size=x.shape).astype(np.float32)
             for e in range(3)]
    seq = ABABatchSequencer(x, 128, seed=4, device=cuda)
    pipe = ABAPipeline(x, 128, seed=4, device=cuda)
    assert pipe.overlapped
    for e, ep in enumerate(pipe.epochs(3, features=lambda i: drift[i])):
        batches = seq.epoch(e, features=drift[e] if e else None)
        assert np.array_equal(pipe.labels, seq.result.labels.cpu().numpy())
        assert all(np.array_equal(a, b) for a, b in zip(ep, batches))
    assert pipe.engine.compile_count == 1
    pipe.engine.close()


# ---------------------------------------------------------------------------
# the model stack: falcon-mamba-7b's Mamba layers and Generator
# ---------------------------------------------------------------------------

def _falcon(reduced=True, **over):
    return model_registry.get_config("falcon-mamba-7b", reduced=reduced,
                                     **over)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
def test_cuda_mamba_layer_prefill_equals_forced_plain_path(cuda, full):
    """One Mamba layer's prefill through the ssm_scan kernel (one launch)
    against the same layer under ``forced_path("ref")`` (none): conv_buf
    bitwise, h within the scan's rtol / atol 1e-4; out within 1e-4 in
    float32 (reduced), and at full width (d_inner 8192, bfloat16, B = 2,
    S = 2048) within two bfloat16 ulps at its scale, 2**-7 max |out|: the
    kernel's y and the plain scan's differ near 1e-6, which can move
    y.to(bfloat16) by one ulp."""
    cfg = _falcon(reduced=not full)
    gen = torch.Generator(device=cuda).manual_seed(11)
    layer = Mamba(cfg, device=cuda)
    defs = mamba_defs(cfg)
    for name, p in layer.named_parameters():
        MT._init_leaf(name, defs[name], p, gen)
    seq = 2048 if full else 64
    x = torch.randn((2, seq, cfg.d_model), generator=gen, device=cuda).to(
        getattr(torch, cfg.compute_dtype))
    out, (conv, h) = _counted("ssm_scan", layer, x)
    n0 = dict(_build.launches)
    with ops.forced_path("ref"):
        out_p, (conv_p, h_p) = layer(x)
    assert _build.launches == n0
    assert torch.equal(conv, conv_p) and conv.dtype == x.dtype
    torch.testing.assert_close(h, h_p, rtol=1e-4, atol=1e-4)
    if full:
        assert out.dtype == torch.bfloat16
        err = (out.float() - out_p.float()).abs().max().item()
        assert err <= 2.0 ** -7 * out_p.float().abs().max().item(), err
    else:
        torch.testing.assert_close(out, out_p, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_ssm_scan_launches_once_a_layer_per_prefill(cuda):
    """A 4-layer reduced model: one ssm_scan launch a Mamba layer in the
    prefill, none in a decode step; the prefill's logits and cache within
    1e-4 of the forced plain path's."""
    cfg = _falcon(n_layers=4)
    model = MT.init_params(cfg, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    tokens = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab_size, (2, 40))).to(cuda)
    n0 = _build.launches["ssm_scan"]
    logits, cache = MT.prefill(cfg, model, tokens, 48)
    assert _build.launches["ssm_scan"] == n0 + 4
    with ops.forced_path("ref"):
        want, want_cache = MT.prefill(cfg, model, tokens, 48)
    torch.testing.assert_close(logits, want, rtol=1e-4, atol=1e-4)
    for name in ("conv", "h"):
        torch.testing.assert_close(cache["L0"][name], want_cache["L0"][name],
                                   rtol=1e-4, atol=1e-4)
    tok = logits.argmax(-1)
    for step in range(3):
        logits, cache = MT.decode_step(cfg, model, cache, 40 + step, tok)
        tok = logits.argmax(-1)
    assert _build.launches["ssm_scan"] == n0 + 4


@pytest.mark.cuda
def test_cuda_generate_reduced_equals_forced_plain_path(cuda):
    """``Generator.generate`` on the card: greedy tokens equal the forced
    plain path's, with one ssm_scan launch a layer (the prefill's); sampled
    tokens in range and equal for equal seeds (P9)."""
    cfg = _falcon()
    model = MT.init_params(cfg, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    server = Generator(cfg, model, max_len=64, device=cuda)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (3, 24))
    n0 = _build.launches["ssm_scan"]
    got = server.generate(prompts, 8)
    assert _build.launches["ssm_scan"] == n0 + cfg.n_layers
    with ops.forced_path("ref"):
        want = server.generate(prompts, 8)
    assert _build.launches["ssm_scan"] == n0 + cfg.n_layers
    np.testing.assert_array_equal(got, want)
    sampled = server.generate(prompts, 8, temperature=1.0, seed=1)
    assert (sampled >= 0).all() and (sampled < cfg.vocab_size).all()
    np.testing.assert_array_equal(
        sampled, server.generate(prompts, 8, temperature=1.0, seed=1))
    assert not np.array_equal(sampled, got)


def _grad_close(got, want, rel=1e-4):
    """Within ``rel`` of the gradient's max |.| (the kernel sums over
    d_inner, batch and time in another order than the plain walk)."""
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    assert err <= rel * scale + 1e-7, (err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("bsz,s,di,ds", [
    (2, 64, 512, 16), (2, 37, 200, 64), (1, 100, 130, 5), (3, 16, 64, 16),
    (1, 9, 70, 32), (2, 33, 96, 2),
    # every instantiation (d_state 1, 2, 3-4, 5-8, 9-16, 17-32, 33-64),
    # d_inner past the last full CTA, S = 1 and 16 k + 1, B = 3, and
    # falcon-mamba-7b's d_inner: 128 channel blocks to sum
    (2, 17, 300, 1), (1, 1, 40, 3), (2, 48, 129, 8), (3, 33, 200, 16),
    (2, 1, 96, 16), (1, 20, 33, 64), (2, 64, 8192, 16)])
def test_cuda_ssm_scan_bwd_vs_plain(cuda, bsz, s, di, ds):
    """The backward kernel against ``ssm_scan_chunk_bwd_ref`` in both
    layouts (the time-major one from a nonzero h0, with its dh0): every
    gradient within 1e-4 of its max |.|; every d_state the kernel
    instantiates for, up to MAX_STATE (64), S past the last full 16-step
    tile and under one, d_inner past the last full CTA, and the sums over
    all of falcon-mamba-7b's channel blocks.  The saving forward's y and h
    are bitwise the serving launch's, its saved states those of the plain
    scan a tile at a time; a second backward is bitwise the first (no
    float atomics)."""
    args = _ssm_inputs((bsz, s), di, ds, cuda)
    gen = torch.Generator(device=cuda).manual_seed(s * di)
    dy = torch.randn((bsz, s, di), generator=gen, device=cuda)
    dh = torch.randn((bsz, di, ds), generator=gen, device=cuda)
    y, h, tiles = _counted("ssm_scan", ssm_scan_train, *args)
    y0, h0_ = K.ssm_scan(*args)
    assert torch.equal(y, y0) and torch.equal(h, h0_)
    want_tiles = ssm_scan_train(*(t.cpu() for t in args))[2]
    torch.testing.assert_close(tiles.cpu(), want_tiles, rtol=1e-4, atol=1e-4)
    got = _counted("ssm_scan_bwd", ssm_scan_bwd, *args, tiles, dy, dh)
    again = ssm_scan_bwd(*args, tiles, dy, dh)
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    tm = [t.transpose(0, 1) for t in (*args[:4], dy)]
    zero = torch.zeros_like(dh)
    want = ssm_scan_chunk_bwd_ref(*tm[:4], args[4], zero, tm[4], dh)
    for g, w in zip(got, [*(t.transpose(0, 1) for t in want[:4]),
                          *want[4:]]):
        assert g.shape == w.shape
        _grad_close(g, w)
    tmc = [t.contiguous() for t in tm]
    h_init = torch.randn((bsz, di, ds), generator=gen, device=cuda)
    _, _, tiles = ssm_scan_train(*tmc[:4], args[4], h_init, time_major=True)
    got = ssm_scan_bwd(*tmc[:4], args[4], tiles, tmc[4], dh,
                       time_major=True)
    want = ssm_scan_chunk_bwd_ref(*tmc[:4], args[4], h_init, tmc[4], dh)
    for g, w in zip(got, want):
        _grad_close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("full", [False, True])
def test_cuda_mamba_layer_grads_equal_forced_plain_path(cuda, full):
    """Every parameter gradient of one Mamba layer (and the input's)
    through the kernels (one ssm_scan and one ssm_scan_bwd launch) against
    the forced plain path (none), within 1e-4 of each gradient's max |.|;
    float32 compute, reduced and at falcon-mamba-7b's width (d_inner 8192,
    B = 2, S = 256)."""
    cfg = _falcon(reduced=not full, compute_dtype="float32")
    gen = torch.Generator(device=cuda).manual_seed(12)
    layer = Mamba(cfg, device=cuda)
    defs = mamba_defs(cfg)
    for name, p in layer.named_parameters():
        MT._init_leaf(name, defs[name], p, gen)
    layer.requires_grad_(True)
    seq = 256 if full else 45
    x = torch.randn((2, seq, cfg.d_model), generator=gen, device=cuda)
    w = torch.randn((2, seq, cfg.d_model), generator=gen, device=cuda)

    def grads():
        layer.zero_grad(set_to_none=True)
        xi = x.clone().requires_grad_(True)
        out, (_, h) = layer(xi)
        ((out * w).sum() + h.sum()).backward()
        return [xi.grad] + [p.grad for p in layer.parameters()]

    n0 = dict(_build.launches)
    got = grads()
    assert _build.launches["ssm_scan"] == n0["ssm_scan"] + 1
    assert _build.launches["ssm_scan_bwd"] == n0["ssm_scan_bwd"] + 1
    n1 = dict(_build.launches)
    with ops.forced_path("ref"):
        want = grads()
    assert _build.launches == n1
    for g, wt in zip(got, want):
        _grad_close(g, wt)


@pytest.mark.cuda
def test_cuda_train_steps_equal_forced_plain_path(cuda):
    """Two train steps of the reduced falcon-mamba-7b (remat on): each
    launches ssm_scan twice a layer (the forward and the recompute) and
    ssm_scan_bwd once; the losses within 1e-5 relative and the updated
    parameters within 1e-4 of the forced plain path's; a third run of the
    kernel path is bitwise the first."""
    from repro_torch.train import OptConfig, adamw_init, make_train_step
    cfg = _falcon()
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (4, 40))).to(cuda)
    step = make_train_step(cfg, None, OptConfig(lr=1e-3, warmup_steps=1),
                           microbatches=2, loss_chunk=16)

    def run():
        model = MT.init_params(cfg, device=cuda, generator=torch.Generator(
            device=cuda).manual_seed(0))
        opt = adamw_init(model)
        losses = []
        for _ in range(2):
            n0 = dict(_build.launches)
            model, opt, m = step(model, opt, {"tokens": tokens})
            losses.append(m["loss"].item())
            moved = {k: v - n0[k] for k, v in _build.launches.items()}
            yield moved
        yield losses, [p.detach().clone() for p in model.parameters()]

    *moves, (losses, params) = run()
    for moved in moves:  # two microbatches a step
        assert moved["ssm_scan"] == 2 * 2 * cfg.n_layers, moved
        assert moved["ssm_scan_bwd"] == 2 * cfg.n_layers, moved
    with ops.forced_path("ref"):
        *_, (want_losses, want_params) = run()
    np.testing.assert_allclose(losses, want_losses, rtol=1e-5)
    for p, q in zip(params, want_params):
        _grad_close(p, q)
    *_, (again, again_params) = run()
    assert again == losses
    assert all(torch.equal(p, q) for p, q in zip(params, again_params))


# ---------------------------------------------------------------------------
# the model stack: the dense attention family
# ---------------------------------------------------------------------------

def _full_softmax(q, k, v, *, window=0, softcap=0.0):
    """Attention through materialised, masked float32 scores."""
    b, s, h, hd = q.shape
    kv = k.shape[2]
    qg = q.float().reshape(b, s, kv, h // kv, hd)
    scores = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / hd ** 0.5
    scores = L._softcap(scores, softcap)
    pos = torch.arange(s, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window:
        mask &= pos[None, :] > pos[:, None] - window
    p = torch.softmax(torch.where(mask, scores, -1e30), dim=-1)
    return torch.einsum("bkgqs,bskh->bqkgh", p, v.float()).reshape(
        b, s, h, hd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_equals_full_softmax(cuda, dtype):
    """gemma2's head shape (8 heads over 4, hd 256) at S = 1 000 with the
    reduced chunks of 128 / 256 (padded blocks), the softcap 50, windowed
    and global: float32 within 1e-4 of max |out|, bfloat16 within two
    bfloat16 ulps at that scale."""
    gen = torch.Generator(device=cuda).manual_seed(21)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((2, 1000, 8, 256), (2, 1000, 4, 256),
                             (2, 1000, 4, 256)))
    for window in (0, 300):
        got = L.flash_attention(q, k, v, window=window, softcap=50.0,
                                chunk_q=128, chunk_kv=256)
        want = _full_softmax(q, k, v, window=window, softcap=50.0)
        assert got.dtype == dtype
        err = (got.float() - want).abs().max().item()
        scale = want.abs().max().item()
        assert err <= (1e-4 if dtype == torch.float32 else 2.0 ** -7) * scale


def _gemma2_local(window=8, **over):
    cfg = model_registry.get_config("gemma2-2b", reduced=True, **over)
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, sliding_window=window) for s in cfg.pattern))


@pytest.mark.cuda
def test_cuda_dense_model_equals_cpu(cuda):
    """A reduced gemma2 with a window of 8 on every layer, in float32, on
    the card against the same weights on the CPU: prefill, three decode
    steps and forward within 1e-4; no kernel of the repo launches."""
    cfg = _gemma2_local()
    model = MT.init_params(cfg, device="cpu", generator=torch.Generator()
                           .manual_seed(5))
    tokens = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 40)))
    n0 = dict(_build.launches)
    got, want = [], []
    for dev, out in ((cuda, got), (torch.device("cpu"), want)):
        m = model.to(dev)
        t = tokens.to(dev)
        logits, cache = MT.prefill(cfg, m, t, 48)
        out.append(logits)
        tok = tokens[:, -1:].to(dev)
        for step in range(3):
            logits, cache = MT.decode_step(cfg, m, cache, 40 + step, tok)
            out.append(logits)
            tok = (tok + 1) % cfg.vocab_size
        out.append(cache["L0"]["k"])
        out.append(MT.forward(cfg, m, t))
    assert _build.launches == n0
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_generate_dense_reduced(cuda):
    """``Generator`` on a reduced qwen2.5 (q, k, v biases, theta 1e6) on the
    card: tokens in range, greedy deterministic, sampling unlike greedy."""
    cfg = model_registry.get_config("qwen2.5-14b", reduced=True)
    model = MT.init_params(cfg, device=cuda, generator=torch.Generator(
        device=cuda).manual_seed(0))
    server = Generator(cfg, model, max_len=64, device=cuda)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 24))
    got = server.generate(prompts, 16)
    assert got.shape == (3, 16)
    assert (got >= 0).all() and (got < cfg.vocab_size).all()
    np.testing.assert_array_equal(got, server.generate(prompts, 16))
    sampled = server.generate(prompts, 16, temperature=1.0, seed=1)
    assert (sampled >= 0).all() and (sampled < cfg.vocab_size).all()
    assert not np.array_equal(sampled, got)


# ---------------------------------------------------------------------------
# the MoE and MLA family, and the hybrid jamba
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "deepseek-v2-236b",
                                  "jamba-v0.1-52b"])
def test_cuda_moe_model_equals_cpu(cuda, arch):
    """The reduced model in float32 on the card against the same weights on
    the CPU: the prefill's logits and every cache entry, three decode steps
    and forward within 1e-4.  jamba's prefill launches ssm_scan once a
    Mamba layer (7 a block of 8), its decode steps never; granite and
    deepseek launch no kernel of the repo."""
    cfg = model_registry.get_config(arch, reduced=True)
    model = MT.init_params(cfg, device="cpu", generator=torch.Generator()
                           .manual_seed(6))
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 40)))
    mamba = sum(s.mixer == "mamba" for s in cfg.pattern) * cfg.n_blocks
    got, want = [], []
    for dev, out in ((cuda, got), (torch.device("cpu"), want)):
        m = model.to(dev)
        t = tokens.to(dev)
        n0 = dict(_build.launches)
        logits, cache = MT.prefill(cfg, m, t, 48)
        scans = _build.launches["ssm_scan"] - n0["ssm_scan"]
        out.append(logits)
        out.extend(e for entry in cache.values() for e in entry.values())
        tok = tokens[:, -1:].to(dev)
        for step in range(3):
            logits, cache = MT.decode_step(cfg, m, cache, 40 + step, tok)
            out.append(logits)
            tok = (tok + 1) % cfg.vocab_size
        out.append(MT.forward(cfg, m, t))
        launched = {k: v - n0[k] for k, v in _build.launches.items()}
        if dev.type == "cuda":
            assert scans == mamba == (14 if cfg.family == "hybrid" else 0)
            assert launched == {k: (2 * mamba if k == "ssm_scan" else 0)
                                for k in launched}  # prefill and forward
        else:
            assert not any(launched.values())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["reduced", "granite-integer",
                                  "granite-integer-drops", "zero-router"])
def test_cuda_moe_routing_equals_cpu(cuda, case):
    """``moe.route`` on the card equals the CPU's: the chosen experts, the
    ranks, the kept pairs and the slots exactly, the probabilities within
    rtol 1e-5 (float32 logits of random inputs differ by ulps between
    cuBLAS and the CPU, and exp scales that by |logit|).  At granite's
    full width (1 536 wide, 40 experts padded to 48, top 8, 512 tokens)
    the inputs are small integers, so the float32 logits are exact on both
    and tie often: the tie rule decides, on the card as on the CPU; with
    capacity factor 0.5 pairs drop.  A zero router picks experts
    0 .. k-1."""
    reduced = case == "reduced"
    cfg = model_registry.get_config("granite-moe-3b-a800m", reduced=reduced)
    if case.endswith("drops"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=0.5))
    gen = torch.Generator().manual_seed(8)
    e_pad = MOE.padded_experts(cfg)
    t = 80 if reduced else 512
    if case.startswith("granite-integer"):
        x = torch.randint(-2, 3, (t, cfg.d_model), generator=gen).float()
        router = torch.randint(-1, 2, (cfg.d_model, e_pad),
                               generator=gen).float() / 8
    else:
        x = torch.randn((t, cfg.d_model), generator=gen)
        router = torch.randn((cfg.d_model, e_pad), generator=gen)
        if case == "zero-router":
            router.zero_()
    got = MOE.route(cfg, router.to(cuda), x.to(cuda))
    want = MOE.route(cfg, router, x)
    assert got.cap == want.cap
    for name in ("top_e", "ranks", "keep", "slot"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), name
    torch.testing.assert_close(got.top_p.cpu(), want.top_p, rtol=1e-5,
                               atol=1e-7)
    if reduced:  # capacity factor 8 >= E / k: nothing drops
        assert bool(want.keep.all())
    if case.endswith("drops"):
        assert not bool(want.keep.all())
    if case == "zero-router":
        assert torch.equal(want.top_e, torch.arange(cfg.moe.top_k).expand(
            t, -1))


# ---------------------------------------------------------------------------
# the front ends: qwen2-vl's M-RoPE and patch prefix, whisper's encoder
# ---------------------------------------------------------------------------

def _grid_positions(b, s, grid):
    """Qwen2-VL's (B, S, 3) positions: ``grid**2`` patches at (0, i //
    grid, i % grid), then text at ``grid + j`` in all three streams."""
    i = torch.arange(grid * grid)
    patches = torch.stack([torch.zeros_like(i), i // grid, i % grid], -1)
    text = (grid + torch.arange(s - grid * grid))[:, None].expand(-1, 3)
    return torch.cat([patches, text]).expand(b, s, 3)


def _front_model(arch, seed):
    """The reduced model on the CPU, its norm weights drawn as 1 + 0.02
    N(0, 1) and biases as 0.02 N(0, 1) (zero under the init rule, which
    makes whisper compute zeros: ROADMAP R9); tokens (2, 40); the front
    end's inputs; qwen2-vl's grid positions (whisper: None)."""
    cfg = model_registry.get_config(arch, reduced=True)
    gen = torch.Generator().manual_seed(seed)
    model = MT.init_params(cfg, device="cpu", generator=gen)
    with torch.no_grad():
        for path, _, p in model.leaves():
            name = path.split("/")[-1]
            if name.startswith(("ln", "final_norm")):
                p.normal_(0.0 if name.endswith("_b") else 1.0, 0.02,
                          generator=gen)
    rng = np.random.default_rng(seed)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    if cfg.enc_layers:
        return cfg, model, tokens, {"enc_frames": torch.from_numpy(
            rng.normal(size=(2, cfg.enc_ctx, cfg.d_model))).float()}, None
    return cfg, model, tokens, {"extra_embeds": torch.from_numpy(
        rng.normal(size=(2, 16, cfg.d_model))).float()}, _grid_positions(
            2, 40, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-medium"])
def test_cuda_front_end_model_equals_cpu(cuda, arch):
    """The reduced model in float32 on the card against the same weights on
    the CPU: ``encode``, the prefill's logits and every cache entry (``xk``,
    ``xv`` included), three decode steps (qwen2-vl at the grid's next text
    positions) and ``forward`` within 1e-4; on the card each step shares
    ``xk`` and ``xv`` with the cache it was given; no kernel of the repo
    launches."""
    cfg, model, tokens, front, grid = _front_model(arch, 9)
    n0 = dict(_build.launches)
    got, want = [], []
    for dev, out in ((cuda, got), (torch.device("cpu"), want)):
        m = model.to(dev)
        t = tokens.to(dev)
        fr = {k: v.to(dev) for k, v in front.items()}
        pos = None if grid is None else grid.to(dev)
        if cfg.enc_layers:
            out.append(MT.encode(cfg, m, fr["enc_frames"]))
        logits, cache = MT.prefill(cfg, m, t, 48, positions=pos, **fr)
        out.append(logits)
        out.extend(e for entry in cache.values() for e in entry.values())
        tok = tokens[:, -1:].to(dev)
        for step in range(3):
            step_pos = None if pos is None else torch.full(
                (2, 1, 3), 40 - 16 + 4 + step, device=dev)
            logits, new = MT.decode_step(cfg, m, cache, 40 + step, tok,
                                         positions=step_pos)
            for key, entry in cache.items():
                for name, e in entry.items():
                    assert (new[key][name].data_ptr() == e.data_ptr()) == (
                        name in ("xk", "xv")), (key, name)
            cache = new
            out.append(logits)
            tok = (tok + 1) % cfg.vocab_size
        out.append(MT.forward(cfg, m, t, positions=pos, **fr))
    assert _build.launches == n0
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_mrope_grid_positions_against_float64(cuda):
    """``apply_rope`` on the card at qwen2-vl-7b's full width (head_dim 128,
    sections (16, 24, 24), theta 1e6) and Qwen2-VL's positions for a 16 x
    16 patch grid and 1 792 text tokens, against the same formula in
    float64, within float32's error for these angles: 2^-22 of max |x|
    times (the largest angle + 4)."""
    cfg = model_registry.get_config("qwen2-vl-7b")
    x = torch.randn((2, 2048, 4, cfg.head_dim), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3))
    pos = _grid_positions(2, 2048, 16).to(cuda)
    got = L.apply_rope(cfg, x, pos)
    half = cfg.head_dim // 2
    inv = cfg.rope_theta ** (-torch.arange(half, dtype=torch.float64,
                                           device=cuda) * 2.0 / cfg.head_dim)
    stream = torch.repeat_interleave(torch.arange(3), torch.tensor(
        cfg.mrope_sections)).to(cuda)
    ang = pos.double()[..., stream] * inv
    sin, cos = torch.sin(ang)[:, :, None], torch.cos(ang)[:, :, None]
    x1, x2 = x.double()[..., :half], x.double()[..., half:]
    want = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    tol = 2.0 ** -22 * x.abs().max().item() * (ang.max().item() + 4)
    assert (got.double() - want).abs().max().item() <= tol
    plain = L.apply_rope(cfg, x, pos[..., 0])
    assert (plain - got).abs().max().item() > 0.1  # the streams count


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-vl-7b", "whisper-medium"])
def test_cuda_generate_front_ends(cuda, arch):
    """``Generator`` on the card with the front end's inputs as numpy
    arrays: tokens in range, greedy deterministic, and the front end's
    inputs move them."""
    cfg, model, tokens, front, _ = _front_model(arch, 10)
    server = Generator(cfg, model, max_len=64, device=cuda)
    front = {k: v.numpy() for k, v in front.items()}
    got = server.generate(tokens.numpy(), 16, **front)
    assert got.shape == (2, 16)
    assert (got >= 0).all() and (got < cfg.vocab_size).all()
    np.testing.assert_array_equal(got, server.generate(tokens.numpy(), 16,
                                                       **front))
    other = {k: -v for k, v in front.items()}
    assert not np.array_equal(got, server.generate(tokens.numpy(), 16,
                                                   **other))
