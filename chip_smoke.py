"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py            # from the root of a checkout

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into the
git-ignored ``build/``), then runs these phases, one or more lines each:

1. environment: the card's name and power limit, torch / CUDA versions and
   the kernel build time;
2. every kernel against its plain PyTorch version on the card, with its
   time, the plain version's, a PyTorch library call's (a yardstick only)
   and the least time the card could take (``bound_ms``);
3. the main path: ``anticluster(x, k=256, chunk_size="auto")`` on the
   paper's *diabetes* shape (n = 253 680, d = 22), which takes the
   ``"stream"`` route with the ``"auction_fused"`` solver.  First the
   process's first call of that path and a second, identical one on the
   same first 16 384 rows (the one-time costs), then the full-size call,
   with the
   kernels' launch counters zeroed just before it and read just after, then
   a profile of the first few batches of one chunk;
4. the same path at n = 16 384 against the plain kernels;

then one JSON line describing every kernel, and as the last line
``{"ok": true, "device": {...}}``.  Any failure raises, exits non-zero and
prints no last line.  Needs one CUDA device; fails without one.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.anticluster import anticluster  # noqa: E402
from repro_torch.core import assignment as asg  # noqa: E402
from repro_torch.core.aba import aba_stream  # noqa: E402
from repro_torch.core.objective import (balance_ok,  # noqa: E402
                                        objective_centroid)
from repro_torch.data.synthetic import PRESETS, make  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import bid_top2 as bid_mod  # noqa: E402
from repro_torch.kernels import gather as gather_mod  # noqa: E402
from repro_torch.kernels.ref import bid_top2_ref, gather_rows_ref  # noqa: E402

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth and fp32 outside the
# tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# Rows of the first/second call pair (two chunks), which are given the
# chunk and solver that the auto route picks at full size.  Two full-size
# calls do not fit the script's 1200 s: one took 353-619 s on the H100
# machines measured (PERF.md).
PAIR_ROWS = 1 << 14
PAIR_ARGS = {"chunk_size": 8192, "solver": "auction_fused"}
PROFILE_BATCHES = 4  # LAPs of the profiled run


T_START = time.perf_counter()


def log(msg: str):
    print(msg, flush=True)


def phase(name: str):
    log(f"== {name} (at {time.perf_counter() - T_START:.1f} s)")


def time_ms(fn, reps: int = 30, warmup: int = 5) -> float:
    """Median over ``reps`` calls of CUDA-event time around one call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, name: str, reps: int = 20) -> float | None:
    """Mean device time of the kernels named ``name`` per call, from the
    profiler; None where it records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(_self_device_us(e) for e in prof.key_averages()
             if _is_kernel(e) and name in e.key)
    return us / reps / 1e3 if us else None


def _self_device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def _is_kernel(evt) -> bool:
    return getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_FP32_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts():
    bid_mod.launches = 0
    gather_mod.launches = 0
    asg.rounds_executed = 0


def counts() -> dict:
    return {"bid_top2": bid_mod.launches, "gather_rows": gather_mod.launches,
            "rounds": asg.rounds_executed}


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def bid_inputs(gen, G, m, k, d, integer, dev):
    if integer:
        def r(lo, hi, shape):
            return torch.randint(lo, hi, shape, generator=gen).float().to(dev)
        return r(-2, 3, (G, m, d)), r(-1, 2, (G, k, d)), r(-2, 3, (G, k))
    return (torch.randn((G, m, d), generator=gen).to(dev),
            torch.randn((G, k, d), generator=gen).to(dev),
            torch.randn((G, k), generator=gen).to(dev))


def check_bid_top2(dev) -> float:
    """Exact on integers, tolerance on floats; returns the float max error
    at the main shape."""
    gen = torch.Generator().manual_seed(0)
    main_err = None
    for G, m, k, d in [(1, 256, 256, 22), (1, 256, 256, 32), (4, 256, 256, 32),
                       (1, 37, 37, 5), (1, 256, 513, 22), (1, 64, 513, 200)]:
        x, c, p = bid_inputs(gen, G, m, k, d, True, dev)
        got, want = bid_mod.bid_top2(x, c, p), bid_top2_ref(x, c, p)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("v1", "j1", "v2")):
            check(torch.equal(g, w), f"bid_top2 {what} differs on integers "
                                     f"at G={G} m={m} k={k} d={d}")
        x, c, p = bid_inputs(gen, G, m, k, d, False, dev)
        (v1, j1, v2), (w1, wj, w2) = bid_mod.bid_top2(x, c, p), bid_top2_ref(x, c, p)
        scale = w1.abs().max().item()
        err = max((v1 - w1).abs().max().item(), (v2 - w2).abs().max().item())
        tol = (1e-4 * scale + 1e-5 * torch.maximum(w1.abs(), w2.abs())).max()
        check(err <= tol.item(), f"bid_top2 float error {err} at "
                                 f"G={G} m={m} k={k} d={d}")
        clear = (w1 - w2) > 1e-4 * scale
        check(torch.equal(j1[clear], wj[clear]),
              f"bid_top2 argmax differs at G={G} m={m} k={k} d={d}")
        log(f"bid_top2 G={G} m={m} k={k} d={d}: integers exact, floats "
            f"max_abs_err={err:.3e} (tol {tol.item():.3e}), argmax equal "
            f"where the top-2 gap > 1e-4*scale")
        if (G, m, k, d) == (1, 256, 256, 22):
            main_err = err
    return main_err


def measure_bid_top2(dev, err) -> dict:
    G, m, k, d = 1, 256, 256, 22
    gen = torch.Generator().manual_seed(1)
    x, c, p = (t[0] for t in bid_inputs(gen, G, m, k, d, False, dev))
    ms = time_ms(lambda: bid_mod.bid_top2(x, c, p))
    dms = device_ms(lambda: bid_mod.bid_top2(x, c, p), "bid_top2_kernel")
    plain = time_ms(lambda: bid_top2_ref(x, c, p))
    bias = (c * c).sum(1) - p

    def library():  # yardstick only: one GEMM with the bias, then topk(2)
        return torch.topk(torch.addmm(bias, x, c.T, alpha=-2.0), 2, dim=1)

    lib = time_ms(library)
    n_bytes = 4 * (m * d + k * d + k) + m * (4 + 8 + 4)
    n_ops = 2 * m * k * d + 2 * k * d
    b, by = bound_ms(n_bytes, n_ops)
    return {"name": "bid_top2", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/bid_top2.cu",
            "replaces": "src/repro/kernels/bid_top2.py:33",
            "shape": f"G={G} m={m} k={k} d={d}", "max_abs_err": err,
            "ms": ms, "device_ms": dms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib}


def check_and_measure_gather(dev) -> dict:
    n, m, d = PRESETS["diabetes"][0], 8192, PRESETS["diabetes"][1]
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((n, d), generator=gen).to(dev)
    idx = torch.randint(-100, n + 100, (m,), generator=gen).to(dev)
    for index in (idx, idx.int()):
        got, want = gather_mod.gather_rows(x, index), gather_rows_ref(x, index)
        torch.cuda.synchronize()
        check(torch.equal(got.view(torch.int32), want.view(torch.int32)),
              f"gather_rows differs ({index.dtype})")
    x32 = torch.randn((n, 32), generator=gen).to(dev)  # the float4 path
    check(torch.equal(gather_mod.gather_rows(x32, idx),
                      gather_rows_ref(x32, idx)), "gather_rows d=32 differs")
    log(f"gather_rows n={n} m={m} d={d} (clipped int64 and int32 indices) "
        f"and d=32: bitwise equal")
    ms = time_ms(lambda: gather_mod.gather_rows(x, idx))
    dms = device_ms(lambda: gather_mod.gather_rows(x, idx),
                    "gather_rows_kernel")
    plain = time_ms(lambda: gather_rows_ref(x, idx))
    clipped = idx.clamp(0, n - 1)
    lib = time_ms(lambda: torch.index_select(x, 0, clipped))
    b, by = bound_ms(2 * 4 * m * d + 8 * m, 0)
    return {"name": "gather_rows", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/gather_rows.cu",
            "replaces": "src/repro/kernels/gather.py:69",
            "shape": f"n={n} m={m} d={d}", "max_abs_err": 0.0, "ms": ms,
            "device_ms": dms, "plain_ms": plain, "bound_ms": b,
            "bound_by": by, "library_ms": lib}


# ---------------------------------------------------------------------------
# phase 3: the main path at full size
# ---------------------------------------------------------------------------

def profile_batches(x, k):
    """The first PROFILE_BATCHES batches of the main path's data, streamed
    as one chunk: device time in bid_top2, in every other kernel, and the
    host gaps between them, all from one profiled run; the wall time of the
    same run without the profiler is printed beside them."""
    from torch.profiler import ProfilerActivity, profile
    xs = x[:PROFILE_BATCHES * k]

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        aba_stream(xs, k, 8192, solver="auction_fused", device=x.device)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    reset_counts()
    unprofiled_ms = run()
    rounds = counts()["rounds"]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_ms = run()
    kernels = [e for e in prof.key_averages() if _is_kernel(e)]
    bid_us = sum(_self_device_us(e) for e in kernels if "bid_top2" in e.key)
    all_us = sum(_self_device_us(e) for e in kernels)
    n_kernels = sum(e.count for e in kernels)
    for e in sorted(kernels, key=_self_device_us, reverse=True)[:8]:
        log(f"  profile: {_self_device_us(e) / 1e3:9.3f} ms device  "
            f"{e.count:7d} launches  {e.key[:90]}")
    if not all_us:
        log("profile: the profiler recorded no device time; the split is "
            "not measured")
        return None
    split = {"rows": xs.shape[0], "rounds": rounds, "wall_ms": wall_ms,
             "bid_top2_device_ms": bid_us / 1e3,
             "other_device_ms": (all_us - bid_us) / 1e3,
             "host_gap_ms": wall_ms - all_us / 1e3,
             "idle_share": 1.0 - all_us / 1e3 / wall_ms,
             "kernel_launches": n_kernels,
             "unprofiled_wall_ms": unprofiled_ms}
    log("profile split (one profiled run; wall, device time and gaps all "
        "from it): " + json.dumps(split))
    return split


def timed_call(x, k, dev, **kw):
    """One user call of the main path, synchronized; (result, seconds,
    counts read just after, zeroed just before)."""
    kw.setdefault("chunk_size", "auto")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    res = anticluster(x, k=k, device=dev, **kw)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    used = counts()
    check(res.route == "stream", f"route {res.route}, expected stream")
    check(res.solver == "auction_fused", f"solver {res.solver}")
    check(used["bid_top2"] > 0 and used["gather_rows"] > 0,
          f"kernels not launched on the main path: {used}")
    return res, seconds, used


def main_path(dev, n: int) -> dict:
    d, k = PRESETS["diabetes"][1], 256
    if n != PRESETS["diabetes"][0]:
        log(f"main path rows cut from {PRESETS['diabetes'][0]} to {n} "
            f"(--n; d={d} and k={k} kept)")
    x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)

    # The one-time costs: the process's first call of the path, then a
    # second one on the same rows.
    n2 = min(n, PAIR_ROWS)
    pair, labels = [], []
    for which in ("first", "second"):
        res2, secs, used2 = timed_call(x[:n2], k, dev, **PAIR_ARGS)
        check(res2.balanced, f"{which} call unbalanced")
        labels.append(res2.labels)
        pair.append({"s": secs, "rounds": used2["rounds"],
                     "us_per_round": secs / used2["rounds"] * 1e6})
        log(f"{which} call n={n2}: {secs:.3f} s, {used2['rounds']} rounds "
            f"({pair[-1]['us_per_round']:.1f} us per round)")
    check(torch.equal(labels[0], labels[1])
          and pair[0]["rounds"] == pair[1]["rounds"],
          "the second call gave other labels or rounds than the first")

    res, main_s, used = timed_call(x, k, dev)
    sizes = res.cluster_sizes.cpu().numpy()
    check(sizes.sum() == n and sizes.min() == n // k
          and sizes.max() == -(-n // k), f"unbalanced sizes {sizes.min()}"
          f"..{sizes.max()}")
    gap = float(res.gap)
    check(np.isfinite(gap) and gap >= 0.0, f"gap {gap}")
    ofv = float(objective_centroid(x, res.labels, k))
    rand = np.random.default_rng(0).permutation(np.arange(n) % k)
    ofv_rand = float(objective_centroid(x, torch.from_numpy(rand).to(dev), k))
    check(ofv > ofv_rand, f"objective {ofv} not above random {ofv_rand}")
    log(f"main path n={n} d={d} k={k}: route={res.route} "
        f"solver={res.solver} {main_s:.3f} s; launches "
        f"bid_top2={used['bid_top2']} gather_rows={used['gather_rows']}; "
        f"bidding rounds {used['rounds']} ({used['rounds'] / n:.2f} per "
        f"row, {main_s / used['rounds'] * 1e6:.1f} us per round); sizes "
        f"{sizes.min()}..{sizes.max()}; ofv {ofv:.6e} > random "
        f"{ofv_rand:.6e}; gap {gap:.6e}")
    split = profile_batches(x, k)
    return {"n": n, "main_s": main_s,
            "main_us_per_round": main_s / used["rounds"] * 1e6,
            "pair_n": n2, "first_call": pair[0], "second_call": pair[1],
            "launches": used, "ofv": ofv, "ofv_random": ofv_rand, "gap": gap,
            "profile": split}


# ---------------------------------------------------------------------------
# phase 4: the path against its plain kernels
# ---------------------------------------------------------------------------

def against_plain(dev):
    n, d, k, chunk = 16384, PRESETS["diabetes"][1], 256, 4096
    x = torch.from_numpy(make("mixture", n, d, seed=1)).to(dev)
    kw = dict(k=k, chunk_size=chunk, solver="auction_fused", device=dev)
    res = anticluster(x, **kw)
    reset_counts()
    with ops.forced_path("ref"):
        plain = anticluster(x, **kw)
        inside = counts()
    check(inside["bid_top2"] == 0 and inside["gather_rows"] == 0,
          f"kernels launched under the forced plain path: {inside}")
    for r in (res, plain):
        check(balance_ok(r.labels.cpu(), k), "unbalanced")
    o_k = float(objective_centroid(x, res.labels, k))
    o_p = float(objective_centroid(x, plain.labels, k))
    check(abs(o_k - o_p) <= 1e-3 * o_p, f"objectives {o_k} vs {o_p}")
    agree = (res.labels == plain.labels).float().mean().item()
    log(f"n={n} k={k} chunk={chunk}: kernels vs plain ofv {o_k:.6e} vs "
        f"{o_p:.6e} (rel {abs(o_k - o_p) / o_p:.2e}); labels agree on "
        f"{agree:.4f} of rows; both balanced")
    return {"agree": agree, "rel": abs(o_k - o_p) / o_p}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=PRESETS["diabetes"][0],
                    help="rows of the main-path run, cut for development "
                         "runs only (default: diabetes, 253680)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("phase 1: environment")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)}")
    _build.build_all()
    log(f"kernel build {_build.build_seconds:.2f} s into {_build.BUILD_DIR}")
    for name, out in _build.build_log.items():
        for line in out.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")

    phase("phase 2: kernels against their plain versions")
    err = check_bid_top2(dev)
    rows = [measure_bid_top2(dev, err), check_and_measure_gather(dev)]
    for r in rows:
        log(f"{r['name']} {r['shape']}: kernel {r['ms']:.4f} ms (device "
            f"{r['device_ms']} ms), plain {r['plain_ms']:.4f} ms, library "
            f"{r['library_ms']:.4f} ms, bound {r['bound_ms']:.6f} ms "
            f"({r['bound_by']})")

    phase("phase 3: the main path")
    main_run = main_path(dev, args.n)
    phase("phase 4: the path against its plain kernels")
    plain_run = against_plain(dev)
    phase("done")

    for r in rows:
        r["launches"] = main_run["launches"][r["name"]]
    log(json.dumps({"main_path": main_run, "against_plain": plain_run}))
    log(smi)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
