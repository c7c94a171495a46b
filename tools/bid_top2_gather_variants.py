"""Time variants of the fused gather-bid kernel in turns on one card.

    python3 tools/bid_top2_gather_variants.py [--rounds 2]

Each variant is ``src/repro_torch/kernels/csrc/bid_top2_gather.cu`` with a
few lines replaced (one CTA an SM, ``bid::push`` in place of
``push_selp``, the feature loop unrolled 4, the ring slots unpadded, c
copied by the threads in place of the TMA), built by nvcc with the port's
flags in a temporary directory, held bitwise
to the kernel as built and to ``bid_top2`` of ``gather_rows`` on the
streaming chunk's rows (the diabetes shape, k = 256), and timed in turns,
first to last then last to first, by CUDA events (median of 30) and by the
profiler's device time, at m = 8192 and 65 536 int64 indices.  Also prints
each variant's stage cycles (median over CTAs, from its timed
instantiation), its registers, the card, and one JSON line.  Needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402

from repro_torch.data.synthetic import PRESETS, make  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bid_top2 import bid_top2  # noqa: E402
from repro_torch.kernels.gather import STAGES, gather_rows  # noqa: E402

SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "bid_top2_gather.cu")
SHAPES = (8192, 65536)  # indices: the streaming chunk's, and 8 tiles a CTA
KERNEL = "bid_top2_gather_kernel"  # its name in the profiler

# name -> (text, replacement) pairs, each text present in the source
VARIANTS = {
    "as built": [],
    "one CTA an SM": [("int64_t held = static_cast<int64_t>(blocks) * sms;",
                       "int64_t held = sms;")],
    "bid::push (a branch a row)": [("bid::push_selp(best[r]",
                                    "bid::push(best[r]")],
    "feature loop unrolled 4": [("#pragma unroll 2\n  for (int fp = 0;",
                                 "#pragma unroll 4\n  for (int fp = 0;")],
    "ring slots unpadded": [("P.ldx = kRows * GW + 4;",
                             "P.ldx = kRows * GW;")],
    "c by the threads, not the TMA": [("P.tma = ldc == P.d &&",
                                       "P.tma = false && ldc == P.d &&")],
}


def variant_source(changes) -> str:
    with open(SOURCE) as f:
        src = f.read()
    for old, new in changes:
        if old not in src:
            raise SystemExit(f"variant text not in {SOURCE}: {old!r}")
        src = src.replace(old, new)
    return src


def registers(ptxas: str) -> dict:
    """'<GW, index type>' -> registers of each untimed instantiation."""
    out, key = {}, None
    for line in ptxas.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"bid_top2_gather_kernelILi(\d)E(\w)Lb0E", line)
            key = f"<{m.group(1)}, {'int64' if m.group(2) == 'l' else 'int32'}>" \
                if m else None
        m = re.search(r"Used (\d+) registers", line)
        if key and m:
            out[key] = int(m.group(1))
            key = None
    return out


def load(lib: str):
    so = ctypes.CDLL(lib)
    fn, timed = so.bid_top2_gather_f32, so.bid_top2_gather_timed_f32
    fn.argtypes = _build._SYMBOLS["bid_top2_gather"][1]
    timed.argtypes = _build._MORE_SYMBOLS["bid_top2_gather_timed_f32"]
    fn.restype = timed.restype = ctypes.c_int

    def call(x, idx, c, p, stamps=None):
        m = idx.shape[0]
        v1 = torch.empty((m,), dtype=torch.float32, device=x.device)
        j1 = torch.empty((m,), dtype=torch.int64, device=x.device)
        v2 = torch.empty((m,), dtype=torch.float32, device=x.device)
        args = (x.data_ptr(), idx.data_ptr(), idx.dtype == torch.int64,
                c.data_ptr(), p.data_ptr(), v1.data_ptr(), j1.data_ptr(),
                v2.data_ptr(), x.shape[0], m, c.shape[0], x.shape[1])
        stream = torch.cuda.current_stream().cuda_stream
        if stamps is None:
            err = fn(*args, stream)
            grid = None
        else:
            g = ctypes.c_int(0)
            err = timed(*args, stamps.data_ptr(), ctypes.addressof(g), stream)
            grid = g.value
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return (v1, j1, v2), grid
    return call


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


def device_ms(fn, reps: int = 20) -> float | None:
    """Mean device time of one launch of the kernel, from the profiler: the
    recorded time over the launches recorded (a run may drop events)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # one profiled run sometimes records nothing
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages() if KERNEL in e.key]
        n = sum(e.count for e in hits)
        if n:
            return sum(float(getattr(e, "self_device_time_total", 0.0))
                       for e in hits) / n / 1e3
    return None


def stage_medians(call, x, idx, c, p) -> dict:
    stamps = torch.zeros((-(-idx.shape[0] // 32), len(STAGES)),
                         dtype=torch.int64, device=x.device)
    for _ in range(3):  # warm
        _, grid = call(x, idx, c, p, stamps)
    torch.cuda.synchronize()
    med = stamps[:grid].double().median(dim=0).values
    return {"ctas": grid,
            **{name: float(v) for name, v in zip(STAGES, med)}}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("bid_top2_gather_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="bid_top2_gather_variants_")
    try:
        procs = {}
        for i, (name, changes) in enumerate(VARIANTS.items()):
            cu, lib = (os.path.join(tmp, f"v{i}{ext}") for ext in (".cu", ".so"))
            with open(cu, "w") as f:
                f.write(variant_source(changes))
            procs[name] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build._CSRC),
                 "-o", lib, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                lib)
        fns, regs = {}, {}
        for name, (proc, lib) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n{out}")
            fns[name], regs[name] = load(lib), registers(out)

        n, d, _ = PRESETS["diabetes"]
        gen = torch.Generator().manual_seed(5)
        x = torch.from_numpy(make("mixture", n, d, seed=0)).to(dev)
        c = x[torch.randperm(n, generator=gen)[:256].to(dev)].contiguous()
        p = torch.rand((256,), generator=gen).to(dev)
        result = {name: {"registers": regs[name]} for name in fns}
        for m in SHAPES:
            idx = torch.randperm(n, generator=gen)[:m].to(dev)
            want = bid_top2(gather_rows(x, idx), c, p)
            for name, call in fns.items():
                got, _ = call(x, idx, c, p)
                again, _ = call(x, idx, c, p)
                if not all(torch.equal(g, w) and torch.equal(a, g)
                           for g, w, a in zip(got, want, again)):
                    raise SystemExit(f"{name} at m={m}: not bitwise "
                                     f"bid_top2(gather_rows), or a second "
                                     f"launch differs")
                result[name][m] = {"ms": [], "device_ms": [],
                                   "stages": stage_medians(call, x, idx, c,
                                                           p)}
            order = list(fns)
            for r in range(args.rounds):
                for name in (order if r % 2 == 0 else order[::-1]):
                    fn = (lambda call=fns[name]: call(x, idx, c, p))
                    result[name][m]["ms"].append(time_ms(fn))
                    result[name][m]["device_ms"].append(device_ms(fn))
        for name, row in result.items():
            print(f"{name} (registers {row['registers']}):", flush=True)
            for m in SHAPES:
                r = row[m]
                st = ", ".join(f"{k} {v:.0f}" for k, v in r["stages"].items())
                print(f"  m={m}: event ms {', '.join(f'{t:.4f}' for t in r['ms'])}"
                      f"; device ms {r['device_ms']}; stage cycles (median "
                      f"over CTAs) {st}", flush=True)
        print(json.dumps({"card": card, "shape": {"n": n, "d": d, "k": 256},
                          "variants": result}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
