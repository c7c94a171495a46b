"""Time variants of the Mamba scan's backward kernel in turns on one card.

    python3 tools/ssm_scan_bwd_variants.py [--shape B S DI DS] [--rounds 2]

Each variant is ``src/repro_torch/kernels/csrc/ssm_scan_bwd.cu`` with a few
lines replaced (the depth of a warp's input ring, the slots of warp sums,
the warps a CTA, the lanes a channel, exp(dt A) kept beside h or formed by
``expf``), built by nvcc with the port's flags in a temporary directory,
held to the plain walk (``ref.ssm_scan_bwd_ref``: each gradient within
1e-4 of its max |.|, a second launch bitwise the first) and timed by CUDA
events in turns, first to last, then last to first.  Prints the card, each
variant's registers and spills by instantiation, its scratch and times,
and one JSON line.  Needs a CUDA device and nvcc; the default shape is one
falcon-mamba-7b layer in training.
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

from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ref import ssm_scan_bwd_ref  # noqa: E402
from repro_torch.kernels.ssm_scan import ssm_scan_train  # noqa: E402

SOURCE = os.path.join(ROOT, "src", "repro_torch", "kernels", "csrc",
                      "ssm_scan_bwd.cu")
REL = 1e-4  # each gradient's error over its max |.|, as phase 2 holds it

_LAUNCH_44 = "    case 44: err = SSM_BWD_LAUNCH(4, 4); break;"
_PART_44 = "    case 44: n = part_floats<4, 4>(B, S, di); break;"
# name -> (text, replacement) pairs, each text present in the source
VARIANTS = {
    "as built": [],
    "ring of 3 tiles": [("constexpr int kStages = 2;",
                         "constexpr int kStages = 3;")],
    "3 slots of warp sums": [("constexpr int kSlots = 2;",
                              "constexpr int kSlots = 3;")],
    "4 warps a CTA": [("static constexpr int kWarps = warps_for(kWarpBytes);",
                       "static constexpr int kWarps = 4;")],
    "8 lanes a channel, 2 states a lane": [
        ("if (ds <= 16) return 44;", "if (ds <= 16) return 82;"),
        (_PART_44, _PART_44 + "\n    case 82: n = part_floats<8, 2>(B, S, di);"
                              " break;"),
        (_LAUNCH_44, _LAUNCH_44 + "\n    case 82: err = SSM_BWD_LAUNCH(8, 2);"
                                  " break;")],
    "exp kept beside h": [
        ("Shape<L, Q>::kMinCTAs)", "1)"),
        ("float hs[kSteps + 1][Q];", "float hs[kSteps + 1][Q], dec[kSteps][Q];"),
        ("fmaf(hs[tt][q], exp2_approx(dtv * a2[q]), dxv * bv[q]);",
         "fmaf(hs[tt][q], dec[tt][q] = exp2_approx(dtv * a2[q]), dxv * bv[q]);"),
        ("const float decay = exp2_approx(dtv * a2[q]);",
         "const float decay = dec[tt][q];")],
    "expf": [("exp2_approx(dtv * a2[q])", "expf(dtv * a2[q] * kLn2)")],
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
    """'(L, Q)' -> 'registers / spill stores' of each walk instantiation."""
    out, key = {}, None
    for line in ptxas.splitlines():
        m = re.search(r"ssm_scan_bwd_kernelILi(\d+)ELi(\d+)E", line)
        if "Compiling entry function" in line:
            key = f"({m.group(1)}, {m.group(2)})" if m else None
        m = re.search(r"(\d+) bytes spill stores", line)
        if key and m:
            out[key] = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if key and m:
            out[key] = f"{m.group(1)} / {out.get(key, '0')} B"
    return out


def load(lib: str):
    so = ctypes.CDLL(lib)
    fn, ws = so.ssm_scan_bwd_f32, so.ssm_scan_bwd_workspace_f32
    fn.argtypes = _build._SYMBOLS["ssm_scan_bwd"][1]
    ws.argtypes = _build._MORE_SYMBOLS["ssm_scan_bwd_workspace_f32"]
    fn.restype = ws.restype = ctypes.c_int

    def call(dt, b_in, c_out, x_in, a_mat, tiles, dy, dh):
        bsz, s, di = dt.shape
        ds = a_mat.shape[1]
        n = ctypes.c_int64()
        if ws(bsz, s, di, ds, ctypes.addressof(n)):
            raise RuntimeError("workspace query refused")
        work = torch.empty((n.value,), dtype=torch.float32, device=dt.device)
        outs = [torch.empty_like(t) for t in (dt, b_in, c_out, x_in)]
        da, dh0 = torch.empty_like(a_mat), torch.empty_like(dh)
        err = fn(*(t.data_ptr() for t in (dt, b_in, c_out, x_in, a_mat,
                                          tiles)), tiles.shape[1],
                 *(t.data_ptr() for t in (dy, dh, *outs, da, dh0, work)),
                 bsz, s, di, ds, di, s * di, ds, s * ds,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: cudaError {err}")
        return (*outs, da, dh0), 4 * n.value
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shape", type=int, nargs=4, default=(2, 4096, 8192, 16),
                    metavar=("B", "S", "DI", "DS"))
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("ssm_scan_bwd_variants: no CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card, flush=True)
    tmp = tempfile.mkdtemp(prefix="ssm_scan_bwd_variants_")
    try:
        procs = {}
        for i, (name, changes) in enumerate(VARIANTS.items()):
            cu, lib = (os.path.join(tmp, f"v{i}{ext}") for ext in (".cu", ".so"))
            with open(cu, "w") as f:
                f.write(variant_source(changes))
            procs[name] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, cu],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                lib)
        fns, regs = {}, {}
        for name, (proc, lib) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc exited {proc.returncode}\n{out}")
            fns[name], regs[name] = load(lib), registers(out)

        bsz, s, di, ds = args.shape
        gen = torch.Generator().manual_seed(16)
        dt = torch.rand((bsz, s, di), generator=gen) * 0.1
        b, c = (torch.randn((bsz, s, ds), generator=gen) for _ in range(2))
        x = torch.randn((bsz, s, di), generator=gen)
        a = -torch.rand((di, ds), generator=gen) * 4.0
        ins = [t.to(dev) for t in (dt, b, c, x, a)]
        dy = torch.randn((bsz, s, di), generator=gen).to(dev)
        dh = torch.randn((bsz, di, ds), generator=gen).to(dev)
        tiles = ssm_scan_train(*ins)[2]
        want = ssm_scan_bwd_ref(*ins, dy, dh)
        result = {}
        for name, fn in fns.items():
            got, scratch = fn(*ins, tiles, dy, dh)
            again, _ = fn(*ins, tiles, dy, dh)
            rel = max((g - w).abs().max().item() / w.abs().max().item()
                      for g, w in zip(got, want[:5]))
            if rel > REL or not all(torch.equal(g, h)
                                    for g, h in zip(got, again)):
                raise SystemExit(f"{name}: max rel err {rel}, or a second "
                                 f"launch differs")
            result[name] = {"registers / spill stores": regs[name],
                            "scratch_bytes": scratch, "max_rel_err": rel,
                            "ms": []}
        del want
        order = list(fns)
        for r in range(args.rounds):
            for name in (order if r % 2 == 0 else order[::-1]):
                result[name]["ms"].append(time_ms(
                    lambda: fns[name](*ins, tiles, dy, dh)))
        for name, row in result.items():
            print(f"{name}: {', '.join(f'{t:.4f}' for t in row['ms'])} ms; "
                  f"scratch {row['scratch_bytes']} B; max rel err "
                  f"{row['max_rel_err']:.3e}; registers / spill stores "
                  f"{row['registers / spill stores']}", flush=True)
        print(json.dumps({"card": card, "shape": list(args.shape),
                          "variants": result}))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
