"""Builds the CUDA sources in ``csrc/`` with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and becomes its own
shared library, ``build/kernels/<name>-<hash>.so`` under the checkout's
root (the ``build/`` directory is git-ignored).  The hash covers the source,
every header in ``csrc/`` and the compiler flags, so an edited source or
header is rebuilt and a stale library is never loaded.  All missing
libraries are compiled at once, one nvcc process per source, at first use;
nothing is compiled at import time.

:func:`launch` calls a kernel's C function, raises on a launch error and
counts the launch in :data:`launches`, the one place the port counts
kernel launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
# source name -> (C symbol, argument types); every function returns a
# cudaError_t as int
_SYMBOLS = {
    "bid_top2": ("bid_top2_f32", (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)),
    "gather_rows": ("gather_rows_f32", (_P, _P, _I, _P, _L, _L, _L, _P)),
    "bid_top2_gather": ("bid_top2_gather_f32",
                        (_P, _P, _I, _P, _P, _P, _P, _P, _L, _I, _I, _I, _P)),
    "cdist": ("cdist_f32", (_P, _P, _P, _L, _I, _I, _P)),
    "cdist_gather": ("cdist_gather_f32", (_P, _P, _I, _P, _P, _L, _L, _I, _I,
                                          _P)),
    "ssm_scan": ("ssm_scan_f32", (_P,) * 9 + (_I,) * 5 + (_L,) * 4 + (_P,)),
    "ssm_scan_bwd": ("ssm_scan_bwd_f32", (_P,) * 6 + (_I,) + (_P,) * 9
                     + (_I,) * 4 + (_L,) * 4 + (_P,)),
    "auction_phase": ("auction_phase_f32",
                      (_P,) * 14 + (_I, _I, _I, _I, _I, _P)),
    "auction_phase_dense": ("auction_phase_dense_f32",
                            (_P,) * 12 + (_I,) * 5 + (_P,)),
}
# further C functions of a source's library: symbol -> argument types.  The
# span's pair counts as a launch of "bid_top2"; the phase kernels' timed
# instantiations are for measurement only and count as launches of
# "auction_phase" / "auction_phase_dense", as the gather-bid kernel's timed
# instantiation and its previous design count as launches of
# "bid_top2_gather".  The backward scan's workspace query launches nothing;
# its kernel function launches two grids (the walk and the sums over channel
# blocks), one launch of "ssm_scan_bwd".
_MORE_SYMBOLS = {
    "ssm_scan_bwd_workspace_f32": (_I, _I, _I, _I, _P),
    "bid_top2_span_f32": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "bid_top2_gather_prev_f32": _SYMBOLS["bid_top2_gather"][1],
    "bid_top2_gather_timed_f32": _SYMBOLS["bid_top2_gather"][1][:-1]
    + (_P, _P, _P),
    "auction_phase_timed_f32": (_P,) * 14 + (_I,) * 5 + (_P, _I, _I, _P),
    "auction_phase_dense_timed_f32": (_P,) * 12 + (_I,) * 5 + (_P, _I, _I,
                                                               _P),
}

# kernel name -> launches since the count was last zeroed; every wrapper
# counts here through launch(), and nowhere else, under _count_lock: an
# engine's worker thread launches beside its caller's thread
launches = dict.fromkeys(_SYMBOLS, 0)
_count_lock = threading.Lock()

_functions: dict = {}
build_log: dict = {}      # name -> nvcc's output (ptxas registers / spills)
build_seconds: float | None = None  # wall time of the last build_all()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def library_path(name: str) -> Path:
    """Where source ``name``'s library lives, keyed by a hash of the source,
    of every header in ``csrc/`` (a source may include any of them) and of
    the compiler flags."""
    h = hashlib.sha256((_CSRC / f"{name}.cu").read_bytes())
    for header in sorted(_CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every missing library, one nvcc per source, all at once.

    Returns ``{name: path}``.  Raises with nvcc's output if a build fails.
    """
    global build_seconds
    paths = {name: library_path(name) for name in _SYMBOLS}
    todo = {name: p for name, p in paths.items() if not p.exists()}
    t0 = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, path in todo.items():
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp)
        failed = []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            build_log[name] = out
            if proc.returncode:
                failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
            else:
                os.replace(tmp, todo[name])  # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    build_seconds = time.perf_counter() - t0
    return paths


def function(name: str, symbol: str | None = None):
    """The ctypes function ``symbol`` (by default the kernel's own) of
    kernel library ``name``, built on first use."""
    main, argtypes = _SYMBOLS[name]
    symbol = symbol or main
    fn = _functions.get(symbol)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes if symbol == main else _MORE_SYMBOLS[symbol]
        fn.restype = ctypes.c_int
        _functions[symbol] = fn
    return fn


def launch(name: str, *args, symbol: str | None = None) -> None:
    """Launch kernel ``name`` with its C arguments (through ``symbol``, by
    default the kernel's own entry); raise if the launch failed, else count
    it."""
    err = function(name, symbol)(*args)
    if err:
        raise RuntimeError(f"{name} kernel launch failed (cudaError {err})")
    with _count_lock:
        launches[name] += 1


# operand name -> the types a kernel takes for it (float32 where not named)
_FLOAT32 = (torch.float32,)
_OPERAND_TYPES = {"idx": (torch.int32, torch.int64), "j1": (torch.int64,),
                  "is_real": (torch.bool,), "skip": (torch.bool,)}


def check_operands(kernel: str, **tensors) -> int:
    """Raise ValueError unless every tensor is contiguous, on the current
    CUDA device and of its type (float32, or as ``_OPERAND_TYPES`` names
    it); return the current stream's handle.  One pass, reading the current
    device once: this runs on every launch."""
    current = torch.cuda.current_device()
    for name, t in tensors.items():
        types = _OPERAND_TYPES.get(name, _FLOAT32)
        if t.dtype not in types or not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous "
                             f"{' or '.join(map(str, types))}, got {t.dtype}")
        if t.get_device() != current:
            raise ValueError(f"{kernel}: {name} is on {t.device}, but the "
                             f"current device is cuda:{current}")
    return torch._C._cuda_getCurrentRawStream(current)
