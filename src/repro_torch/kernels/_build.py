"""Builds the CUDA sources in ``csrc/`` with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C function and becomes its own
shared library, ``build/kernels/<name>-<hash>.so`` under the checkout's
root (the ``build/`` directory is git-ignored).  The hash covers the source
and the compiler flags, so an edited source is rebuilt and a stale library
is never loaded.  All missing libraries are compiled at once, one nvcc
process per source, at first use; nothing is compiled at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

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
}

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
    src = (_CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


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


def function(name: str):
    """The ctypes function of kernel library ``name``, built on first use."""
    fn = _functions.get(name)
    if fn is None:
        path = library_path(name)
        if not path.exists():
            build_all()
        symbol, argtypes = _SYMBOLS[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _functions[name] = fn
    return fn
