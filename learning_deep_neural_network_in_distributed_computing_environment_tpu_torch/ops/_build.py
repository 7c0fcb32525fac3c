"""Build and load the hand-written CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds).  Libraries land in ``build/kernels/``
beside the package, named by a hash of their sources and flags, so an
edited source is rebuilt and an unchanged one is reused.  All missing
libraries are compiled in parallel, one ``nvcc`` process per source.

Nothing here runs at import: the first kernel launch (or an explicit
``build_all()``) triggers the build.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# library name -> its source; every library also depends on the headers
SOURCES = {"flash_fwd": "flash_fwd.cu", "flash_bwd": "flash_bwd.cu",
           "flash_bwd_fused": "flash_bwd_fused.cu"}

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_STRIDES = [_LL] * 9
# C signatures (csrc/*.cu): pointers, dtype code, B, H, KV, Lq, Lk, D,
# strides, causal, scale, stream
SIGNATURES = {
    "flash_fwd": ("flash_fwd", [_P] * 5 + [_I] * 7 + _STRIDES + [_I, _F, _P]),
    "flash_bwd_dq": ("flash_bwd", [_P] * 7 + [_I] * 7 + _STRIDES + [_LL] * 3
                     + [_I, _F, _P]),
    "flash_bwd_dkv": ("flash_bwd", [_P] * 8 + [_I] * 7 + _STRIDES + [_LL] * 3
                      + [_I, _F, _P]),
    "flash_bwd_fused": ("flash_bwd_fused", [_P] * 9 + [_I] * 7 + _STRIDES
                        + [_LL] * 3 + [_I, _F, _P]),
}

_loaded: dict[str, ctypes.CDLL] = {}
_functions: dict[str, ctypes._CFuncPtr] = {}
_build_logs: dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built from the "
                       "sources in csrc/ at first use and need the CUDA "
                       "toolkit (PATH or /usr/local/cuda/bin)")


def _library_path(name: str) -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / SOURCES[name]]:
        digest.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every library that is not built yet, all in parallel; return
    each freshly built library's compiler output (``-Xptxas -v``: registers,
    shared memory and spills per kernel).  Raises on a failed build."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _library_path(n) for n in SOURCES}
    todo = {n: p for n, p in todo.items() if not p.exists()}
    procs = {}
    for name, out in todo.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        _build_logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {n: _build_logs[n] for n in procs}


def function(symbol: str):
    """The C entry point ``symbol`` with its argument types declared,
    building and loading its library on first use."""
    fn = _functions.get(symbol)
    if fn is not None:
        return fn
    lib_name, argtypes = SIGNATURES[symbol]
    if lib_name not in _loaded:
        path = _library_path(lib_name)
        if not path.exists():
            build_all()
        _loaded[lib_name] = ctypes.CDLL(str(path))
    fn = getattr(_loaded[lib_name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _functions[symbol] = fn
    return fn
