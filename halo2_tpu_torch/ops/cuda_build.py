"""Build and load the port's CUDA kernels (csrc/*.cu).

Each source is compiled by `nvcc` for sm_90a into a shared library with
a plain C interface and loaded with ctypes (no PyTorch headers, so a build
takes seconds). Builds run at first use, one `nvcc` per source started
together, into the gitignored directory halo2_tpu_torch/_build/, keyed by
a hash of the sources so an edit rebuilds. Nothing here runs at import
time: the CPU tests import every module on a machine without `nvcc`.

Every C entry point returns `cudaGetLastError()` after its launch;
`check` raises on a non-zero code.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "_build")

# library name -> its .cu source; every source includes field.cuh
SOURCES = {
    "field_kernels": "field_kernels.cu",
    "point_kernels": "point_kernels.cu",
    "ntt_kernels": "ntt_kernels.cu",
}
_HEADERS = ("field.cuh",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_U32P = ctypes.POINTER(ctypes.c_uint32)
# C signatures (all return int = cudaError_t)
_ARGTYPES = {
    "field_kernels": {
        "h2t_fmul": [_I, _P, _P, _P, _LL, _LL, _LL, _P],
        "h2t_faddsub": [_I, _I, _P, _P, _P, _LL, _LL, _LL, _P],
        "h2t_fmul_limbs_first": [_I, _P, _P, _P, _LL, _P],
    },
    "ntt_kernels": {
        "h2t_ntt_pass": [_I, _P, _P, _P, _LL, _I, _I, _I, _I, _I, _P],
    },
    "point_kernels": {
        "h2t_padd_masked": [_I, _P, _P, _P, _P, _P, _P, _I, _LL, _LL, _LL,
                            _LL, _P],
        "h2t_pmixed_masked": [_I, _P, _P, _P, _P, _P, _LL, _P],
        "h2t_pmixed_bucket_runs": [_I, _P, _P, _P, _P, _P, _LL, _LL, _LL,
                                   _P],
        "h2t_padd": [_I, _P, _P, _P, _LL, _P],
        "h2t_pdouble": [_I, _P, _P, _LL, _P],
        "h2t_pdouble_masked": [_I, _P, _P, _P, _LL, _P],
        "h2t_glv_ladder": [_I, _P, _P, _P, _P, _U32P, _U32P, _I, _LL, _P],
        "h2t_scalar_mul_ladder": [_I, _P, _P, _P, _P, _P, _LL, _I, _LL, _P],
    },
}

_LIBS: dict = {}
BUILD_LOG: dict = {}   # name -> {"seconds": float, "ptxas": str}


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), "/usr/local/cuda/bin/nvcc",
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the GPU")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for f in (SOURCES[name],) + _HEADERS:
        with open(os.path.join(CSRC, f), "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def _so_path(name: str) -> str:
    return os.path.join(BUILD, f"{name}-{_digest(name)}.so")


def build_all(names=None) -> dict:
    """Compile every missing library in parallel (one nvcc each); return
    BUILD_LOG. Raises with the compiler output if any build fails."""
    names = list(SOURCES) if names is None else list(names)
    todo = [n for n in names if not os.path.exists(_so_path(n))]
    if not todo:
        return BUILD_LOG
    os.makedirs(BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    tmp = {n: f"{_so_path(n)}.{os.getpid()}.tmp" for n in todo}
    for n in todo:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               "-Xptxas", "-v", "-I", CSRC, "-o", tmp[n],
               os.path.join(CSRC, SOURCES[n])]
        procs[n] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
    failed = []
    for n, pr in procs.items():
        log, _ = pr.communicate()
        BUILD_LOG[n] = {"seconds": time.perf_counter() - t0, "ptxas": log}
        if pr.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {pr.returncode})\n{log}")
        else:
            os.replace(tmp[n], _so_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return BUILD_LOG


def library(name: str) -> ctypes.CDLL:
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(_so_path(name))
        for fn, argtypes in _ARGTYPES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {code}")
