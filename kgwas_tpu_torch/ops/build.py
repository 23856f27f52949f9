"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source under ``ops/csrc/`` is compiled on first use into its own
shared library with a plain C interface, named by a content hash of the
source, the shared headers (``*.cuh``) and the flags, under
``build/kernels/`` at the repository root (or ``$KGWAS_TORCH_BUILD_DIR``).
A library whose hash is already there is reused. ``build_all`` starts one
nvcc per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float

# kernel name -> (source, C entry point, argtypes)
KERNELS = {
    "merged_gat_fwd": (
        "merged_gat_fwd.cu",
        "kgwas_merged_gat_fwd",
        [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I32, _I32, _I32, _F32,
         _F32, _P],
    ),
    "merged_gat_bwd": (
        "merged_gat_bwd.cu",
        "kgwas_merged_gat_bwd",
        [_P] * 11 + [_I64, _I64, _I32, _I32, _I32, _F32, _F32, _P],
    ),
    "csc_segment_sum": (
        "csc_segment_sum.cu",
        "kgwas_csc_segment_sum",
        [_P] * 8 + [ctypes.POINTER(_I64)] + [_P] * 3
        + [_I32, _I64, _I32, _I32, _P],
    ),
    "csr_segment_sum": (
        "csr_segment_sum.cu",
        "kgwas_csr_segment_sum",
        [_P] * 5 + [_I64, _I32, _P],
    ),
    "segment_softmax_spmm_fwd": (
        "segment_softmax_spmm_fwd.cu",
        "kgwas_segment_softmax_spmm_fwd",
        [_P] * 7 + [_I64, _I32, _P],
    ),
    "segment_softmax_spmm_bwd": (
        "segment_softmax_spmm_bwd.cu",
        "kgwas_segment_softmax_spmm_bwd",
        [_P] * 10 + [_I64, _I32, _P],
    ),
}

_loaded: dict = {}
build_log: dict = {}   # kernel name -> {"seconds": s, "ptxas": text}


def build_dir() -> Path:
    env = os.environ.get("KGWAS_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return Path(__file__).resolve().parents[2] / "build" / "kernels"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME)")
    return found


def _lib_path(name: str) -> Path:
    source = KERNELS[name][0]
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # included by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every kernel not yet built, one nvcc per source started
    together. Returns {name: seconds} for the ones compiled now."""
    names = list(KERNELS) if names is None else list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC / KERNELS[name][0])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    done = {}
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{text}")
        os.replace(tmp, out)
        done[name] = time.perf_counter() - t0
        build_log[name] = {"seconds": done[name], "ptxas": text}
    return done


def library(name: str):
    """The loaded ctypes entry point of one kernel, built if needed."""
    fn = _loaded.get(name)
    if fn is None:
        build_all([name])
        lib = ctypes.CDLL(str(_lib_path(name)))
        fn = getattr(lib, KERNELS[name][1])
        fn.argtypes = KERNELS[name][2]
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn
