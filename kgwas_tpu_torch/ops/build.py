"""Builds the port's CUDA kernels with nvcc and loads them with ctypes.

Each source under ``ops/csrc/`` is compiled on first use into its own
shared library with a plain C interface, named by a content hash of the
source, the shared headers (``*.cuh``) and the flags, under
``build/kernels/`` at the repository root (or ``$KGWAS_TORCH_BUILD_DIR``).
A library whose hash is already there is reused. ``build_all`` starts one
nvcc per source, all at once. A source may export several entry points
(the f32 and bf16 instances of a kernel): each is a name of ``KERNELS``,
and the names of one source share its library and its build.

``build_host`` builds a host C++ source with a C interface (``native/``)
the same way, with the host compiler (``$CXX``, else ``c++``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

from ..engine.profiling import span

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
        [_P] * 9 + [_I64, _P, _P, _I64, _P, _P, _P, _I64, _I32, _I32, _I32,
                    _F32, _F32, _P],
    ),
    "merged_gat_bwd": (
        "merged_gat_bwd.cu",
        "kgwas_merged_gat_bwd",
        [_P] * 12 + [_I64, _P, _P, _I64, _P, _I64, _I32, _I32, _I32, _F32,
                     _F32, _P],
    ),
    "csc_segment_sum": (
        "csc_segment_sum.cu",
        "kgwas_csc_segment_sum",
        [_P] * 9 + [_I64, _P, _P, _I64, _P, _P, ctypes.POINTER(_I64),
                    ctypes.POINTER(_I64), _P, _P, _P, _P, _I32, _I32, _P],
    ),
    "csr_segment_sum": (
        "csr_segment_sum.cu",
        "kgwas_csr_segment_sum",
        [_P] * 6 + [_I64, _P, _P, _I64, _P, _I64, _I32, _P],
    ),
    "segment_softmax_spmm_fwd": (
        "segment_softmax_spmm_fwd.cu",
        "kgwas_segment_softmax_spmm_fwd",
        [_P] * 9 + [_I64, _P, _P, _I64, _P, _P, _P, _I64, _I32, _P],
    ),
    "segment_softmax_spmm_bwd": (
        "segment_softmax_spmm_bwd.cu",
        "kgwas_segment_softmax_spmm_bwd",
        [_P] * 12 + [_I64, _I64, _I32, _P],
    ),
    # the bf16 instances (bf16 value tables), in the same sources
    # (the merged GAT kernels' bf16 instances take the per-source-row
    # scores a_src after a_dst, from the score pass merged_gat_a_src_bf16)
    "merged_gat_fwd_bf16": (
        "merged_gat_fwd.cu",
        "kgwas_merged_gat_fwd_bf16",
        [_P] * 10 + [_I64, _P, _P, _I64, _P, _P, _P, _I64, _I32, _I32, _I32,
                     _F32, _F32, _P],
    ),
    "merged_gat_a_src_bf16": (
        "merged_gat_fwd.cu",
        "kgwas_merged_gat_a_src_bf16",
        [_P, _P, _P, ctypes.POINTER(_I64), _I32, _I32, _P],
    ),
    "merged_gat_bwd_bf16": (
        "merged_gat_bwd.cu",
        "kgwas_merged_gat_bwd_bf16",
        [_P] * 13 + [_I64, _P, _P, _I64, _P, _I64, _I32, _I32, _I32, _F32,
                     _F32, _P],
    ),
    "csc_segment_sum_bf16": (
        "csc_segment_sum.cu",
        "kgwas_csc_segment_sum_bf16",
        [_P] * 9 + [_I64, _P, _P, _I64, _P, _P, ctypes.POINTER(_I64),
                    ctypes.POINTER(_I64), _P, _P, _P, _P, _I32, _I32, _P],
    ),
    "csr_segment_sum_bf16": (
        "csr_segment_sum.cu",
        "kgwas_csr_segment_sum_bf16",
        [_P] * 6 + [_I64, _P, _P, _I64, _P, _I64, _I32, _I32, _I32, _P],
    ),
    "segment_softmax_spmm_fwd_bf16": (
        "segment_softmax_spmm_fwd.cu",
        "kgwas_segment_softmax_spmm_fwd_bf16",
        [_P] * 9 + [_I64, _P, _P, _I64, _P, _P, _P, _I64, _I32, _I32, _I32,
                    _P],
    ),
    "segment_softmax_spmm_bwd_bf16": (
        "segment_softmax_spmm_bwd.cu",
        "kgwas_segment_softmax_spmm_bwd_bf16",
        [_P] * 12 + [_I64, _I64, _I32, _I32, _I32, _P],
    ),
    # a measuring tool on no path of the package (chip_smoke.py)
    "gather_probe": (
        "gather_probe.cu",
        "kgwas_gather_probe",
        [_P, _P, _I64, _I64, _P, _I32, _P],
    ),
    "gather_probe_bf16": (
        "gather_probe.cu",
        "kgwas_gather_probe_bf16",
        [_P, _P, _I64, _I64, _P, _I32, _P],
    ),
}

_loaded: dict = {}
build_log: dict = {}   # kernel name -> {"seconds": s, "ptxas": text}


def _log_build(name, out, seconds, text):
    """Records a build's ptxas output, and keeps it beside the library for
    a later process that finds the library built (seconds 0)."""
    if text is None:
        ptxas = out.with_suffix(".ptxas.txt")
        text = ptxas.read_text() if ptxas.exists() else ""
    else:
        out.with_suffix(".ptxas.txt").write_text(text)
    build_log[name] = {"seconds": seconds, "ptxas": text}


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


def _primary(name: str) -> str:
    """The first name of KERNELS whose entry point lives in name's source:
    the name its library and build log go by."""
    source = KERNELS[name][0]
    return next(k for k, v in KERNELS.items() if v[0] == source)


def _lib_path(name: str) -> Path:
    name = _primary(name)
    source = KERNELS[name][0]
    h = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):   # included by the sources
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=None) -> dict:
    """Compile every kernel not yet built, one nvcc per source started
    together. Returns {name: seconds} for the sources compiled now, by
    their primary name."""
    names = list(KERNELS) if names is None else list(names)
    names = list(dict.fromkeys(_primary(n) for n in names))
    build_dir().mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            _log_build(name, out, 0.0, None)
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
        _log_build(name, out, done[name], text)
    return done


def library(name: str):
    """The loaded ctypes entry point of one kernel, built if needed."""
    fn = _loaded.get(name)
    if fn is None:
        with span("kgwas.ops.load"):
            build_all([name])
            fn = _entry(_lib_path(name), KERNELS[name][1], KERNELS[name][2])
        _loaded[name] = fn
    return fn


def _entry(lib_path, entry, argtypes):
    fn = getattr(ctypes.CDLL(str(lib_path)), entry)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def build_source(source, name, entry, argtypes):
    """The ctypes entry point of any CUDA source (another checkout's kernel,
    for a comparison), built with the same flags under its own name and a
    hash of its directory's sources; its ptxas output goes to build_log."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    out = build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        _log_build(name, out, 0.0, None)
    else:
        t0 = time.perf_counter()
        text = _compile_once([_nvcc(), *NVCC_FLAGS], source, out)
        _log_build(name, out, time.perf_counter() - t0, text)
    return _entry(out, entry, argtypes)


def _compile_once(cmd, source, out) -> str:
    """Runs cmd + [-o tmp, source] and renames tmp to out (so that
    processes building the same library at once each finish with a whole
    one); raises with the compiler's output where it fails, else returns
    that output."""
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([*cmd, "-o", str(tmp), str(source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed for {source}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return proc.stdout + proc.stderr


# the host compiler of the port's C++ sources (native/) and its flags
HOST_CXX = os.environ.get("CXX", "c++")
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def build_host(source, name) -> ctypes.CDLL:
    """The loaded library of a host C++ source with a C interface, compiled
    with HOST_CXX into build_dir() under a hash of the source and the
    flags (reused where it is there). Raises where the compiler is missing
    or fails, with its output: there is no other route."""
    source = Path(source)
    h = hashlib.sha256(source.read_bytes())
    h.update(" ".join((HOST_CXX,) + HOST_FLAGS).encode())
    out = build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"
    if not out.exists():
        cxx = shutil.which(HOST_CXX)
        if cxx is None:
            raise RuntimeError(f"host C++ compiler {HOST_CXX!r} not found "
                               f"(set CXX) to build {source}")
        _compile_once([cxx, *HOST_FLAGS], source, out)
    return ctypes.CDLL(str(out))


def ptxas_entries(text: str):
    """[(kernel, registers, static shared bytes, local bytes: stack frame
    and spills)] of each entry function in nvcc -Xptxas -v output, names
    demangled where c++filt is on the PATH."""
    rows, name, spill = [], None, 0
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spill = sum(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            rows.append([name, int(m.group(1)),
                         int(smem.group(1)) if smem else 0, spill])
            name = None
    demangle = shutil.which("c++filt")
    if demangle and rows:
        out = subprocess.run([demangle], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True).stdout
        for r, nice in zip(rows, out.splitlines()):
            r[0] = nice.replace("(anonymous namespace)::", "").split("(")[0]
    return [tuple(r) for r in rows]
