"""The shard compiler's host loops in C++: a stable counting sort, CSR
offsets and edge coalescing (two counting sorts), each O(E + N), where
numpy's stable argsort is O(E log E) and its bincount O(E + N).

Counterpart of ``kgwas_tpu/native/`` (``_shardops.cpp``, ``shardops.py``),
written as plain C++ with a C interface (``shardops.cpp``) that is built
at first use with the host compiler (``ops/build.build_host``, into
``build/kernels/``) and loaded with ctypes. A failed build raises with the
compiler's output; nothing falls back to numpy quietly. The numpy versions
(``*_plain``) are the plain versions the tests hold these against; inside
``with plain():`` the functions here run them instead (a comparison run).

  * ``stable_order(keys, n_keys)``: ``np.argsort(keys, kind="stable")``
    (int64) for int32 or int64 keys in [0, n_keys), bit for bit
  * ``csr_offsets(keys, n_rows)``: int64 [n_rows + 1], the offsets of the
    rows of ascending keys (a bincount's cumsum)
  * ``coalesce(src, dst, num_dst)``: the (src, dst) pairs sorted by
    src * num_dst + dst with duplicates dropped (int64)
"""
from __future__ import annotations

import contextlib
import ctypes
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent / "shardops.cpp"

_lib = None
_plain = False

_P = ctypes.c_void_p
_I64 = ctypes.c_int64


def library():
    """The built library, loaded once (ops/build.build_host)."""
    global _lib
    if _lib is None:
        from ..ops.build import build_host

        lib = build_host(SOURCE, "shardops")
        for name in ("kgwas_stable_order_i32", "kgwas_stable_order_i64",
                     "kgwas_csr_offsets_i32", "kgwas_csr_offsets_i64"):
            fn = getattr(lib, name)
            fn.argtypes = [_P, _I64, _I64, _P]
            fn.restype = _I64
        lib.kgwas_coalesce.argtypes = [_P, _P, _I64, _I64, _I64, _P]
        lib.kgwas_coalesce.restype = _I64
        _lib = lib
    return _lib


@contextlib.contextmanager
def plain():
    """Inside: the functions of this module run their numpy versions."""
    global _plain
    was, _plain = _plain, True
    try:
        yield
    finally:
        _plain = was


def _keys(keys):
    keys = np.asarray(keys)
    if keys.ndim != 1 or keys.dtype.kind not in "iu":
        raise TypeError(f"keys must be 1-D integers, got {keys.dtype} "
                        f"{keys.shape}")
    if keys.dtype not in (np.int32, np.int64):
        keys = keys.astype(np.int64)
    keys = np.ascontiguousarray(keys)
    return keys, "i32" if keys.dtype == np.int32 else "i64"


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def _raise_out_of_range(rc, keys, bound, what):
    if rc < 0:
        i = -1 - rc
        raise ValueError(f"{what}: key {int(keys[i])} at {i} is outside "
                         f"[0, {bound})")


def stable_order_plain(keys, n_keys=None):
    return np.argsort(np.asarray(keys), kind="stable")


def stable_order(keys, n_keys=None):
    """np.argsort(keys, kind="stable") (int64) of integer keys in [0,
    n_keys) (by default the largest key + 1), by a counting sort."""
    if _plain:
        return stable_order_plain(keys, n_keys)
    keys, kind = _keys(keys)
    if n_keys is None:
        n_keys = int(keys.max()) + 1 if len(keys) else 0
    order = np.empty(len(keys), np.int64)
    rc = getattr(library(), f"kgwas_stable_order_{kind}")(
        _ptr(keys), len(keys), int(n_keys), _ptr(order))
    _raise_out_of_range(rc, keys, n_keys, "stable_order")
    return order


def csr_offsets_plain(keys, n_rows):
    counts = np.bincount(np.asarray(keys, dtype=np.int64), minlength=n_rows)
    if len(counts) > n_rows:
        raise ValueError("csr_offsets: a key exceeds n_rows")
    offsets = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    return offsets


def csr_offsets(keys, n_rows):
    """CSR offsets int64 [n_rows + 1]: offsets[r + 1] - offsets[r] keys
    equal r, for keys in [0, n_rows) (ascending, for a CSR)."""
    if _plain:
        return csr_offsets_plain(keys, n_rows)
    keys, kind = _keys(keys)
    offsets = np.empty(int(n_rows) + 1, np.int64)
    rc = getattr(library(), f"kgwas_csr_offsets_{kind}")(
        _ptr(keys), len(keys), int(n_rows), _ptr(offsets))
    _raise_out_of_range(rc, keys, n_rows, "csr_offsets")
    return offsets


def coalesce_plain(src, dst, num_dst):
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    key = src * int(num_dst) + dst
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    keep = np.ones(len(key_sorted), dtype=bool)
    keep[1:] = key_sorted[1:] != key_sorted[:-1]
    sel = order[keep]
    return src[sel], dst[sel]


def coalesce(src, dst, num_dst):
    """(src, dst) int64 sorted by src * num_dst + dst, each key's first
    edge kept, for src >= 0 and dst in [0, num_dst)."""
    if _plain:
        return coalesce_plain(src, dst, num_dst)
    src = np.ascontiguousarray(src, dtype=np.int64)
    dst = np.ascontiguousarray(dst, dtype=np.int64)
    if src.shape != dst.shape or src.ndim != 1:
        raise ValueError(f"src {src.shape} and dst {dst.shape} must be 1-D "
                         "and alike")
    num_src = int(src.max()) + 1 if len(src) else 0
    keep = np.empty(len(src), np.int64)
    n = library().kgwas_coalesce(_ptr(src), _ptr(dst), len(src), num_src,
                                 int(num_dst), _ptr(keep))
    if n < 0:
        i = -1 - n
        raise ValueError(f"coalesce: edge {i} ({int(src[i])}, {int(dst[i])})"
                         f" lies outside [0, {num_src}) x [0, {num_dst})")
    return src[keep[:n]], dst[keep[:n]]
