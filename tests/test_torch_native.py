"""The port's native shard ops (``kgwas_tpu_torch/native``) against their
numpy versions and the JAX package's.

  * ``stable_order`` is ``np.argsort(kind="stable")`` bit for bit on random
    keys, keys with many duplicates, all equal and none, held as int32
    and as int64; ``csr_offsets`` is numpy's bincount / cumsum;
    ``coalesce`` is the numpy coalesce and ``kgwas_tpu.native.shardops``'
  * ``compile_graph`` and ``build_merged_layouts`` (whole and split) give
    the arrays of the numpy path, bit for bit, and the JAX package's
  * a missing or failing host compiler raises (no quiet numpy route); a
    key outside its range raises
"""
import dataclasses

import numpy as np
import pytest

from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg
from kgwas_tpu.native import shardops as jax_shardops

from kgwas_tpu_torch.graph import (build_merged_layouts, compile_graph,
                                   make_synthetic_kg, transforms)
from kgwas_tpu_torch.native import shardops
from kgwas_tpu_torch.ops import build

KEYS = {
    "random": lambda rng: rng.integers(0, 5000, 200_000),
    "duplicates": lambda rng: rng.integers(0, 4, 10_000),
    "all equal": lambda rng: np.full(3_000, 7),
    "empty": lambda rng: np.zeros(0, np.int64),
}


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", list(KEYS))
def test_stable_order_is_numpy_stable_argsort(kind, dtype):
    keys = KEYS[kind](np.random.default_rng(0)).astype(dtype)
    got = shardops.stable_order(keys)
    want = np.argsort(keys, kind="stable")
    assert got.dtype == want.dtype and np.array_equal(got, want)
    n = int(keys.max()) + 1 if len(keys) else 0
    assert np.array_equal(shardops.stable_order(keys, n + 5), want)


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", list(KEYS))
def test_csr_offsets_are_numpys(kind, dtype):
    keys = np.sort(KEYS[kind](np.random.default_rng(1))).astype(dtype)
    n_rows = (int(keys.max()) + 1 if len(keys) else 0) + 3
    got = shardops.csr_offsets(keys, n_rows)
    want = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(keys.astype(np.int64), minlength=n_rows),
              out=want[1:])
    assert got.dtype == np.int64 and np.array_equal(got, want)
    assert np.array_equal(shardops.csr_offsets_plain(keys, n_rows), want)


@pytest.mark.parametrize("n_nodes", [300, 4])   # few or many duplicates
def test_coalesce_is_numpys_and_jax_packages(n_nodes):
    rng = np.random.default_rng(2)
    src, dst = (rng.integers(0, n_nodes, 20_000),
                rng.integers(0, 300, 20_000))
    got = shardops.coalesce(src, dst, 300)
    for want in (shardops.coalesce_plain(src, dst, 300),
                 jax_shardops.coalesce_edges(src, dst, 300)):
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    ei = np.stack([src, dst])
    with shardops.plain():
        plain = transforms.coalesce(ei, 300, 300)
    assert np.array_equal(transforms.coalesce(ei, 300, 300), plain)


def test_out_of_range_keys_raise():
    with pytest.raises(ValueError, match="outside"):
        shardops.stable_order(np.array([0, 3, 1]), 3)
    with pytest.raises(ValueError, match="outside"):
        shardops.stable_order(np.array([0, -1]), 3)
    with pytest.raises(ValueError, match="outside"):
        shardops.csr_offsets(np.array([0, 2]), 2)
    with pytest.raises(ValueError, match="outside"):
        shardops.coalesce(np.array([0, 1]), np.array([1, 3]), 3)
    with pytest.raises(ValueError, match="outside"):
        shardops.coalesce(np.array([0, -1]), np.array([1, 2]), 3)
    with pytest.raises(TypeError):
        shardops.stable_order(np.array([0.0, 1.0]))


def _arrays(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def _assert_same(a, b, what):
    assert a.keys() == b.keys(), what
    for k in a:
        x, y = a[k], b[k]
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), (what, k)
        else:
            assert x == y, (what, k)


KG = dict(n_snp=1100, n_gene=600, n_go=60, seed=7)


@pytest.mark.parametrize("split", [None, "Gene:10000,SNP:2500"])
def test_compile_and_layouts_bitwise_the_numpy_path(monkeypatch, split):
    if split is None:
        monkeypatch.delenv("KGWAS_MERGED_MAX_EDGES", raising=False)
    else:
        monkeypatch.setenv("KGWAS_MERGED_MAX_EDGES", split)
    g = make_synthetic_kg(**KG)
    runs = []
    for plain in (False, True):
        with shardops.plain() if plain else np.errstate():
            cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
            runs.append((cg, build_merged_layouts(cg, tile_rows=512)))
    (cg, layouts), (cg_p, layouts_p) = runs
    assert cg.relations.keys() == cg_p.relations.keys()
    for k in cg.relations:
        _assert_same(_arrays(cg.relations[k]), _arrays(cg_p.relations[k]), k)
    assert layouts.keys() == layouts_p.keys()
    for t in layouts:
        _assert_same(_arrays(layouts[t]), _arrays(layouts_p[t]), t)
    # and the JAX package's compile (its native extension, or its numpy
    # fallback)
    cg_j = jax_compile_graph(jax_make_kg(**KG), edge_pad_multiple=512,
                             node_pad_multiple=512)
    for k, r in cg.relations.items():
        j = cg_j.relations[k]
        for f in ("src", "dst", "row_offsets", "csc_perm", "csc_src_sorted",
                  "csc_offsets"):
            assert np.array_equal(getattr(r, f), getattr(j, f)), (k, f)


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("KGWAS_TORCH_BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(build, "HOST_CXX", str(tmp_path / "no-such-c++"))
    monkeypatch.setattr(shardops, "_lib", None)
    with pytest.raises(RuntimeError, match="not found"):
        shardops.stable_order(np.array([1, 0]))
    with pytest.raises(RuntimeError, match="not found"):
        compile_graph(make_synthetic_kg(n_snp=50, n_gene=10, n_go=5, seed=0))


def test_failing_build_raises_with_the_compilers_output(monkeypatch,
                                                        tmp_path):
    monkeypatch.setenv("KGWAS_TORCH_BUILD_DIR", str(tmp_path))
    bad = tmp_path / "bad.cpp"
    bad.write_text("extern \"C\" int f() { return undeclared_name; }\n")
    with pytest.raises(RuntimeError, match="undeclared_name"):
        build.build_host(bad, "bad")
    assert not list(tmp_path.glob("*.so"))
