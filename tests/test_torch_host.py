"""The port's host path (numpy only) against the JAX package's.

Graph build, shard compile and merged layouts must give equal arrays; the
GWAS processing must give the same labels and LDSC weights; the numpy
``finalize_predictions`` must give the pandas version's P_weighted,
KGWAS_P and scale factor (atol 1e-12), including all-zero and heavily tied
predictions, which collapse the quantile bins.
"""
import numpy as np
import pandas as pd
import pytest

from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg
from kgwas_tpu.graph.merged_layout import build_merged_layouts as jax_build
from kgwas_tpu.stats import calibration as jax_cal

from kgwas_tpu_torch import KGWAS_Data
from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.stats import calibration
from kgwas_tpu_torch.utils import read_table, write_table
from torch_threads import few_torch_threads  # noqa: F401,E402

KG = dict(n_snp=700, n_gene=90, n_go=45, snp_dim=20, gene_dim=24, go_dim=12,
          avg_degree=5)


@pytest.mark.parametrize("seed", [0, 11])
def test_graph_compile_layouts_equal_jax(seed):
    g, gj = make_synthetic_kg(seed=seed, **KG), jax_make_kg(seed=seed, **KG)
    assert list(g.edge_index) == list(gj.edge_index)
    for t in gj.node_features:
        assert np.array_equal(g.node_features[t], gj.node_features[t]), t
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    cgj = jax_compile_graph(gj, edge_pad_multiple=512, node_pad_multiple=512)
    assert cg.padded_nodes == cgj.padded_nodes
    for t in cgj.node_x:
        assert np.array_equal(cg.node_x[t], cgj.node_x[t]), t
    for k, rj in cgj.relations.items():
        r = cg.relations[k]
        for f in ("src", "dst", "row_offsets", "csc_perm", "csc_src_sorted",
                  "csc_offsets"):
            a, b = getattr(r, f), getattr(rj, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (k, f)
    lay = build_merged_layouts(cg, tile_rows=512)
    layj = jax_build(cgj, tile_rows=512)
    assert list(lay) == list(layj)
    for t, Lj in layj.items():
        L = lay[t]
        assert L.rel_keys == Lj.rel_keys and L.src_types == Lj.src_types
        assert (L.n_rows_per_rel, L.n_rows_total, L.num_edges,
                L.n_src_total) == (Lj.n_rows_per_rel, Lj.n_rows_total,
                                   Lj.num_edges, Lj.n_src_total)
        for f in ("src", "dst", "row_offsets", "tile2rel", "src_base",
                  "csc_perm", "csc_ids", "csc_offsets", "edge_base"):
            a, b = getattr(L, f), getattr(Lj, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (t, f)


def test_layout_rejects_unaligned_padding():
    cg = compile_graph(make_synthetic_kg(seed=0, **KG), node_pad_multiple=256)
    with pytest.raises(ValueError, match="tile_rows"):
        build_merged_layouts(cg, tile_rows=512)


def test_process_gwas_file_equals_jax(tmp_path):
    kw = dict(n_snp=400, n_gene=50, n_go=20, seed=5)
    d = KGWAS_Data.from_synthetic(data_path=str(tmp_path / "p"), **kw)
    dj = JaxData.from_synthetic(data_path=str(tmp_path / "j"), **kw)
    for x in (d, dj):
        x.load_synthetic_gwas(seed=5)
        x.process_gwas_file()
    assert list(d.lr_uni) == list(dj.lr_uni.columns)
    for c in dj.lr_uni.columns:
        a, b = d.lr_uni[c], dj.lr_uni[c].values
        assert np.array_equal(a, b), c
    assert np.array_equal(d.y, dj.y)
    assert np.array_equal(d.all_ids, dj.all_ids)
    ids = dj.lr_uni.ID.values
    assert np.array_equal([d.rs_id_to_ldsc_weight[i] for i in ids],
                          [dj.rs_id_to_ldsc_weight[i] for i in ids])


def _preds(seed, kind, n=4000):
    rng = np.random.default_rng(seed)
    if kind == "zero":          # a dead ReLU head
        return np.zeros((n, 1), np.float32)
    if kind == "ties":          # a handful of distinct values
        return (rng.integers(0, 4, size=(n, 1)) * 0.5).astype(np.float32)
    if kind == "half_dead":
        return np.maximum(rng.standard_normal((n, 1)), 0).astype(np.float32)
    return rng.standard_normal((n, 1)).astype(np.float32)


@pytest.mark.parametrize("kind", ["normal", "zero", "ties", "half_dead"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_finalize_predictions_equals_pandas(seed, kind):
    n = 4000
    rng = np.random.default_rng(100 + seed)
    z = rng.standard_normal(n)
    z[: n // 20] += 4 * rng.standard_normal(n // 20)
    from scipy.stats import norm

    p = np.clip(2 * norm.sf(np.abs(z)), 1e-300, 1)
    pred = _preds(seed, kind, n)
    ref, ref_scale = jax_cal.finalize_predictions(
        pd.DataFrame({"ID": np.arange(n), "P": p}), pred)
    got, scale = calibration.finalize_predictions(
        {"ID": np.arange(n), "P": p.copy()}, pred)
    assert list(got) == list(ref.columns)
    assert scale == ref_scale
    for c in ("pred", "P_weighted", "KGWAS_P"):
        np.testing.assert_allclose(got[c], ref[c].values.astype(np.float64),
                                   rtol=0, atol=1e-12)
    assert np.all((got["KGWAS_P"] >= 0) & (got["KGWAS_P"] <= 1))


def test_table_round_trip(tmp_path):
    t = {"ID": np.array(["rs1", "rs2"], dtype=object),
         "N": np.array([3, 4]), "P": np.array([0.25, 1e-300]),
         "pred": np.array([0.5, 1.25], dtype=np.float32)}
    path = str(tmp_path / "pred.csv")
    write_table(t, path)
    back = read_table(path)
    assert list(back) == list(t)
    assert list(back["ID"]) == ["rs1", "rs2"]
    assert np.array_equal(back["N"], t["N"])
    assert np.array_equal(back["P"], t["P"])
    assert np.array_equal(back["pred"], t["pred"].astype(np.float64))
    # pandas reads the same file
    df = pd.read_csv(path, sep="\t")
    assert list(df.columns) == list(t)
    assert np.array_equal(df.P.values, t["P"])


def _write_table_by_rows(table, path, sep="\t"):
    """The row-by-row writer that write_table replaced: the reference for
    its bytes."""
    from kgwas_tpu_torch.utils import _cell_text

    names = list(table)
    cols = [_cell_text(table[k]) for k in names]
    with open(path, "w") as f:
        f.write(sep.join(names) + "\n")
        for row in zip(*cols):
            f.write(sep.join(row) + "\n")


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_write_table_bytes_equal_the_row_writer(tmp_path, n):
    """Floats with NaN, inf, -0.0 and extremes, float32, integers and
    strings: the column writer's file is byte for byte the row writer's."""
    rng = np.random.default_rng(n)
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-30, 30, n)
    f[::7] = np.nan
    f[1::11] = np.inf
    f[2::13] = -0.0
    f[3::17] = 1e16
    t = {"ID": np.array([f"rs{i}" for i in range(n)], dtype=object),
         "CHR": rng.integers(-5, 10**12, n), "x": f,
         "pred": rng.random(n).astype(np.float32),
         "flag": rng.random(n) < 0.5}
    a, b = str(tmp_path / "cols.tsv"), str(tmp_path / "rows.tsv")
    write_table(t, a)
    _write_table_by_rows(t, b)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()

