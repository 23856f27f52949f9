"""The port's evaluation modules and text tables against the JAX package's:
stats/clumps.py and stats/gwas_eval.py on seeded tables (with tied P
values, positions and cM, where the row order follows pandas' sort), and
utils.write_table / read_table against pandas' to_csv / read_csv.
"""
import os
import sys

import numpy as np
import pandas as pd
import pytest

import kgwas_tpu.stats.clumps as jc
import kgwas_tpu.stats.gwas_eval as je
import kgwas_tpu_torch.stats.clumps as pc
import kgwas_tpu_torch.stats.gwas_eval as pe
from kgwas_tpu_torch.utils import read_table, sort_order, write_table


def _table(df):
    return {k: df[k].to_numpy() for k in df.columns}


def _plain(obj):
    """Nested results as plain Python values, numpy scalars and arrays
    included, for equality across the packages."""
    if isinstance(obj, dict):
        return {_plain(k): _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_plain(v) for v in obj]
    if hasattr(obj, "to_numpy"):        # pandas 3's string arrays
        obj = obj.to_numpy()
    if isinstance(obj, np.ndarray):
        return [_plain(v) for v in obj.tolist()]
    if isinstance(obj, np.generic):
        return obj.item()
    return obj


# ---------------------------------------------------------- write / read

def _awkward_frame(n=40, seed=0):
    rng = np.random.default_rng(seed)
    names = np.array([f"GO term {i}" for i in range(n)], dtype=object)
    names[::5] = [f"regulation of x, y {i}" for i in range(0, n, 5)]
    names[1::7] = [f'the "quoted" {i}' for i in range(1, n, 7)]
    names[2::11] = "line\nbreak"
    names[3::13] = "cr\rhere"
    names[4::9] = np.nan
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)
    f[::6] = np.nan
    return pd.DataFrame({"name": names, "x": f,
                         "k": rng.integers(-5, 10**9, n),
                         "flag": rng.random(n) < 0.5,
                         "a,b": ["v"] * n})


@pytest.mark.parametrize("sep", [",", "\t"])
def test_write_table_bytes_equal_to_csv(tmp_path, sep):
    """QUOTE_MINIMAL as to_csv: a cell or name holding the separator, a
    quote or a line break is quoted, its quotes doubled; NaN is empty."""
    df = _awkward_frame()
    a, b = str(tmp_path / "port.csv"), str(tmp_path / "pandas.csv")
    write_table(_table(df), a, sep=sep)
    df.to_csv(b, sep=sep, index=False)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_write_table_one_column(tmp_path):
    """One column: an empty or missing cell is written "" as csv writes a
    row of one empty field."""
    df = pd.DataFrame({"only": np.array(["a", "", np.nan, "b,c"],
                                        dtype=object)})
    a, b = str(tmp_path / "p.csv"), str(tmp_path / "q.csv")
    write_table(_table(df), a, sep=",")
    df.to_csv(b, index=False)
    assert open(a).read() == open(b).read()
    df = pd.DataFrame({"v": [np.nan, 1.5]})
    write_table(_table(df), a, sep=",")
    df.to_csv(b, index=False)
    assert open(a).read() == open(b).read()


@pytest.mark.parametrize("sep", [",", "\t", None])
def test_read_table_matches_read_csv(tmp_path, sep):
    """What to_csv wrote reads back as read_csv reads it (sep None: the
    separator sniffed as the python engine sniffs it): names, dtypes and
    values, floats as read_csv's float_precision="round_trip" reads them,
    the correctly rounded values (pandas' default parser is not:
    test_torch_realdata.py::test_reader_floats_are_correctly_rounded)."""
    df = _awkward_frame()
    if sep is None:   # a comma in the header line would be sniffed
        df = df.drop(columns=["a,b"])
    path = str(tmp_path / "t.txt")
    df.to_csv(path, sep=sep or ";", index=False)
    got = read_table(path, sep=sep)
    want = pd.read_csv(path, sep=sep or ";", float_precision="round_trip")
    if sep is None:
        assert list(pd.read_csv(path, sep=None, engine="python").columns) \
            == list(want.columns)
    assert list(got) == list(want.columns)
    for c in want.columns:
        w = want[c].to_numpy()
        if w.dtype.kind in "fiub":
            assert got[c].dtype.kind == w.dtype.kind, c
            np.testing.assert_array_equal(got[c], w)
        else:
            assert [None if x != x else x for x in got[c].tolist()] == \
                [None if x != x else x for x in w.tolist()], c


def test_read_table_header_none_and_unnamed(tmp_path):
    path = str(tmp_path / "x.bim")
    pd.DataFrame({"c": [1, 2], "i": ["rs1", "rs2"], "m": [0.5, 0.25]}
                 ).to_csv(path, sep="\t", header=False, index=False)
    got = read_table(path, header=None)
    want = pd.read_csv(path, sep="\t", header=None)
    assert list(got) == list(want.columns) == [0, 1, 2]
    path = str(tmp_path / "u.csv")
    pd.DataFrame({"v": [1.5]}, index=["rs1"]).to_csv(path)
    assert list(read_table(path, sep=",")) == list(pd.read_csv(path).columns) \
        == ["Unnamed: 0", "v"]


def test_sort_order_is_pandas_sort_values():
    rng = np.random.default_rng(1)
    v = rng.integers(0, 8, 300).astype(float)
    v[::17] = np.nan
    df = pd.DataFrame({"v": v, "i": np.arange(300)})
    assert np.array_equal(sort_order(v), df.sort_values("v").i.to_numpy())
    o = np.array(v.tolist(), dtype=object)
    assert np.array_equal(sort_order(o), pd.DataFrame(
        {"v": o, "i": np.arange(300)}).sort_values("v").i.to_numpy())


# ----------------------------------------------------------------- clumps

@pytest.fixture(scope="module")
def ld_world(tmp_path_factory):
    """300 SNPs on 3 chromosomes, cM with ties (2 decimals over 2 cM), LD
    blocks, and a GWAS with tied P values; the .bim also as a file."""
    rng = np.random.default_rng(0)
    n = 300
    ids = [f"rs{i}" for i in range(n)]
    bim = pd.DataFrame({0: rng.integers(1, 4, n), 1: ids,
                        2: np.round(rng.uniform(0, 2, n), 2), 3: 0,
                        4: "A", 5: "G"})
    snp2ld = {ids[i]: [ids[j] for j in range(i + 1, min(i + 4, n))]
              for i in range(0, n, 10)}
    p = np.round(rng.uniform(0, 1e-6, n), 9)
    p[::3] = 1e-9
    gwas = pd.DataFrame({"SNP": ids, "P": p})
    path = tmp_path_factory.mktemp("bim") / "ukb_white_with_cm.bim"
    bim.to_csv(path, sep="\t", header=False, index=False)
    return {"ids": ids, "bim": bim, "ld": snp2ld, "gwas": gwas,
            "bim_path": str(path)}


def test_clumps_match_jax(ld_world):
    w = ld_world
    for t_p in (5e-8, 5e-7):
        gold_j = jc.get_clumps_gold_label("", w["gwas"], t_p=t_p,
                                          snp2ld_snps=w["ld"])
        gold_p = pc.get_clumps_gold_label("", _table(w["gwas"]), t_p=t_p,
                                          snp2ld_snps=w["ld"])
        assert _plain(gold_p) == _plain(gold_j)
    bim_p = read_table(w["bim_path"], header=None)
    meta_j = jc.get_meta_clumps(gold_j, "", bim_df=w["bim"])
    meta_p = pc.get_meta_clumps(gold_p, "", bim_df=bim_p)
    assert _plain(meta_p) == _plain(meta_j)
    ranked = list(w["gwas"].sort_values("P").SNP)
    q_j = jc.get_mega_clump_query("", gold_j, ranked, snp2ld_snps=w["ld"],
                                  bim_df=w["bim"])
    q_p = pc.get_mega_clump_query("", gold_p, ranked, snp2ld_snps=w["ld"],
                                  bim_df=bim_p)
    assert _plain(q_p) == _plain(q_j)
    curve_j = jc.get_curve(list(q_j[1].values()), list(meta_j[1].values()))
    curve_p = pc.get_curve(list(q_p[1].values()), list(meta_p[1].values()))
    assert _plain(curve_p) == _plain(curve_j)
    for a, b in ((["a", "b", "c"], ["b", "c", "d"]), ([], ["x"])):
        assert pc.get_prec_recall(np.array(a), np.array(b)) == \
            jc.get_prec_recall(np.array(a), np.array(b))


def test_meta_clumps_read_the_bim_from_data_path(ld_world, tmp_path):
    w = ld_world
    (tmp_path / "misc_data").mkdir()
    (tmp_path / "misc_data" / "ukb_white_with_cm.bim").write_bytes(
        open(w["bim_path"], "rb").read())
    clumps = pc.build_clumps(w["ids"][:60], w["ld"])
    root = str(tmp_path) + "/"
    assert _plain(pc.get_meta_clumps(clumps, root)) == _plain(
        jc.get_meta_clumps(clumps, root))


# -------------------------------------------------------------- gwas_eval

@pytest.fixture(scope="module")
def gwas_world():
    rng = np.random.default_rng(3)
    n = 1200
    ids = [f"rs{i}" for i in range(n)]
    p = rng.uniform(0, 1, n)
    p[:40] = rng.uniform(0, 1e-9, 40)
    p[40:60] = 1e-10                     # tied P values
    res = pd.DataFrame({"#CHROM": rng.integers(1, 4, n),
                        "POS": rng.integers(1, 3_000_000, n) // 1000 * 1000,
                        "ID": ids, "P": p})
    hits_all = np.array(ids[:30] + ids[45:70])
    return res, hits_all


def test_gwas_results_match_jax(gwas_world):
    res, hits = gwas_world
    n = len(res)
    assert _plain(pe.get_gwas_results(_table(res), hits, n)) == _plain(
        je.get_gwas_results(res, hits, n))
    assert _plain(pe.get_precision_recall_at_N(_table(res), hits, n, 0.5)) \
        == _plain(je.get_precision_recall_at_N(res, hits, n, 0.5))


@pytest.mark.parametrize("extend", [False, True])
def test_clusters_match_jax(gwas_world, extend):
    res, hits = gwas_world
    hit_rows = res[res.P < 1e-3]
    got = pe.get_cluster_from_gwas(_table(hit_rows), 200_000,
                                   threshold_extend=extend,
                                   cluster_compare_threshold=50_000)
    want = je.get_cluster_from_gwas(hit_rows, 200_000,
                                    threshold_extend=extend,
                                    cluster_compare_threshold=50_000)
    assert _plain(got) == _plain(want)
    flat, pos2idx = want[2], want[4]
    pred = res.ID.values[::7]
    g = pe.get_cluster_hits_from_pred(pred, 100_000, _table(res), flat,
                                      pos2idx)
    j = je.get_cluster_hits_from_pred(pred, 100_000, res, flat, pos2idx)
    assert g[0] == {k: int(v) for k, v in j[0].items()}
    assert g[1] == j[1]
    assert _plain(g[3]) == _plain(j[3])
    for c in j[2].columns:
        assert _plain(g[2][c]) == _plain(j[2][c].to_numpy()), c

    rng_j = want[5]
    other = je.get_cluster_from_gwas(res[res.P < 0.01], 200_000,
                                     cluster_compare_threshold=50_000,
                                     verbose=False)[5]
    assert _plain(pe.find_overlap_clusters(other, rng_j)) == _plain(
        je.find_overlap_clusters(other, rng_j))
    assert _plain(pe.find_non_overlap_clusters(other, rng_j)) == _plain(
        je.find_non_overlap_clusters(other, rng_j))
    low = res[res.P < 0.05]
    args = (200_000, _table(hit_rows), _table(res[res.P < 0.01]),
            _table(low))
    assert pe.get_pr_curve(*args, threshold_extend=extend) == \
        je.get_pr_curve(200_000, hit_rows, res[res.P < 0.01], low,
                        threshold_extend=extend)
    ranked = res.sort_values("P")
    # targets the whole ranking reaches (a larger one never ends, in both)
    most = pe.get_cluster_count(_table(ranked), 200_000, 50_000, extend,
                                rng_j)["set_total"]
    ks = sorted({max(1, most // 4), max(1, most // 2)})
    kt_p = pe.get_top_k_clusters(_table(ranked), ks, 200_000, 50_000,
                                 extend, rng_j)
    kt_j = je.get_top_k_clusters(ranked, ks, 200_000, 50_000, extend, rng_j)
    assert _plain(kt_p) == _plain(kt_j)


def test_quantile_normalize_matches_jax():
    rng = np.random.default_rng(9)
    df = pd.DataFrame({c: rng.random(50) * s for c, s in
                       zip("abcdefghij", range(1, 11))})
    got = pe.quantile_normalize(_table(df))
    want = je.quantile_normalize(df)
    assert list(got) == list(want.columns)
    for c in want.columns:
        assert np.array_equal(got[c], want[c].to_numpy()), c


def test_plot_cluster_range(monkeypatch, tmp_path):
    """matplotlib is imported in the call: the plot draws as the JAX one
    does, and without matplotlib the call raises ImportError."""
    pytest.importorskip("matplotlib")
    ranges = [{1: [(0, 10)]}, {1: [(5, 20)]}, {2: [(1, 2)]}, {}]
    fig = pe.plot_cluster_range(1, *ranges, show=False,
                                save_path=str(tmp_path / "p.png"))
    assert (tmp_path / "p.png").exists()
    # the caller's dicts gain an empty entry for the chromosome, as in JAX
    jranges = [{1: [(0, 10)]}, {1: [(5, 20)]}, {2: [(1, 2)]}, {}]
    je.plot_cluster_range(1, *jranges, show=False)
    assert ranges == jranges
    assert len(fig.axes[0].lines) == 2
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError):
        pe.plot_cluster_range(1, {}, {}, {}, {}, show=False)


def test_host_utils_match_jax(tmp_path):
    """The rest of utils.py: save_dict / load_dict, find_nearest, flatten,
    ensure_dir, find_connected_components_details and compute_metrics
    with the JAX package's full signature."""
    import kgwas_tpu.utils as ju
    import kgwas_tpu_torch.utils as pu

    obj = {"a": np.arange(3), "b": [1, "x"]}
    pu.save_dict(str(tmp_path / "o.pkl"), obj)
    back = ju.load_dict(str(tmp_path / "o.pkl"))
    assert np.array_equal(back["a"], obj["a"]) and back["b"] == obj["b"]
    arr = np.array([3.0, 7.5, -2.0, 7.4])
    for v in (0.0, 7.45, 100.0, -5.0):
        assert pu.find_nearest(arr, v) == ju.find_nearest(arr, v)
    assert pu.flatten([[1, 2], [], [3]]) == ju.flatten([[1, 2], [], [3]])
    d = str(tmp_path / "x" / "y")
    assert pu.ensure_dir(d) == d and os.path.isdir(d)
    rng = np.random.default_rng(2)
    edges = [tuple(e) for e in rng.integers(0, 30, (40, 2)).tolist()]
    assert _plain(pu.find_connected_components_details(edges)) == _plain(
        ju.find_connected_components_details(edges))
    res = {"pred": rng.random(20), "truth": rng.random(20)}
    kw = dict(binary=True, coverage=0.9, uncertainty_reg=2, loss_fct=None)
    assert pu.compute_metrics(res, **kw) == ju.compute_metrics(res, **kw)
