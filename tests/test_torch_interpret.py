"""The interpretation slice of the port against the JAX package: the
interpretation forward, the edge-weight table, the disease-critical
network and the per-variant tables, and the label helpers.

  * ``HeteroGNN.collect_attention`` against ``apply_collect_attention
    (raw=True)`` from the same JAX-initialised weights: every relation of
    both layers (the forward runs every group, with no ReLU between
    layers), α at rtol 1e-5, atol 1e-6 (float32, the projections in
    another order); GAT sum, mean, max (fold 0) and sigmoid_gat.
  * ``attention_tables`` against the JAX function on
    ``tests/test_interpret_tables.py``'s graphs with parallel edges, on the
    per-group dedup and on the duplicate-name fallback: the same rows,
    weights at the same tolerance.
  * ``_zscore``, ``_max_over_parallel`` and the descending sort against
    the JAX package's pandas code on crafted tables (one-row groups, tied
    relations, NaN and inf), and ``generate_viz`` on a crafted network:
    the same rows in the same order, floats equal.
  * ``get_disease_critical_network`` on one checkpoint that both packages
    load (with pred.csv): the three tables equal after a canonical sort,
    floats at rtol 1e-4, atol 1e-5, NaN and inf in the same places. A pair
    (or a SNP's neighbourhood) whose kept rows differ counts as a near-tie
    only where its largest importance agrees within that tolerance; their
    number is bounded. With and without the MAGMA branch: the JAX
    package's MAGMA branch runs to its end under pandas 3 only with string
    gene ids and a gseapy (a stub here); without gseapy it raises on the
    empty G2P frame, where the port gives the tables without G2P rows.
  * SAGE has no attention: empty tables on both sides.
  * ``bonferroni`` and ``residual_label`` against the JAX functions.
"""
import dataclasses
import os
import pickle
import sys
import types
from types import SimpleNamespace

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.config import ModelConfig as JaxModelConfig
from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.interpret import attention as jax_attention
from kgwas_tpu.interpret import network as jax_network
from kgwas_tpu.models import apply_collect_attention, init_hetero_gnn
from kgwas_tpu.stats import labels as jax_labels

import kgwas_tpu_torch as kt
from kgwas_tpu_torch.config import ModelConfig
from kgwas_tpu_torch.engine import params_from_jax
from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph
from kgwas_tpu_torch.interpret import attention, network
from kgwas_tpu_torch.models import HeteroGNN, device_layouts, layer_path
from kgwas_tpu_torch.stats import labels

from test_interpret_tables import _graph_with_parallel_edges

ALPHA_RTOL, ALPHA_ATOL = 1e-5, 1e-6
TABLE_RTOL, TABLE_ATOL = 1e-4, 1e-5
# near-ties allowed: at most this share of the groups (and at least 1)
NEAR_TIE_SHARE = 0.01
KG = dict(n_snp=400, n_gene=80, n_go=30, seed=1)
TYPES = {"SNP", "Gene", "BiologicalProcess", "CellularComponent",
         "MolecularFunction"}


def columns_of(df) -> dict:
    """A DataFrame as a column table: numbers as numpy, the rest as str."""
    out = {}
    for c in df.columns:
        col = df[c]
        if col.dtype.kind in "iuf":
            out[c] = col.to_numpy()
        else:
            out[c] = np.array([str(v) for v in col], dtype=object)
    return out


def _canonical(table, keys):
    cols = [np.asarray(table[k]) for k in keys]
    cols = [c.astype(str) if c.dtype == object else c for c in cols]
    order = np.lexsort(cols[::-1])
    return {k: np.asarray(v)[order] for k, v in table.items()}


def _floats_close(a, b, rtol, atol):
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        return False
    fin = np.isfinite(b)
    same_special = np.array_equal(np.isfinite(a), fin) and np.array_equal(
        a[~fin].astype(str), b[~fin].astype(str))
    return same_special and bool(np.all(
        np.abs(a[fin] - b[fin]) <= atol + rtol * np.abs(b[fin])))


def _same_rows(a, b, keys, float_col, rtol, atol):
    if len(a[keys[0]]) != len(b[keys[0]]):
        return False
    a, b = _canonical(a, keys + [float_col]), _canonical(b, keys + [float_col])
    for c in a:
        if c == float_col:
            if not _floats_close(a[c], b[c], rtol, atol):
                return False
        elif not np.array_equal(np.asarray(a[c]).astype(str),
                                np.asarray(b[c]).astype(str)):
            return False
    return True


def compare_tables(got, want, keys, group, float_col, near=None,
                   rtol=TABLE_RTOL, atol=TABLE_ATOL):
    """Raises unless the column tables hold the same rows (after a
    canonical sort by keys), floats within tolerance; groups (by the group
    columns) whose rows differ pass only as near-ties: near(a, b) says
    whether the two groups agree up to a near-tie (default: their largest
    float_col value within tolerance). Returns the number of near-ties."""
    assert list(got) == list(want)
    if _same_rows(got, want, keys, float_col, rtol, atol):
        return 0

    def by_group(t):
        rows = {}
        for i, k in enumerate(zip(*[np.asarray(t[c]).astype(str)
                                    for c in group])):
            rows.setdefault(k, []).append(i)
        return {k: {c: np.asarray(v)[r] for c, v in t.items()}
                for k, r in rows.items()}

    if near is None:
        def near(a, b):
            return _floats_close([np.nanmax(a[float_col])],
                                 [np.nanmax(b[float_col])], rtol, atol)
    g, w = by_group(got), by_group(want)
    assert g.keys() == w.keys()
    ties = 0
    for k in g:
        if _same_rows(g[k], w[k], keys, float_col, rtol, atol):
            continue
        assert near(g[k], w[k]), f"group {k} differs beyond a near-tie"
        ties += 1
    assert ties <= max(1, NEAR_TIE_SHARE * len(g)), (ties, len(g))
    return ties


def _neighbourhood_near_tie(a, b):
    """Two neighbourhoods of one SNP differ only through a near-tie when
    their genes' (V2G rows') importances agree within tolerance."""
    va = np.sort(a["importance"][a["t_type"] == "SNP"])
    vb = np.sort(b["importance"][b["t_type"] == "SNP"])
    return _floats_close(va, vb, TABLE_RTOL, TABLE_ATOL)


NETWORK_KEYS = ["layer", "rel_type", "h_type", "t_type", "h_idx", "t_idx"]
DCN_KEYS = ["Category", "rel_type", "h_type", "t_type", "h_idx", "t_idx",
            "h_id", "t_id"]
LOCAL_KEYS = ["QUERY_SNP", "h_type", "t_type", "rel_type", "h_idx", "t_idx",
              "h_id", "t_id"]


def assert_interpretation_equal(got, want):
    """got: the port's three column tables; want: the JAX package's three
    DataFrames. Returns the near-tie counts."""
    nw, vi, dcn = got
    jnw, jvi, jdcn = (columns_of(df) for df in want)
    compare_tables(nw, jnw, NETWORK_KEYS, NETWORK_KEYS, "weight",
                   rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
    ties_dcn = compare_tables(dcn, jdcn, DCN_KEYS,
                              ["Category", "h_idx", "t_idx"], "importance")
    ties_local = compare_tables(vi, jvi, LOCAL_KEYS, ["QUERY_SNP"],
                                "importance", near=_neighbourhood_near_tie)
    return ties_dcn, ties_local


# ------------------------------------------------ the interpretation forward

def _small_world(seed, **cfg_kw):
    """(JAX cfg, params, meta, arrays, port model, layouts, x, relations)
    on the parallel-edge graph, from the same JAX-initialised weights."""
    g = _graph_with_parallel_edges(seed=seed)
    cgj = jax_compile_graph(g)
    cfg = JaxModelConfig(gnn_hidden_dim=16, gnn_num_layers=2, **cfg_kw)
    meta = cgj.meta()
    params = jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
        jax.random.PRNGKey(seed), cfg, meta, 20, 32, 16))
    # the port's graph: the same edges, rows padded to the merged tile
    gp = _graph_with_parallel_edges(seed=seed)
    cg = compile_graph(gp, edge_pad_multiple=512, node_pad_multiple=512)
    port_cfg = ModelConfig.from_dict(cfg.to_dict())
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    model = HeteroGNN(port_cfg, rel_types, 20, 32, 16, seed=1)
    model.load_state_dict(params_from_jax(params))
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu",
                             cg, layer_path(port_cfg))
    x = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
    return cfg, params, meta, cgj, model, layouts, x, cg


VARIANTS = {
    "GAT-sum": {},
    "GAT-mean": {"gnn_aggr": "mean"},
    "GAT-max": {"gnn_aggr": "max"},
    "GAT-sigmoid": {"sigmoid_gat": True},
}


@pytest.mark.parametrize("name", list(VARIANTS))
def test_collect_attention_matches_jax(name):
    cfg, params, meta, cgj, model, layouts, x, cg = _small_world(
        2, **VARIANTS[name])
    want = apply_collect_attention(params, cfg, meta, cgj.arrays(), raw=True)
    got = model.collect_attention(x, layouts)
    assert len(got) == len(want) == 2
    for li, (a, b) in enumerate(zip(got, want)):
        # every relation of every layer: all groups run, both layers
        assert set(a) == set(b) == set(cg.relations), li
        for rk, alpha in a.items():
            e = cg.relations[rk].num_edges
            ref = np.asarray(b[rk])[:e]
            assert alpha.shape == (e, 1)
            np.testing.assert_allclose(alpha.numpy(), ref, rtol=ALPHA_RTOL,
                                       atol=ALPHA_ATOL, err_msg=f"l{li + 1} "
                                       f"{rk}")


@pytest.mark.parametrize("fallback", [False, True])
def test_attention_tables_match_jax(fallback):
    cfg, params, meta, cgj, model, layouts, x, cg = _small_world(
        1 if fallback else 0)
    rels_j, rels = dict(cgj.relations), dict(cg.relations)
    if fallback:
        # two relation keys carrying one name: the global dedup
        keys = sorted(rels)
        rels_j[keys[1]] = dataclasses.replace(rels_j[keys[1]],
                                              rel=rels_j[keys[0]].rel)
        rels[keys[1]] = dataclasses.replace(rels[keys[1]],
                                            rel=rels[keys[0]].rel)
    want = jax_attention.attention_tables(params, cfg, meta, cgj.arrays(),
                                          rels_j)
    got = attention.attention_tables(model, x, layouts, rels)
    assert list(got) == list(want.columns)
    assert len(got["h_idx"]) == len(want) > 0
    compare_tables(got, columns_of(want), NETWORK_KEYS, NETWORK_KEYS,
                   "weight", rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
    assert got["weight"].dtype == np.float64
    assert set(got["layer"]) == {"l1", "l2"} and set(got["t_type"]) == TYPES


# -------------------------------------------------- the tables, on pandas

def _crafted_pairs(rng, n):
    df = pd.DataFrame({
        "h_idx": rng.integers(0, 4, n),
        "t_idx": rng.integers(0, 3, n),
        # few values: ties within and across relations
        "weight": rng.choice([-1.0, 0.0, 0.5, 1.0, 3.0], n),
        "h_type": "Gene",
        "t_type": "SNP",
        "rel_type": rng.choice(["rev_A", "rev_B", "rev_C"], n),
    })
    return df


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zscore_and_max_over_parallel_match_pandas(seed):
    rng = np.random.default_rng(seed)
    df = _crafted_pairs(rng, 60)
    # rev_B copies rev_A's rows: equal statistics, so every pair of the two
    # ties; rev_D has one row (std 0: its z is NaN) and rev_E rows that the
    # stats lack (dropped); one stats row of rev_C alone: +-inf and NaN
    a = df[df.rel_type == "rev_A"]
    df = pd.concat([df[df.rel_type != "rev_B"], a.assign(rel_type="rev_B"),
                    pd.DataFrame({"h_idx": [1], "t_idx": [2], "weight": [0.5],
                                  "h_type": "Gene", "t_type": "SNP",
                                  "rel_type": ["rev_D"]}),
                    a.assign(rel_type="rev_E")], ignore_index=True)
    df["rel_type"] = df.rel_type.astype("category")
    stats = df[df.rel_type != "rev_E"]
    c_rows = np.flatnonzero(stats.rel_type == "rev_C")
    stats = stats.drop(stats.index[c_rows[1:]])
    for s in (stats, df[df.rel_type.isin(["rev_A", "rev_B", "rev_D"])]):
        want = jax_network._zscore(df, s)
        got = network._zscore(columns_of(df), columns_of(s))
        assert got["z_rel"].dtype == np.float64
        for c in want.columns:
            assert np.array_equal(np.asarray(got[c]).astype(str),
                                  columns_of(want)[c].astype(str)), c
        assert np.isnan(got["z_rel"]).any()
        want_best = columns_of(jax_network._max_over_parallel(want))
        got_best = network._max_over_parallel(got)
        assert list(got_best) == list(want_best)
        for c in want_best:
            assert np.array_equal(np.asarray(got_best[c]).astype(str),
                                  want_best[c].astype(str)), c
        # a pair kept twice: tied relations both stay
        pairs = list(zip(got_best["h_idx"], got_best["t_idx"]))
        assert len(pairs) > len(set(pairs))


@pytest.mark.parametrize("n", [5, 40, 300])
def test_descending_order_matches_sort_values(n):
    rng = np.random.default_rng(n)
    v = rng.choice([np.nan, -np.inf, -1.0, 0.0, 0.25, 2.0, np.inf], n)
    want = pd.DataFrame({"importance": v}).sort_values(
        "importance")[::-1].index.to_numpy()
    assert np.array_equal(network._descending(v), want)


N_SNP, N_GENE, N_BP = 16, 10, 6
# (h_type, rel, t_type, edges): the generate_viz inputs by kind; the rev_ABC
# copy of rev_Enhancer ties every V2G pair, rev_Rare and Gene-solo-Gene have
# one hit row each (a NaN z, and +-inf or NaN on their other rows)
CRAFTED = [
    ("Gene", "rev_Enhancer-eQTL-Gene", "SNP", 40),
    ("Gene", "rev_TSS", "SNP", 10),
    ("Gene", "Gene-PPI-Gene", "Gene", 30),
    ("Gene", "Gene-coexp-Gene", "Gene", 24),
    ("BiologicalProcess", "rev_Gene-memberof-BiologicalProcess", "Gene", 20),
    ("Gene", "Gene-memberof-BiologicalProcess", "BiologicalProcess", 20),
    ("SNP", "Enhancer-eQTL-Gene", "Gene", 40),
    ("SNP", "TSS", "Gene", 10),
    ("CellularComponent", "rev_Gene-memberof-CellularComponent", "Gene", 8),
]
SIZES = {"SNP": N_SNP, "Gene": N_GENE, "BiologicalProcess": N_BP,
         "CellularComponent": N_BP}


def _crafted_network(seed):
    rng = np.random.default_rng(seed)
    parts = []
    for h_type, rel, t_type, n in CRAFTED:
        h = rng.integers(0, SIZES[h_type], n)
        t = rng.integers(0, SIZES[t_type], n)
        for layer in ("l1", "l2"):
            parts.append(pd.DataFrame({
                "h_idx": h, "t_idx": t,
                "weight": rng.choice([-1.0, -0.5, 0.0, 0.5, 1.0, 2.0], n),
                "h_type": h_type, "rel_type": rel, "t_type": t_type,
                "layer": layer}))
            if rel == "rev_Enhancer-eQTL-Gene":
                parts.append(parts[-1].assign(rel_type="rev_ABC-Gene"))
    # rev_Rare's row to SNP 0 is its one hit row (SNPs 12, 13 are no
    # hits); Gene-solo-Gene has one row. Their pairs start at the gene no
    # other row holds, so the NaN z stays the pair's max
    g = N_GENE
    parts.append(pd.DataFrame({
        "h_idx": [g, g, g, g], "t_idx": [0, 12, 13, 5],
        "weight": [0.5, 1.0, 0.5, 2.0], "h_type": "Gene",
        "rel_type": ["rev_Rare-Gene"] * 3 + ["Gene-solo-Gene"],
        "t_type": ["SNP"] * 3 + ["Gene"], "layer": "l1"}))
    df = pd.concat(parts, ignore_index=True)
    for c in ("h_type", "rel_type", "t_type", "layer"):
        df[c] = df[c].astype("category")
    return df


def _runs(kgwas_res, idx2id):
    id2idx = {t: {v: k for k, v in m.items()} for t, m in idx2id.items()}
    data = SimpleNamespace(idx2id=idx2id, id2idx=id2idx)
    return (SimpleNamespace(kgwas_res=pd.DataFrame(kgwas_res), data=data),
            SimpleNamespace(kgwas_res=kgwas_res, data=data))


def _crafted_runs():
    idx2id = {"SNP": {i: f"rs{i}" for i in range(N_SNP)},
              "Gene": {i: f"G{i}" for i in range(N_GENE + 1)},
              **{t: {i: f"GO{i}" for i in range(N_BP)}
                 for t in ("BiologicalProcess", "CellularComponent",
                           "MolecularFunction")}}
    p = np.where(np.arange(N_SNP) < 7, 1e-9, 0.3)
    return _runs({"ID": np.array([f"rs{i}" for i in range(N_SNP)],
                                 dtype=object), "P": p}, idx2id)


def _write_go_names(path):
    os.makedirs(os.path.join(path, "misc_data"), exist_ok=True)
    with open(os.path.join(path, "misc_data", "go2name.pkl"), "wb") as f:
        pickle.dump({"GO0": "cell death", "GO3": "apoptotic process"}, f)


@pytest.mark.parametrize("seed", [0, 3])
def test_generate_viz_matches_jax_on_crafted_network(tmp_path, seed):
    """Same rows in the same order, floats equal: ties, one-row hit groups,
    NaN and inf, GO names, TSS excluded, self pairs dropped."""
    _write_go_names(str(tmp_path))
    df = _crafted_network(seed)
    jrun, prun = _crafted_runs()
    want = jax_network.generate_viz(jrun, df, str(tmp_path), K_neighbors=2)
    got = network.generate_viz(prun, columns_of(df), str(tmp_path),
                               K_neighbors=2)
    for g, w in zip(got, want):
        w = columns_of(w)
        assert list(g) == list(w) and len(w["h_idx"]) > 0
        for c in w:
            assert np.array_equal(np.asarray(g[c]).astype(str),
                                  w[c].astype(str)), c
    vi, dcn = got
    assert np.isnan(dcn["importance"]).any()
    assert np.isinf(vi["importance"]).any() or np.isnan(
        vi["importance"]).any()
    assert "Cell death" in set(dcn["h_id"])
    if seed:
        return
    # a process pool gives the same tables
    pooled = network.generate_viz(prun, columns_of(df), str(tmp_path),
                                  K_neighbors=2, num_cpus=2)
    for g, p in zip(got, pooled):
        for c in g:
            assert np.array_equal(np.asarray(g[c]).astype(str),
                                  np.asarray(p[c]).astype(str)), c


def test_zero_hits_give_empty_tables(tmp_path):
    """No SNP under the threshold: the port's tables are empty; the JAX
    package raises there under pandas 3 (setting a column of an empty
    frame), kept as a note in ROADMAP.md Queue 3."""
    df = _crafted_network(0)
    jrun, prun = _crafted_runs()
    with pytest.raises(ValueError):
        jax_network.generate_viz(jrun, df, str(tmp_path),
                                 variant_threshold=1e-300)
    vi, dcn = network.generate_viz(prun, columns_of(df), str(tmp_path),
                                   variant_threshold=1e-300)
    assert len(vi["h_idx"]) == 0
    assert set(dcn["Category"]) == {"G2G", "G2P"}   # no V2G without hits


# ------------------------------------------ the whole slice, one checkpoint

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A port-trained checkpoint (with pred.csv) at n_snp 400, hidden 32,
    and both packages' runs loaded from it."""
    path = str(tmp_path_factory.mktemp("interpret"))
    data = kt.KGWAS_Data.from_synthetic(data_path=path, **KG)
    data.load_synthetic_gwas(seed=1)
    data.process_gwas_file()
    data.prepare_split()
    run = kt.KGWAS(data, device="cpu", exp_name="interp", seed=1)
    run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=32, no_relu=True)
    run.train(batch_size=64, epoch=2, lr=1e-3)
    ckpt = os.path.join(path, "model", "interp")
    port = kt.KGWAS(data, device="cpu").load_pretrained(ckpt)
    jdata = JaxData.from_synthetic(data_path=path, **KG)
    jdata.load_synthetic_gwas(seed=1)
    jdata.process_gwas_file()
    jrun = JaxKGWAS(jdata).load_pretrained(ckpt)
    jnet = jax_attention.get_network_weight(jrun, jdata)
    return path, port, jrun, jnet


def test_disease_critical_network_matches_jax(checkpoint):
    path, port, jrun, jnet = checkpoint
    got = port.get_disease_critical_network(variant_threshold=0.5)
    want = (jnet,) + jax_network.generate_viz(jrun, jnet, path, 0.5)
    assert_interpretation_equal(got, want)
    nw, vi, dcn = got
    assert set(nw["layer"]) == {"l1", "l2"} and set(nw["t_type"]) == TYPES
    assert set(dcn["Category"]) <= {"V2G", "G2G", "G2P"}
    assert len(dcn["h_idx"]) and len(vi["h_idx"])
    assert not any(r.startswith("rev_") for r in dcn["rel_type"])
    # the served state is the checkpoint's: the same predictions
    np.testing.assert_allclose(port.predict_all(),
                               np.asarray(jrun.predict_all()),
                               rtol=1e-5, atol=1e-6)


def _magma_files(path, rng):
    """genes.out (MAGMA gene analysis) and misc_data/NCBI37.3.gene.loc with
    string gene ids; a third of the genes Bonferroni-significant, two ids
    whose names the KG lacks."""
    os.makedirs(os.path.join(path, "misc_data"), exist_ok=True)
    n = KG["n_gene"] + 2
    with open(os.path.join(path, "misc_data", "NCBI37.3.gene.loc"), "w") as f:
        for i in range(n):
            f.write(f"ENSG{i:05d}\t1\t{i * 100}\t{i * 100 + 50}\t+\tG{i}\n")
    genes = os.path.join(path, "genes.out")
    with open(genes, "w") as f:
        f.write("GENE CHR START STOP NSNPS NPARAM N ZSTAT P\n")
        for i in rng.permutation(n):
            p = 1e-9 if i % 3 == 0 else 0.4
            f.write(f"ENSG{i:05d}  1  {i * 100}  {i * 100 + 50}  5  3  10000"
                    f"  {rng.normal():.4f}  {p:.6g}\n")
    with open(os.path.join(path, "misc_data", "gene_set_bp.pkl"), "wb") as f:
        pickle.dump({f"GO{i}": [f"G{j}" for j in range(i, i + 5)]
                     for i in range(8)}, f)
    return genes


def _gseapy_stub(calls):
    """gseapy.prerank returning fixed results; records each call's ranked
    genes (a DataFrame from the JAX package, a .rnk path from the port)."""
    def prerank(rnk, gene_sets, **kw):
        if isinstance(rnk, str):
            rows = [line.split("\t") for line in open(rnk).read().split("\n")
                    if line]
            ranked = [(g, float(z)) for g, z in rows]
        else:
            ranked = [(str(g), float(z)) for g, z in
                      zip(rnk.index, rnk["ZSTAT"])]
        calls.append((ranked, sorted(gene_sets), kw))
        res = pd.DataFrame({"Term": [f"GO{i}" for i in range(8)],
                            "NOM p-val": [0.2, 0.01, 0.5, 0.03, 0.04, 0.9,
                                          0.6, 0.07]})
        return SimpleNamespace(res2d=res)
    return types.SimpleNamespace(prerank=prerank)


def test_magma_branch_matches_jax(checkpoint, monkeypatch):
    path, port, jrun, jnet = checkpoint
    genes = _magma_files(path, np.random.default_rng(5))
    calls = []
    monkeypatch.setitem(sys.modules, "gseapy", _gseapy_stub(calls))
    got = port.get_disease_critical_network(variant_threshold=0.5,
                                            magma_path=genes)
    want = (jnet,) + jax_network.generate_viz(jrun, jnet, path, 0.5, genes)
    assert len(calls) == 2 and calls[0] == calls[1]
    assert_interpretation_equal(got, want)
    dcn = got[2]
    kept = set(dcn["h_id"][dcn["Category"] == "G2P"])
    assert kept and kept <= {f"GO{i}" for i in (1, 3, 4, 7, 0)}
    # gene hits only: G2G rows join the significant genes
    sig = {f"G{i}" for i in range(0, KG["n_gene"], 3)}
    g2g = dcn["Category"] == "G2G"
    assert set(dcn["h_id"][g2g]) <= sig and set(dcn["t_id"][g2g]) <= sig

    # gseapy absent: no programs. The JAX package raises on the empty G2P
    # frame; the port gives the same tables without G2P rows
    monkeypatch.delitem(sys.modules, "gseapy")
    with pytest.raises(ValueError):
        jax_network.generate_viz(jrun, jnet, path, 0.5, genes)
    nw, vi, dcn0 = port.get_disease_critical_network(variant_threshold=0.5,
                                                     magma_path=genes)
    assert "G2P" not in set(dcn0["Category"])
    no_bp = lambda t, col: {k: v[t[col] != "BiologicalProcess"]  # noqa: E731
                            for k, v in t.items()}
    compare_tables(dcn0, no_bp(columns_of(want[2]), "h_type"), DCN_KEYS,
                   ["Category", "h_idx", "t_idx"], "importance")
    compare_tables(vi, no_bp(columns_of(want[1]), "h_type"), LOCAL_KEYS,
                   ["QUERY_SNP"], "importance", near=_neighbourhood_near_tie)


def test_sage_has_no_attention(checkpoint):
    """SAGE has no attention: the JAX package's apply_collect_attention
    gives no alpha and an empty table; so does the port, and its tables
    stay empty (the JAX package raises on the empty frames there)."""
    path, port, jrun, _ = checkpoint
    data = port.data
    sage = kt.KGWAS(data, device="cpu", seed=3).initialize_model(
        gnn_backbone="SAGE", gnn_hidden_dim=16)
    sage.kgwas_res = port.kgwas_res
    _, x, layouts = sage._device_state()
    assert sage.model.collect_attention(x, layouts) == [{}, {}]
    jsage = JaxKGWAS(jrun.data)
    jsage.initialize_model(gnn_backbone="SAGE", gnn_hidden_dim=16)
    jnet = jax_attention.get_network_weight(jsage, jrun.data)
    nw, vi, dcn = sage.get_disease_critical_network(variant_threshold=0.5)
    assert list(nw) == list(jnet.columns) and len(jnet) == 0
    assert all(len(t[next(iter(t))]) == 0 for t in (nw, vi, dcn))


# ------------------------------------------------------------------ labels

def test_bonferroni_and_residual_label_equal_jax():
    rng = np.random.default_rng(0)
    p = rng.random(50)
    np.testing.assert_array_equal(labels.bonferroni(p),
                                  jax_labels.bonferroni(p))
    n = 200
    lr_uni = {"BETA": rng.standard_normal(n) * 0.01,
              "SE": np.full(n, 0.01), "ld_score": rng.uniform(1, 100, n),
              "w_ld_score": rng.uniform(1, 60, n),
              "ld_weight": rng.uniform(0.1, 2.0, n)}
    lr_uni["BETA"][3] = np.nan
    for mode in ("residual-w-ld", "residual-ld", "residual-w-ld-ols",
                 "residual-ld-ols", "residual-ld-ols-abs"):
        np.testing.assert_allclose(
            labels.residual_label(lr_uni, mode),
            jax_labels.residual_label(pd.DataFrame(lr_uni), mode),
            rtol=1e-12, atol=1e-12, err_msg=mode)
