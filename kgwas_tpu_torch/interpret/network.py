"""Disease-critical network and per-variant interpretation.

Counterpart of ``kgwas_tpu/interpret/network.py`` (after reference
kgwas/utils.py:496-725: generate_viz, get_local_interpretation) on column
tables (``dict[str, np.ndarray]``), numpy only. The attention weights are
z-scored within rel_type, the max over parallel relations is kept per
(head, tail) pair, the V2G / G2G / G2P / G2V tables are assembled, and each
hit SNP's top-K neighbourhood is extracted (optionally in a process pool).
The z statistics of the full tables come from the HIT subsets, a reference
quirk kept for parity (utils.py:643-651).

The pandas operations of the JAX package are copied as they run under
pandas 3:

  * ``_zscore``: per rel_type the Kahan-summed mean (pandas' groupby mean)
    and ``np.std`` (ddof 0: a one-row group has std 0, so its z is NaN or
    +-inf) of the stats table; rows whose rel_type the stats table lacks
    are dropped (an inner merge on observed groups), the left order kept;
  * ``_max_over_parallel``: per (h_idx, t_idx) in key order, the max z
    (NaN skipped, NaN when every z is NaN) and every row whose z equals it
    (NaN matching NaN, as a pandas merge key does), in table order;
  * ``sort_values("importance")[::-1]``: numpy's quicksort over the
    non-NaN values, the NaN positions after them, then reversed (NaN
    first).
"""
from __future__ import annotations

import multiprocessing
import os
import pickle
import tempfile
from functools import partial
from typing import Optional

import numpy as np

from ..stats.labels import bonferroni
from ..utils import _parse, load_dict, n_rows, print_sys, take

PAIR_COLUMNS = ("h_idx", "t_idx", "importance", "h_type", "t_type",
                "rel_type")
NETWORK_COLUMNS = PAIR_COLUMNS + ("Category", "h_id", "t_id")
LOCAL_COLUMNS = PAIR_COLUMNS + ("h_id", "t_id", "QUERY_SNP")


# ------------------------------------------------------------ column tables

def _concat(tables, columns) -> dict:
    return {c: np.concatenate([t[c] for t in tables]) if tables
            else np.zeros(0, dtype=object) for c in columns}


def _strings(values) -> np.ndarray:
    return np.array(list(values), dtype=object)


def _equals(col: np.ndarray, value) -> np.ndarray:
    return np.asarray(col == value, dtype=bool)


def _isin(col: np.ndarray, values) -> np.ndarray:
    return np.isin(col, np.asarray(list(values), dtype=np.int64))


def _ids(mapping: dict, idx: np.ndarray) -> np.ndarray:
    """mapping[i] for each index (the JAX package's per-row idx2id)."""
    return _strings(mapping[i] for i in idx.tolist())


def _kahan_mean(values: np.ndarray) -> float:
    """The mean as pandas' groupby mean sums it (compensated, in order)."""
    s = c = 0.0
    for v in values.tolist():
        y = v - c
        t = s + y
        c = (t - s) - y
        s = t
    return s / len(values)


# ------------------------------------------------------------- the tables

def _zscore(df: dict, stats_df: dict) -> dict:
    """df's rows whose rel_type stats_df holds, with the per-rel_type
    rel_type_std, rel_type_mean and z_rel = (weight - mean) / std from
    stats_df's weights."""
    names = stats_df["rel_type"]
    weight = np.asarray(stats_df["weight"], dtype=np.float64)
    std, mean = {}, {}
    for name in dict.fromkeys(names.tolist()):
        w = weight[_equals(names, name)]
        std[name] = float(np.std(w))
        mean[name] = _kahan_mean(w)
    rel = df["rel_type"]
    keep = np.zeros(len(rel), dtype=bool)
    row_std = np.zeros(len(rel))
    row_mean = np.zeros(len(rel))
    for name in std:
        sel = _equals(rel, name)
        keep |= sel
        row_std[sel] = std[name]
        row_mean[sel] = mean[name]
    out = take(df, keep)
    out["rel_type_std"] = row_std[keep]
    out["rel_type_mean"] = row_mean[keep]
    with np.errstate(divide="ignore", invalid="ignore"):
        out["z_rel"] = ((np.asarray(out["weight"], dtype=np.float64)
                         - out["rel_type_mean"]) / out["rel_type_std"])
    return out


def _max_over_parallel(df: dict, importance_col: str = "z_rel") -> dict:
    """Per (h_idx, t_idx): keep the max-z relation (reference
    utils.py:592-594), every one of a tie."""
    h = np.asarray(df["h_idx"], dtype=np.int64)
    t = np.asarray(df["t_idx"], dtype=np.int64)
    z = np.asarray(df[importance_col], dtype=np.float64)
    if not len(z):
        return {c: df[c][:0] if c in df else np.zeros(0) for c in
                PAIR_COLUMNS}
    order = np.lexsort((t, h))      # stable: equal keys in table order
    hs, ts, zs = h[order], t[order], z[order]
    start = np.ones(len(order), dtype=bool)
    start[1:] = (hs[1:] != hs[:-1]) | (ts[1:] != ts[:-1])
    best = np.fmax.reduceat(zs, np.flatnonzero(start))[np.cumsum(start) - 1]
    keep = (zs == best) | (np.isnan(zs) & np.isnan(best))
    rows = order[keep]
    return {
        "h_idx": h[rows],
        "t_idx": t[rows],
        "importance": best[keep],
        "h_type": df["h_type"][rows],
        "t_type": df["t_type"][rows],
        "rel_type": df["rel_type"][rows],
    }


def _descending(values: np.ndarray) -> np.ndarray:
    """The order of sort_values()[::-1] over a float column: quicksort of
    the non-NaN values with the NaN positions after them, reversed."""
    values = np.asarray(values, dtype=np.float64)
    nan = np.isnan(values)
    idx = np.arange(len(values))
    non_nan = idx[~nan]
    ascending = non_nan[values[~nan].argsort(kind="quicksort")]
    return np.concatenate([ascending, idx[nan]])[::-1]


def _rows_by(col: np.ndarray) -> dict:
    """value -> the rows holding it, in table order (the rows of
    ``table[table.col == value]``)."""
    codes: dict = {}
    inv = np.fromiter((codes.setdefault(v, len(codes)) for v in col.tolist()),
                      dtype=np.int64, count=len(col))
    order = np.argsort(inv, kind="stable")
    bounds = np.searchsorted(inv[order], np.arange(len(codes) + 1))
    return {v: order[bounds[i]:bounds[i + 1]] for i, v in enumerate(codes)}


def _rows(table: dict, col: str, value, index: Optional[dict]):
    if index is not None:
        return index.get(value, np.zeros(0, dtype=np.int64))
    return np.flatnonzero(_equals(table[col], value))


def get_local_interpretation(query_snp, v2g, g2g, g2p, g2v, id2idx,
                             K_neighbors, index=None):
    """Top-K neighbourhood around one hit SNP (reference utils.py:496-521):
    its K most important genes (V2G), and for each of them its K most
    important G2G, G2P and G2V edges, with QUERY_SNP; None when any step
    fails, as the reference's except does, or when the SNP has no gene
    (setting a column of the reference's empty frame raises). index: the
    tables' rows by t_idx (v2g) and t_id (the others), from _rows_by."""
    index = index or {}
    try:
        rows = _rows(v2g, "t_idx", id2idx["SNP"][query_snp],
                     index.get("v2g"))
        rows = rows[_descending(v2g["importance"][rows])][:K_neighbors]
        gene_hit = take(v2g, rows)
        gene_hit["rel_type"] = _strings(x[4:] for x in gene_hit["rel_type"])

        def topk_for(name, table, split_rel=False):
            parts = []
            for gene in gene_hit["h_id"].tolist():
                r = _rows(table, "t_id", gene, index.get(name))
                parts.append(r[_descending(table["importance"][r])]
                             [:K_neighbors])
            out = take(table, np.concatenate(parts) if parts
                        else np.zeros(0, dtype=np.int64))
            if split_rel and n_rows(out):
                out["rel_type"] = _strings(x.split("-")[1]
                                           for x in out["rel_type"])
            return out

        local = _concat([gene_hit, topk_for("g2g", g2g, split_rel=True),
                         topk_for("g2p", g2p, split_rel=True),
                         topk_for("g2v", g2v)], LOCAL_COLUMNS[:-1])
        n = n_rows(local)
        if not n:
            return None
        local["QUERY_SNP"] = np.full(n, query_snp, dtype=object)
        return local
    except Exception:
        return None


def generate_viz(
    run,
    df_network: dict,
    data_path: str,
    variant_threshold: float = 5e-8,
    magma_path: Optional[str] = None,
    magma_threshold: float = 0.05,
    program_threshold: float = 0.05,
    K_neighbors: int = 3,
    num_cpus: int = 1,
):
    """(variant interpretation, disease-critical network) column tables
    from the edge-weight table df_network (attention_tables), the run's
    kgwas_res (hits: P below variant_threshold) and its data's id maps.
    magma_path: a MAGMA gene-analysis output whose Bonferroni-significant
    genes (read through misc_data/NCBI37.3.gene.loc) filter the genes,
    and whose GSEA programs (gseapy, optional) filter the programs."""
    gwas = run.kgwas_res
    idx2id = run.data.idx2id
    id2idx = run.data.id2idx
    print_sys("Start generating disease critical network...")

    go2name = {}
    go2name_path = os.path.join(data_path, "misc_data/go2name.pkl")
    if os.path.exists(go2name_path):
        with open(go2name_path, "rb") as f:
            go2name = pickle.load(f)

    # TSS edges are positional, not functional: excluded (utils.py:535)
    rel = df_network["rel_type"]
    df_network = take(df_network, ~(_equals(rel, "TSS")
                                     | _equals(rel, "rev_TSS")))
    h_type, t_type = df_network["h_type"], df_network["t_type"]
    snp2genes = take(df_network, _equals(t_type, "SNP")
                      & _equals(h_type, "Gene"))
    gene2gene = take(df_network, _equals(t_type, "Gene")
                      & _equals(h_type, "Gene"))
    gene2go = take(df_network, _equals(t_type, "Gene")
                    & _equals(h_type, "BiologicalProcess"))

    snps = gwas["SNP"] if "SNP" in gwas else gwas["ID"]
    with np.errstate(invalid="ignore"):
        hit = np.asarray(gwas["P"], dtype=np.float64) < variant_threshold
    hit_snps = np.asarray(snps)[hit]
    hit_snps_idx = [id2idx["SNP"][i] for i in hit_snps]

    if magma_path is not None:
        print_sys("Using MAGMA genes to filter...")
        gwas_gene = _read_whitespace_table(magma_path)
        id2gene = _gene_names(
            os.path.join(data_path, "misc_data/NCBI37.3.gene.loc"))
        gwas_gene["GENE"] = _strings(id2gene[x]
                                     for x in gwas_gene["GENE"].tolist())
        corrected = bonferroni(gwas_gene["P"], alpha=magma_threshold)
        gwas_gene["corrected_p_value"] = corrected
        df_gene_hits = take(gwas_gene, corrected < magma_threshold)
        gene_hit_idx = [id2idx["Gene"][i] for i in df_gene_hits["GENE"]
                        if i in id2idx["Gene"]]
        go_hits_idx = _gsea_program_filter(
            df_gene_hits, data_path, id2idx, program_threshold)
    else:
        print_sys("No filters... Using all genes and gene programs...")
        gene_hit_idx = list(id2idx["Gene"].values())
        go_hits_idx = list(id2idx["BiologicalProcess"].values())

    bp_ids = idx2id["BiologicalProcess"]

    def program_name(go):
        return go2name[go].capitalize() if go in go2name else go

    # ---- disease-critical network: z-score within HIT subsets ----
    snp2genes_hit = take(snp2genes, _isin(snp2genes["t_idx"], hit_snps_idx)
                          & _isin(snp2genes["h_idx"], gene_hit_idx))
    snp2genes_hit = _zscore(snp2genes_hit, snp2genes_hit)
    v2g_hit = _max_over_parallel(snp2genes_hit)
    v2g_hit["rel_type"] = _strings(x[4:] for x in v2g_hit["rel_type"])
    v2g_hit["Category"] = np.full(n_rows(v2g_hit), "V2G", dtype=object)
    v2g_hit["h_id"] = _ids(idx2id["Gene"], v2g_hit["h_idx"])
    v2g_hit["t_id"] = _ids(idx2id["SNP"], v2g_hit["t_idx"])

    gene2gene_hit = take(gene2gene, _isin(gene2gene["h_idx"], gene_hit_idx)
                          & _isin(gene2gene["t_idx"], gene_hit_idx))
    gene2gene_hit = _zscore(gene2gene_hit, gene2gene_hit)
    g2g_hit = _max_over_parallel(gene2gene_hit)
    g2g_hit["rel_type"] = _strings(x.split("-")[1]
                                   for x in g2g_hit["rel_type"])
    g2g_hit["Category"] = np.full(n_rows(g2g_hit), "G2G", dtype=object)
    g2g_hit["h_id"] = _ids(idx2id["Gene"], g2g_hit["h_idx"])
    g2g_hit["t_id"] = _ids(idx2id["Gene"], g2g_hit["t_idx"])

    gene2program_hit = take(gene2go, _isin(gene2go["t_idx"], gene_hit_idx)
                             & _isin(gene2go["h_idx"], go_hits_idx))
    gene2program_hit = _zscore(gene2program_hit, gene2program_hit)
    g2p_hit = _max_over_parallel(gene2program_hit)
    g2p_hit["rel_type"] = _strings(x.split("-")[1]
                                   for x in g2p_hit["rel_type"])
    g2p_hit["Category"] = np.full(n_rows(g2p_hit), "G2P", dtype=object)
    g2p_hit["h_id"] = _strings(program_name(x) for x in
                               _ids(bp_ids, g2p_hit["h_idx"]))
    g2p_hit["t_id"] = _ids(idx2id["Gene"], g2p_hit["t_idx"])
    disease_critical_network = _concat([v2g_hit, g2g_hit, g2p_hit],
                                       NETWORK_COLUMNS)

    print_sys("Disease critical network finished generating...")
    print_sys("Generating variant interpretation networks...")

    # ---- full tables for local interpretation (stats from hit subsets,
    #      reference quirk: utils.py:643-651) ----
    v2g = _max_over_parallel(_zscore(snp2genes, snp2genes_hit))
    v2g["h_id"] = _ids(idx2id["Gene"], v2g["h_idx"])
    v2g["t_id"] = _ids(idx2id["SNP"], v2g["t_idx"])

    g2g = _max_over_parallel(_zscore(gene2gene, gene2gene_hit))
    g2g["h_id"] = _ids(idx2id["Gene"], g2g["h_idx"])
    g2g["t_id"] = _ids(idx2id["Gene"], g2g["t_idx"])
    g2g = take(g2g, g2g["h_idx"] != g2g["t_idx"])

    g2p = _max_over_parallel(_zscore(gene2go, gene2program_hit))
    g2p["h_id"] = _strings(program_name(x) for x in
                           _ids(bp_ids, g2p["h_idx"]))
    g2p["t_id"] = _ids(idx2id["Gene"], g2p["t_idx"])

    gene2snp = take(df_network, _equals(h_type, "SNP")
                     & _equals(t_type, "Gene"))
    gene2snp_hit = take(gene2snp, _isin(gene2snp["h_idx"], hit_snps_idx)
                         & _isin(gene2snp["t_idx"], gene_hit_idx))
    g2v = _max_over_parallel(_zscore(gene2snp, gene2snp_hit))
    g2v["h_id"] = _ids(idx2id["SNP"], g2v["h_idx"])
    g2v["t_id"] = _ids(idx2id["Gene"], g2v["t_idx"])

    print_sys(f"Number of hit snps: {len(hit_snps)}")
    index = {"v2g": _rows_by(v2g["t_idx"]), "g2g": _rows_by(g2g["t_id"]),
             "g2p": _rows_by(g2p["t_id"]), "g2v": _rows_by(g2v["t_id"])}
    process_func = partial(
        get_local_interpretation,
        v2g=v2g,
        g2g=g2g,
        g2p=g2p,
        g2v=g2v,
        id2idx=id2idx,
        K_neighbors=K_neighbors,
        index=index,
    )

    if num_cpus > 1:
        with multiprocessing.get_context("spawn").Pool(num_cpus) as p:
            res = list(p.imap(process_func, hit_snps))
    else:
        res = [process_func(s) for s in hit_snps]
    kept = [i for i in res if i is not None]
    df_variant_interpretation = _concat(kept, LOCAL_COLUMNS)

    return df_variant_interpretation, disease_critical_network


def _read_whitespace_table(path: str) -> dict:
    """A whitespace-separated text table with a header line (MAGMA's
    genes.out), each column integer, float or string."""
    with open(path) as f:
        header = f.readline().split()
        rows = [line.split() for line in f if line.strip()]
    cols = list(zip(*rows)) if rows else [()] * len(header)
    return {name: _parse(list(c)) for name, c in zip(header, cols)}


def _gene_names(path: str) -> dict:
    """NCBI gene id (column 1) -> gene name (column 6) of a tab-separated
    gene location file without header."""
    with open(path) as f:
        rows = [line.rstrip("\n").split("\t") for line in f if line.strip()]
    ids = _parse([r[0] for r in rows]).tolist()
    names = _parse([r[5] for r in rows]).tolist()
    return dict(zip(ids, names))


def _gsea_program_filter(df_gene_hits, data_path, id2idx, program_threshold):
    """GSEA prerank over the hit genes -> significant BP programs. gseapy
    is optional; any failure (gseapy absent among them) gives the empty
    set, as the reference's except branch does."""
    try:
        import gseapy as gp

        gene_sets = load_dict(os.path.join(data_path,
                                           "misc_data/gene_set_bp.pkl"))
        with tempfile.TemporaryDirectory() as tmp:
            rnk = os.path.join(tmp, "genes.rnk")
            with open(rnk, "w") as f:
                for gene, z in zip(df_gene_hits["GENE"].tolist(),
                                   df_gene_hits["ZSTAT"].tolist()):
                    f.write(f"{gene}\t{z!r}\n")
            gsea_results_BP = gp.prerank(
                rnk=rnk,
                gene_sets=gene_sets,
                outdir=None,
                permutation_num=100,
                min_size=2,
                max_size=1000,
                seed=42,
            ).res2d
        go_hits = gsea_results_BP[
            gsea_results_BP["NOM p-val"] < program_threshold
        ].Term.values
        if len(go_hits) <= 5:
            go_hits = gsea_results_BP.sort_values("NOM p-val")[:5].Term.values
        print_sys("Using GSEA gene programs to filter...")
        return [id2idx["BiologicalProcess"][x] for x in go_hits]
    except Exception:
        print_sys("No significant gene programs found...")
        return []
