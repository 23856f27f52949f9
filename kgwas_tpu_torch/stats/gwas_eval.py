"""GWAS hit evaluation: precision/recall against gold hit sets, and the
positional clustering of hits (host side, numpy only).

Counterpart of ``kgwas_tpu/stats/gwas_eval.py`` on column tables, for the
subsampling and simulation analyses. Sorts follow pandas' ``sort_values``
(``utils.sort_order``).
"""
from __future__ import annotations

import numpy as np

from ..utils import find_nearest, print_sys, sort_order, take, unique_in_order


def _precision(labels):
    return float(np.mean(labels)) if len(labels) else 0.0


def _by_p(res: dict, column_rsid: str) -> np.ndarray:
    """The ids of ``res`` sorted by ascending P."""
    return np.asarray(res[column_rsid])[sort_order(res["P"])]


# ---------------------------------------------------------------------------
# hit-level precision/recall
# ---------------------------------------------------------------------------

def get_precision_recall_at_N(res, hits_all, input_dim, N, column_rsid="ID",
                              thres=5e-8):
    """Smallest K whose top-K (by P) reaches recall N, by a coarse-to-fine
    search with strides 10000/1000/100/10/1."""
    eval_dict = {}
    p_sorted = _by_p(res, column_rsid)

    def recall_at(K):
        topK_true = np.intersect1d(hits_all, p_sorted[:K])
        return len(topK_true) / len(hits_all)

    K = 1
    for stride in (10000, 1000, 100, 10, 1):
        start = max(K - stride, 1) if stride != 10000 else 1
        for K in range(start, input_dim if stride == 10000 else K, stride):
            if recall_at(K) > N:
                break
        if stride == 1:
            break

    print_sys(f"PR@{int(N * 100)} is achieved when K = {K}")
    eval_dict[f"PR@{int(N * 100)}_K"] = K
    topK_true = [1 if i in hits_all else 0 for i in p_sorted[:K]]
    eval_dict[f"PR@{int(N * 100)}"] = _precision(topK_true)
    return eval_dict


def get_gwas_results(res, hits_all, input_dim, column_rsid="ID", thres=5e-8):
    """Overall and top-K precision/recall/f1."""
    eval_dict = {}
    with np.errstate(invalid="ignore"):
        hits_sub = np.asarray(res[column_rsid])[np.asarray(res["P"]) < thres]
    eval_dict["overall_recall"] = len(np.intersect1d(hits_sub, hits_all)) / len(
        hits_all
    )
    if len(hits_sub) == 0:
        eval_dict["overall_precision"] = 0
        eval_dict["overall_f1"] = 0
    else:
        eval_dict["overall_precision"] = len(
            np.intersect1d(hits_sub, hits_all)
        ) / len(hits_sub)
        denom = eval_dict["overall_recall"] + eval_dict["overall_precision"]
        eval_dict["overall_f1"] = (
            2 * eval_dict["overall_recall"] * eval_dict["overall_precision"] / denom
            if denom
            else 0
        )
    p_sorted = _by_p(res, column_rsid)
    for K in [100, 500, 1000, 5000]:
        topK_true = [1 if i in hits_all else 0 for i in p_sorted[:K]]
        eval_dict[f"precision_{K}"] = _precision(topK_true)
        eval_dict[f"recall_{K}"] = sum(topK_true) / len(hits_all)

    for N in (0.8, 0.9, 0.95):
        eval_dict.update(
            get_precision_recall_at_N(res, hits_all, input_dim, N, column_rsid, thres)
        )
    return eval_dict


# ---------------------------------------------------------------------------
# positional clustering
# ---------------------------------------------------------------------------

def get_cluster_from_gwas(df, cluster_distance_threshold=500000,
                          threshold_extend=False,
                          cluster_compare_threshold=None, verbose=True):
    """Greedy 1-D position clustering of hits per chromosome (columns
    #CHROM, POS, ID)."""
    cluster_chr_pos = {}
    cluster_chr_rs = {}

    chrom = np.asarray(df["#CHROM"])
    for chr_num in unique_in_order(chrom):
        rows = np.nonzero(chrom == chr_num)[0]
        rows = rows[sort_order(np.asarray(df["POS"])[rows])]
        pos = np.asarray(df["POS"])[rows]
        rs = np.asarray(df["ID"])[rows]

        cluster_set, cluster_set_rs = [], []
        cur_pos = pos[0]
        cur_set = [cur_pos]
        cur_set_rs = [rs[0]]

        for idx, next_pos in enumerate(pos[1:]):
            if next_pos - cur_pos < cluster_distance_threshold:
                cur_set.append(next_pos)
                cur_set_rs.append(rs[idx + 1])
                if threshold_extend:
                    cur_pos = next_pos
            else:
                cluster_set.append(cur_set)
                cluster_set_rs.append(cur_set_rs)
                cur_pos = next_pos
                cur_set = [next_pos]
                cur_set_rs = [rs[idx + 1]]
        cluster_set.append(cur_set)
        cluster_set_rs.append(cur_set_rs)
        cluster_chr_pos[chr_num] = cluster_set
        cluster_chr_rs[chr_num] = cluster_set_rs

    cluster_chr_pos_flatten = {}
    cluster_chr_cluster_idx_flatten = {}
    cluster_chr_cluster_pos2idx_flatten = {}
    for chr_num, cluster_list in cluster_chr_pos.items():
        pos_flat, idx_flat = [], []
        for idx, cluster in enumerate(cluster_list):
            pos_flat += cluster
            idx_flat += [idx] * len(cluster)
        cluster_chr_pos_flatten[chr_num] = pos_flat
        cluster_chr_cluster_idx_flatten[chr_num] = idx_flat
        cluster_chr_cluster_pos2idx_flatten[chr_num] = dict(zip(pos_flat, idx_flat))

    if verbose:
        print_sys(
            "Number of clusters: "
            + str(sum(len(j) for j in cluster_chr_pos.values()))
        )

    cluster_chr_range = {}
    if cluster_compare_threshold is not None:
        for c, clusters in cluster_chr_pos.items():
            cluster_chr_range[c] = [
                (min(x) - cluster_compare_threshold,
                 max(x) + cluster_compare_threshold)
                for x in clusters
            ]
    return (
        cluster_chr_pos,
        cluster_chr_rs,
        cluster_chr_pos_flatten,
        cluster_chr_cluster_idx_flatten,
        cluster_chr_cluster_pos2idx_flatten,
        cluster_chr_range,
    )


def get_cluster_hits_from_pred(pred_hits, threshold, lr_uni,
                               cluster_chr_pos_flatten,
                               cluster_chr_cluster_pos2idx_flatten):
    """Assign predicted hits to the nearest existing clusters. Returns
    (cluster id -> hit count, hits outside every cluster, the hits' table
    with closest_cluster, distance2cluster, include_as_cluster and
    cluster_id, the novel hits' ids)."""
    pred = set(np.asarray(pred_hits).tolist())
    keep = np.array([i in pred for i in np.asarray(lr_uni["ID"]).tolist()],
                    dtype=bool)
    df_hits = take(lr_uni, keep)
    chrom = df_hits["#CHROM"].tolist()
    pos = np.asarray(df_hits["POS"])
    closest = np.array([find_nearest(cluster_chr_pos_flatten[c], p)
                        for c, p in zip(chrom, pos)])
    df_hits["closest_cluster"] = closest
    df_hits["distance2cluster"] = np.abs(closest - pos)
    df_hits["include_as_cluster"] = df_hits["distance2cluster"] < threshold
    df_hits["cluster_id"] = np.array(
        [str(c) + "_" + str(cluster_chr_cluster_pos2idx_flatten[c][k])
         for c, k in zip(chrom, closest.tolist())], dtype=object)
    inside = df_hits["include_as_cluster"]
    ids, counts = np.unique(df_hits["cluster_id"][inside].astype(str),
                            return_counts=True)
    order = np.argsort(-counts, kind="stable")
    cluster2count = {str(ids[i]): int(counts[i]) for i in order}
    num_non_hits = int((~inside).sum())
    novel_rs_id = df_hits["ID"][~inside]
    print_sys(f"Number of predicted hits: {len(pred_hits)}")
    print_sys(
        f"Number of predicted hits not in the existing clusters: {len(novel_rs_id)}"
    )
    print_sys(f"Number of cluster hits: {len(cluster2count)}")
    return cluster2count, num_non_hits, df_hits, novel_rs_id


# ---------------------------------------------------------------------------
# cluster overlap counting
# ---------------------------------------------------------------------------

def find_overlap_clusters(query_cluster2range, gold_cluster2range):
    out = {}
    for chr_num, eval_cluster in query_cluster2range.items():
        if chr_num not in gold_cluster2range:
            continue
        gold_cluster = gold_cluster2range[chr_num]
        found = []
        for a in eval_cluster:
            for b in gold_cluster:
                if (a[0] <= b[1]) and (b[0] <= a[1]):
                    found.append((a, b))
                    break
        out[chr_num] = found
    return out


def find_non_overlap_clusters(query_cluster2range, gold_cluster2range):
    out = {}
    for chr_num, eval_cluster in query_cluster2range.items():
        gold_cluster = gold_cluster2range.get(chr_num, [])
        missing = []
        for a in eval_cluster:
            if not any((a[0] <= b[1]) and (b[0] <= a[1]) for b in gold_cluster):
                missing.append(a)
        out[chr_num] = missing
    return out


def get_cluster_count(method_hit_gwas, cluster_distance_threshold,
                      cluster_compare_threshold, threshold_extend,
                      gold_cluster_chr_range):
    (_, _, _, _, _, rng) = get_cluster_from_gwas(
        method_hit_gwas,
        cluster_distance_threshold,
        threshold_extend=threshold_extend,
        cluster_compare_threshold=cluster_compare_threshold,
        verbose=False,
    )
    total = sum(len(j) for j in gold_cluster_chr_range.values())
    set_total = sum(len(j) for j in rng.values())
    overlap_ref = 0
    overlap_query = 0
    for j in find_overlap_clusters(rng, gold_cluster_chr_range).values():
        overlap_ref += len(np.unique([set(i[1]) for i in j]))
        overlap_query += len(np.unique([set(i[0]) for i in j]))
    return {
        "set_overlap_ref": overlap_ref,
        "set_overlap_query": overlap_query,
        "set_total": set_total,
        "total_set": total,
    }


def get_pr_curve(cluster_distance_threshold, gold_label_gwas_hits,
                 method_hit_gwas, low_data_gwas_hits,
                 cluster_compare_threshold=None, method_name="gnn",
                 threshold_extend=False):
    """Set-level precision/recall of the method's clusters against the gold
    clusters, with the base GWAS ('plink') beside it."""
    if cluster_compare_threshold is None:
        cluster_compare_threshold = int(cluster_distance_threshold / 2)

    def ranges_of(hits):
        return get_cluster_from_gwas(
            hits,
            cluster_distance_threshold,
            threshold_extend=threshold_extend,
            cluster_compare_threshold=cluster_compare_threshold,
            verbose=False,
        )[5]

    gold_rng = ranges_of(gold_label_gwas_hits)

    total = sum(len(j) for j in gold_rng.values())
    base = get_cluster_count(
        low_data_gwas_hits, cluster_distance_threshold,
        cluster_compare_threshold, threshold_extend, gold_rng,
    )
    gnn = get_cluster_count(
        method_hit_gwas, cluster_distance_threshold,
        cluster_compare_threshold, threshold_extend, gold_rng,
    )

    gnn_precision = (
        gnn["set_overlap_query"] / gnn["set_total"] if gnn["set_total"] else -1
    )
    base_precision = (
        base["set_overlap_query"] / base["set_total"] if base["set_total"] else -1
    )
    return {
        "plink_precision": base_precision,
        "plink_recall": base["set_overlap_ref"] / total,
        f"{method_name}_precision": gnn_precision,
        f"{method_name}_recall": gnn["set_overlap_ref"] / total,
        "plink_set_overlap_ref": base["set_overlap_ref"],
        "plink_set_overlap_query": base["set_overlap_query"],
        "plink_set_total": base["set_total"],
        f"{method_name}_set_overlap_ref": gnn["set_overlap_ref"],
        f"{method_name}_set_overlap_query": gnn["set_overlap_query"],
        f"{method_name}_set_total": gnn["set_total"],
        "total_set": total,
    }


def get_top_k_clusters(query_rank, top_hits_k_range, cluster_distance_threshold,
                       cluster_compare_threshold, threshold_extend,
                       gold_cluster_chr_range):
    """For each target k, the smallest prefix of the ranked SNP table whose
    cluster count reaches k, coarse to fine (strides 100/10/1)."""

    def count(n):
        return get_cluster_count(
            {k: np.asarray(v)[:n] for k, v in query_rank.items()},
            cluster_distance_threshold, cluster_compare_threshold,
            threshold_extend, gold_cluster_chr_range)

    snp_k = 0
    k_to_cluster = {}
    k_to_closest_x = {}
    for k in top_hits_k_range:
        while True:
            out = count(snp_k)
            if out["set_total"] < k:
                snp_k += 100
            else:
                snp_k -= 100
                while True:
                    out = count(snp_k)
                    if out["set_total"] < k:
                        snp_k += 10
                    else:
                        closest_x = snp_k
                        closest_distance = abs(out["set_total"] - k)
                        for x in range(snp_k - 10, snp_k):
                            out = count(x)
                            if abs(out["set_total"] - k) <= closest_distance:
                                closest_x = x
                                closest_distance = abs(out["set_total"] - k)
                        break
                break
        k_to_cluster[k] = count(closest_x)
        k_to_closest_x[k] = closest_x
    return k_to_cluster, k_to_closest_x


def quantile_normalize(df_input: dict) -> dict:
    """Rank-based quantile normalization across the columns of a table:
    each value becomes the mean, over columns, of the sorted values at its
    rank."""
    cols = {k: np.asarray(v) for k, v in df_input.items()}
    sorted_cols = [np.array(sorted(v.tolist()), dtype=np.float64)
                   for v in cols.values()]
    # pandas' row mean: the columns added in order, then divided
    total = sorted_cols[0].copy()
    for c in sorted_cols[1:]:
        total += c
    rank = (total / np.float64(len(sorted_cols))).tolist()
    out = {}
    for k, v in cols.items():
        t = np.searchsorted(np.sort(v), v)
        out[k] = np.array([rank[i] for i in t])
    return out


def plot_cluster_range(chr_num, gnn_cluster_chr_range, cluster_chr_range,
                       gold_cluster_chr_range, findor_cluster_chr_range,
                       x_start=None, x_end=None, base_gwas_name="FastGWA",
                       gold_ref_name="GWAS Catalog", show=True, save_path=None):
    """Per-chromosome locus-range plot across methods: each cluster is a
    horizontal segment on its method's row. Inserts an empty entry for a
    missing chromosome into the caller's dicts, as the JAX package does.
    matplotlib is imported here; without it this raises ImportError.
    Returns the Figure."""
    import matplotlib

    if not show:
        matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    fig = plt.figure(figsize=(14, 3))
    ax = fig.add_subplot(111)

    for d in (cluster_chr_range, gnn_cluster_chr_range,
              gold_cluster_chr_range, findor_cluster_chr_range):
        if chr_num not in d:
            d[chr_num] = {}

    for i in findor_cluster_chr_range[chr_num]:
        ax.plot(i, ["FINDOR", "FINDOR"], "*-")
    for i in gnn_cluster_chr_range[chr_num]:
        ax.plot(i, ["GNN", "GNN"], "s-")
    for i in cluster_chr_range[chr_num]:
        ax.plot(i, [base_gwas_name, base_gwas_name], "^-")
    for i in gold_cluster_chr_range[chr_num]:
        ax.plot(i, [gold_ref_name, gold_ref_name], "o-")

    ax.set_xlabel("Position Index at Chromosome " + str(chr_num))
    if x_start is not None:
        ax.set_xlim([x_start, x_end])
    if save_path is not None:
        fig.savefig(save_path, bbox_inches="tight")
    if show:
        plt.show()
    return fig
