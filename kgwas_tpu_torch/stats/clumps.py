"""LD-clump benchmark machinery (host side, numpy only).

Counterpart of ``kgwas_tpu/stats/clumps.py`` on column tables: clumps of
ranked hits from precomputed LD dictionaries, their merge into mega-clumps
within 0.1 cM on a chromosome, top-K query clumps, and precision/recall
curves. The .bim table has the integer column names of a header-less read
(``utils.read_table(path, header=None)``).
"""
from __future__ import annotations

from copy import copy
from typing import List, Optional

import numpy as np

from ..utils import load_dict, read_table, sort_order, unique_in_order


def _load_ld_dict(data_path: str, no_hla: bool, snp2ld_snps: Optional[dict]):
    if snp2ld_snps:
        return snp2ld_snps
    name = "ld_score/ukb_white_ld_10MB_no_hla.pkl" if no_hla else \
        "ld_score/ukb_white_ld_10MB.pkl"
    return load_dict(data_path + name)


def build_clumps(snp_hits, snp2ld_snps) -> List[List[str]]:
    """Greedy clumps over ranked SNP hits: each hit not yet in a clump
    founds one, itself and the SNPs in LD with it."""
    clumps = []
    snps_in_clumps = set()
    for snp in snp_hits:
        if snp in snps_in_clumps:
            continue
        if snp in snp2ld_snps:
            clumps.append([snp] + list(snp2ld_snps[snp]))
            snps_in_clumps.update(snp2ld_snps[snp])
            snps_in_clumps.add(snp)
        else:
            clumps.append([snp])
            snps_in_clumps.add(snp)
    return clumps


def get_clumps_gold_label(
    data_path, gold_label_gwas, t_p=5e-8, no_hla=False, column="P",
    snp2ld_snps=None,
):
    """Gold clumps of the hits below t_p, ranked by ``column``."""
    snp2ld_snps = _load_ld_dict(data_path, no_hla, snp2ld_snps)
    values = np.asarray(gold_label_gwas[column])
    with np.errstate(invalid="ignore"):
        hit = values < t_p
    order = sort_order(values[hit])
    snp_hits = np.asarray(gold_label_gwas["SNP"])[hit][order]
    return build_clumps(snp_hits, snp2ld_snps)


def get_meta_clumps(clumps, data_path, bim_df: Optional[dict] = None):
    """Merge clumps within 0.1 cM on the same chromosome into mega-clumps
    (independent loci). Returns (mega-clump -> clump names, mega-clump ->
    rsids, mega-clump -> chromosome)."""
    if bim_df is None:
        bim_df = read_table(data_path + "misc_data/ukb_white_with_cm.bim",
                            sep="\t", header=None)
    snp2cm = dict(zip(np.asarray(bim_df[1]).tolist(),
                      np.asarray(bim_df[2]).tolist()))
    snp2chr = dict(zip(np.asarray(bim_df[1]).tolist(),
                       np.asarray(bim_df[0]).tolist()))

    names = [f"Clump {i}" for i in range(len(clumps))]
    idx2clump = dict(zip(names, clumps))
    idx2clump_chrom = {n: snp2chr[c[0]] for n, c in zip(names, clumps)}
    cm = [snp2cm[c[0]] for c in clumps]
    cm_min = [min(snp2cm[s] for s in c) for c in clumps]
    cm_max = [max(snp2cm[s] for s in c) for c in clumps]
    chroms = np.array([idx2clump_chrom[n] for n in names], dtype=object)

    all_mega_clump_across_chr = []
    for chrom in unique_in_order(chroms):
        rows = np.nonzero(chroms == chrom)[0]
        # the clump table is an object column in pandas: sort it as one
        rows = rows[sort_order(np.array([cm[i] for i in rows], dtype=object))]
        all_mega = []
        cur = []
        base_cm = 0
        for i in rows:
            if (cm_min[i] - base_cm) < 0.1:
                cur.append(names[i])
                base_cm = cm_max[i]
            else:
                all_mega.append(cur)
                base_cm = cm_max[i]
                cur = [names[i]]
        all_mega.append(cur)
        # the first group is empty iff the first clump started a new group
        if len(all_mega[0]) == 0:
            all_mega_clump_across_chr += all_mega[1:]
        else:
            all_mega_clump_across_chr += all_mega

    def flatten(groups):
        return [item for sub in groups for item in sub]

    idx2mega = {
        f"Mega-Clump {i}": c for i, c in enumerate(all_mega_clump_across_chr)
    }
    idx2mega_rsid = {
        f"Mega-Clump {i}": flatten([idx2clump[j] for j in c])
        for i, c in enumerate(all_mega_clump_across_chr)
    }
    idx2mega_chrom = {
        f"Mega-Clump {i}": idx2clump_chrom[c[0]]
        for i, c in enumerate(all_mega_clump_across_chr)
    }
    return idx2mega, idx2mega_rsid, idx2mega_chrom


def get_mega_clump_query(
    data_path, clumps, snp_hits, no_hla=False, snp2ld_snps=None,
    bim_df: Optional[dict] = None,
):
    """Top-K query clumps of a ranked SNP list, K = max(3 |gold|, 100),
    merged into mega-clumps."""
    snp2ld_snps = _load_ld_dict(data_path, no_hla, snp2ld_snps)
    clumps_pred = []
    snps_in_clumps_pred = set()
    K = max(len(clumps) * 3, 100)
    for snp in snp_hits:
        if len(clumps_pred) >= K:
            break
        if snp in snps_in_clumps_pred:
            continue
        if snp in snp2ld_snps:
            clumps_pred.append([snp] + list(snp2ld_snps[snp]))
            snps_in_clumps_pred.update(snp2ld_snps[snp])
            snps_in_clumps_pred.add(snp)
        else:
            clumps_pred.append([snp])
            snps_in_clumps_pred.add(snp)
    return get_meta_clumps(clumps_pred, data_path, bim_df=bim_df)


def get_curve(mega_clump_pred, mega_clump_gold):
    """Recall and precision at each k over the predicted mega-clumps against
    the gold ones."""
    recall_k = {}
    precision_k = {}
    found_clump_idx = []
    clump_idx_record = {}
    pred_has_hit = 0
    for k, query_clump in enumerate(mega_clump_pred):
        k += 1
        overlaps_any = False
        for clump_idx, clump in enumerate(mega_clump_gold):
            if len(np.intersect1d(query_clump, clump)) > 0:
                if clump_idx not in found_clump_idx:
                    found_clump_idx.append(clump_idx)
                overlaps_any = True
        clump_idx_record[k] = copy(found_clump_idx)
        if overlaps_any:
            pred_has_hit += 1
        recall_k[k] = len(found_clump_idx) / len(mega_clump_gold)
        precision_k[k] = pred_has_hit / k
    return recall_k, precision_k, clump_idx_record


def get_prec_recall(pred_hits, gold_hits):
    recall = len(np.intersect1d(pred_hits, gold_hits)) / len(gold_hits)
    precision = (
        len(np.intersect1d(pred_hits, gold_hits)) / len(pred_hits)
        if len(pred_hits)
        else 0
    )
    return {"recall": recall, "precision": precision}
