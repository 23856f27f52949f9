"""Independent loci of a KGWAS result table: the counting unit of the
calibration runner and the sweep.

Counterpart of ``count_loci`` (``scripts/run_calibration.py``) and
``loci_leads`` (``scripts/run_sweep.py``) on column tables
(``dict[str, np.ndarray]``). The hits below ``t_p`` are ranked by
p-value in the order of pandas' ``sort_values`` (``utils.sort_order``:
numpy's quicksort, which is not stable, so tied p-values keep pandas'
order), clumped greedily (no LD panel for these SNPs, so every clump is
one SNP) and merged into mega-clumps within 0.1 cM on a chromosome, at
1 cM per Mb of ``POS``.
"""
from __future__ import annotations

import numpy as np

from ..engine.profiling import span
from ..stats.clumps import build_clumps, get_meta_clumps
from ..utils import sort_order

# genome-wide significance, the threshold of every count
T_P = 5e-8


def _ranked_hits(res: dict, p_col: str, t_p: float) -> np.ndarray:
    """The IDs of the rows with p_col below t_p, by ascending p_col."""
    p = np.asarray(res[p_col])
    hit = p < t_p
    return np.asarray(res["ID"])[hit][sort_order(p[hit])]


@span("kgwas.loci")
def count_loci(res: dict, p_col: str, sumstats: dict, t_p: float = T_P):
    """The number of independent loci (mega-clumps) of res's hits, the map
    (CHR, SNP, POS) read from the raw sumstats table."""
    order = _ranked_hits(res, p_col, t_p)
    if not len(order):
        return 0
    bim = {0: np.asarray(sumstats["CHR"]), 1: np.asarray(sumstats["SNP"]),
           2: np.asarray(sumstats["POS"]) / 1e6}
    mega, _, _ = get_meta_clumps(build_clumps(order, {}), data_path=None,
                                 bim_df=bim)
    return len(mega)


def loci_leads(res: dict, p_col: str, t_p: float = T_P):
    """The independent loci of res's hits as sorted (chrom, lead cM) pairs,
    a mega-clump's lead being its first SNP. res carries the renamed
    sumstats' #CHROM and POS columns (``KGWAS.train``'s table does)."""
    order = _ranked_hits(res, p_col, t_p)
    if not len(order):
        return []
    ids = np.asarray(res["ID"])
    chrom = np.asarray(res["#CHROM"])
    cm = np.asarray(res["POS"]) / 1e6
    _, mega_rsids, _ = get_meta_clumps(build_clumps(order, {}),
                                       data_path=None,
                                       bim_df={0: chrom, 1: ids, 2: cm})
    # a repeated ID keeps its last row, as dict(zip(...)) does
    id2cm = dict(zip(ids.tolist(), cm.tolist()))
    id2chr = dict(zip(ids.tolist(), chrom.tolist()))
    return sorted({(int(id2chr[m[0]]), float(id2cm[m[0]]))
                   for m in mega_rsids.values()})
