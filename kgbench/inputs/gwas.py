"""GWAS inputs: fastGWA-shaped sumstats over the KG's SNPs (one row per SNP,
in SNP order, ids ``rs<i>``) and the two LD-score tables, as column tables
(``dict[str, np.ndarray]``) with the reference's column names.

A draw with n_causal = 0 is a pure null (z ~ N(0, 1)); otherwise n_causal
SNPs drawn without replacement get z += 4 N(0, 1), the calibration
protocol's causal arm.
"""
from __future__ import annotations

import numpy as np

from . import sub_seed


def snp_ids(n_snp: int) -> np.ndarray:
    return np.char.add("rs", np.arange(n_snp).astype(str)).astype(object)


def make_sumstats(n_snp: int, n_causal: int, sample_size: int, seed: int,
                  *tags: int) -> dict:
    """Columns CHR, SNP, POS, A1, A2, N, AF1, BETA, SE, P."""
    from scipy.stats import norm

    rng = np.random.default_rng(sub_seed(seed, 3, *tags))
    z = rng.standard_normal(n_snp)
    if n_causal:
        causal = rng.choice(n_snp, size=n_causal, replace=False)
        z[causal] += rng.standard_normal(n_causal) * 4.0
    se = np.full(n_snp, 0.01)
    return {
        "CHR": rng.integers(1, 23, size=n_snp),
        "SNP": snp_ids(n_snp),
        "POS": np.sort(rng.integers(1, 2_000_000, size=n_snp)),
        "A1": np.full(n_snp, "A", dtype=object),
        "A2": np.full(n_snp, "G", dtype=object),
        "N": np.full(n_snp, sample_size, dtype=np.int64),
        "AF1": rng.uniform(0.05, 0.5, size=n_snp),
        "BETA": z * se,
        "SE": se,
        "P": np.clip(2.0 * norm.sf(np.abs(z)), 1e-300, 1.0),
    }


def make_ld_scores(n_snp: int, seed: int):
    """(ld, w_ld): columns SNP and ldscore, uniform in [1, 100) and
    [0.5, 60)."""
    rng = np.random.default_rng(sub_seed(seed, 4))
    ids = snp_ids(n_snp)
    return ({"SNP": ids, "ldscore": rng.uniform(1.0, 100.0, size=n_snp)},
            {"SNP": ids, "ldscore": rng.uniform(0.5, 60.0, size=n_snp)})
