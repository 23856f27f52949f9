"""Synthetic KG + GWAS generator for tests, benchmarks and demos.

Counterpart of ``kgwas_tpu/graph/synthetic.py``: the same seeded numpy RNG
calls in the same order, so both packages build identical graphs from one
seed. Sumstats and LD-score tables come back as column tables
(``dict[str, np.ndarray]``) with the JAX package's column names, because the
port's host path runs on numpy alone.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .schema import HeteroGraph
from .transforms import standard_kg_transforms

GO_TYPES = ("CellularComponent", "BiologicalProcess", "MolecularFunction")


def _rand_edges(rng, n_src, n_dst, n_edges):
    src = rng.integers(0, n_src, size=n_edges)
    dst = rng.integers(0, n_dst, size=n_edges)
    return np.stack([src, dst]).astype(np.int64)


def make_synthetic_kg(
    n_snp: int = 200,
    n_gene: int = 60,
    n_go: int = 30,
    snp_dim: int = 20,
    gene_dim: int = 32,
    go_dim: int = 16,
    avg_degree: int = 4,
    seed: int = 0,
    apply_transforms: bool = True,
) -> HeteroGraph:
    """A seeded KG with the real schema; apply_transforms=False returns the
    raw relations, before ``standard_kg_transforms``."""
    rng = np.random.default_rng(seed)
    g = HeteroGraph()
    g.node_features["SNP"] = rng.random((n_snp, snp_dim), dtype=np.float32)
    g.node_features["Gene"] = rng.random((n_gene, gene_dim), dtype=np.float32)
    for t in GO_TYPES:
        g.node_features[t] = rng.random((n_go, go_dim), dtype=np.float32)

    g.edge_index[("SNP", "TSS", "Gene")] = _rand_edges(
        rng, n_snp, n_gene, n_snp * 1
    )
    g.edge_index[("SNP", "Enhancer-eQTL-Gene", "Gene")] = _rand_edges(
        rng, n_snp, n_gene, n_snp * avg_degree
    )
    g.edge_index[("Gene", "Gene-PPI-Gene", "Gene")] = _rand_edges(
        rng, n_gene, n_gene, n_gene * avg_degree
    )
    # this order (not GO_TYPES') fixes the RNG draws and the relation order
    for t in ("BiologicalProcess", "CellularComponent", "MolecularFunction"):
        g.edge_index[("Gene", f"Gene-memberof-{t}", t)] = _rand_edges(
            rng, n_gene, n_go, n_gene * 2
        )
    g.edge_index[
        ("BiologicalProcess", "BP-parentof-BP", "BiologicalProcess")
    ] = _rand_edges(rng, n_go, n_go, n_go * 2)

    if apply_transforms:
        g = standard_kg_transforms(g)
    return g.validate()


def make_synthetic_sumstats(
    n_snp: int,
    n_causal: Optional[int] = None,
    sample_size: int = 10000,
    seed: int = 0,
) -> dict:
    """fastGWA-shaped sumstats over the synthetic SNP set, as a column table
    with columns CHR, SNP, POS, A1, A2, N, AF1, BETA, SE, P."""
    from scipy.stats import norm

    rng = np.random.default_rng(seed + 1)
    if n_causal is None:
        n_causal = max(n_snp // 20, 1)
    z = rng.standard_normal(n_snp)
    causal_idx = rng.choice(n_snp, size=n_causal, replace=False)
    z[causal_idx] += rng.standard_normal(n_causal) * 4.0
    se = np.full(n_snp, 0.01)
    beta = z * se
    p = np.clip(2.0 * norm.sf(np.abs(z)), 1e-300, 1.0)
    return {
        "CHR": rng.integers(1, 23, size=n_snp),
        "SNP": np.array([f"rs{i}" for i in range(n_snp)], dtype=object),
        "POS": np.sort(rng.integers(1, 2_000_000, size=n_snp)),
        "A1": np.full(n_snp, "A", dtype=object),
        "A2": np.full(n_snp, "G", dtype=object),
        "N": np.full(n_snp, sample_size, dtype=np.int64),
        "AF1": rng.uniform(0.05, 0.5, size=n_snp),
        "BETA": beta,
        "SE": se,
        "P": p,
    }


def make_synthetic_ld_scores(n_snp: int, seed: int = 0):
    """(ld_scores, w_ld_scores) column tables with columns SNP and ldscore."""
    rng = np.random.default_rng(seed + 2)
    ids = np.array([f"rs{i}" for i in range(n_snp)], dtype=object)
    ld = {"SNP": ids, "ldscore": rng.uniform(1.0, 100.0, size=n_snp)}
    w_ld = {"SNP": ids, "ldscore": rng.uniform(0.5, 60.0, size=n_snp)}
    return ld, w_ld


def make_synthetic_subsample_sumstats(
    n_snp: int,
    pheno_seed: int,
    sample_size: int,
    seed: int,
    ref_n: int = 50_000,
    n_causal: Optional[int] = None,
    return_causal: bool = False,
):
    """Subsampling power-analysis sumstats, a column table with the columns
    of make_synthetic_sumstats. The trait architecture (map positions,
    allele frequencies, the causal SNPs and their effects at ref_n) is
    fixed by pheno_seed alone; the marginal z of a causal SNP scales as
    sqrt(sample_size / ref_n), and the noise draw follows
    (pheno_seed, sample_size, seed). return_causal=True also returns the
    sorted causal indices."""
    from scipy.stats import norm

    if n_causal is None:
        n_causal = max(n_snp // 100, 1)
    rng_t = np.random.default_rng(900_000 + pheno_seed)
    chrom = rng_t.integers(1, 23, size=n_snp)
    pos = np.sort(rng_t.integers(1, 2_000_000, size=n_snp))
    af = rng_t.uniform(0.05, 0.5, size=n_snp)
    causal_idx = np.sort(rng_t.choice(n_snp, size=n_causal, replace=False))
    true_z_ref = np.zeros(n_snp)
    # half discoverable (|z| ~ 7-10), half marginal (|z| ~ 3-6)
    true_z_ref[causal_idx] = (rng_t.uniform(3.0, 10.0, size=n_causal)
                              * rng_t.choice([-1.0, 1.0], size=n_causal))

    rng_s = np.random.default_rng(
        np.random.SeedSequence([7_700_000, pheno_seed, sample_size, seed]))
    z = (true_z_ref * np.sqrt(sample_size / ref_n)
         + rng_s.standard_normal(n_snp))
    se = np.full(n_snp, 0.01)
    p = np.clip(2.0 * norm.sf(np.abs(z)), 1e-300, 1.0)
    table = {
        "CHR": chrom,
        "SNP": np.array([f"rs{i}" for i in range(n_snp)], dtype=object),
        "POS": pos,
        "A1": np.full(n_snp, "A", dtype=object),
        "A2": np.full(n_snp, "G", dtype=object),
        "N": np.full(n_snp, sample_size, dtype=np.int64),
        "AF1": af,
        "BETA": z * se,
        "SE": se,
        "P": p,
    }
    if return_causal:
        return table, causal_idx
    return table
