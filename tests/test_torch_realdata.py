"""The port's real-data path against the JAX package's, on a fabricated
bundle with the real tarball's layout (``REQUIRED_FILES``; the layout of
tests/test_realdata_bundle.py at 60 SNPs, plus the optional embedding
files: the TransE tables and the CADD CSV).

  (i)   load_kg: features bitwise, edges and relation order equal, for
        every embedding option the bundle holds and with sample_edges; the
        random fallback rows draw the JAX package's RNG stream; the edge
        pickle as lists, numpy arrays or torch tensors
  (ii)  every sumstats loader: lr_uni column by column, dtypes included
  (iii) process_gwas_file: y bitwise for the four chi branches and the five
        residual modes; the LDSC weights; all_ids and the split; with a
        duplicated SNP in the sumstats and in the LD file, and SNPs missing
        from the LD files
  (iv)  the float reader: correctly rounded (pandas' is not)
  (v)   the file:// download of the core bundle and of the example
        sumstats; offline=True and a complete bundle never download, and a
        failed download raises
  (vi)  pred after one epoch trained in both packages from the same
        parameters

The sumstats files print their floats with 6 significant digits, as GCTA
and PLINK print them, and the LD scores with 3 decimals, as LDSC prints
them: pandas reads such text exactly, so the JAX package's inputs are the
port's to the bit. (iv) holds the 17-digit case apart.
"""
import os
import pickle
import shutil
import tarfile
import urllib.error
import urllib.request

import jax
import numpy as np
import pandas as pd
import pytest
import torch

import kgwas_tpu.kgwas_data as jkd
from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData

import kgwas_tpu_torch.kgwas_data as pkd
from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.engine import params_from_jax
from kgwas_tpu_torch.utils import read_table
from torch_threads import few_torch_threads  # noqa: F401,E402

N_SNP, N_GENE, N_GO = 60, 20, 8
GO_TYPES = ["CellularComponent", "BiologicalProcess", "MolecularFunction"]
SCDRS_TRAIT = "UKB_460K.body_HEIGHTz"
BINARY_TRAIT = "body_BALDING1"


def _dump(root, rel, obj):
    p = os.path.join(root, rel)
    os.makedirs(os.path.dirname(p), exist_ok=True)
    with open(p, "wb") as f:
        pickle.dump(obj, f)


def write_bundle(root, edge_format="list"):
    """A layout-exact mini bundle under root/; returns the SNP ids. Some
    ids are missing from every embedding table (the random fallback), the
    LD files miss SNPs and repeat one (its last row wins)."""
    rng = np.random.default_rng(0)
    snp_ids = [f"rs{1000 + i}" for i in range(N_SNP)]
    gene_ids = [f"ENSG{i:011d}" for i in range(N_GENE)]
    go_ids = [f"GO:{i:07d}" for i in range(N_GO)]
    idx2id = {
        "SNP": dict(enumerate(snp_ids)),
        "Gene": dict(enumerate(gene_ids)),
        **{t: dict(enumerate(go_ids)) for t in GO_TYPES},
    }
    id2idx = {t: {v: k for k, v in m.items()} for t, m in idx2id.items()}

    def rand_edges(ns, nd, e):
        return np.stack([rng.integers(0, ns, e), rng.integers(0, nd, e)])

    edge_index = {
        ("SNP", "TSS", "Gene"): rand_edges(N_SNP, N_GENE, N_SNP),
        ("SNP", "Enhancer-eQTL-Gene", "Gene"):
            rand_edges(N_SNP, N_GENE, 2 * N_SNP),
        ("Gene", "Gene-PPI-Gene", "Gene"): rand_edges(N_GENE, N_GENE,
                                                      3 * N_GENE),
        **{("Gene", f"Gene-memberof-{t}", t):
           rand_edges(N_GENE, N_GO, 2 * N_GENE) for t in GO_TYPES},
        ("BiologicalProcess", "BP-parentof-BP", "BiologicalProcess"):
            rand_edges(N_GO, N_GO, N_GO),
    }
    _dump(root, "cell_kg/network/node_idx2id.pkl", idx2id)
    _dump(root, "cell_kg/network/node_id2idx.pkl", id2idx)
    write_edges(root, edge_index, edge_format)
    _dump(root, "cell_kg/node_emb/variant_emb/enformer_feat.pkl",
          {s: rng.standard_normal(20).astype(np.float32)
           for s in snp_ids[: N_SNP - 5]})
    _dump(root, "cell_kg/node_emb/gene_emb/esm_feat.pkl",
          {g: rng.standard_normal(5120).astype(np.float32)
           for g in gene_ids[: N_GENE - 2]})
    # TransE: one table over the ids of every node type, some left out
    kg_ids = snp_ids[3:] + gene_ids[1:] + go_ids[2:]
    _dump(root, "cell_kg/node_emb/transe_emb/transe_emb_id2idx_kg.pkl",
          {k: i for i, k in enumerate(kg_ids)})
    _dump(root, "cell_kg/node_emb/transe_emb/transe_emb_inverse_triplets.pkl",
          rng.standard_normal((len(kg_ids), 50)).astype(np.float32))
    # CADD: a CSV whose first header cell is empty, one id repeated
    cadd_ids = snp_ids[: N_SNP - 4] + [snp_ids[7]]
    cadd = pd.DataFrame(rng.standard_normal((len(cadd_ids), 64)),
                        index=cadd_ids,
                        columns=[f"c{i}" for i in range(64)])
    cadd.to_csv(os.path.join(root,
                             "cell_kg/node_emb/variant_emb/cadd_feat.csv"),
                float_format="%.6g")

    os.makedirs(os.path.join(root, "ld_score"), exist_ok=True)
    ld_ids = snp_ids[: N_SNP - 2] + [snp_ids[4]]
    pd.DataFrame({"ID": ld_ids, "ldscore": rng.uniform(1, 50, len(ld_ids))}
                 ).to_csv(os.path.join(root,
                                       "ld_score/filter_genotyped_ldscores.csv"),
                          index=False, float_format="%.3f")
    wld_ids = snp_ids[1: N_SNP - 3] + [snp_ids[9]]
    pd.DataFrame({"ID": wld_ids, "ldscore": rng.uniform(0, 20, len(wld_ids))}
                 ).to_csv(os.path.join(root, "ld_score/ldscores_from_data.csv"),
                          index=False, float_format="%.3f")
    _dump(root, "ld_score/ukb_white_ld_10MB_no_hla.pkl", {s: [] for s in snp_ids})
    _dump(root, "ld_score/ukb_white_ld_10MB.pkl", {s: [] for s in snp_ids})
    # GO names as the real ones read: commas and quotes inside
    _dump(root, "misc_data/go2name.pkl",
          {g: f'process {i}, "part" {i % 3}' for i, g in enumerate(go_ids)})
    pd.DataFrame({
        "chr": rng.integers(1, 23, N_SNP), "id": snp_ids,
        "cm": np.linspace(0, 1, N_SNP),
        "pos": np.sort(rng.integers(1, 10**8, N_SNP)),
        "a1": "A", "a2": "G",
    }).to_csv(os.path.join(root, "misc_data/ukb_white_with_cm.bim"),
              sep="\t", header=False, index=False)
    return snp_ids


def write_edges(root, edge_index, edge_format):
    conv = {"list": lambda v: np.asarray(v).tolist(),
            "array": np.asarray,
            "tensor": lambda v: torch.as_tensor(np.asarray(v))}[edge_format]
    _dump(root, "cell_kg/network/edge_index.pkl",
          {k: conv(v) for k, v in edge_index.items()})


def sumstats_frame(snp_ids, seed=1, n_extra=10):
    """fastGWA rows: the KG SNPs but the first two, 10 SNPs not in the KG
    among them, and one KG SNP twice."""
    rng = np.random.default_rng(seed)
    ids = list(snp_ids[2:]) + [f"rs9{i:04d}" for i in range(n_extra)]
    ids.append(snp_ids[10])
    ids = [ids[i] for i in rng.permutation(len(ids))]
    n = len(ids)
    return pd.DataFrame({
        "CHR": rng.integers(1, 23, n),
        "SNP": ids,
        "POS": rng.integers(1, 10**8, n),
        "A1": "A", "A2": "G", "N": 10000,
        "AF1": rng.uniform(0.05, 0.95, n),
        "BETA": rng.standard_normal(n) * 0.02,
        "SE": rng.uniform(0.01, 0.03, n),
        "P": rng.uniform(0, 1, n),
    })


def write_sumstats(path, df, sep="\t"):
    df.to_csv(path, sep=sep, index=False, float_format="%.6g")


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("bundle"))
    snp_ids = write_bundle(root)
    ss = sumstats_frame(snp_ids)
    paths = {}
    # tab-separated fastGWA, with a missing BETA (its y is 0)
    df = ss.copy()
    df.loc[3, "BETA"] = np.nan
    paths["fastgwa"] = os.path.join(root, "ss.fastGWA")
    write_sumstats(paths["fastgwa"], df)
    # the same rows comma-separated: the reader sniffs the separator
    paths["comma"] = os.path.join(root, "ss.csv")
    write_sumstats(paths["comma"], ss, sep=",")
    # P alone (chi2.ppf), with a missing P
    df = ss[["CHR", "SNP", "POS", "N", "P"]].copy()
    df.loc[5, "P"] = np.nan
    paths["p_only"] = os.path.join(root, "ss_p.txt")
    write_sumstats(paths["p_only"], df)
    # the clean file trained on
    paths["train"] = os.path.join(root, "ss_train.fastGWA")
    write_sumstats(paths["train"], ss)
    return {"root": root, "snp_ids": snp_ids, "ss": ss, "paths": paths}


def assert_same_table(got, df, what):
    """A port column table equal to a DataFrame: names in order, dtype
    kind, and every value (floats to the bit, NaN where NaN)."""
    assert list(got) == list(df.columns), what
    for c in df.columns:
        want, have = df[c].to_numpy(), np.asarray(got[c])
        assert len(have) == len(want), (what, c)
        if want.dtype.kind in "fiub":
            assert have.dtype.kind == want.dtype.kind, (what, c, have.dtype,
                                                        want.dtype)
            if want.dtype.kind == "f":
                assert np.array_equal(have.astype(np.float64).view(np.int64),
                                      want.astype(np.float64).view(np.int64)), \
                    (what, c)
            else:
                assert np.array_equal(have, want), (what, c)
        else:
            def text(v):
                return [None if isinstance(x, float) and x != x else str(x)
                        for x in v.tolist()]
            assert text(have) == text(want), (what, c)


def _both(root, **kw):
    """Both packages' KGWAS_Data on one bundle, its KG loaded."""
    j = JaxData(data_path=root, offline=True)
    p = KGWAS_Data(data_path=root, offline=True)
    j.load_kg(**kw)
    p.load_kg(**kw)
    return j, p


def _assert_same_graph(j, p):
    assert p.idx2id == j.idx2id and p.id2idx == j.id2idx
    for a in ("snp_init_dim_size", "go_init_dim_size", "gene_init_dim_size"):
        assert getattr(p, a) == getattr(j, a), a
    jg, pg = j.graph, p.graph
    assert list(pg.node_features) == list(jg.node_features)
    for t, x in jg.node_features.items():
        assert pg.node_features[t].dtype == x.dtype == np.float32
        assert np.array_equal(pg.node_features[t].view(np.int32),
                              x.view(np.int32)), t
    assert list(pg.edge_index) == list(jg.edge_index)
    for et, ei in jg.edge_index.items():
        assert np.array_equal(pg.edge_index[et], ei), et


# ------------------------------------------------------------- (i) load_kg

@pytest.mark.parametrize("snp,go,gene,sample", [
    ("enformer", "random", "esm", False),
    ("random", "random", "random", False),
    ("kg", "kg", "kg", False),
    ("cadd", "random", "esm", False),
    ("enformer", "random", "esm", True),
])
def test_load_kg_matches_jax(bundle, snp, go, gene, sample):
    """Features to the bit, including the fallback rows of the ids missing
    from each table, which consume the JAX package's single RNG stream in
    its order (SNP, the GO types, Gene, then the edge samples)."""
    j, p = _both(bundle["root"], snp_init_emb=snp, go_init_emb=go,
                 gene_init_emb=gene, sample_edges=sample,
                 sample_ratio=0.5 if sample else 1.0)
    _assert_same_graph(j, p)
    assert p.snp_init_dim_size == pkd.SNP_EMB_SPECS[snp][1]
    if sample:
        full = KGWAS_Data(data_path=bundle["root"], offline=True).load_kg()
        assert p.graph.total_edges < full.graph.total_edges


def test_fallback_rows_follow_one_rng_stream(bundle):
    """A missing node's row is rng.random(dim, float32) in node-index order
    on one default_rng(42): drawn here by hand."""
    p = KGWAS_Data(data_path=bundle["root"], offline=True)
    p.load_kg(snp_init_emb="enformer", go_init_emb="random",
              gene_init_emb="esm")
    rng = np.random.default_rng(42)
    snp = [rng.random(20, dtype=np.float32) for _ in range(5)]
    go = {t: rng.random((N_GO, 128), dtype=np.float32) for t in GO_TYPES}
    gene = [rng.random(5120, dtype=np.float32) for _ in range(2)]
    x = p.graph.node_features
    assert np.array_equal(x["SNP"][N_SNP - 5:], np.stack(snp))
    for t in GO_TYPES:
        assert np.array_equal(x[t], go[t])
    assert np.array_equal(x["Gene"][N_GENE - 2:], np.stack(gene))


@pytest.mark.parametrize("fmt", ["array", "tensor"])
def test_edge_pickle_formats(bundle, tmp_path, fmt):
    """edge_index.pkl as numpy arrays or CPU torch tensors (the reference's
    bundle) loads as the lists do, in both packages."""
    root = str(tmp_path / "b")
    shutil.copytree(bundle["root"], root)
    with open(os.path.join(root, "cell_kg/network/edge_index.pkl"), "rb") as f:
        edges = pickle.load(f)
    write_edges(root, edges, fmt)
    j, p = _both(root)
    _assert_same_graph(j, p)
    ref = KGWAS_Data(data_path=bundle["root"], offline=True).load_kg()
    _assert_same_graph(ref, p)


# -------------------------------------------------------- (ii) the loaders

def _load_both(root, method, *args, **kw):
    j, p = _both(root)
    for d in (j, p):
        getattr(d, method)(*args, **kw)
    return j, p


def _assert_same_load(j, p, what):
    assert_same_table(p.lr_uni, j.lr_uni, what)
    assert p.sample_size == j.sample_size, what
    assert (p.pheno, p.seed) == (j.pheno, j.seed), what


@pytest.mark.parametrize("name", ["fastgwa", "comma", "p_only"])
def test_load_external_gwas_matches_jax(bundle, name):
    """The rows whose SNP is in the KG, in file order (the repeated SNP
    twice); sample_size is the first kept row's N."""
    j, p = _load_both(bundle["root"], "load_external_gwas",
                      path=bundle["paths"][name], seed=3)
    _assert_same_load(j, p, name)
    assert len(p.lr_uni["ID"]) == N_SNP - 2 + 1


def test_load_external_gwas_requires_columns(bundle, tmp_path):
    path = str(tmp_path / "bad.txt")
    write_sumstats(path, bundle["ss"].drop(columns=["N"]))
    p = KGWAS_Data(data_path=bundle["root"], offline=True)
    p.load_kg()
    with pytest.raises(ValueError, match="N column"):
        p.load_external_gwas(path=path)
    with pytest.raises(ValueError, match="valid path"):
        p.load_external_gwas()


@pytest.fixture(scope="module")
def study_files(bundle, tmp_path_factory):
    """The files of the other loaders under a copy of the bundle."""
    root = str(tmp_path_factory.mktemp("studies"))
    shutil.copytree(bundle["root"], root, dirs_exist_ok=True)
    # these loaders keep every row: the studies cover the KG's SNPs (one
    # twice); process_gwas_file raises KeyError on a SNP not in the KG
    ss = bundle["ss"][bundle["ss"].SNP.isin(bundle["snp_ids"])].reset_index(
        drop=True)
    sim = os.path.join(root, "simulation_gwas")
    for sub, stem in (("causal_link_simulation",
                       "20000_1_0.3_graph_funct_v2_ggi.fastGWA"),
                      ("causal_simulation",
                       "20000_1_0.3_5000_graph_funct_v2.fastGWA"),
                      ("null_simulation", "20000_1_0.3_5000.fastGWA")):
        os.makedirs(os.path.join(sim, sub))
        df = ss.copy()
        if sub == "causal_link_simulation":   # both SNP and ID columns
            df.insert(2, "ID", df.SNP)
        write_sumstats(os.path.join(sim, sub, stem), df)
    os.makedirs(os.path.join(root, "full_gwas"))
    write_sumstats(os.path.join(root, "full_gwas",
                                "body_BMIz_with_rel_fastgwa.fastGWA"), ss)
    # scDRS: one column per trait, a trait's missing values dropped
    rng = np.random.default_rng(5)
    sc = ss[["CHR", "SNP", "POS", "A1", "A2", "N", "AF1"]].copy()
    sc[SCDRS_TRAIT] = rng.chisquare(1, len(sc))
    sc.loc[[1, 4], SCDRS_TRAIT] = np.nan
    sc["PASS_Lupus"] = rng.chisquare(1, len(sc))
    os.makedirs(os.path.join(root, "scDRS_Data"))
    sc.to_csv(os.path.join(root, "scDRS_Data/sumstats_ukb_snps.csv"),
              index=False, float_format="%.6g")
    _dump(root, "scDRS_data/trait2size.pkl", {SCDRS_TRAIT: 337000})
    # subsampled cohorts: fastGWA above 3000, PLINK linear and logistic
    sub = os.path.join(root, "subsample_gwas")
    os.makedirs(sub)
    write_sumstats(os.path.join(sub, "body_BMIz_fastgwa_full_5000_2.fastGWA"),
                   ss)
    plink = pd.DataFrame({
        "#CHROM": ss.CHR, "POS": ss.POS, "ID": ss.SNP, "REF": "A",
        "ALT": "G", "A1": "G", "TEST": "ADD", "OBS_CT": 2000,
        "BETA": ss.BETA, "SE": ss.SE, "T_STAT": ss.BETA / ss.SE, "P": ss.P})
    write_sumstats(os.path.join(sub, "body_BMIz_plink_2000_2."
                                     "PHENO1.glm.linear"), plink)
    logistic = plink.drop(columns=["BETA", "SE", "T_STAT"]).assign(
        OR=np.exp(ss.BETA), **{"LOG(OR)_SE": ss.SE, "Z_STAT": ss.BETA / ss.SE})
    logistic = logistic[[c for c in logistic.columns if c != "P"] + ["P"]]
    logistic.loc[2, "Z_STAT"] = np.nan
    write_sumstats(os.path.join(sub, f"{BINARY_TRAIT}_plink_2000_2."
                                     "PHENO1.glm.logistic.hybrid"), logistic)
    return root


LOADS = {
    "simulation-causal_link": ("load_simulation_gwas", ("causal_link", 1), {}),
    "simulation-causal": ("load_simulation_gwas", ("causal", 1), {}),
    "simulation-null": ("load_simulation_gwas", ("null", 1), {}),
    "full-scdrs": ("load_full_gwas", (SCDRS_TRAIT,), {"seed": 4}),
    "full-fastgwa": ("load_full_gwas", ("body_BMIz",), {"seed": 4}),
    "subsample-fastgwa": ("load_gwas_subsample", ("body_BMIz", 5000, 2), {}),
    "subsample-linear": ("load_gwas_subsample", ("body_BMIz", 2000, 2), {}),
    "subsample-logistic": ("load_gwas_subsample", (BINARY_TRAIT, 2000, 2),
                           {}),
}


@pytest.mark.parametrize("name", sorted(LOADS))
def test_study_loaders_match_jax(study_files, name):
    method, args, kw = LOADS[name]
    j, p = _load_both(study_files, method, *args, **kw)
    _assert_same_load(j, p, name)


def test_synthetic_subsample_loader_matches_jax(tmp_path):
    j = JaxData.from_synthetic(n_snp=300, n_gene=40, n_go=12, seed=2,
                               data_path=str(tmp_path / "j"))
    p = KGWAS_Data.from_synthetic(n_snp=300, n_gene=40, n_go=12, seed=2,
                                  data_path=str(tmp_path / "p"))
    for d in (j, p):
        d.load_synthetic_gwas_subsample(pheno_seed=7, sample_size=8000,
                                        seed=3)
    _assert_same_load(j, p, "synthetic subsample")
    assert np.array_equal(p._synth_causal_idx, j._synth_causal_idx)
    for d in (j, p):
        d.process_gwas_file()
    assert np.array_equal(p.y, j.y)


def test_pheno_lists_match_jax(bundle):
    p = KGWAS_Data(data_path=bundle["root"], offline=True)
    j = JaxData(data_path=bundle["root"], offline=True)
    assert p.get_pheno_list() == j.get_pheno_list()
    import kgwas_tpu.params as jp
    import kgwas_tpu_torch.params as pp

    names = [k for k in vars(jp) if not k.startswith("_") and k != "os"]
    assert {k: getattr(pp, k) for k in names} == {k: getattr(jp, k)
                                                  for k in names}


# ----------------------------------------------- (iii) process_gwas_file

BRANCHES = {
    # label: (loader name or external file, label mode)
    "chi-precomputed": ("full-scdrs", "chi"),
    "chi-z_stat": ("subsample-logistic", "chi"),
    "chi-beta_se": ("fastgwa", "chi"),
    "chi-p": ("p_only", "chi"),
    **{f"label-{m}": ("fastgwa", m) for m in pkd.RESIDUAL_LABELS},
}


def _processed(bundle, study_files, source, label):
    if source in LOADS:
        method, args, kw = LOADS[source]
        root = study_files
    else:
        method, args, kw = ("load_external_gwas", (),
                            {"path": bundle["paths"][source], "seed": 11})
        root = bundle["root"]
    j, p = _both(root)
    for d in (j, p):
        getattr(d, method)(*args, **kw)
        d.process_gwas_file(label=label)
        d.prepare_split()
    return j, p


@pytest.mark.parametrize("name", sorted(BRANCHES))
def test_process_gwas_file_matches_jax(bundle, study_files, name):
    """y to the bit; the added columns in the JAX package's order; the LDSC
    weights at rtol 1e-12 (float64, the same formula); all_ids and the
    split equal. The sumstats repeat a SNP, and SNPs missing from an LD
    file take its minimum (plus 1 for the data LD)."""
    j, p = _processed(bundle, study_files, *BRANCHES[name])
    assert_same_table(p.lr_uni, j.lr_uni, name)
    assert np.array_equal(np.asarray(p.y, dtype=np.float64).view(np.int64),
                          np.asarray(j.y, dtype=np.float64).view(np.int64))
    assert list(p.rs_id_to_ldsc_weight) == list(j.rs_id_to_ldsc_weight)
    np.testing.assert_allclose(list(p.rs_id_to_ldsc_weight.values()),
                               list(j.rs_id_to_ldsc_weight.values()),
                               rtol=1e-12, atol=0)
    assert np.array_equal(p.all_ids, j.all_ids)
    for m in ("train_mask", "val_mask", "test_mask"):
        assert np.array_equal(getattr(p, m), getattr(j, m)), m
    assert np.array_equal(p.graph.node_labels["SNP"],
                          j.graph.node_labels["SNP"])


def test_ld_minimum_and_duplicates(bundle):
    """The LD maps keep a repeated id's last row; a SNP missing from a file
    takes the minimum over the whole file (not over the sumstats' SNPs),
    the data LD plus 1; a SNP repeated in the sumstats gets one weight."""
    p = KGWAS_Data(data_path=bundle["root"], offline=True).load_kg()
    p.load_external_gwas(path=bundle["paths"]["fastgwa"])
    p.process_gwas_file()
    ld = pd.read_csv(os.path.join(bundle["root"],
                                  "ld_score/filter_genotyped_ldscores.csv"))
    wld = pd.read_csv(os.path.join(bundle["root"],
                                   "ld_score/ldscores_from_data.csv"))
    ids = list(p.lr_uni["ID"])
    snp_ids = bundle["snp_ids"]
    rows = {i: k for k, i in enumerate(ids)}
    # missing from the LD file: SNPs N_SNP-2.. (not in the sumstats past 2)
    missing = snp_ids[N_SNP - 2]
    assert p.lr_uni["ld_score"][rows[missing]] == ld.ldscore.min()
    missing_w = snp_ids[N_SNP - 3]
    assert p.lr_uni["w_ld_score"][rows[missing_w]] == 1 + wld.ldscore.min()
    # the repeated LD row: its last value
    assert p.lr_uni["ld_score"][rows[snp_ids[4]]] == ld.ldscore.iloc[-1]
    assert p.lr_uni["w_ld_score"][rows[snp_ids[9]]] == 1 + wld.ldscore.iloc[-1]
    dup = snp_ids[10]
    assert ids.count(dup) == 2 and len(p.rs_id_to_ldsc_weight) == len(ids) - 1


def test_unknown_label_raises(bundle):
    p = KGWAS_Data(data_path=bundle["root"], offline=True).load_kg()
    p.load_external_gwas(path=bundle["paths"]["fastgwa"])
    with pytest.raises(ValueError, match="label"):
        p.process_gwas_file(label="nope")


# ------------------------------------------------------ (iv) float reader

def test_reader_floats_are_correctly_rounded(tmp_path):
    """The port parses every float as Python's float does, the correctly
    rounded value, also with 17 significant digits. pandas' parser (both
    engines, pandas 3) is not: it keeps about 17 digits after the point,
    so 0.001257302210933933 reads thousands of ulp away. The port does not
    copy that."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(2000) * 10.0 ** rng.integers(-12, 3, 2000)
    text = [repr(float(v)) for v in x]
    path = str(tmp_path / "f.tsv")
    with open(path, "w") as f:
        f.write("v\tq\n" + "\n".join(t + "\tx" for t in text) + "\n")
    got = read_table(path, sep=None)["v"]
    want = np.array([float(s) for s in text])
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert np.array_equal(got, x)
    pd_vals = pd.read_csv(path, sep=None, engine="python").v.values
    assert (pd_vals != want).any()
    # where pandas differs, it is off by more than rounding, but it stays
    # within 1e-11 relative
    np.testing.assert_allclose(pd_vals, want, rtol=1e-11)


# ------------------------------------------------ (v) download and offline

@pytest.fixture(scope="module")
def tarball(bundle, tmp_path_factory):
    tar_path = tmp_path_factory.mktemp("tar") / "kgwas_core_data.tar.gz"
    with tarfile.open(tar_path, "w:gz") as tar:
        for name in os.listdir(bundle["root"]):
            if name in ("cell_kg", "ld_score", "misc_data"):
                tar.add(os.path.join(bundle["root"], name), arcname=name)
    return str(tar_path)


def test_download_and_extract_over_file_url(tarball, tmp_path, monkeypatch):
    monkeypatch.setattr(pkd, "CORE_DATA_URL", "file://" + tarball)
    data_dir = tmp_path / "data"
    KGWAS_Data(data_path=str(data_dir))
    for rel in pkd.REQUIRED_FILES:
        assert (data_dir / rel).exists(), rel
    assert not (data_dir / "kgwas_core_data.tar.gz").exists()
    assert pkd.REQUIRED_FILES == jkd.REQUIRED_FILES
    monkeypatch.undo()
    assert (pkd.CORE_DATA_URL, pkd.EXAMPLE_GWAS_URL) == (
        jkd.CORE_DATA_URL, jkd.EXAMPLE_GWAS_URL)


def test_example_file_over_file_url(bundle, tmp_path, monkeypatch):
    """example_file=True downloads the example sumstats into data_path once
    and loads them as the JAX package does."""
    root = str(tmp_path / "b")
    shutil.copytree(bundle["root"], root)
    monkeypatch.setattr(pkd, "EXAMPLE_GWAS_URL",
                        "file://" + bundle["paths"]["fastgwa"])
    monkeypatch.setattr(jkd, "EXAMPLE_GWAS_URL",
                        "file://" + bundle["paths"]["fastgwa"])
    j, p = _both(root)
    p.load_external_gwas(example_file=True)
    cached = os.path.join(root, pkd.EXAMPLE_GWAS_FILE)
    assert os.path.exists(cached)
    j.load_external_gwas(example_file=True)
    _assert_same_load(j, p, "example file")


def _no_network(monkeypatch):
    calls = []

    def refuse(*args, **kwargs):
        calls.append(args)
        raise urllib.error.URLError("network disabled in this test")

    monkeypatch.setattr(urllib.request, "urlopen", refuse)
    return calls


def test_offline_and_complete_bundle_never_download(bundle, tmp_path,
                                                    monkeypatch):
    calls = _no_network(monkeypatch)
    KGWAS_Data(data_path=bundle["root"])              # complete
    KGWAS_Data(data_path=str(tmp_path / "e"), offline=True)   # empty
    assert calls == []
    # an incomplete bundle, not offline: the failed download raises
    with pytest.raises(urllib.error.URLError):
        KGWAS_Data(data_path=str(tmp_path / "f"))
    assert len(calls) == 1
    assert not os.path.exists(tmp_path / "f" / "cell_kg")


# ------------------------------------------------------- (vi) one epoch

def test_one_epoch_on_the_bundle_trains_like_jax(bundle, tmp_path):
    """The kgwas_101 flow in both packages from the same parameters: one
    epoch of 16-SNP batches. pred: rtol 1e-4 with an absolute floor at 1e-4
    of the largest prediction (float32 in another summation order, then
    Adam, as tests/test_torch_train.py holds the golden pipeline); the
    pred.csv columns in the JAX package's order."""
    root = str(tmp_path / "b")
    shutil.copytree(bundle["root"], root)
    j, p = _both(root)
    for d in (j, p):
        d.load_external_gwas(path=bundle["paths"]["train"], seed=1)
        d.process_gwas_file()
        d.prepare_split()
    run = JaxKGWAS(j, exp_name="jax101", seed=1)
    run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=16, no_relu=True)
    init = jax.tree_util.tree_map(np.array, run.params)
    res = run.train(batch_size=16, epoch=1, save_best_model=False)

    port = KGWAS(p, device="cpu", exp_name="port101", seed=1)
    port.initialize_model(gnn_num_layers=2, gnn_hidden_dim=16, no_relu=True)
    port.model.load_state_dict(params_from_jax(init))
    table = port.train(batch_size=16, epoch=1)

    assert list(table) == list(res.columns)
    for c in ("ID", "ld_score", "w_ld_score", "y"):
        assert list(table[c]) == list(res[c]), c
    pred = res.pred.values
    assert np.abs(pred).max() > 0
    np.testing.assert_allclose(table["pred"], pred, rtol=1e-4,
                               atol=1e-4 * np.abs(pred).max())
    kp = table["KGWAS_P"]
    assert len(kp) == N_SNP - 2 + 1 and np.all((kp >= 0) & (kp <= 1))
    # the port's pred.csv reads back as the JAX package reads it
    back = pd.read_csv(os.path.join(root, "model", "port101", "pred.csv"),
                       sep=None, engine="python")
    assert list(back.columns) == list(res.columns)
