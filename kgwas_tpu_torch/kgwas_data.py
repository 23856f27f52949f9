"""KGWAS_Data: the KG + GWAS sumstats data layer (host side, numpy only).

Counterpart of ``kgwas_tpu/kgwas_data.py``: the KG bundle (``__init__``
with its download of the core bundle, ``load_kg`` with every embedding
option), the sumstats loaders, ``process_gwas_file`` (the LD-score files,
every ``chi`` branch and the ``residual-*`` labels), ``prepare_split``
(scikit-learn's split, copied in numpy), ``compile`` and the synthetic
mode. The sumstats table ``lr_uni`` is a column table
(``dict[str, np.ndarray]``) with the JAX package's column names; files are
read with ``utils.read_table``, pandas' ``read_csv`` on numpy. Where the
JAX package builds a dict over rows (the LD-score maps, the LDSC weights),
the port builds the same dict, so a duplicated id keeps its last row.
"""
from __future__ import annotations

import os
import shutil
import tarfile
import urllib.request
from typing import Optional

import numpy as np

from .engine.profiling import span
from .graph.schema import HeteroGraph
from .graph.shard_compile import CompiledGraph, compile_graph
from .graph.synthetic import (
    GO_TYPES,
    make_synthetic_kg,
    make_synthetic_ld_scores,
    make_synthetic_subsample_sumstats,
    make_synthetic_sumstats,
)
from .graph.transforms import standard_kg_transforms
from .stats.ldsc import ldsc_regression_weights
from .utils import load_dict, n_rows, print_sys, read_table, rename, take

# embedding option -> (file relative to data_path, row width)
_TRANSE = "cell_kg/node_emb/transe_emb/transe_emb_inverse_triplets.pkl"
_TRANSE_ID2IDX = "cell_kg/node_emb/transe_emb/transe_emb_id2idx_kg.pkl"
SNP_EMB_SPECS = {
    "random": (None, 128),
    "kg": (_TRANSE, 50),
    "cadd": ("cell_kg/node_emb/variant_emb/cadd_feat.csv", 64),
    "baselineLD": ("cell_kg/node_emb/variant_emb/baselineld_feat.pkl", 70),
    "SLDSC": ("cell_kg/node_emb/variant_emb/sldsc_feat.pkl", 165),
    "enformer": ("cell_kg/node_emb/variant_emb/enformer_feat.pkl", 20),
}
GO_EMB_SPECS = {
    "random": (None, 128),
    "kg": (_TRANSE, 50),
    "biogpt": ("cell_kg/node_emb/program_emb/biogpt_feat.pkl", 1600),
}
GENE_EMB_SPECS = {
    "random": (None, 128),
    "kg": (_TRANSE, 50),
    "esm": ("cell_kg/node_emb/gene_emb/esm_feat.pkl", 5120),
    "pops": ("cell_kg/node_emb/gene_emb/pops_feat.pkl", 57742),
    "pops_expression": ("cell_kg/node_emb/gene_emb/pops_expression_feat.pkl",
                        40546),
}

BINARY_TRAITS = [
    "body_BALDING1",
    "cancer_BREAST",
    "disease_ALLERGY_ECZEMA_DIAGNOSED",
    "disease_HYPOTHYROIDISM_SELF_REP",
    "other_MORNINGPERSON",
    "pigment_SUNBURN",
]

CORE_DATA_URL = "https://dataverse.harvard.edu/api/access/datafile/10731230"
EXAMPLE_GWAS_URL = "https://dataverse.harvard.edu/api/access/datafile/10730346"
EXAMPLE_GWAS_FILE = "biochemistry_Creatinine_fastgwa_full_10000_1.fastGWA"

REQUIRED_FILES = [
    "cell_kg/network/node_idx2id.pkl",
    "cell_kg/network/edge_index.pkl",
    "cell_kg/network/node_id2idx.pkl",
    "cell_kg/node_emb/variant_emb/enformer_feat.pkl",
    "cell_kg/node_emb/gene_emb/esm_feat.pkl",
    "ld_score/filter_genotyped_ldscores.csv",
    "ld_score/ldscores_from_data.csv",
    "ld_score/ukb_white_ld_10MB_no_hla.pkl",
    "ld_score/ukb_white_ld_10MB.pkl",
    "misc_data/ukb_white_with_cm.bim",
]

RESIDUAL_LABELS = ("residual-w-ld", "residual-ld", "residual-ld-ols",
                   "residual-ld-ols-abs", "residual-w-ld-ols")
_GWAS_RENAME = {"CHR": "#CHROM", "SNP": "ID"}


def train_test_split(ids, y, test_size: float, seed: int):
    """(train ids, test ids, train y, test y) as scikit-learn's
    ``train_test_split(ids, y, test_size=test_size, random_state=seed)``
    gives them: a ShuffleSplit whose test part is the first
    ceil(test_size * n) of ``RandomState(seed).permutation(n)`` and whose
    train part is the rest, in permutation order."""
    n = len(ids)
    n_test = int(np.ceil(test_size * n))
    if not 0 < n_test < n:
        raise ValueError(f"test_size={test_size} leaves an empty split of "
                         f"{n} samples")
    perm = np.random.RandomState(seed).permutation(n)
    test, train = perm[:n_test], perm[n_test:]
    ids, y = np.asarray(ids), np.asarray(y)
    return ids[train], ids[test], y[train], y[test]


def _score_map(table: dict, path: str) -> dict:
    """``dict(df.values)`` of a two-column table (id, score): the last row
    of a repeated id wins."""
    if len(table) != 2:
        raise ValueError(f"{path}: {len(table)} columns, an LD-score file "
                         f"has two (id, score)")
    keys, values = table.values()
    return dict(zip(np.asarray(keys).tolist(), np.asarray(values).tolist()))


def _fillna0(y: np.ndarray) -> np.ndarray:
    return np.where(np.isnan(y), 0.0, y)


class KGWAS_Data:
    def __init__(self, data_path: str = "./data/", offline: bool = False):
        """A bundle under data_path. When one of REQUIRED_FILES is missing
        and offline is False, the core bundle is downloaded and extracted
        there first; a complete bundle, or offline=True, never downloads."""
        self.data_path = data_path
        os.makedirs(data_path, exist_ok=True)
        self.graph: Optional[HeteroGraph] = None
        self.compiled: Optional[CompiledGraph] = None
        self._synthetic = False

        missing = [f for f in REQUIRED_FILES
                   if not os.path.exists(os.path.join(data_path, f))]
        if missing and not offline:
            print_sys("Relevant data not found in the data_path. "
                      "Downloading and extracting data...")
            self._download_and_extract_data(CORE_DATA_URL, "kgwas_core_data")
        elif not missing:
            print_sys("All required data files are present.")

    def download_all_data(self):
        """Download the full ~55 GB bundle (the upstream URL is a
        placeholder, as in the JAX package)."""
        url = "https://dataverse.harvard.edu/api/access/datafile/XXXX"
        self._download_and_extract_data(url, "kgwas_data")

    # -- download helpers ---------------------------------------------------

    def _download_with_progress(self, url, file_path):
        request = urllib.request.Request(url,
                                         headers={"User-Agent": "Mozilla/5.0"})
        response = urllib.request.urlopen(request)
        # response.headers serves http(s) and file:// responses alike
        total = int(str(response.headers.get("Content-Length", "0")).strip()
                    or 0)
        block = 1024 * 64
        done = 0
        with open(file_path, "wb") as f:
            while True:
                buf = response.read(block)
                if not buf:
                    break
                f.write(buf)
                done += len(buf)
                if total:
                    print_sys(f"download {done / total:.1%}")

    def _download_and_extract_data(self, url, file_name):
        tar_path = os.path.join(self.data_path, f"{file_name}.tar.gz")
        self._download_with_progress(url, tar_path)
        with tarfile.open(tar_path, "r:gz") as tar:
            # the 'data' filter rejects absolute paths and links leaving
            # data_path
            tar.extractall(self.data_path, filter="data")
        os.remove(tar_path)
        extracted = os.path.join(self.data_path, file_name)
        if os.path.exists(extracted):
            for root, _, files in os.walk(extracted):
                rel = os.path.relpath(root, extracted)
                dst_dir = os.path.join(self.data_path, rel)
                os.makedirs(dst_dir, exist_ok=True)
                for fn in files:
                    dst = os.path.join(dst_dir, fn)
                    if not os.path.exists(dst):
                        shutil.move(os.path.join(root, fn), dst)
            shutil.rmtree(extracted)

    # -- KG loading ---------------------------------------------------------

    def _build_features(self, node_map, feat_lookup, dim, rng):
        """[n, dim] float32 rows in node-index order: a node's table row, or
        for a node missing from the table ``rng.random(dim, float32)``.
        The missing rows are drawn at once, which gives the values of one
        draw per node in index order."""
        rows = np.empty((len(node_map), dim), dtype=np.float32)
        missing = []
        for i in range(len(node_map)):
            vec = feat_lookup(node_map[i])
            if vec is None:
                missing.append(i)
            else:
                rows[i] = np.asarray(vec, dtype=np.float32)
        if missing:
            rows[missing] = rng.random((len(missing), dim), dtype=np.float32)
            print_sys(f"  {len(missing)}/{len(node_map)} nodes got random "
                      f"fallback rows")
        return rows

    def _node_features(self, node_maps, option, specs, rng):
        """{node type: rows} for node types sharing one embedding option,
        drawing from rng in the order of node_maps. Returns (rows, dim)."""
        path, dim = specs[option]
        if option == "random":
            return ({t: rng.random((len(m), dim), dtype=np.float32)
                     for t, m in node_maps.items()}, dim)
        full = os.path.join(self.data_path, path)
        if option == "kg":
            id2idx_kg = load_dict(os.path.join(self.data_path, _TRANSE_ID2IDX))
            kg_emb = load_dict(full)

            def lookup(nid):
                return kg_emb[id2idx_kg[nid]] if nid in id2idx_kg else None
        else:
            if option == "cadd":
                # a CSV whose first header cell is empty: the row ids
                cols = read_table(full, sep=",")
                keys = cols.pop("Unnamed: 0")
                values = np.column_stack(
                    [np.asarray(v, dtype=np.float64) for v in cols.values()])
                table = dict(zip(keys.tolist(), values))
            else:
                table = load_dict(full)
            lookup = table.get
        return ({t: self._build_features(m, lookup, dim, rng)
                 for t, m in node_maps.items()}, dim)

    def load_kg(
        self,
        snp_init_emb: str = "enformer",
        go_init_emb: str = "random",
        gene_init_emb: str = "esm",
        sample_edges: bool = False,
        sample_ratio: float = 1.0,
        rng_seed: int = 42,
    ):
        """The bundle's KG with the node features of the chosen embedding
        options. One ``np.random.default_rng(rng_seed)`` gives, in this
        order: the SNP rows (the random table, or the fallback rows), the
        three GO types in GO_TYPES order, Gene, then each relation's
        edge-sampling permutation in edge_index.pkl's order."""
        data_path = self.data_path
        print_sys("--loading KG---")
        idx2id = load_dict(os.path.join(data_path,
                                        "cell_kg/network/node_idx2id.pkl"))
        edge_index_all = load_dict(os.path.join(
            data_path, "cell_kg/network/edge_index.pkl"))
        id2idx = load_dict(os.path.join(data_path,
                                        "cell_kg/network/node_id2idx.pkl"))
        self.id2idx = id2idx
        self.idx2id = idx2id

        rng = np.random.default_rng(rng_seed)
        g = HeteroGraph()
        for types, option, specs, attr in (
                (("SNP",), snp_init_emb, SNP_EMB_SPECS, "snp_init_dim_size"),
                (GO_TYPES, go_init_emb, GO_EMB_SPECS, "go_init_dim_size"),
                (("Gene",), gene_init_emb, GENE_EMB_SPECS,
                 "gene_init_dim_size")):
            rows, dim = self._node_features({t: idx2id[t] for t in types},
                                            option, specs, rng)
            g.node_features.update(rows)
            setattr(self, attr, dim)

        for et, ei in edge_index_all.items():
            # lists, numpy arrays or CPU torch tensors
            ei = np.asarray(ei, dtype=np.int64)
            if sample_edges:
                e = ei.shape[1]
                k = int(e * sample_ratio)
                idx = rng.permutation(e)[:k]
                print_sys(f"{et} sampling ratio {sample_ratio} from {e} to {k}")
                ei = ei[:, idx]
            g.edge_index[tuple(et)] = ei

        g = standard_kg_transforms(g)
        self.graph = g.validate()
        self.compiled = None
        return self

    # -- synthetic mode (tests, demos, chip_smoke.py) -----------------------

    @classmethod
    def from_synthetic(
        cls,
        n_snp: int = 500,
        n_gene: int = 100,
        n_go: int = 40,
        seed: int = 42,
        data_path: str = "./data_synth/",
        **kg_kwargs,
    ) -> "KGWAS_Data":
        self = cls(data_path=data_path, offline=True)
        self._synthetic = True
        g = make_synthetic_kg(n_snp=n_snp, n_gene=n_gene, n_go=n_go,
                              seed=seed, **kg_kwargs)
        self.graph = g
        self.snp_init_dim_size = g.feature_dim("SNP")
        self.gene_init_dim_size = g.feature_dim("Gene")
        self.go_init_dim_size = g.feature_dim("BiologicalProcess")
        snp_ids = [f"rs{i}" for i in range(n_snp)]
        gene_ids = [f"G{i}" for i in range(n_gene)]
        go_ids = [f"GO{i}" for i in range(n_go)]
        self.idx2id = {
            "SNP": dict(enumerate(snp_ids)),
            "Gene": dict(enumerate(gene_ids)),
            **{t: dict(enumerate(go_ids)) for t in GO_TYPES},
        }
        self.id2idx = {
            t: {v: k for k, v in m.items()} for t, m in self.idx2id.items()
        }
        self._synth_sumstats = make_synthetic_sumstats(n_snp, seed=seed)
        self._synth_ld, self._synth_w_ld = make_synthetic_ld_scores(
            n_snp, seed=seed)
        return self

    @span("kgwas.data.load_gwas")
    def load_synthetic_gwas(self, seed: int = 42):
        if not self._synthetic:
            raise ValueError("only valid for from_synthetic data")
        self.lr_uni = rename({k: np.array(v, copy=True)
                              for k, v in self._synth_sumstats.items()},
                             _GWAS_RENAME)
        self.sample_size = int(self.lr_uni["N"][0])
        self.pheno = "SYNTHETIC"
        self.seed = seed
        return self

    # -- GWAS sumstats loaders ----------------------------------------------

    @span("kgwas.data.load_gwas")
    def load_external_gwas(self, path=None, seed=42, example_file=False):
        """A sumstats file of any delimiter (sniffed) with CHR, SNP, P and N
        columns; the rows whose SNP is in the KG are kept, in file order.
        example_file=True reads the example sumstats, downloaded into
        data_path when it is not there."""
        if example_file:
            example_path = os.path.join(self.data_path, EXAMPLE_GWAS_FILE)
            if not os.path.exists(example_path):
                print_sys("Example file not found locally. Downloading...")
                self._download_with_progress(EXAMPLE_GWAS_URL, example_path)
            path = example_path
        if path is None:
            raise ValueError("A valid path must be provided or example_file "
                             "must be set to True.")
        print_sys(f"Loading GWAS file from {path}...")
        lr_uni = read_table(path, sep=None)
        for col in ("CHR", "SNP", "P", "N"):
            if col not in lr_uni:
                raise ValueError(f"{col} column not in the file!")
        lr_uni = rename(lr_uni, _GWAS_RENAME)

        old_len = n_rows(lr_uni)
        kg_snps = set(self.idx2id["SNP"].values())
        keep = np.fromiter((i in kg_snps for i in lr_uni["ID"].tolist()),
                           dtype=bool, count=old_len)
        lr_uni = take(lr_uni, keep)
        print_sys(f"Number of SNPs in the KG: {len(self.idx2id['SNP'])}")
        print_sys(f"Number of SNPs in the GWAS: {old_len}")
        print_sys(f"Number of SNPs in the KG variant set: {n_rows(lr_uni)}")

        self.lr_uni = lr_uni
        # the first kept row's N, not their mean
        self.sample_size = lr_uni["N"][0]
        self.pheno = "EXTERNAL"
        self.seed = seed

    @span("kgwas.data.load_gwas")
    def load_simulation_gwas(self, simulation_type, seed):
        """The simulation sumstats of the bundle's simulation_gwas/."""
        print_sys("Using simulation data....")
        small_cohort = 5000
        num_causal_hits = 20000
        heritability = 0.3
        self.sample_size = small_cohort
        stem = f"{num_causal_hits}_{seed}_{heritability}"
        names = {
            "causal_link": "causal_link_simulation/"
                           f"{stem}_graph_funct_v2_ggi.fastGWA",
            "causal": "causal_simulation/"
                      f"{stem}_{small_cohort}_graph_funct_v2.fastGWA",
            "null": f"null_simulation/{stem}_{small_cohort}.fastGWA",
        }
        if simulation_type not in names:
            raise ValueError(f"unknown simulation_type {simulation_type!r}")
        lr_uni = read_table(os.path.join(
            self.data_path, "simulation_gwas", names[simulation_type]))
        if "SNP" in lr_uni and "ID" in lr_uni:
            self.lr_uni = rename(lr_uni, {"CHR": "#CHROM"})
        else:
            self.lr_uni = rename(lr_uni, _GWAS_RENAME)
        self.seed = seed
        self.pheno = "simulation"

    @span("kgwas.data.load_gwas")
    def load_full_gwas(self, pheno, seed=42):
        """A full-cohort GWAS: an scDRS trait's column of the scDRS sumstats
        (its rows without a value dropped), or the trait's fastGWA file."""
        from .params import scdrs_traits

        data_path = self.data_path
        self.pheno = pheno
        self.seed = seed
        if pheno in scdrs_traits:
            print_sys("Using scdrs traits...")
            # the sumstats live under scDRS_Data/ but the sizes under
            # scDRS_data/: both paths are the reference's, kept as they are
            table = read_table(os.path.join(
                data_path, "scDRS_Data/sumstats_ukb_snps.csv"), sep=",")
            cols = ["CHR", "SNP", "POS", "A1", "A2", "N", "AF1", pheno]
            lr_uni = {k: table[k] for k in cols}
            value = lr_uni[pheno]
            present = (~np.isnan(value) if value.dtype.kind == "f"
                       else np.array([v == v for v in value.tolist()],
                                     dtype=bool))
            lr_uni = rename(take(lr_uni, present),
                            {"CHR": "#CHROM", "SNP": "ID", pheno: "chi"})
            self.lr_uni = lr_uni
            trait2size = load_dict(os.path.join(data_path,
                                                "scDRS_data/trait2size.pkl"))
            self.sample_size = trait2size[pheno]
        else:
            lr_uni = read_table(os.path.join(
                data_path, f"full_gwas/{pheno}_with_rel_fastgwa.fastGWA"))
            self.lr_uni = rename(lr_uni, _GWAS_RENAME)
            self.sample_size = 387113

    @span("kgwas.data.load_gwas")
    def load_gwas_subsample(self, pheno, sample_size, seed):
        """A subsampled-cohort GWAS: fastGWA above 3000 samples, else PLINK
        (logistic for the binary traits), whose columns keep PLINK's
        names."""
        binary = pheno in BINARY_TRAITS
        self.sample_size = sample_size
        self.pheno = pheno
        if sample_size > 3000:
            fp = os.path.join(
                self.data_path, "subsample_gwas/"
                f"{pheno}_fastgwa_full_{sample_size}_{seed}.fastGWA")
            lr_uni = rename(read_table(fp), _GWAS_RENAME)
        else:
            suffix = ("PHENO1.glm.logistic.hybrid" if binary
                      else "PHENO1.glm.linear")
            fp = os.path.join(
                self.data_path,
                f"subsample_gwas/{pheno}_plink_{sample_size}_{seed}.{suffix}")
            lr_uni = read_table(fp)
        self.lr_uni = lr_uni
        self.seed = seed

    @span("kgwas.data.load_gwas")
    def load_synthetic_gwas_subsample(self, pheno_seed, sample_size, seed,
                                      ref_n=50_000):
        """Synthetic counterpart of load_gwas_subsample: the trait's
        architecture fixed by pheno_seed, its power growing with
        sample_size, fresh noise per seed
        (graph/synthetic.make_synthetic_subsample_sumstats)."""
        if not self._synthetic:
            raise ValueError("only valid for from_synthetic data")
        table, causal = make_synthetic_subsample_sumstats(
            len(self.idx2id["SNP"]), pheno_seed=pheno_seed,
            sample_size=sample_size, seed=seed, ref_n=ref_n,
            return_causal=True)
        self.lr_uni = rename(table, _GWAS_RENAME)
        self.sample_size = sample_size
        self.pheno = f"synthetic_{pheno_seed}"
        self.seed = seed
        self._synth_causal_idx = causal
        return self

    # -- labels and splits --------------------------------------------------

    def _ld_tables(self):
        if self._synthetic:
            return self._synth_ld, self._synth_w_ld
        paths = [os.path.join(self.data_path, "ld_score", f)
                 for f in ("filter_genotyped_ldscores.csv",
                           "ldscores_from_data.csv")]
        return tuple(read_table(p, sep=",") for p in paths)

    @span("kgwas.data.process_gwas_file")
    def process_gwas_file(self, label: str = "chi"):
        """LDSC weights and the regression label of every sumstats row.
        Adds the columns ld_score, w_ld_score (the data LD score plus 1),
        then ld_weight (residual labels), then y to lr_uni. A SNP missing
        from an LD-score file takes that file's minimum score."""
        if label != "chi" and label not in RESIDUAL_LABELS:
            raise ValueError(f"unknown label mode {label!r}")
        lr_uni = self.lr_uni
        ld_scores, w_ld_scores = self._ld_tables()
        ids = lr_uni["ID"].tolist()

        m = 15000000
        if "N" not in lr_uni:
            n = self.sample_size
        elif lr_uni["N"].dtype.kind == "f":
            n = np.nanmean(lr_uni["N"])     # pandas' mean skips NaN
        else:
            n = np.mean(lr_uni["N"])
        h_g_2 = 0.5

        ld_map = _score_map(ld_scores, "filter_genotyped_ldscores.csv")
        # the minimum over the whole file, not over the sumstats' SNPs
        min_ld = min(ld_map.values())
        lr_uni["ld_score"] = np.array([ld_map.get(x, min_ld) for x in ids])
        w_map = _score_map(w_ld_scores, "ldscores_from_data.csv")
        min_ld = min(w_map.values())
        # the data LD excludes the query SNP itself, so add 1
        lr_uni["w_ld_score"] = 1 + np.array([w_map.get(x, min_ld)
                                             for x in ids])

        print_sys("Using ldsc weight...")
        ld = np.asarray(lr_uni["ld_score"], dtype=np.float64)
        w_ld = np.asarray(lr_uni["w_ld_score"], dtype=np.float64)
        ldsc_weight = ldsc_regression_weights(ld, w_ld, n, m, h_g_2)
        ldsc_weight = ldsc_weight / np.mean(ldsc_weight)
        # a repeated SNP keeps its last row's weight
        self.rs_id_to_ldsc_weight = dict(zip(ids, ldsc_weight))

        if label == "chi":
            if "chi" in lr_uni:
                print_sys("chi pre-computed...")
                y = np.asarray(lr_uni["chi"])
            elif self.pheno in BINARY_TRAITS and self.sample_size <= 3000:
                y = _fillna0(np.asarray(lr_uni["Z_STAT"]) ** 2)
            elif "BETA" in lr_uni and "SE" in lr_uni:
                with np.errstate(divide="ignore", invalid="ignore"):
                    y = _fillna0((np.asarray(lr_uni["BETA"])
                                  / np.asarray(lr_uni["SE"])) ** 2)
            else:
                from scipy.stats import chi2

                y = _fillna0(chi2.ppf(1 - np.asarray(lr_uni["P"]), 1))
        else:
            from .stats.labels import residual_label

            lr_uni["ld_weight"] = np.array(
                [self.rs_id_to_ldsc_weight[x] for x in ids])
            y = residual_label(lr_uni, label)
        lr_uni["y"] = y

        snp_idx = self.id2idx["SNP"]
        self.all_ids = np.array([snp_idx[i] for i in ids])
        self.y = y
        self.lr_uni = lr_uni

    @span("kgwas.data.prepare_split")
    def prepare_split(self, test_set_fraction_data: float = 0.05):
        """The JAX package's double split with the run seed: test off all
        SNPs, then val off the remaining train ids, each as scikit-learn's
        ``train_test_split(..., random_state=self.seed)`` draws it."""
        train_val_ids, test_ids, y_train_val, y_test = train_test_split(
            self.all_ids, self.y, test_set_fraction_data, self.seed)
        train_ids, val_ids, y_train, y_val = train_test_split(
            train_val_ids, y_train_val, 0.05, self.seed)

        self.train_input_nodes = ("SNP", train_ids)
        self.val_input_nodes = ("SNP", val_ids)
        self.test_input_nodes = ("SNP", test_ids)

        y_snp = np.zeros(self.graph.num_nodes("SNP"), dtype=np.float32) - 1
        y_snp[train_ids] = y_train
        y_snp[val_ids] = y_val
        y_snp[test_ids] = y_test
        self.graph.node_labels["SNP"] = y_snp

        self.train_mask = train_ids
        self.val_mask = val_ids
        self.test_mask = test_ids
        self.all_mask = self.all_ids

    def compile(self, edge_pad_multiple: int = 512,
                node_pad_multiple: int = 512, force: bool = False):
        """Static-shape compiled graph; node rows padded to a multiple of
        512, the merged layout's tile."""
        if self.compiled is None or force:
            with span("kgwas.data.compile"):
                self.compiled = compile_graph(
                    self.graph,
                    edge_pad_multiple=edge_pad_multiple,
                    node_pad_multiple=node_pad_multiple,
                )
        return self.compiled

    def get_pheno_list(self):
        from .params import indep_traits_21, scdrs_traits

        return {"large_cohort": scdrs_traits, "21_indep_traits": indep_traits_21}
