"""KGWAS_Data: the KG + GWAS sumstats data layer (host side, numpy only).

Counterpart of ``kgwas_tpu/kgwas_data.py`` for the serving and training
slices: ``from_synthetic``, ``load_synthetic_gwas``, ``process_gwas_file``
(the ``label="chi"`` path), ``prepare_split`` (scikit-learn's split,
copied in numpy) and ``compile``. The sumstats table ``lr_uni`` is a
column table (``dict[str, np.ndarray]``) with the JAX package's column
names; lookups by SNP id run through sorted numpy keys.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from .graph.schema import HeteroGraph
from .graph.shard_compile import CompiledGraph, compile_graph
from .graph.synthetic import (
    GO_TYPES,
    make_synthetic_kg,
    make_synthetic_ld_scores,
    make_synthetic_sumstats,
)
from .stats.ldsc import ldsc_regression_weights
from .utils import print_sys

BINARY_TRAITS = [
    "body_BALDING1",
    "cancer_BREAST",
    "disease_ALLERGY_ECZEMA_DIAGNOSED",
    "disease_HYPOTHYROIDISM_SELF_REP",
    "other_MORNINGPERSON",
    "pigment_SUNBURN",
]

_LOADERS = "ROADMAP.md Queue 1 item 9 (real-data loaders)"


def lookup(keys, values, query, default=None):
    """values[keys == q] for each q in query, as ``dict(zip(keys, values))``
    would give it (the last of duplicate keys wins). A query missing from
    keys gets ``default``, or raises KeyError when default is None."""
    keys = np.asarray(keys).astype(str)[::-1]
    values = np.asarray(values)[::-1]
    uniq, first = np.unique(keys, return_index=True)
    uvals = values[first]
    query = np.asarray(query).astype(str)
    if len(uniq) == 0:
        pos = np.zeros(len(query), dtype=np.int64)
        hit = np.zeros(len(query), dtype=bool)
    else:
        pos = np.minimum(np.searchsorted(uniq, query), len(uniq) - 1)
        hit = uniq[pos] == query
    if not hit.all():
        if default is None:
            raise KeyError(query[~hit][0])
        return np.where(hit, uvals[pos] if len(uniq) else default, default)
    return uvals[pos]


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


class KGWAS_Data:
    def __init__(self, data_path: str = "./data/"):
        self.data_path = data_path
        os.makedirs(data_path, exist_ok=True)
        self.graph: Optional[HeteroGraph] = None
        self.compiled: Optional[CompiledGraph] = None
        self._synthetic = False

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
        self = cls(data_path=data_path)
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

    def load_synthetic_gwas(self, seed: int = 42):
        if not self._synthetic:
            raise ValueError("only valid for from_synthetic data")
        rename = {"CHR": "#CHROM", "SNP": "ID"}
        self.lr_uni = {rename.get(k, k): np.array(v, copy=True)
                       for k, v in self._synth_sumstats.items()}
        self.sample_size = int(self.lr_uni["N"][0])
        self.pheno = "SYNTHETIC"
        self.seed = seed
        return self

    def process_gwas_file(self, label: str = "chi"):
        if label != "chi":
            raise NotImplementedError(
                f"label={label!r} is not ported yet (only 'chi' is): "
                f"{_LOADERS}")
        if not self._synthetic:
            raise NotImplementedError(
                f"LD-score files of real data are not read yet: {_LOADERS}")
        lr_uni = self.lr_uni
        ld_scores, w_ld_scores = self._synth_ld, self._synth_w_ld
        ids = lr_uni["ID"]

        m = 15000000
        n = np.mean(lr_uni["N"]) if "N" in lr_uni else self.sample_size
        h_g_2 = 0.5
        lr_uni["ld_score"] = lookup(
            ld_scores["SNP"], ld_scores["ldscore"], ids,
            default=np.min(ld_scores["ldscore"]))
        # data LD excludes the query SNP itself, so add 1
        lr_uni["w_ld_score"] = 1 + lookup(
            w_ld_scores["SNP"], w_ld_scores["ldscore"], ids,
            default=np.min(w_ld_scores["ldscore"]))

        print_sys("Using ldsc weight...")
        # per-ID values, the last row of a duplicated ID winning
        ld = lookup(ids, lr_uni["ld_score"], ids).astype(np.float64)
        w_ld = lookup(ids, lr_uni["w_ld_score"], ids).astype(np.float64)
        ldsc_weight = ldsc_regression_weights(ld, w_ld, n, m, h_g_2)
        ldsc_weight = ldsc_weight / np.mean(ldsc_weight)
        self.rs_id_to_ldsc_weight = dict(zip(ids, ldsc_weight))

        if "chi" in lr_uni:
            print_sys("chi pre-computed...")
            y = np.asarray(lr_uni["chi"], dtype=np.float64)
        elif self.pheno in BINARY_TRAITS and self.sample_size <= 3000:
            y = np.asarray(lr_uni["Z_STAT"], dtype=np.float64) ** 2
        elif "BETA" in lr_uni and "SE" in lr_uni:
            y = (np.asarray(lr_uni["BETA"], dtype=np.float64)
                 / np.asarray(lr_uni["SE"], dtype=np.float64)) ** 2
        else:
            from scipy.stats import chi2

            y = chi2.ppf(1 - np.asarray(lr_uni["P"], dtype=np.float64), 1)
        if "chi" not in lr_uni:
            y = np.where(np.isnan(y), 0.0, y)
        lr_uni["y"] = y

        snp_keys = np.array(list(self.id2idx["SNP"].keys()), dtype=object)
        snp_idx = np.array(list(self.id2idx["SNP"].values()), dtype=np.int64)
        self.all_ids = lookup(snp_keys, snp_idx, ids).astype(np.int64)
        self.y = y
        self.lr_uni = lr_uni

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
            self.compiled = compile_graph(
                self.graph,
                edge_pad_multiple=edge_pad_multiple,
                node_pad_multiple=node_pad_multiple,
            )
        return self.compiled
