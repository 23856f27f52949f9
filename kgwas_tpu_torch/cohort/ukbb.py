"""UK Biobank cohort construction on numpy and scipy (host only).

Counterpart of ``kgwas_tpu/cohort/ukbb.py`` (the reference's
``kgwas/data.py`` ``ukbb_cohort``): sample QC (ancestry, relatedness,
aneuploidy, sex mismatch, data quality), kinship pruning by the connected
components of the kinship graph, covariates (sex, age, principal
components, assessment centre, genotyping batch), phenotypes (a raw field,
an external trait file, ICD10 codes) and their PLINK files.

Tables are column tables (``dict[str, np.ndarray]``); the JAX package's
pandas and scikit-learn steps are copied on numpy:

  * ``DataFrame.sample(frac=1, random_state=s)`` is
    ``RandomState(s).permutation(n)`` (``_shuffled``);
  * ``train_test_split(test_size=f, random_state=s)`` is
    ``RandomState(s).permutation(n)`` with its first ``ceil(f n)`` entries
    the test rows (``_train_test_split``);
  * ``quantile_transform(output_distribution="normal", random_state=42)``
    is ``_quantile_normal``; ``OneHotEncoder(handle_unknown="ignore")`` is
    ``_one_hot`` (sorted categories, NaN its own last one);
  * ``to_csv(sep=" ", header=None, index=None)`` is ``utils.write_columns``
    (floats as numpy prints them, which is how pandas writes them).

The ``*.pkl`` caches of tables (``covariates_all.pkl``, ``icd10.pkl``,
``{field}_pheno.pkl``) hold column tables; the JAX package's hold pandas
DataFrames, which the port does not read (``_load_table`` says which file
to delete). The cohorts' eid arrays (``cohort_*.pkl``) are numpy arrays in
both packages, and shared. Paths default to ``kgwas_tpu_torch.params``
(environment variables).
"""
from __future__ import annotations

import csv
import math
import os
from operator import itemgetter
from typing import List, Optional, Set

import numpy as np

from ..params import fam_path, kinship_path
from ..utils import (_column_names, _parse, load_dict, n_rows, print_sys,
                     read_table, rename, save_dict, take, write_columns)

BINARY_TRAITS = [
    "body_BALDING1",
    "cancer_BREAST",
    "disease_ALLERGY_ECZEMA_DIAGNOSED",
    "disease_HYPOTHYROIDISM_SELF_REP",
    "other_MORNINGPERSON",
    "pigment_SUNBURN",
]

# UK Biobank QC field ids (reference data.py:44-67)
F_ANCESTRY = "22006-0.0"       # genetic ethnic grouping (white british == 1)
F_RELATED_EXCL = "22018-0.0"   # genetic relatedness exclusions
F_ANEUPLOIDY = "22019-0.0"     # sex chromosome aneuploidy
F_SEX_SELF = "31-0.0"          # self-reported sex
F_SEX_GENETIC = "22001-0.0"    # genetically determined sex
F_QUALITY = "22010-0.0"        # recommended genomic analysis exclusions

# scikit-learn's QuantileTransformer bound on the uniform scale
_BOUNDS_THRESHOLD = 1e-7


# ------------------------------------------------------------------ helpers

def isnull(col) -> np.ndarray:
    """pandas' ``isnull`` of one column: NaN (and None) are missing."""
    col = np.asarray(col)
    if col.dtype.kind == "f":
        return np.isnan(col)
    if col.dtype.kind == "O":
        return np.array([v is None or (isinstance(v, float) and v != v)
                         for v in col.tolist()], dtype=bool)
    return np.zeros(len(col), dtype=bool)


def isin(col, values) -> np.ndarray:
    """pandas' ``Series.isin``: by sorting for numbers, through a set for
    text (numpy compares object arrays pairwise)."""
    col, values = np.asarray(col), np.asarray(values)
    if len(values) == 0:
        return np.zeros(len(col), dtype=bool)
    if col.dtype.kind in "biuf" and values.dtype.kind in "biuf":
        return np.isin(col, values)
    members = set(values.tolist())
    return np.fromiter((v in members for v in col.tolist()), dtype=bool,
                       count=len(col))


def _load_table(path: str) -> dict:
    """A cached column table; a pandas pickle (the JAX package's cache)
    raises, naming the file to delete."""
    stale = ValueError(
        f"{path} is not a column table (the JAX package caches pandas "
        f"DataFrames there, which this package does not read): delete it "
        f"and it is built again")
    try:
        obj = load_dict(path)
    except (ImportError, AttributeError) as e:
        raise stale from e
    if not isinstance(obj, dict):
        raise stale
    return obj


def _shuffled(n: int, seed: int) -> np.ndarray:
    """Row order of pandas' ``sample(frac=1, random_state=seed)``:
    ``RandomState.choice(n, n, replace=False)``, its permutation."""
    return np.random.RandomState(seed).permutation(n)


def _train_test_split(n: int, test_size, seed: int):
    """(train rows, test rows) of scikit-learn's ``train_test_split(...,
    test_size=test_size, random_state=seed)`` over n rows (ShuffleSplit:
    ceil(test_size n) test rows first in one permutation)."""
    if isinstance(test_size, (float, np.floating)):
        if not 0 < test_size < 1:
            raise ValueError(f"test_size={test_size} should be a float in "
                             f"the (0, 1) range")
        n_test = math.ceil(test_size * n)
    else:
        n_test = int(test_size)
        if not 0 < n_test < n:
            raise ValueError(f"test_size={test_size} should be between 1 "
                             f"and {n - 1}")
    n_train = n - n_test
    if n_train == 0:
        raise ValueError(f"with n_samples={n} and test_size={test_size}, "
                         f"the train set would be empty")
    perm = np.random.RandomState(seed).permutation(n)
    return perm[n_test:n_test + n_train], perm[:n_test]


def _quantile_normal(y, seed: int = 42, n_quantiles: int = 1000,
                     subsample: int = 100_000) -> np.ndarray:
    """scikit-learn's ``quantile_transform(y[:, None],
    output_distribution="normal", random_state=seed)[:, 0]``: quantiles
    from a subsample of ``subsample`` rows when there are more, the mean of
    the ascending and descending interpolations, the normal's ppf, clipped
    where the uniform scale is within 1e-7 of 0 or 1."""
    from scipy import stats

    x = np.array(y, dtype=np.float64)
    n = len(x)
    n_q = max(1, min(n_quantiles, n))
    rng = np.random.RandomState(seed)
    references = np.linspace(0, 1, n_q, endpoint=True)
    fit = x
    if subsample < n:
        idx = np.arange(n)
        rng.shuffle(idx)
        fit = x[idx[:subsample]]
    quantiles = np.nanpercentile(fit[:, None], references * 100, axis=0)[:, 0]
    with np.errstate(invalid="ignore"):
        lower = x - _BOUNDS_THRESHOLD < quantiles[0]
        upper = x + _BOUNDS_THRESHOLD > quantiles[-1]
    finite = ~np.isnan(x)
    xf = x[finite]
    x[finite] = 0.5 * (np.interp(xf, quantiles, references)
                       - np.interp(-xf, -quantiles[::-1], -references[::-1]))
    x[upper] = 1
    x[lower] = 0
    with np.errstate(invalid="ignore"):
        x = stats.norm.ppf(x)
        clip_min = stats.norm.ppf(_BOUNDS_THRESHOLD - np.spacing(1))
        clip_max = stats.norm.ppf(1 - (_BOUNDS_THRESHOLD - np.spacing(1)))
        return np.clip(x, clip_min, clip_max)


def _categories(values) -> list:
    """scikit-learn's OneHotEncoder categories of a column: the sorted
    distinct values, a missing value (NaN) as the last one."""
    values = np.asarray(values)
    miss = isnull(values)
    present = values[~miss]
    if present.dtype.kind == "O":
        cats = sorted(set(present.tolist()))
    else:
        cats = np.unique(present).tolist()
    return cats + ([float("nan")] if miss.any() else [])


def _one_hot(values, categories: list) -> np.ndarray:
    """int64 [n, len(categories)] indicator of each row's category (NaN
    matches a NaN category); a value outside them is a row of zeros
    (handle_unknown="ignore")."""
    values = np.asarray(values)
    nan_code = next((i for i, c in enumerate(categories)
                     if isinstance(c, float) and c != c), None)
    code = {c: i for i, c in enumerate(categories) if i != nan_code}
    miss = isnull(values)
    codes = np.array([nan_code if m else code.get(v)
                      for v, m in zip(values.tolist(), miss.tolist())],
                     dtype=object)
    out = np.zeros((len(values), len(categories)), dtype=np.int64)
    known = np.array([c is not None for c in codes.tolist()], dtype=bool)
    out[np.flatnonzero(known), codes[known].astype(np.int64)] = 1
    return out


# ------------------------------------------------------------------- fields

def _header(path: str) -> list:
    with open(path, newline="") as f:
        return next(csv.reader(f))


def get_fields(all_field_ids: List, main_data_path: str) -> dict:
    """The ``eid`` column and every column of the requested UK Biobank
    field ids (``{field}-{instance}.{array}``), in the file's order, typed
    as pandas' ``read_csv`` types them (reference utils.py:108-112). Reads
    the header, then only those columns of each row: the main table is
    tens of GB."""
    header = _header(main_data_path)
    names = _column_names(header)
    keep = [i for i, h in enumerate(header)
            if h == "eid" or any(h.startswith(f"{fid}-")
                                 for fid in all_field_ids)]
    width = len(header)
    pick = (itemgetter(*keep) if len(keep) > 1
            else lambda row: (row[keep[0]],))

    def picked(reader):
        for row in reader:
            if not row:
                continue
            if len(row) < width:
                row = row + [""] * (width - len(row))
            yield pick(row)

    with open(main_data_path, newline="") as f:
        reader = csv.reader(f)
        next(reader)
        rows = list(picked(reader))
    cols = list(zip(*rows)) if rows else [()] * len(keep)
    return {names[i]: _parse(list(c)) for i, c in zip(keep, cols)}


def get_row_last_values(table) -> np.ndarray:
    """Each row's last non-missing value over the columns in order (the
    latest measurement; reference utils.py:115-122). table: a column table
    or a list of columns."""
    cols = [np.asarray(c) for c in (table.values() if isinstance(table, dict)
                                    else table)]
    n = len(cols[0])
    numeric = all(c.dtype.kind in "biuf" for c in cols)
    result = np.full(n, np.nan, dtype=np.float64 if numeric else object)
    for col in cols[::-1]:
        miss = isnull(result)
        result[miss] = col[miss]
    return result


def get_kinship_groups(kinship_table_path: Optional[str] = None) -> List[Set]:
    """Kinship groups: the connected components of the kinship graph
    (reference utils.py:153-178), in the order of their component labels."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    kin = read_table(kinship_table_path or kinship_path, sep=" ")
    id1, id2 = np.asarray(kin["ID1"]), np.asarray(kin["ID2"])
    ids = np.unique(np.concatenate([id1, id2]))
    n = len(ids)
    i1, i2 = np.searchsorted(ids, id1), np.searchsorted(ids, id2)
    rows = np.concatenate([i1, i2])
    cols = np.concatenate([i2, i1])
    mat = csr_matrix((np.ones(len(rows), dtype=bool), (rows, cols)),
                     shape=(n, n), dtype=bool)
    _, labels = connected_components(mat, directed=False)
    order = np.argsort(labels, kind="stable")
    bounds = np.cumsum(np.bincount(labels))[:-1]
    return [set(ids[g].tolist()) for g in np.split(order, bounds)]


def remove_kinships(eid, verbose=True, kinship_table_path=None) -> np.ndarray:
    """Keep one member (the lowest eid) of each kinship group among eid
    (reference utils.py:124-151). Returns the boolean keep-mask."""
    eid = np.asarray(eid)
    all_eids = set(eid.tolist())
    groups = get_kinship_groups(kinship_table_path)
    relevant = [g & all_eids for g in groups]
    relevant = [g for g in relevant if len(g) >= 2]
    dropped = set()
    for g in relevant:
        dropped.update(sorted(g)[1:])
    mask = ~isin(eid, list(dropped))
    if verbose:
        print_sys(
            f"{len(relevant)} kinship groups relevant; removing "
            f"{len(dropped)} samples, {len(mask)} -> {mask.sum()}"
        )
    return mask


def _to_str(col) -> np.ndarray:
    """pandas' ``astype("str")`` of an eid column."""
    return np.array([str(v) for v in np.asarray(col).tolist()], dtype=object)


def _write_codes(path: str, fid, iid, codes: np.ndarray, names: list):
    """The ICD10 PLINK table as pandas' ``to_csv(index=None, sep=" ")``
    writes it: a header, then per row FID, IID and one digit (1 or 2) per
    code; the code matrix is written as bytes, not cell by cell."""
    n, k = codes.shape
    body = np.full((n, 2 * k), ord(" "), dtype=np.uint8)
    if k:
        body[:, 0::2] = codes.astype(np.uint8) + ord("0")
        body[:, -1] = ord("\n")
    lines = [" ".join(["FID", "IID"] + list(names)).encode() + b"\n"]
    tail = b"" if k else b"\n"
    for i, (a, b) in enumerate(zip(np.asarray(fid).tolist(),
                                   np.asarray(iid).tolist())):
        lines.append(f"{a} {b}{' ' if k else ''}".encode() + body[i].tobytes()
                     + tail)
    with open(path, "wb") as f:
        f.write(b"".join(lines))


# ------------------------------------------------------------------- cohort

class ukbb_cohort:
    def __init__(
        self,
        main_data_path,
        cohort_data_path,
        withdraw_path,
        keep_relatives: bool = False,
        kinship_table_path: Optional[str] = None,
    ):
        self.keep_relatives = keep_relatives
        self.cohort_data_path = cohort_data_path
        self.main_data_path = main_data_path
        self.kinship_table_path = kinship_table_path

        name = ("cohort_with_relatives.pkl" if keep_relatives
                else "cohort_no_relatives.pkl")
        cohort_path = os.path.join(cohort_data_path, name)

        if not os.path.exists(cohort_path):
            print_sys("construct from scratch...")
            df = get_fields([22006, 22018, 22019, 22001, 22010, 31],
                            main_data_path)
            steps = [
                ("white british ancestry (22006)",
                 lambda d: d[F_ANCESTRY] == 1),
                ("relatedness exclusions (22018)",
                 lambda d: isnull(d[F_RELATED_EXCL])),
                ("sex chromosome aneuploidy (22019)",
                 lambda d: isnull(d[F_ANEUPLOIDY])),
                ("sex mismatch (31 vs 22001)",
                 lambda d: d[F_SEX_SELF] == d[F_SEX_GENETIC]),
                ("genomic data quality (22010)",
                 lambda d: isnull(d[F_QUALITY])),
            ]
            print_sys(f"Total sample size: {n_rows(df)}")
            for desc, fn in steps:
                before = n_rows(df)
                df = take(df, np.asarray(fn(df), dtype=bool))
                print_sys(f"{desc}: {before} -> {n_rows(df)}")

            os.makedirs(cohort_data_path, exist_ok=True)
            save_dict(os.path.join(cohort_data_path,
                                   "cohort_with_relatives.pkl"), df["eid"])
            mask = remove_kinships(df["eid"],
                                   kinship_table_path=kinship_table_path)
            df = take(df, mask)
            save_dict(os.path.join(cohort_data_path,
                                   "cohort_no_relatives.pkl"), df["eid"])
        else:
            print_sys("Found local copy...")

        self.cohort = load_dict(cohort_path)
        print_sys(f"There are {len(self.cohort)} samples!")
        if keep_relatives:
            no_rel = os.path.join(cohort_data_path, "cohort_no_relatives.pkl")
            if os.path.exists(no_rel):
                self.no_rel_eid = load_dict(no_rel)

    # -- covariates (reference data.py:87-155) -------------------------------

    def get_covariates(self, to_plink=False, plink_num_pca=15,
                       return_full=False, plink_filter=False):
        covar_path = os.path.join(self.cohort_data_path, "covariates_all.pkl")
        if os.path.exists(covar_path):
            print_sys("Found local copy...")
            self.covar = _load_table(covar_path)
        else:
            print_sys("construct co-variates from scratch...")
            df = get_fields([31, 54, 21003, 22009], self.main_data_path)
            colmap = {f"22009-0.{i}": f"pca {i}" for i in range(1, 41)}
            colmap.update({"31-0.0": "sex", "21003-0.0": "age",
                           "54-0.0": "assessment_center"})
            covar = rename(df, colmap)
            centers = covar["assessment_center"]
            center = _one_hot(centers, _categories(centers))
            drop = {"21003-1.0", "21003-2.0", "21003-3.0",
                    "assessment_center", "54-1.0", "54-2.0", "54-3.0"}
            covar = {k: v for k, v in covar.items() if k not in drop}
            for i in range(center.shape[1]):
                covar[f"center_{i}"] = center[:, i]

            fam = read_table(fam_path, sep=",")
            traits = np.asarray(fam["trait"])
            batch = _one_hot(traits, _categories(traits))
            nb = batch.shape[1]
            code = dict(zip(np.asarray(fam["fid"]).tolist(),
                            batch.argmax(axis=1).tolist() if nb else []))
            rows = np.zeros((n_rows(covar), nb), dtype=np.int64)
            idx = [code.get(e) for e in np.asarray(covar["eid"]).tolist()]
            hit = np.array([c is not None for c in idx], dtype=bool)
            rows[np.flatnonzero(hit),
                 np.array([c for c in idx if c is not None],
                          dtype=np.int64)] = 1
            for i in range(nb):
                covar[f"batch_{i}"] = rows[:, i]
            self.covar = covar
            save_dict(covar_path, self.covar)
            print_sys("Done! Saving...")

        if not to_plink:
            if return_full:
                return self.covar
            return take(self.covar, isin(self.covar["eid"], self.cohort))

        plink_path = os.path.join(
            self.cohort_data_path, f"covar_pca{plink_num_pca}_all_real_value"
        )
        if plink_filter:
            plink_path += "_null_removed"
        plink_path += ".txt"
        if not os.path.exists(plink_path):
            names = list(self.covar)
            pca_cols = [c for c in names
                        if c[:3] == "pca" and int(c.split()[-1])
                        <= plink_num_pca]

            def argmax_of(part):
                cols = [self.covar[c] for c in names if part in c]
                return np.argmax(np.stack(cols, axis=1), axis=1)

            center, batch = argmax_of("center"), argmax_of("batch")
            covar = {c: self.covar[c] for c in names[:43]}
            covar["assessment_center"] = center
            covar["batch"] = batch
            if plink_filter:
                covar = take(covar, isin(covar["eid"], self.cohort))
            write_columns([covar[c] for c in
                           ["eid", "eid", "age", "sex", "assessment_center",
                            "batch"] + pca_cols], plink_path, sep=" ")
            self.covar = covar
        self.covar_plink = read_table(plink_path, sep=" ", header=None)
        return self.covar_plink

    # -- phenotypes (reference data.py:157-365) -------------------------------

    def _plink_write(self, pheno, plink_path, value_col):
        if not os.path.exists(plink_path):
            write_columns([pheno["eid"], pheno["eid"], pheno[value_col]],
                          plink_path, sep=" ")
        else:
            print_sys("Already existed! Loading...")
        return read_table(plink_path, sep=" ", header=None)

    def get_external_traits(self, trait_name, to_plink=False, to_str=True,
                            random_seed=42, sep_cohort=False, randomize=False,
                            use_sample_size=False, sample_size=-1,
                            randomize_seed=42, data_path="./data/"):
        trait_type = "binary" if trait_name in BINARY_TRAITS else "continuous"
        pheno_path = os.path.join(self.cohort_data_path,
                                  f"{trait_name}_pheno.pkl")
        if os.path.exists(pheno_path):
            print_sys("Found local copy...")
            self.pheno = _load_table(pheno_path)
        else:
            print_sys("construct phenotype from scratch...")
            pheno = read_table(os.path.join(
                data_path, "full_gwas", f"{trait_name}_{trait_type}.csv"),
                sep=",")
            pheno["eid"] = np.asarray(pheno["eid"]).astype(np.int64)
            pheno = take(pheno, ~isnull(pheno["pheno"]))
            if trait_type == "binary":
                pheno["pheno"] = (np.asarray(pheno["pheno"]) + 1).astype(
                    np.int64)
            self.pheno = pheno
            save_dict(pheno_path, self.pheno)

        self.pheno = take(self.pheno, isin(self.pheno["eid"], self.cohort))
        if to_str:
            self.pheno["eid"] = _to_str(self.pheno["eid"])
        if not to_plink:
            return self.pheno

        plink_path = os.path.join(self.cohort_data_path,
                                  f"{trait_name}_plink")
        plink_path += ("_with_relatives" if self.keep_relatives
                       else "_no_relatives")
        if use_sample_size:
            plink_path += f"_{sample_size}_{random_seed}"
        if sep_cohort:
            plink_path += "_sep_cohort"
        if randomize:
            plink_path += f"_randomize{randomize_seed}"
        plink_path += ".txt"

        if randomize:
            col = np.asarray(self.pheno["pheno"])
            self.pheno["pheno"] = col[_shuffled(len(col), randomize_seed)]
        if use_sample_size:
            eid = np.asarray(self.pheno["eid"])
            ids = eid[_shuffled(len(eid), random_seed)]
            keep = (ids[sample_size:] if sep_cohort
                    else ids[:sample_size])
            self.pheno = take(self.pheno, isin(eid, keep))

        self.pheno_plink = self._plink_write(self.pheno, plink_path,
                                             list(self.pheno)[-1])
        return self.pheno_plink

    def get_phenotype(self, field_id, aggregate="last_value", to_plink=False,
                      to_str=True, normalize="None", frac=1, random_seed=42,
                      fastgwa_match=False, icd10=False, icd10_level=2,
                      sep_cohort=False, randomize=False, use_sample_size=False,
                      sample_size=-1, randomize_seed=42):
        pheno_path = os.path.join(self.cohort_data_path,
                                  f"{field_id}_pheno.pkl")
        if os.path.exists(pheno_path):
            print_sys("Found local copy...")
            self.pheno = _load_table(pheno_path)
        else:
            print_sys("construct phenotype from scratch...")
            if icd10:
                icd = self.get_icd10(to_plink=True, level=icd10_level,
                                     get_all=True)
                self.pheno = {"eid": np.asarray(icd["FID"]).astype(np.int64),
                              field_id: icd[field_id]}
            else:
                self.pheno = get_fields([field_id], self.main_data_path)
            save_dict(pheno_path, self.pheno)

        key = str(field_id)
        names = list(self.pheno)
        if len(names) > 2 and aggregate == "last_value":
            print_sys("Getting the latest measure...")
            last = get_row_last_values([self.pheno[c] for c in names[1:]])
            self.pheno = take({"eid": self.pheno["eid"], key: last},
                              ~isnull(last))

        if fastgwa_match:
            if not self.keep_relatives:
                raise ValueError(
                    "fastgwa_match=True requires keep_relatives=True!")
            eid = self.pheno["eid"]
            self.rel_ratio = (isin(eid, self.no_rel_eid).sum()
                              / isin(eid, self.cohort).sum())

        self.pheno = take(self.pheno, isin(self.pheno["eid"], self.cohort))

        if normalize != "None":
            y = self.pheno[key]
            if normalize == "log":
                y = np.log(y)
            elif normalize == "std":
                y = (y - np.mean(y)) / np.std(y)
            elif normalize == "quantile_normalization":
                y = _quantile_normal(y, seed=42)
            self.pheno[key] = y

        if to_str:
            self.pheno["eid"] = _to_str(self.pheno["eid"])
        if not to_plink:
            return self.pheno

        plink_path = os.path.join(self.cohort_data_path, f"{field_id}_plink")
        plink_path += ("_with_relatives" if self.keep_relatives
                       else "_no_relatives")
        if normalize != "None":
            plink_path += f"_{normalize}"
        if use_sample_size:
            plink_path += f"_{sample_size}_{random_seed}"
        elif frac != 1:
            plink_path += f"_{frac}_{random_seed}"
        if fastgwa_match:
            plink_path += "_match"
        if sep_cohort:
            plink_path += "_sep_cohort"
        if randomize:
            plink_path += f"_randomize{randomize_seed}"
        plink_path += ".txt"

        if randomize:
            col = np.asarray(self.pheno[key])
            self.pheno[key] = col[_shuffled(len(col), randomize_seed)]

        eid = np.asarray(self.pheno["eid"])
        if use_sample_size:
            if icd10:
                cases = eid[np.asarray(self.pheno[key]) == 2]
                keep = np.concatenate((
                    cases[_shuffled(len(cases), random_seed)][:sample_size],
                    eid[np.asarray(self.pheno[key]) == 1]))
                if sep_cohort:
                    raise NotImplementedError
            else:
                ids = eid[_shuffled(len(eid), random_seed)]
                keep = ids[sample_size:] if sep_cohort else ids[:sample_size]
            self.pheno = take(self.pheno, isin(eid, keep))
        elif frac != 1:
            y = np.asarray(self.pheno[key])
            tr, te = _train_test_split(len(eid), frac, random_seed)
            train_ids, test_ids, y_tr = eid[tr], eid[te], y[tr]
            if fastgwa_match:
                tr, te = _train_test_split(len(train_ids),
                                           1 - self.rel_ratio, 42)
                train_ids, test_ids = train_ids[tr], train_ids[te]
            keep = test_ids if sep_cohort else train_ids
            self.pheno = take(self.pheno, isin(eid, keep))

        self.pheno_plink = self._plink_write(self.pheno, plink_path,
                                             list(self.pheno)[-1])
        return self.pheno_plink

    def get_icd10(self, to_plink=False, level=2, get_all=False):
        """ICD10 (field 41270) case/control phenotypes, codes with more than
        100 cases only (reference data.py:368-426)."""
        pheno_path = os.path.join(self.cohort_data_path, "icd10.pkl")
        level_str = f"level{level}"
        if os.path.exists(pheno_path):
            print_sys("Found local copy...")
            self.icd10 = _load_table(pheno_path)
        else:
            print_sys("construct from scratch...")
            raw = get_fields([41270], self.main_data_path)
            names = list(raw)
            grid = np.stack([np.asarray(raw[c], dtype=object)
                             for c in names[1:]], axis=1)
            present = ~np.stack([isnull(raw[c]) for c in names[1:]], axis=1)
            flat = grid[present]
            bounds = np.cumsum(present.sum(axis=1))[:-1]
            level3 = np.empty(len(grid), dtype=object)
            level2 = np.empty(len(grid), dtype=object)
            for i, codes in enumerate(np.split(flat, bounds)):
                level3[i] = codes
                level2[i] = (np.array(sorted({c[:3] for c in codes}))
                             if len(codes) else np.unique([]))
            self.icd10 = {"eid": raw["eid"], "level3": level3,
                          "level2": level2}
            save_dict(pheno_path, self.icd10)

        if get_all:
            self.pheno = dict(self.icd10)
        else:
            self.pheno = take(self.icd10, isin(self.icd10["eid"],
                                               self.cohort))
        if not to_plink:
            return self.pheno

        suffix = ("with_relatives" if (self.keep_relatives or get_all)
                  else "no_relatives")
        plink_path = os.path.join(
            self.cohort_data_path, f"icd10_plink_{suffix}_{level_str}.txt")
        if os.path.exists(plink_path):
            print_sys("Found local copy...")
            self.icd10_plink = read_table(plink_path, sep=" ")
        else:
            print_sys("transforming to plink files...")
            rows = self.pheno[level_str]
            counts = np.array([len(r) for r in rows], dtype=np.int64)
            flat = (np.concatenate([np.asarray(r, dtype=object)
                                    for r in rows])
                    if counts.sum() else np.array([], dtype=object))
            uniq = np.unique(flat.astype(str)) if len(flat) else np.array([])
            onehot = np.zeros((len(rows), len(uniq)), dtype=np.int8)
            onehot[np.repeat(np.arange(len(rows)), counts),
                   np.searchsorted(uniq, flat.astype(str))] = 1
            common = np.flatnonzero(onehot.sum(axis=0) > 100)
            codes = onehot[:, common] + 1   # PLINK coding: 1 control, 2 case
            eid = np.asarray(self.pheno["eid"])
            names = uniq[common].tolist()
            print_sys(f"There are {len(names)} ICD10 codes with at least 100 "
                      f"cases.")
            _write_codes(plink_path, eid, eid, codes, names)
            self.icd10_plink = {"FID": eid, "IID": eid,
                                **{c: codes[:, j]
                                   for j, c in enumerate(names)}}
        return self.icd10_plink
