"""The port's UK Biobank cohort builder (kgwas_tpu_torch/cohort/ukbb.py)
against the JAX package's (kgwas_tpu/cohort/ukbb.py) on the same raw files:
the cases of tests/test_cohort.py on its fixture, then on a larger
fabricated cohort (QC fields, centre and age over 4 visits, 40 PCs, a
phenotype over 4 visits, ICD10 codes, kinship pairs, a fam file of
genotyping batches) every normalize mode, frac, use_sample_size,
randomize, sep_cohort, fastgwa_match's two splits, the ICD10 > 100 cut,
covariates and external traits, with the PLINK files compared byte for
byte. Each package writes its caches into its own directory. The numpy
copies of pandas' sample, scikit-learn's train_test_split,
quantile_transform and OneHotEncoder are held against those libraries.
"""
import os
import pickle

import numpy as np
import pandas as pd
import pytest

import kgwas_tpu.cohort.ukbb as jukbb
import kgwas_tpu_torch.cohort.ukbb as tukbb
from kgwas_tpu_torch.cohort import (get_fields, get_kinship_groups,
                                    get_row_last_values, remove_kinships,
                                    ukbb_cohort)
from test_cohort import raw_ukbb  # noqa: F401  (the JAX tests' fixture)
from torch_threads import few_torch_threads  # noqa: F401,E402


def assert_table_equal(table, df, rtol=0.0):
    """A port column table equals a pandas frame: names in order, values
    (NaN where NaN), eids compared as text when either side is text.
    rtol: for floats that pandas read from 17-digit text, which its parser
    does not round correctly (ROADMAP Queue 3 notes; 1 ulp)."""
    assert list(table) == list(df.columns)
    for k in df.columns:
        got, want = np.asarray(table[k]), df[k].to_numpy()
        if got.dtype.kind in "OU" or want.dtype.kind in "OU":
            assert [str(v) for v in got.tolist()] == [
                str(v) for v in want.tolist()], k
        elif rtol:
            np.testing.assert_allclose(got, want, rtol=rtol, atol=0,
                                       err_msg=str(k))
        else:
            np.testing.assert_array_equal(got, want.astype(got.dtype),
                                          err_msg=str(k))


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


# ------------------------------------------- the cases of tests/test_cohort.py

def test_get_fields_selects_columns(raw_ukbb):  # noqa: F811
    main_path, _, _, df = raw_ukbb
    out = get_fields([50], main_path)
    assert list(out) == ["eid", "50-0.0", "50-1.0"]
    assert_table_equal(out, jukbb.get_fields([50], main_path), rtol=3e-16)
    # correctly rounded: as pandas reads with float_precision="round_trip"
    assert_table_equal(out, pd.read_csv(main_path, usecols=[0, 7, 8],
                                        float_precision="round_trip"))


def test_get_row_last_values(raw_ukbb):  # noqa: F811
    _, _, _, df = raw_ukbb
    last = get_row_last_values({c: df[c].to_numpy()
                                for c in ("50-0.0", "50-1.0")})
    want = jukbb.get_row_last_values(df[["50-0.0", "50-1.0"]])
    np.testing.assert_array_equal(last, want.to_numpy())


def test_remove_kinships_keeps_lowest_eid(raw_ukbb):  # noqa: F811
    _, kin_path, _, _ = raw_ukbb
    eid = np.arange(1000, 1040)
    mask = remove_kinships(eid, verbose=False, kinship_table_path=kin_path)
    kept = set(eid[mask].tolist())
    assert 1015 in kept and 1016 not in kept
    assert 1017 in kept and 1018 not in kept and 1019 not in kept
    want = jukbb.remove_kinships(pd.Series(eid), verbose=False,
                                 kinship_table_path=kin_path)
    np.testing.assert_array_equal(mask, want.to_numpy())


def test_cohort_qc_filters(raw_ukbb):  # noqa: F811
    main_path, kin_path, cohort_dir, _ = raw_ukbb
    c = ukbb_cohort(main_path, cohort_dir, withdraw_path="/nonexistent",
                    keep_relatives=False, kinship_table_path=kin_path)
    assert len(c.cohort) == 27
    assert 1000 not in c.cohort and 1016 not in c.cohort
    c2 = ukbb_cohort(main_path, cohort_dir, withdraw_path="/nonexistent",
                     keep_relatives=True, kinship_table_path=kin_path)
    assert len(c2.cohort) == 30
    j = jukbb.ukbb_cohort(main_path, cohort_dir + "_jax", "/nonexistent",
                          keep_relatives=False, kinship_table_path=kin_path)
    np.testing.assert_array_equal(c.cohort, j.cohort)


def test_get_phenotype_aggregate_and_plink(raw_ukbb):  # noqa: F811
    main_path, kin_path, cohort_dir, _ = raw_ukbb
    c = ukbb_cohort(main_path, cohort_dir, withdraw_path="/nonexistent",
                    keep_relatives=False, kinship_table_path=kin_path)
    pheno = c.get_phenotype(50, to_str=False)
    assert set(pheno) == {"eid", "50"}
    assert np.isin(pheno["eid"], c.cohort).all()
    plink = c.get_phenotype(50, to_plink=True, to_str=False)
    assert len(plink) == 3
    assert (plink[0] == plink[1]).all()
    j = jukbb.ukbb_cohort(main_path, cohort_dir + "_jax", "/nonexistent",
                          keep_relatives=False, kinship_table_path=kin_path)
    assert_table_equal(pheno, j.get_phenotype(50, to_str=False), rtol=3e-16)
    jplink = j.get_phenotype(50, to_plink=True, to_str=False)
    assert_table_equal({str(k): v for k, v in plink.items()},
                       jplink.rename(columns=str), rtol=3e-16)


# ------------------------------------------------------ a larger fabrication

CODES = (["I10", "E119", "K573", "J459", "M179", "E780", "K219", "N390",
          "I251", "Z864"] + [f"C{i:02d}{i % 10}" for i in range(20)])


def write_ukbb(root, n=900, seed=0, icd_width=6):
    """Raw UK Biobank files in the real layout: the main CSV (columns by
    field id, values at the precision the showcase gives), a kinship table
    and a fam file of genotyping batches. Returns their paths."""
    rng = np.random.default_rng(seed)
    eid = np.arange(1_000_000, 1_000_000 + n)
    cols = {"eid": eid}
    sex = rng.integers(0, 2, n).astype(float)
    cols["31-0.0"] = sex
    for v in range(4):
        x = np.round(rng.normal(170, 10, n), 1)
        x[rng.random(n) < 0.3 * v + 0.05] = np.nan
        cols[f"50-{v}.0"] = x
    for v in range(4):
        c = rng.choice([11010.0, 11012.0, 11016.0, 11021.0, 11025.0], n)
        c[rng.random(n) < (0.01 if v == 0 else 0.7)] = np.nan
        cols[f"54-{v}.0"] = c
    for v in range(4):
        a = rng.integers(40, 71, n).astype(float) + v
        a[rng.random(n) < (0.0 if v == 0 else 0.7)] = np.nan
        cols[f"21003-{v}.0"] = a
    g = sex.copy()
    g[:12] = 1 - g[:12]                                  # sex mismatch
    cols["22001-0.0"] = g
    anc = np.ones(n)
    anc[12:40] = np.nan                                  # not white british
    cols["22006-0.0"] = anc
    for i in range(1, 41):
        cols[f"22009-0.{i}"] = np.round(rng.normal(0, 10 / i, n), 4)
    q = np.full(n, np.nan)
    q[40:46] = 1.0
    cols["22010-0.0"] = q
    r = np.full(n, np.nan)
    r[46:50] = 1.0
    cols["22018-0.0"] = r
    an = np.full(n, np.nan)
    an[50:52] = 1.0
    cols["22019-0.0"] = an
    p = np.array([0.5, 0.4, 0.3, 0.25, 0.2, 0.15, 0.12, 0.1, 0.08, 0.05]
                 + [0.02] * 20)
    n_codes = rng.integers(0, icd_width + 1, n)
    grid = np.full((n, icd_width), np.nan, dtype=object)
    for i in range(n):
        picks = [c for c, take in zip(CODES, rng.random(len(CODES)) < p)
                 if take][: n_codes[i]]
        grid[i, : len(picks)] = picks
    for k in range(icd_width):
        cols[f"41270-0.{k}"] = grid[:, k]
    main = os.path.join(root, "main.csv")
    pd.DataFrame(cols).to_csv(main, index=False)
    a = rng.choice(eid, 240, replace=False)
    kin = pd.DataFrame({"ID1": a[:120], "ID2": a[120:],
                        "Kinship": np.round(rng.random(120) / 4, 4)})
    # pairs joined through shared members: groups of 4
    kin = pd.concat([kin, pd.DataFrame({"ID1": a[120:150], "ID2": a[150:180],
                                        "Kinship": 0.25})])
    kin_path = os.path.join(root, "kinship.dat")
    kin.to_csv(kin_path, index=False, sep=" ")
    fam = pd.DataFrame({
        "fid": eid[rng.random(n) < 0.95],
    })
    fam["trait"] = rng.choice(["Batch_b001", "Batch_b002", "UKBiLEVEAX_b1",
                               "UKBiLEVEAX_b10"], len(fam))
    fam_path = os.path.join(root, "fam.csv")
    fam.to_csv(fam_path, index=False)
    return main, kin_path, fam_path


@pytest.fixture(scope="module")
def big(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ukbb"))
    return root, *write_ukbb(root)


def object_strings():
    """pandas 2's text columns (object dtype), the reference's: under pandas
    3's default str dtype the JAX package's OneHotEncoder fit on the fam
    file's traits and its train_test_split of eids as text raise
    (NotImplementedError from ArrowStringArray.reshape, TypeError from
    indexing one; ROADMAP Queue 3 notes)."""
    return pd.option_context("future.infer_string", False)


class Legacy:
    """A JAX package cohort whose every method call runs with
    object_strings()."""

    def __init__(self, cls, *args):
        with object_strings():
            self._obj = cls(*args)

    def __getattr__(self, name):
        attr = getattr(self._obj, name)
        if not callable(attr):
            return attr

        def call(*a, **k):
            with object_strings():
                return attr(*a, **k)
        return call


def pair(big, tag, keep_relatives=False, monkeypatch=None):
    """The port's and the JAX package's cohorts on the same raw files,
    each with its own cache directory (the JAX one under
    object_strings())."""
    root, main, kin, fam = big
    if monkeypatch is not None:
        monkeypatch.setattr(tukbb, "fam_path", fam)
        monkeypatch.setattr(jukbb, "fam_path", fam)
    pt = os.path.join(root, tag, "port")
    jx = os.path.join(root, tag, "jax")
    return (ukbb_cohort(main, pt, "/nonexistent", keep_relatives, kin),
            Legacy(jukbb.ukbb_cohort, main, jx, "/nonexistent",
                   keep_relatives, kin),
            pt, jx)


def plink_files_equal(pt, jx, prefix):
    names = sorted(f for f in os.listdir(jx) if f.startswith(prefix)
                   and f.endswith(".txt"))
    assert names and names == sorted(
        f for f in os.listdir(pt) if f.startswith(prefix)
        and f.endswith(".txt"))
    for name in names:
        assert same_bytes(os.path.join(pt, name), os.path.join(jx, name)), \
            name
    return names


def test_kinship_groups_match_in_order(big):
    _, _, kin, _ = big
    assert get_kinship_groups(kin) == jukbb.get_kinship_groups(kin)
    assert any(len(g) > 2 for g in get_kinship_groups(kin))


@pytest.mark.parametrize("keep_relatives", [False, True])
def test_cohort_eids_match(big, keep_relatives):
    c, j, pt, jx = pair(big, f"qc{keep_relatives}", keep_relatives)
    np.testing.assert_array_equal(c.cohort, j.cohort)
    for name in ("cohort_with_relatives.pkl", "cohort_no_relatives.pkl"):
        with open(os.path.join(jx, name), "rb") as f:
            np.testing.assert_array_equal(pickle.load(f),
                                          tukbb.load_dict(
                                              os.path.join(pt, name)))


@pytest.mark.parametrize("normalize", ["None", "log", "std",
                                       "quantile_normalization"])
def test_normalize_modes(big, normalize):
    c, j, pt, jx = pair(big, f"norm_{normalize}")
    got = c.get_phenotype(50, normalize=normalize, to_str=False)
    want = j.get_phenotype(50, normalize=normalize, to_str=False)
    assert_table_equal(got, want)
    c.get_phenotype(50, normalize=normalize, to_plink=True)
    j.get_phenotype(50, normalize=normalize, to_plink=True)
    plink_files_equal(pt, jx, "50_plink")


SPLITS = {
    "frac": dict(frac=0.3),
    "frac-sep": dict(frac=0.3, sep_cohort=True),
    "frac-seed": dict(frac=0.25, random_seed=7),
    "sample-size": dict(use_sample_size=True, sample_size=200),
    "sample-size-sep": dict(use_sample_size=True, sample_size=200,
                            sep_cohort=True),
    "sample-size-default": dict(use_sample_size=True),
    "randomize": dict(randomize=True, randomize_seed=3),
    "randomize-frac": dict(randomize=True, frac=0.5,
                           normalize="quantile_normalization"),
}


@pytest.mark.parametrize("name", list(SPLITS))
def test_phenotype_splits(big, name):
    c, j, pt, jx = pair(big, f"split_{name}")
    got = c.get_phenotype(50, to_plink=True, **SPLITS[name])
    want = j.get_phenotype(50, to_plink=True, **SPLITS[name])
    assert len(got[0]) == len(want)
    plink_files_equal(pt, jx, "50_plink")


@pytest.mark.parametrize("sep_cohort", [False, True])
def test_fastgwa_match_two_splits(big, sep_cohort):
    c, j, pt, jx = pair(big, f"fastgwa{sep_cohort}", keep_relatives=True)
    c.get_phenotype(50, to_plink=True, frac=0.4, fastgwa_match=True,
                    sep_cohort=sep_cohort)
    j.get_phenotype(50, to_plink=True, frac=0.4, fastgwa_match=True,
                    sep_cohort=sep_cohort)
    assert c.rel_ratio == j.rel_ratio and 0 < c.rel_ratio < 1
    plink_files_equal(pt, jx, "50_plink")
    with pytest.raises(ValueError, match="keep_relatives"):
        pair(big, "fastgwa_norel")[0].get_phenotype(50, fastgwa_match=True)


def test_icd10_cut_and_plink(big):
    c, j, pt, jx = pair(big, "icd10")
    got = c.get_icd10(to_plink=True)
    want = j.get_icd10(to_plink=True)
    assert_table_equal(got, want)
    names = plink_files_equal(pt, jx, "icd10_plink")
    assert names == ["icd10_plink_no_relatives_level2.txt"]
    # the cut: exactly the level-2 codes with more than 100 cases
    level2 = c.get_icd10()["level2"]
    counts = pd.Series([x for row in level2 for x in row]).value_counts()
    assert sorted(list(got)[2:]) == sorted(counts[counts > 100].index)
    assert 0 < len(got) - 2 < counts.size
    # level 3 and the whole table (get_all) too
    assert_table_equal(c.get_icd10(to_plink=True, level=3, get_all=True),
                       j.get_icd10(to_plink=True, level=3, get_all=True))
    plink_files_equal(pt, jx, "icd10_plink")
    # read back from the file on the second call
    assert_table_equal(c.get_icd10(to_plink=True), want)


@pytest.mark.parametrize("kw", [dict(), dict(use_sample_size=True,
                                             sample_size=50)])
def test_icd10_phenotype(big, kw):
    c, j, pt, jx = pair(big, f"icd10_pheno{len(kw)}")
    c.get_phenotype("I10", icd10=True, to_plink=True, **kw)
    j.get_phenotype("I10", icd10=True, to_plink=True, **kw)
    plink_files_equal(pt, jx, "I10_plink")
    with pytest.raises(NotImplementedError):
        c.get_phenotype("I10", icd10=True, to_plink=True, sep_cohort=True,
                        use_sample_size=True, sample_size=5)


@pytest.mark.parametrize("plink_filter", [False, True])
def test_covariates(big, monkeypatch, plink_filter):
    c, j, pt, jx = pair(big, f"covar{plink_filter}",
                        monkeypatch=monkeypatch)
    assert_table_equal(c.get_covariates(return_full=True),
                       j.get_covariates(return_full=True))
    assert_table_equal(c.get_covariates(), j.get_covariates())
    got = c.get_covariates(to_plink=True, plink_num_pca=10,
                           plink_filter=plink_filter)
    j.get_covariates(to_plink=True, plink_num_pca=10,
                     plink_filter=plink_filter)
    assert len(got) == 16
    plink_files_equal(pt, jx, "covar_pca10")


def test_jax_pickle_cache_raises_naming_the_file(big, monkeypatch):
    root, main, kin, fam = big
    c, j, pt, jx = pair(big, "stale", monkeypatch=monkeypatch)
    j.get_covariates()
    j.get_phenotype(50)
    os.makedirs(pt, exist_ok=True)
    for name in ("covariates_all.pkl", "50_pheno.pkl"):
        with open(os.path.join(jx, name), "rb") as f:
            blob = f.read()
        with open(os.path.join(pt, name), "wb") as f:
            f.write(blob)
    with pytest.raises(ValueError, match="covariates_all.pkl.*delete"):
        c.get_covariates()
    with pytest.raises(ValueError, match="50_pheno.pkl.*delete"):
        c.get_phenotype(50)


@pytest.mark.parametrize("trait", ["body_BALDING1", "body_HEIGHTz"])
def test_external_traits(big, trait):
    root = big[0]
    c, j, pt, jx = pair(big, f"ext_{trait}")
    rng = np.random.default_rng(1)
    n = 300
    eid = np.sort(rng.choice(c.cohort, n, replace=False))
    vals = (rng.integers(0, 2, n).astype(float) if trait == "body_BALDING1"
            else np.round(rng.normal(0, 1, n), 5))
    vals[::17] = np.nan
    kind = "binary" if trait == "body_BALDING1" else "continuous"
    os.makedirs(os.path.join(root, "full_gwas"), exist_ok=True)
    pd.DataFrame({"eid": eid, "pheno": vals}).to_csv(
        os.path.join(root, "full_gwas", f"{trait}_{kind}.csv"), index=False)
    kw = dict(to_plink=True, data_path=root, use_sample_size=True,
              sample_size=100, randomize=True)
    c.get_external_traits(trait, **kw)
    j.get_external_traits(trait, **kw)
    plink_files_equal(pt, jx, f"{trait}_plink")


# ------------------------------------------------ the numpy copies, directly

@pytest.mark.parametrize("n,seed", [(1, 0), (7, 42), (1000, 3)])
def test_shuffled_is_pandas_sample(n, seed):
    s = pd.Series(np.arange(n))
    np.testing.assert_array_equal(
        tukbb._shuffled(n, seed), s.sample(frac=1, random_state=seed).values)


@pytest.mark.parametrize("n,test_size,seed", [(10, 0.3, 42), (999, 0.1, 7),
                                              (50, 0.98, 0), (40, 5, 1)])
def test_train_test_split_is_sklearn(n, test_size, seed):
    from sklearn.model_selection import train_test_split

    ids = np.arange(n) * 3
    tr, te = tukbb._train_test_split(n, test_size, seed)
    want_tr, want_te = train_test_split(ids, test_size=test_size,
                                        random_state=seed)
    np.testing.assert_array_equal(ids[tr], want_tr)
    np.testing.assert_array_equal(ids[te], want_te)
    with pytest.raises(ValueError):
        tukbb._train_test_split(n, 0.0, seed)


@pytest.mark.parametrize("n,n_q,subsample", [(50, 1000, 100_000),
                                             (3000, 1000, 100_000),
                                             (5000, 300, 1200)])
def test_quantile_normal_is_sklearn(n, n_q, subsample):
    from sklearn.preprocessing import quantile_transform

    rng = np.random.default_rng(n)
    y = np.round(rng.gamma(2.0, 3.0, n), 2)    # ties, a skewed tail
    y[::13] = np.nan
    want = quantile_transform(y.reshape(-1, 1), output_distribution="normal",
                              random_state=42, n_quantiles=n_q,
                              subsample=subsample).reshape(-1)
    got = tukbb._quantile_normal(y, seed=42, n_quantiles=n_q,
                                 subsample=subsample)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("values", [
    np.array([11012.0, 11010.0, np.nan, 11012.0, 11025.0]),
    np.array([3, 1, 2, 3]),
    np.array(["b", "a", np.nan, "c", "a"], dtype=object),
])
def test_one_hot_is_sklearn(values):
    from sklearn.preprocessing import OneHotEncoder

    enc = OneHotEncoder(handle_unknown="ignore")
    with object_strings():
        enc.fit(pd.Series(values).unique().reshape(-1, 1))
    want = enc.transform(values.reshape(-1, 1)).toarray().astype(int)
    got = tukbb._one_hot(values, tukbb._categories(values))
    np.testing.assert_array_equal(got, want)
