"""The port's experiment scripts (kgwas_tpu_torch/scripts, kgwas_tpu_torch/
demo) against the JAX package's scripts and demos, on the CPU:

  (i)   make_synthetic_sumstats(return_causal=True): the table column by
        column and the causal indices, exactly, for n_causal 0, the
        default and 7, two seeds
  (ii)  loci_leads and count_loci against scripts/run_sweep.py's and
        scripts/run_calibration.py's (loaded from their files) on tables
        with hits on several chromosomes, leads within 0.1 cM, tied
        p-values and positions (where numpy's quicksort, pandas' default,
        orders ties otherwise than a stable sort), and no hits: exactly
  (iii) job_list and the jobs each process runs, from the JAX main and
        the port's, for both modes and several host slots (the port's
        slot also from torchrun's RANK / WORLD_SIZE)
  (iv)  run_seed (both arms) and run_job (synthetic subsample, and the
        real-bundle simulation and subsample paths) against the JAX
        functions, KGWAS.train patched on both sides to return the same
        table: the whole result, wall_s aside, equal as JSON
  (v)   a resumed calibration run trains nothing for the seeds it has,
        and only the missing seed otherwise
  (vi)  the port's summarizers print the JAX scripts' text on the port's
        CPU runs' JSONs, on sweep_results_syn50k/ and on
        benchmarks/calib_v2/ (both read only)

and the entry points' CPU runs: run_calibration and run_sweep through
main([... "--cpu"]) at 2,000 SNPs, hidden 16, 1 epoch; kgwas_101,
kgwas_simulation and disease_critical_network on their synthetic
fallbacks; kgwas_subsampling on the fabricated bundle of
test_torch_realdata.py with hits in its studies; run_magma with a missing
binary (external/magma.py prints that and returns None); every one of
them raises without --cpu when there is no card.
"""
import importlib.util
import json
import os
import runpy
import shutil
import sys
import tempfile
from argparse import Namespace
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

import kgwas_tpu
import kgwas_tpu.graph.synthetic as jsyn
import kgwas_tpu_torch.graph.synthetic as psyn
from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.demo import (disease_critical_network, kgwas_101,
                                  kgwas_simulation, kgwas_subsampling,
                                  run_magma)
from kgwas_tpu_torch.utils import n_rows
from kgwas_tpu_torch.scripts import (loci, run_calibration, run_sweep,
                                     summarize_calibration,
                                     summarize_subsample)
from test_torch_realdata import bundle, study_files, write_sumstats  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401,E402

ROOT = Path(__file__).resolve().parents[1]
CPU_RUN = ["--cpu", "--hidden", "16", "--epochs", "1"]


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_calib():
    return _load_script("run_calibration")


@pytest.fixture(scope="module")
def jax_sweep():
    return _load_script("run_sweep")


def _frame(table):
    return pd.DataFrame({k: np.asarray(v) for k, v in table.items()})


def _as_json(d):
    return json.dumps({k: v for k, v in d.items() if k != "wall_s"},
                      sort_keys=True)


# ---------------------------------------------------------------- (i)

@pytest.mark.parametrize("seed", [0, 3])
@pytest.mark.parametrize("n_causal", [0, None, 7], ids=["0", "default", "7"])
def test_synthetic_sumstats_with_causal_matches_jax(n_causal, seed):
    jt, jc = jsyn.make_synthetic_sumstats(500, n_causal=n_causal, seed=seed,
                                          return_causal=True)
    pt, pc = psyn.make_synthetic_sumstats(500, n_causal=n_causal, seed=seed,
                                          return_causal=True)
    assert list(pt) == list(jt.columns)
    for k in jt.columns:
        assert np.array_equal(np.asarray(pt[k]), jt[k].to_numpy()), k
    assert pc.dtype == jc.dtype and np.array_equal(pc, jc)
    assert len(pc) == (25 if n_causal is None else n_causal)
    plain = psyn.make_synthetic_sumstats(500, n_causal=n_causal, seed=seed)
    assert all(np.array_equal(plain[k], pt[k]) for k in pt)


# ---------------------------------------------------------------- (ii)

def _loci_table(case):
    """A KGWAS-shaped result (ID, #CHROM, POS, P, KGWAS_P) and its raw
    sumstats (CHR, SNP, POS)."""
    rng = np.random.default_rng(11)
    n = 400
    chrom = rng.integers(1, 6, n)
    pos = np.sort(rng.integers(1, 2_000_000, n))
    p = rng.uniform(1e-6, 1, n)
    kp = rng.uniform(1e-6, 1, n)
    if case == "chromosomes":
        hit = rng.choice(n, 40, replace=False)
        p[hit] = 10.0 ** rng.uniform(-20, -8, 40)
        kp[hit[:25]] = 10.0 ** rng.uniform(-20, -8, 25)
    elif case == "close_leads":
        # runs of hits a few kb apart (< 0.1 cM) on one chromosome
        chrom[100:160] = 3
        pos[100:160] = 500_000 + np.arange(60) * 30_000
        p[100:160] = 10.0 ** rng.uniform(-15, -8, 60)
        kp[100:160:2] = 1e-10
    elif case == "ties":
        # tied p-values and tied positions among many hits
        hit = rng.choice(n, 120, replace=False)
        p[hit] = rng.choice([1e-9, 1e-12, 3e-10], 120)
        kp[hit] = rng.choice([1e-9, 2e-11], 120)
        chrom[hit[:60]] = 2
        pos[hit[:60]] = rng.choice([700_000, 710_000, 1_500_000], 60)
    ids = np.array([f"rs{i}" for i in range(n)], dtype=object)
    res = {"#CHROM": chrom, "ID": ids, "POS": pos, "P": p, "KGWAS_P": kp}
    sumstats = {"CHR": chrom, "SNP": ids, "POS": pos}
    return res, sumstats


@pytest.mark.parametrize("case", ["chromosomes", "close_leads", "ties",
                                  "no_hits"])
def test_loci_match_jax_scripts(case, jax_calib, jax_sweep):
    res, sumstats = _loci_table(case)
    jres, jss = _frame(res), _frame(sumstats)
    for col in ("P", "KGWAS_P"):
        got = loci.loci_leads(res, col)
        want = jax_sweep.loci_leads(jres, col)
        assert got == want, col
        assert (loci.count_loci(res, col, sumstats)
                == jax_calib.count_loci(jres, col, jss)), col
        assert loci.count_loci(res, col, sumstats) == len(got)
    if case == "no_hits":
        assert got == [] and loci.count_loci(res, "P", sumstats) == 0
    if case == "ties":
        # the hits' p-values tie where quicksort (pandas' default) and a
        # stable sort disagree; the port ranks the hits as the JAX
        # scripts' hits.sort_values(p_col).ID does (with singleton clumps
        # the loci do not depend on it, the clumps' order does)
        for col in ("P", "KGWAS_P"):
            p = res[col][res[col] < 5e-8]
            assert not np.array_equal(p.argsort(kind="quicksort"),
                                      p.argsort(kind="stable"))
            hits = jres[jres[col] < 5e-8]
            assert (loci._ranked_hits(res, col, 5e-8).tolist()
                    == hits.sort_values(col).ID.tolist())


# ---------------------------------------------------------------- (iii)

MODES = {
    "simulation": ["--mode", "simulation", "--simulation-type", "causal",
                   "--seed-start", "2", "--seed-end", "9"],
    "subsample": ["--mode", "subsample", "--phenos", "a", "b",
                  "--sample-sizes", "5000", "12500", "--seed-start", "1",
                  "--seed-end", "4"],
}


def _jobs_run(module, argv, monkeypatch, tmp_path, port):
    ran = []

    def fake(job, args):
        ran.append(tuple(job))
        return {"job": list(job)}

    monkeypatch.setattr(module, "run_job", fake)
    out = ["--out-dir", tempfile.mkdtemp(dir=tmp_path)]
    if port:
        module.main(argv + out + ["--cpu"])
    else:
        monkeypatch.setattr(sys, "argv", ["run_sweep.py"] + argv + out)
        module.main()
    return ran


@pytest.mark.parametrize("mode", sorted(MODES))
def test_job_list_and_host_slots_match_jax(mode, jax_sweep, monkeypatch,
                                           tmp_path):
    argv = MODES[mode]
    args = run_sweep.parser().parse_args(argv)
    assert run_sweep.job_list(args) == jax_sweep.job_list(args)
    for slot in ([], ["--host-index", "0", "--num-hosts", "3"],
                 ["--host-index", "1", "--num-hosts", "3"],
                 ["--host-index", "2", "--num-hosts", "3"],
                 ["--host-index", "0"], ["--mesh-data", "1"]):
        want = _jobs_run(jax_sweep, argv + slot, monkeypatch, tmp_path, False)
        got = _jobs_run(run_sweep, argv + slot, monkeypatch, tmp_path, True)
        assert got == want and want, slot
    # torchrun's RANK / WORLD_SIZE give the slot --host-index gives JAX
    for rank in range(3):
        want = _jobs_run(jax_sweep, argv + ["--host-index", str(rank),
                                            "--num-hosts", "3"],
                         monkeypatch, tmp_path, False)
        monkeypatch.setenv("RANK", str(rank))
        monkeypatch.setenv("WORLD_SIZE", "3")
        got = _jobs_run(run_sweep, argv, monkeypatch, tmp_path, True)
        monkeypatch.delenv("RANK")
        monkeypatch.delenv("WORLD_SIZE")
        assert got == want and want
    # a JSON that exists is skipped by both
    first = run_sweep.job_list(args)[0]
    ran = {}
    for name, module, extra in (("j", jax_sweep, []),
                                ("p", run_sweep, ["--cpu"])):
        done = tmp_path / f"done_{name}"
        done.mkdir()
        (done / ("_".join(map(str, first)) + ".json")).write_text("{}")
        ran[name] = []
        monkeypatch.setattr(module, "run_job",
                            lambda job, a, r=ran[name]: r.append(job) or {})
        monkeypatch.setattr(sys, "argv", ["run_sweep.py"] + argv
                            + ["--out-dir", str(done)])
        module.main(*([argv + ["--out-dir", str(done)] + extra]
                      if extra else []))
    assert ran["p"] == ran["j"] and ran["j"] and first not in ran["j"]


# ---------------------------------------------------------------- (iv)

def _fake_columns(n, p, seed):
    """The fixed pred and KGWAS_P a patched train returns: KGWAS_P below
    5e-8 on a share of the rows, some of them tied."""
    rng = np.random.default_rng(seed)
    pred = rng.standard_normal(n)
    kp = np.clip(np.asarray(p) * 10.0 ** rng.uniform(-9, 0.3, n), 0, 1)
    kp[rng.choice(n, max(n // 25, 1), replace=False)] = 1e-9
    return pred, kp


METRICS = {"mse": 1.5, "pearsonr": float("nan")}


def _patch_train(monkeypatch):
    """KGWAS.train of both packages returns the data's sumstats with the
    same pred and KGWAS_P, and sets the same test metrics and scale
    factor."""
    def jax_train(self, *args, **kwargs):
        table = self.data.lr_uni.copy()
        table["pred"], table["KGWAS_P"] = _fake_columns(
            len(table), table["P"].to_numpy(), self.seed)
        self.test_metrics, self.scale_factor = dict(METRICS), 1.25
        return table

    def port_train(self, *args, **kwargs):
        table = {k: np.array(v, copy=True)
                 for k, v in self.data.lr_uni.items()}
        table["pred"], table["KGWAS_P"] = _fake_columns(
            len(table["P"]), table["P"], self.seed)
        self.test_metrics, self.scale_factor = dict(METRICS), 1.25
        self.train_seconds = {"setup": 0.0, "epochs": 0.0, "tail": 0.0}
        return table

    monkeypatch.setattr(kgwas_tpu.KGWAS, "train", jax_train)
    monkeypatch.setattr(KGWAS, "train", port_train)


def test_run_seed_matches_jax(jax_calib, monkeypatch, tmp_path):
    _patch_train(monkeypatch)
    args = Namespace(n_snp=600, hidden=8, batch_size=64, epochs=1, cpu=True)
    kg = dict(n_snp=600, n_gene=60, n_go=100, seed=0)
    jdata = kgwas_tpu.KGWAS_Data.from_synthetic(
        data_path=str(tmp_path / "j"), **kg)
    pdata = KGWAS_Data.from_synthetic(data_path=str(tmp_path / "p"), **kg)
    for arm, seed in (("null", 1), ("causal", 2), ("causal", 5)):
        want = jax_calib.run_seed(jdata, {}, arm, seed, args)
        split = {}
        got = run_calibration.run_seed(pdata, {}, arm, seed, args, split)
        assert _as_json(got) == _as_json(want), (arm, seed)
        assert isinstance(got["wall_s"], float)
        assert set(split) == set(run_calibration.SPLIT_KEYS)
        assert split["pred_csv"] <= split["tail"]
        if arm == "causal":
            assert got["kgwas_true_pos"] > 0 and got["gwas_loci"] > 0


def _sweep_args(**kw):
    base = dict(data_path=None, synthetic_n_snp=0, ref_n=50_000, layers=2,
                hidden=8, epochs=1, batch_size=64, mesh_data=None,
                snp_emb="enformer", go_emb="random", gene_emb="esm",
                sample_edges=False, sample_ratio=1.0, cpu=True)
    base.update(kw)
    return Namespace(**base)


def test_run_job_synthetic_matches_jax(jax_sweep, monkeypatch, tmp_path):
    _patch_train(monkeypatch)
    for job in (("subsample", "1", 50_000, 1), ("subsample", "2", 12_500, 3)):
        want = jax_sweep.run_job(job, _sweep_args(
            synthetic_n_snp=800, data_path=str(tmp_path / "j")))
        got = run_sweep.run_job(job, _sweep_args(
            synthetic_n_snp=800, data_path=str(tmp_path / "p")))
        assert _as_json(got) == _as_json(want), job
        assert got["n_causal"] == 8 and got["kgwas_loci"]


@pytest.fixture(scope="module")
def hit_studies(study_files, tmp_path_factory):
    """The studies of test_torch_realdata.py with P below 5e-8 on eight
    SNPs in the null simulation, the subsample and the full cohort."""
    root = str(tmp_path_factory.mktemp("hit_studies"))
    shutil.copytree(study_files, root, dirs_exist_ok=True)
    for rel in ("simulation_gwas/null_simulation/20000_1_0.3_5000.fastGWA",
                "subsample_gwas/body_BMIz_fastgwa_full_5000_2.fastGWA",
                "full_gwas/body_BMIz_with_rel_fastgwa.fastGWA"):
        path = os.path.join(root, rel)
        df = pd.read_csv(path, sep="\t")
        df.loc[df.index[3:11], "P"] = [1e-12, 1e-9, 1e-9, 2e-15, 3e-8, 1e-9,
                                       4e-10, 1e-20]
        write_sumstats(path, df)
    return root + "/"


@pytest.mark.parametrize("job", [("simulation", "null", 1),
                                 ("subsample", "body_BMIz", 5000, 2)],
                         ids=["simulation", "subsample"])
def test_run_job_real_bundle_matches_jax(job, hit_studies, jax_sweep,
                                         monkeypatch):
    _patch_train(monkeypatch)
    want = jax_sweep.run_job(job, _sweep_args(data_path=hit_studies))
    got = run_sweep.run_job(job, _sweep_args(data_path=hit_studies))
    assert _as_json(got) == _as_json(want)
    assert got["gwas_hits_5e8"] == 8 and got["gwas_loci"]
    assert "n_causal" not in got


# ------------------------------------------------- (v), (vi), CPU runs

CALIB_KEYS = {"arm", "seed", "gwas_hits", "kgwas_hits", "gwas_loci",
              "kgwas_loci", "scale_factor", "wall_s"}
CAUSAL_KEYS = CALIB_KEYS | {"gwas_true_pos", "gwas_false_pos",
                            "kgwas_true_pos", "kgwas_false_pos", "n_causal"}


@pytest.fixture(scope="module")
def calib_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("calib")
    run_calibration.main(["--n-snp", "2000", "--null-seeds", "1",
                          "--causal-seeds", "1", "--out-dir", str(out)]
                         + CPU_RUN)
    return out


def test_run_calibration_cpu(calib_dir):
    """The JSONs hold the JAX runner's keys; the GWAS side equals a
    recount from the seed's sumstats draw alone."""
    for arm, keys in (("null", CALIB_KEYS), ("causal", CAUSAL_KEYS)):
        out = json.loads((calib_dir / f"{arm}_1.json").read_text())
        assert set(out) == keys
        n_causal = 0 if arm == "null" else 100
        ss, causal = psyn.make_synthetic_sumstats(
            2000, n_causal=n_causal, seed=10_001, return_causal=True)
        res = {"ID": ss["SNP"], "P": ss["P"]}
        assert out["gwas_hits"] == int((ss["P"] < 5e-8).sum())
        assert out["gwas_loci"] == loci.count_loci(res, "P", ss)
        assert 0 <= out["kgwas_hits"] <= 2000
        if arm == "causal":
            hits = set(ss["SNP"][ss["P"] < 5e-8].tolist())
            causal = {f"rs{i}" for i in causal}
            assert out["n_causal"] == 100
            assert out["gwas_true_pos"] == len(hits & causal) > 0
            assert out["gwas_false_pos"] == len(hits - causal)


def test_resumed_calibration_trains_only_missing_seeds(calib_dir,
                                                       monkeypatch,
                                                       tmp_path):
    out = tmp_path / "resume"
    shutil.copytree(calib_dir, out)
    before = {p.name: (p.read_bytes(), p.stat().st_mtime_ns)
              for p in out.glob("*.json")}
    trained = []
    real_train = KGWAS.train

    def counting(self, *args, **kwargs):
        trained.append(self.exp_name)
        return real_train(self, *args, **kwargs)

    monkeypatch.setattr(KGWAS, "train", counting)
    argv = ["--n-snp", "2000", "--null-seeds", "1", "--causal-seeds", "1",
            "--out-dir", str(out)] + CPU_RUN
    run_calibration.main(argv)
    assert trained == []
    assert {p.name: (p.read_bytes(), p.stat().st_mtime_ns)
            for p in out.glob("*.json")} == before
    (out / "null_1.json").unlink()
    run_calibration.main(argv)
    assert trained == ["calib_null_1"]
    again = json.loads((out / "null_1.json").read_text())
    assert _as_json(again) == _as_json(json.loads(before["null_1.json"][0]))


@pytest.fixture(scope="module")
def sweep_dir(tmp_path_factory):
    out = tmp_path_factory.mktemp("sweep")
    run_sweep.main(["--mode", "subsample", "--synthetic-n-snp", "2000",
                    "--phenos", "1", "--sample-sizes", "12500", "50000",
                    "--seed-start", "1", "--seed-end", "2",
                    "--data-path", str(out / "data"),
                    "--out-dir", str(out / "json")] + CPU_RUN)
    return out / "json"


def test_run_sweep_cpu(sweep_dir):
    keys = {"job", "gwas_hits_5e8", "kgwas_hits_5e8", "test_metrics",
            "scale_factor", "gwas_loci", "kgwas_loci", "n_causal",
            "gwas_causal_recovered", "kgwas_causal_recovered"}
    files = sorted(p.name for p in sweep_dir.glob("*.json"))
    assert files == ["subsample_1_12500_1.json", "subsample_1_50000_1.json"]
    for name in files:
        out = json.loads((sweep_dir / name).read_text())
        assert set(out) == keys
        _, pheno, n, seed = out["job"]
        ss, causal = psyn.make_synthetic_subsample_sumstats(
            2000, int(pheno), n, seed, return_causal=True)
        res = {"ID": ss["SNP"], "#CHROM": ss["CHR"], "POS": ss["POS"],
               "P": ss["P"]}
        hit = ss["P"] < 5e-8
        assert out["gwas_hits_5e8"] == int(hit.sum())
        assert [tuple(x) for x in out["gwas_loci"]] == loci.loci_leads(
            res, "P")
        assert out["n_causal"] == len(causal) == 20
        assert out["gwas_causal_recovered"] == int(hit[causal].sum())


def _jax_summary(script, argv, monkeypatch, capsys):
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [script] + argv)
    runpy.run_path(str(ROOT / "scripts" / script), run_name="__main__")
    return capsys.readouterr().out


def test_summarize_calibration_matches_jax(calib_dir, monkeypatch, capsys):
    for d in (calib_dir, ROOT / "benchmarks" / "calib_v2"):
        want = _jax_summary("summarize_calibration.py", [str(d)],
                            monkeypatch, capsys)
        summarize_calibration.main([str(d)])
        got = capsys.readouterr().out
        assert got == want and "null: n=" in got


def test_summarize_subsample_matches_jax(sweep_dir, monkeypatch, capsys):
    for d, ref_n in ((sweep_dir, 50_000),
                     (ROOT / "sweep_results_syn50k", 50_000),
                     (ROOT / "sweep_results_syn50k", 25_000)):
        argv = ["--out-dir", str(d), "--ref-n", str(ref_n)]
        want = _jax_summary("summarize_subsample.py", argv, monkeypatch,
                            capsys)
        summarize_subsample.main(argv)
        got = capsys.readouterr().out
        assert got == want and "## Trait seed" in got


# ---------------------------------------------------------------- demos

def test_demo_kgwas_101_and_network(tmp_path, capsys):
    """kgwas_101 on the synthetic KG to its checkpoint reload, then the
    disease-critical network demo on that checkpoint."""
    path = str(tmp_path / "d") + "/"
    run, run2 = kgwas_101.main(["--synthetic", "--data-path", path]
                               + CPU_RUN)
    out = capsys.readouterr().out
    assert "reloaded checkpoint OK" in out and "KGWAS_P" in out
    np.testing.assert_array_equal(run2.predict_all(), run.predict_all())
    net, variants, dcn = disease_critical_network.main(
        ["--data-path", path, "--cpu", "--variant-threshold", "1e-3"])
    assert os.path.exists(path + "disease_critical_network.csv")
    assert n_rows(dcn) and n_rows(net) and n_rows(variants)
    assert set(dcn["Category"].tolist()) <= {"V2G", "G2G", "G2P"}


def test_demo_network_trains_without_checkpoint(tmp_path, monkeypatch):
    trained = []
    real_train = KGWAS.train

    def short(self, *args, **kwargs):
        trained.append(kwargs)
        return real_train(self, *args, **{**kwargs, "epoch": 1})

    monkeypatch.setattr(KGWAS, "train", short)
    net, variants, dcn = disease_critical_network.main(
        ["--data-path", str(tmp_path), "--cpu", "--variant-threshold", "1e-2"])
    assert trained == [{"epoch": 2, "batch_size": 512}]
    assert n_rows(net)


def test_demo_kgwas_simulation(tmp_path, capsys):
    out = tmp_path / "sim.json"
    results = kgwas_simulation.main(
        ["--seeds", "1", "3", "--data-path", str(tmp_path / "d"),
         "--out", str(out)] + CPU_RUN)
    assert [r["seed"] for r in results] == [1, 2]
    assert json.loads(out.read_text()) == results
    for r in results:
        # the null draw: one causal SNP of 2,000
        ss = psyn.make_synthetic_sumstats(2000, n_causal=1,
                                          seed=r["seed"] + 10000)
        assert r["gwas_hits"] == int((ss["P"] < 5e-8).sum())
    assert "null false positives per seed" in capsys.readouterr().out


def test_demo_kgwas_subsampling(hit_studies, tmp_path):
    out = tmp_path / "sub.json"
    rows = kgwas_subsampling.main(
        ["--data-path", hit_studies, "--pheno", "body_BMIz",
         "--sample-sizes", "5000", "--seeds", "2", "--epochs", "1",
         "--hidden", "16", "--out", str(out), "--cpu"])
    assert json.loads(out.read_text()) == rows
    (row,) = rows
    assert row["pheno"] == "body_BMIz" and row["sample_size"] == 5000
    assert 0 <= row["recall_at_k"] <= 1 and 0 <= row["precision_at_k"] <= 1


def test_demo_run_magma_without_binary(tmp_path, capsys):
    path = str(tmp_path / "m") + "/"
    kgwas_101.main(["--synthetic", "--data-path", path] + CPU_RUN)
    # present, so nothing is downloaded
    Path(path, "gene_annotation.genes.annot").write_text("")
    capsys.readouterr()
    got = run_magma.main(["--data-path", path, "--magma-bin",
                          str(tmp_path / "no_magma"), "--bfile", "g1000",
                          "--cpu"])
    assert got is None
    assert "MAGMA executable not found" in capsys.readouterr().err
    magma_in = Path(path, "model_pred/new_experiments/"
                    "kgwas_101_magma_format.csv")
    assert magma_in.read_text().splitlines()[0] == "SNP\tP"


ENTRY_POINTS = {
    "run_calibration": (run_calibration, ["--n-snp", "2000"]),
    "run_sweep": (run_sweep, ["--synthetic-n-snp", "2000"]),
    "kgwas_101": (kgwas_101, ["--synthetic"]),
    "kgwas_simulation": (kgwas_simulation, []),
    "disease_critical_network": (disease_critical_network, []),
    "kgwas_subsampling": (kgwas_subsampling, []),
    "run_magma": (run_magma, ["--magma-bin", "magma", "--bfile", "b"]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_points_raise_without_a_card(name, monkeypatch, tmp_path):
    module, argv = ENTRY_POINTS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main(argv + ["--data-path", str(tmp_path / "d")]
                    if name != "run_calibration" else
                    argv + ["--out-dir", str(tmp_path / "o")])
    assert not (tmp_path / "o").exists() and not (tmp_path / "d").exists()


def test_run_sweep_coordinator_trains_over_the_group(sweep_dir, tmp_path):
    """--coordinator joins a process group over TCP (one gloo rank here)
    and --mesh-data trains each job over it: rank 0 writes the JSON the
    single-process run wrote, its test metrics within rtol 1e-5 (the
    mesh path sums the float32 predictions in another order)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    out = tmp_path / "json"
    try:
        run_sweep.main(["--mode", "subsample", "--synthetic-n-snp", "2000",
                        "--phenos", "1", "--sample-sizes", "12500",
                        "--seed-start", "1", "--seed-end", "2",
                        "--data-path", str(tmp_path / "data"),
                        "--out-dir", str(out), "--coordinator",
                        f"localhost:{port}", "--num-processes", "1",
                        "--process-id", "0", "--mesh-data", "1"] + CPU_RUN)
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    name = "subsample_1_12500_1.json"
    got = json.loads((out / name).read_text())
    want = json.loads((sweep_dir / name).read_text())
    for k in ("mse", "pearsonr"):
        np.testing.assert_allclose(got["test_metrics"].pop(k),
                                   want["test_metrics"].pop(k), rtol=1e-5)
    assert got == want
