"""The port's external tool wrappers (external/gwas_runner.py,
external/magma.py, KGWAS.run_magma and the CLI's classic-gwas and magma)
against the JAX package's, with mock plink2 / gcta64 / magma shell scripts
that check their argv and write outputs in the tools' formats (the cases
of tests/test_external.py).

The JAX package reads the tools' outputs with pandas' C parser, which does
not always round to the nearest float; the port rounds correctly. Float
columns are held to 1 ulp, everything else exactly.
"""
import os
import stat

import numpy as np
import pandas as pd
import pytest

import kgwas_tpu.external.gwas_runner as jg
import kgwas_tpu.external.magma as jm
import kgwas_tpu_torch.external.gwas_runner as pg
import kgwas_tpu_torch.external.magma as pm
from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.cli import main


def _mock_binary(path, script):
    with open(path, "w") as f:
        f.write("#!/bin/bash\n" + script)
    os.chmod(path, os.stat(path).st_mode | stat.S_IEXEC)
    return str(path)


def _writer(out_suffix, text, check=""):
    """A mock tool that writes text to <--out><out_suffix>, after an
    optional argv check."""
    return (check + 'while [[ $# -gt 0 ]]; do if [[ "$1" == "--out" ]]; '
            'then OUT="$2"; fi; shift; done\n'
            f"cat > \"${{OUT}}{out_suffix}\" <<'END'\n{text}END\n")


def _plink_text(n=40, seed=0, logistic=False):
    rng = np.random.default_rng(seed)
    beta = rng.standard_normal(n) * 0.05
    se = rng.uniform(0.01, 0.05, n)
    p = 10.0 ** -rng.uniform(0, 12, n)
    if logistic:
        head = "#CHROM\tPOS\tID\tREF\tALT\tA1\tTEST\tOBS_CT\tOR\tLOG(OR)_SE" \
               "\tZ_STAT\tP\n"
        rows = [f"{rng.integers(1, 23)}\t{100 * i + 1}\trs{i}\tA\tG\tG\tADD\t"
                f"2000\t{np.exp(b):.7g}\t{s:.7g}\t{b / s:.7g}\t{q:.7g}"
                for i, (b, s, q) in enumerate(zip(beta, se, p))]
    else:
        head = "#CHROM\tPOS\tID\tREF\tALT\tA1\tTEST\tOBS_CT\tBETA\tSE" \
               "\tT_STAT\tP\n"
        rows = [f"{rng.integers(1, 23)}\t{100 * i + 1}\trs{i}\tA\tG\tG\tADD\t"
                f"2000\t{b:.7g}\t{s:.7g}\t{b / s:.7g}\t{q:.7g}"
                for i, (b, s, q) in enumerate(zip(beta, se, p))]
    rows[3] = rows[3].rsplit("\t", 1)[0] + "\tNA"
    return head + "\n".join(rows) + "\n"


def _fastgwa_text(n=40, seed=1):
    rng = np.random.default_rng(seed)
    head = "CHR\tSNP\tPOS\tA1\tA2\tN\tAF1\tBETA\tSE\tP\n"
    rows = [f"{rng.integers(1, 23)}\trs{i}\t{1000 + i}\tA\tG\t5000\t"
            f"{rng.uniform(0.05, 0.5):.7g}\t{rng.standard_normal() * 0.02:.7g}"
            f"\t{rng.uniform(0.005, 0.02):.7g}\t{10.0 ** -rng.uniform(0, 9):.7g}"
            for i in range(n)]
    return head + "\n".join(rows) + "\n"


def assert_table_within_ulp(got, df):
    """A port table against a DataFrame read by pandas' C parser: names in
    order, dtype kinds, strings and ints exactly, floats to 1 ulp."""
    assert list(got) == list(df.columns)
    for c in df.columns:
        want, have = df[c].to_numpy(), np.asarray(got[c])
        if want.dtype.kind == "f":
            assert have.dtype.kind == "f", c
            assert np.array_equal(np.isnan(have), np.isnan(want)), c
            ok = ~np.isnan(want)
            ulp = np.abs(have[ok].view(np.int64) - want[ok].view(np.int64))
            assert ulp.max(initial=0) <= 1, (c, ulp.max())
        elif want.dtype.kind in "iub":
            assert have.dtype.kind == want.dtype.kind, c
            assert np.array_equal(have, want), c
        else:
            assert [str(v) for v in have.tolist()] == \
                [str(v) for v in want.tolist()], c


def test_select_engine_rules():
    # PLINK for N <= 3000 or a binary trait
    assert pg.select_engine(3000, False) == "plink"
    assert pg.select_engine(5000, True) == "plink"
    assert pg.select_engine(5000, False) == "fastgwa"
    for n in (1, 2999, 3000, 3001, 10**6):
        for b in (False, True):
            assert pg.select_engine(n, b) == jg.select_engine(n, b)


@pytest.mark.parametrize("binary", [False, True])
def test_plink_path_parses_like_jax(tmp_path, binary):
    result_dir = tmp_path / "results"
    result_dir.mkdir()
    suffix = (".PHENO1.glm.logistic.hybrid" if binary
              else ".PHENO1.glm.linear")
    check = ('[[ "$*" == *"--glm hide-covar --pheno /fake/pheno.txt"* ]] '
             '|| exit 3\n')
    plink = _mock_binary(tmp_path / "plink2", _writer(
        suffix, _plink_text(logistic=binary), check))
    kw = dict(bfile="/fake/bfile", result_dir=str(result_dir),
              plink2_bin=plink)
    got = pg.run_classic_gwas(pg.GwasToolConfig(**kw), "/fake/pheno.txt",
                              "run", sample_size=2000, binary=binary)
    want = jg.run_classic_gwas(jg.GwasToolConfig(**kw), "/fake/pheno.txt",
                               "run", sample_size=2000, binary=binary)
    assert list(got["ID"][:2]) == ["rs0", "rs1"] and "P" in got
    assert_table_within_ulp(got, want)


def test_fastgwa_path_parses_and_renames_like_jax(tmp_path):
    result_dir = tmp_path / "results"
    result_dir.mkdir()
    check = ('[[ "$*" == *"--grm-sparse /fake/grm --fastGWA-mlm"* ]] '
             '|| exit 3\n')
    gcta = _mock_binary(tmp_path / "gcta64",
                        _writer(".fastGWA", _fastgwa_text(), check))
    kw = dict(bfile="/fake/bfile", result_dir=str(result_dir),
              gcta_bin=gcta, grm_sparse="/fake/grm")
    got = pg.run_classic_gwas(pg.GwasToolConfig(**kw), "/fake/pheno.txt",
                              "fg", sample_size=5000)
    want = jg.run_classic_gwas(jg.GwasToolConfig(**kw), "/fake/pheno.txt",
                               "fg", sample_size=5000)
    assert "#CHROM" in got and "ID" in got
    assert_table_within_ulp(got, want)


def test_failing_tool_raises(tmp_path):
    bad = _mock_binary(tmp_path / "plink2", "exit 7\n")
    cfg = pg.GwasToolConfig(bfile="/fake", result_dir=str(tmp_path),
                            plink2_bin=bad)
    with pytest.raises(RuntimeError, match="code 7"):
        pg.run_classic_gwas(cfg, "/fake/pheno", "x", sample_size=100)


def test_fastgwa_requires_grm(tmp_path):
    cfg = pg.GwasToolConfig(bfile="/fake", result_dir=str(tmp_path))
    with pytest.raises(ValueError):
        pg.run_fastgwa(cfg, "/fake/pheno", "x")


def test_cli_classic_gwas_writes_what_jax_writes(tmp_path):
    """classic-gwas through both CLIs on one mock fastGWA: the same
    sumstats file, byte for byte (7-digit floats read and written
    back)."""
    from kgwas_tpu.cli import main as jax_main

    gcta = _mock_binary(tmp_path / "gcta64",
                        _writer(".fastGWA", _fastgwa_text()))
    outs = []
    for name, fn in (("port", main), ("jax", jax_main)):
        d = tmp_path / name
        d.mkdir()
        fn(["classic-gwas", "--bfile", "/fake/b", "--pheno", "/fake/p",
            "--sample-size", "5000", "--grm", "/fake/grm", "--gcta-bin",
            gcta, "--result-dir", str(d), "--name", "g"])
        outs.append((d / "g.sumstats.tsv").read_bytes())
    assert outs[0] == outs[1]


class FakeData:
    def _download_with_progress(self, url, path):
        raise AssertionError("should not download; the annotation exists")


def _fake_run(tmp_path, table):
    class FakeRun:
        data_path = str(tmp_path)
        save_name = "magma_test"
        data = FakeData()
        kgwas_res = table
    return FakeRun()


def test_magma_wrapper_matches_jax(tmp_path):
    """run_magma writes the (SNP, P) input and runs the binary with MAGMA's
    argv; the input file is the JAX package's, byte for byte."""
    magma = _mock_binary(tmp_path / "magma", (
        '[[ "$1" == "--bfile" && "$2" == "/fake/bfile" && "$3" == '
        '"--gene-annot" && "$6" == *_magma_format.csv && "$7" == "N=5000" '
        '&& "$8" == "--out" ]] || exit 3\necho "MAGMA mock ran with: $@"\n'))
    (tmp_path / "gene_annotation.genes.annot").write_text("fake annot")
    table = {"ID": np.array(["rs1", "rs2", "rs3"], dtype=object),
             "KGWAS_P": np.array([0.01, 0.5, 1e-12]),
             "N": np.array([5000, 5000, 5000])}
    out_prefix = pm.run_magma(_fake_run(tmp_path, table), magma,
                              "/fake/bfile")
    magma_input = os.path.join(str(tmp_path), "model_pred", "new_experiments",
                               "magma_test_magma_format.csv")
    port_bytes = open(magma_input, "rb").read()
    df = pd.read_csv(magma_input, sep="\t")
    assert list(df.columns) == ["SNP", "P"]
    assert out_prefix.endswith("magma_test_magma_out")
    jax_prefix = jm.run_magma(_fake_run(tmp_path, pd.DataFrame(table)),
                              magma, "/fake/bfile")
    assert jax_prefix == out_prefix
    assert open(magma_input, "rb").read() == port_bytes


def test_magma_needs_n(tmp_path):
    table = {"ID": np.array(["rs1"], dtype=object),
             "KGWAS_P": np.array([0.1])}
    with pytest.raises(ValueError, match="N missing"):
        pm.run_magma(_fake_run(tmp_path, table), "magma", "/fake/bfile")


def test_kgwas_run_magma_and_cli_magma(tmp_path):
    """KGWAS.run_magma on a trained model's KGWAS_P, and the CLI's magma
    on its checkpoint (kgwas_res from pred.csv): one MAGMA input each,
    equal."""
    data = KGWAS_Data.from_synthetic(n_snp=300, n_gene=40, n_go=12, seed=3,
                                     data_path=str(tmp_path))
    data.load_synthetic_gwas(seed=3)
    data.process_gwas_file()
    data.prepare_split()
    run = KGWAS(data, device="cpu", exp_name="mg", seed=3)
    run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=8)
    run.train(batch_size=64, epoch=1)
    magma = _mock_binary(tmp_path / "magma", 'echo "ok $@"\n')
    (tmp_path / "gene_annotation.genes.annot").write_text("fake annot")
    prefix = run.run_magma(magma, "/fake/bfile")
    path = prefix.replace("_magma_out", "_magma_format.csv")
    first = open(path, "rb").read()
    # round_trip: the correctly rounded values (pandas' default parser
    # can be off in the last digits of 17-digit text)
    df = pd.read_csv(path, sep="\t", float_precision="round_trip")
    assert list(df.SNP) == list(run.kgwas_res["ID"])
    np.testing.assert_array_equal(df.P.values, run.kgwas_res["KGWAS_P"])
    os.remove(path)
    # the CLI loads the same synthetic KG (its fixed sizes differ, so train
    # it there first) and reads kgwas_res from the checkpoint's pred.csv
    d = str(tmp_path / "cli")
    main(["train", "--synthetic", "--device", "cpu", "--data-path", d,
          "--name", "mg", "--hidden", "8", "--epochs", "1", "--seed", "3"])
    (tmp_path / "cli" / "gene_annotation.genes.annot").write_text("a")
    prefix = main(["magma", "--synthetic", "--device", "cpu", "--data-path",
                   d, "--name", "mg", "--seed", "3", "--magma-bin", magma,
                   "--bfile", "/fake/bfile"])
    written = pd.read_csv(prefix.replace("_magma_out", "_magma_format.csv"),
                          sep="\t", float_precision="round_trip")
    pred = pd.read_csv(os.path.join(d, "model", "mg", "pred.csv"), sep="\t",
                       float_precision="round_trip")
    assert list(written.SNP) == list(pred.ID)
    np.testing.assert_array_equal(written.P.values, pred.KGWAS_P.values)
    assert len(first) > 0
