"""The port's command line (kgwas_tpu_torch/cli.py) through ``--device
cpu``: the cases of tests/test_cli.py on --synthetic, the same flow on a
layout-exact bundle (tests/test_torch_realdata.py's), a checkpoint trained
by the JAX package's CLI served by the port's predict, --watchdog-timeout's
relaunch under the stall watchdog, and the flags of options not ported
yet, which raise before any data loads.
"""
import os

import numpy as np
import pandas as pd
import pytest
import torch

from kgwas_tpu.cli import main as jax_main
from kgwas_tpu_torch import cli
from kgwas_tpu_torch.cli import main
from test_torch_realdata import sumstats_frame, write_bundle, write_sumstats
from torch_threads import few_torch_threads  # noqa: F401,E402

SYNTH = ["--synthetic", "--device", "cpu", "--seed", "7"]


@pytest.fixture(scope="module")
def trained_dir(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("cli_data"))
    run = main(["train", *SYNTH, "--data-path", d, "--name", "cli_t",
                "--hidden", "16", "--epochs", "1", "--batch-size", "256",
                "--pallas"])
    return d, run


def test_cli_train_artifacts(trained_dir):
    d, run = trained_dir
    model_dir = os.path.join(d, "model", "cli_t")
    for f in ("model.npz", "config.pkl", "pred.csv"):
        assert os.path.exists(os.path.join(model_dir, f)), f
    # --pallas is accepted and leaves no trace in the model's config
    assert "use_pallas" not in run.config
    assert run.device.type == "cpu"


def test_cli_predict(trained_dir, tmp_path):
    d, run = trained_dir
    out = str(tmp_path / "preds.npy")
    pred = main(["predict", *SYNTH, "--data-path", d, "--name", "cli_t",
                 "--out", out])
    saved = np.load(out)
    assert saved.shape == (2000,) and np.all(np.isfinite(saved))
    assert np.array_equal(saved, pred)
    assert np.array_equal(saved, run.predict_all())


def test_cli_interpret(trained_dir, tmp_path):
    d, _ = trained_dir
    out = str(tmp_path / "dcn.csv")
    tables = main(["interpret", *SYNTH, "--data-path", d, "--name", "cli_t",
                   "--variant-threshold", "0.5", "--out", out])
    dcn = pd.read_csv(out)
    assert len(dcn) > 0
    assert list(dcn.columns) == list(tables[2])


@pytest.mark.parametrize("flag,case", [
    (["--mesh", "8"], "mesh outside torchrun"),
    (["--dtype", "bfloat16", "--aggr", "max"], "bf16 GAT max"),
])
def test_cli_mesh_outside_torchrun_raises_and_bf16_gat_max_trains(
        tmp_path, flag, case):
    """Two flags that once raised for options not yet ported. --mesh 8 in
    a process that torchrun did not start (no process group of 8 ranks)
    raises ValueError before loading: the data path is never made. A bf16
    --dtype on GAT max (the per-relation softmax GAT) trains an epoch with
    finite losses."""
    d = tmp_path / "never"
    if case == "mesh outside torchrun":
        with pytest.raises(ValueError, match="torchrun"):
            main(["train", *SYNTH, "--data-path", str(d), *flag])
        assert not d.exists()
        return
    run = main(["train", *SYNTH, "--data-path", str(d), "--hidden", "8",
                "--epochs", "1", "--batch-size", "256", *flag])
    assert run.model_cfg.compute_dtype == "bfloat16"
    assert run.model_cfg.gnn_aggr == "max"
    assert np.all(np.isfinite(run.epoch_losses[0]))


def test_cli_watchdog_timeout_relaunches(tmp_path, monkeypatch):
    """--watchdog-timeout runs the same command again as a child process
    (python -m kgwas_tpu_torch.cli, KGWAS_UNDER_WATCHDOG and KGWAS_HEARTBEAT
    set) under the stall watchdog; the child trains, touching the
    heartbeat, and its artifacts are on disk when the parent returns 0."""
    from kgwas_tpu_torch.engine import watchdog

    d = str(tmp_path / "wd")
    argv = ["train", *SYNTH, "--data-path", d, "--name", "wd", "--hidden",
            "8", "--epochs", "1", "--batch-size", "512",
            "--watchdog-timeout", "300", "--watchdog-restarts", "0"]
    calls = []
    real = watchdog.run_with_watchdog

    def spy(cmd, heartbeat, **kw):
        calls.append((list(cmd), heartbeat, kw))
        rc = real(cmd, heartbeat, poll_s=0.5, **kw)
        calls[-1] += (os.path.exists(heartbeat),)
        return rc

    monkeypatch.setattr(watchdog, "run_with_watchdog", spy)
    assert main(argv) == 0
    (cmd, hb, kw, beat), = calls
    assert cmd[1:3] == ["-m", "kgwas_tpu_torch.cli"] and cmd[3:] == argv
    assert kw["env"]["KGWAS_UNDER_WATCHDOG"] == "1"
    assert kw["env"]["KGWAS_HEARTBEAT"] == hb and beat
    assert (kw["stall_timeout_s"], kw["max_restarts"]) == (300.0, 0)
    for f in ("model.npz", "config.pkl", "pred.csv"):
        assert os.path.exists(os.path.join(d, "model", "wd", f)), f


def test_cli_heads_and_remat_run(tmp_path):
    """--heads and --remat run: a 2-head model trained with each layer
    recomputed in the backward, its checkpoint served by predict."""
    d = str(tmp_path)
    run = main(["train", *SYNTH, "--data-path", d, "--name", "h2", "--hidden",
                "8", "--epochs", "1", "--batch-size", "512", "--heads", "2",
                "--remat"])
    assert run.model_cfg.gat_num_head == 2 and run.model_cfg.remat
    assert run.config["gat_num_head"] == 2 and "remat" not in run.config
    assert run.model.lin.weight.shape == (1, 16)
    pred = main(["predict", *SYNTH, "--data-path", d, "--name", "h2",
                 "--out", os.path.join(d, "pred.npy")])
    np.testing.assert_array_equal(pred, run.predict_all())


@pytest.mark.parametrize("cmd", ["train", "predict", "interpret"])
def test_cli_without_card_or_device_raises(tmp_path, monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = tmp_path / "never"
    with pytest.raises(RuntimeError, match="CUDA"):
        main([cmd, "--synthetic", "--data-path", str(d)])
    with pytest.raises(RuntimeError, match="CUDA"):
        main([cmd, "--synthetic", "--data-path", str(d), "--device", "cuda"])
    assert not d.exists()


def test_cli_warm_cache_builds_the_kernels(monkeypatch, capsys):
    from kgwas_tpu_torch.ops import build

    calls = []
    monkeypatch.setattr(build, "build_all",
                        lambda names=None: calls.append(names) or {"k": 1.0})
    assert main(["warm-cache", "--shapes", "bench", "demo"]) == {"k": 1.0}
    assert calls == [None]
    assert "kernels built" in capsys.readouterr().out


def test_cli_bench_runs_the_port_bench(monkeypatch):
    from kgwas_tpu_torch import bench_lib

    seen = {}
    monkeypatch.delenv("BENCH_STEPS", raising=False)
    monkeypatch.setattr(bench_lib, "main", lambda device=None: seen.update(
        device=device, steps=os.environ["BENCH_STEPS"]))
    main(["bench", "--steps", "3", "--device", "cpu"])
    assert seen == {"device": "cpu", "steps": "3"}


# ------------------------------------------------------- on the bundle

@pytest.fixture(scope="module")
def bundle_runs(tmp_path_factory):
    """One bundle; the port's CLI trains on it, and so does the JAX
    package's CLI (another model name)."""
    root = str(tmp_path_factory.mktemp("cli_bundle"))
    snp_ids = write_bundle(root)
    gwas = os.path.join(root, "sumstats.fastGWA")
    write_sumstats(gwas, sumstats_frame(snp_ids))
    common = ["--data-path", root, "--gwas", gwas, "--hidden", "16",
              "--epochs", "1", "--batch-size", "16", "--seed", "7"]
    run = main(["train", "--device", "cpu", "--name", "port", *common])
    jax_main(["train", "--name", "jax", *common])
    return {"root": root, "gwas": gwas, "run": run}


def test_cli_train_on_the_bundle(bundle_runs):
    root, run = bundle_runs["root"], bundle_runs["run"]
    for f in ("model.npz", "config.pkl", "pred.csv"):
        assert os.path.exists(os.path.join(root, "model", "port", f)), f
    kp = run.kgwas_res["KGWAS_P"]
    assert np.all(np.isfinite(kp) & (kp >= 0) & (kp <= 1))
    assert run.data.gene_init_dim_size == 5120


def test_cli_predict_on_the_bundle_serves_the_trained_state(bundle_runs,
                                                            tmp_path):
    out = str(tmp_path / "p.npy")
    pred = main(["predict", "--device", "cpu", "--data-path",
                 bundle_runs["root"], "--name", "port", "--out", out])
    assert np.array_equal(pred, bundle_runs["run"].predict_all())


def test_port_predict_serves_the_jax_cli_checkpoint(bundle_runs, tmp_path):
    """The JAX CLI's checkpoint, served by the port's predict and by the
    JAX predict: float32 in another summation order (rtol 1e-5, atol 1e-6,
    as tests/test_torch_train.py serves a checkpoint)."""
    args = ["--data-path", bundle_runs["root"], "--name", "jax"]
    jout, pout = str(tmp_path / "j.npy"), str(tmp_path / "p.npy")
    jax_main(["predict", *args, "--out", jout])
    main(["predict", "--device", "cpu", *args, "--out", pout])
    want, got = np.load(jout), np.load(pout)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_cli_interpret_on_the_bundle(bundle_runs, tmp_path):
    """interpret writes the disease-critical network with commas, quoted
    where a cell holds one, as to_csv writes it."""
    out = str(tmp_path / "dcn.csv")
    tables = main(["interpret", "--device", "cpu", "--data-path",
                   bundle_runs["root"], "--gwas", bundle_runs["gwas"],
                   "--name", "port", "--variant-threshold", "0.5",
                   "--out", out])
    dcn = tables[2]
    back = pd.read_csv(out)
    assert len(back) == len(dcn["h_idx"]) > 0
    assert list(back.columns) == list(dcn)
    frame = pd.DataFrame({k: list(v) for k, v in dcn.items()})
    with open(out) as f:
        text = f.read()
    assert text == frame.to_csv(index=False)
    assert '"Process' in text and '""part""' in text


def test_cli_parser_covers_the_jax_cli():
    """Every subcommand and flag of the JAX CLI parses in the port's."""
    import kgwas_tpu.cli as jc
    import argparse

    def flags(mod):
        seen = {}
        orig = argparse.ArgumentParser.parse_args

        def capture(self, argv=None, namespace=None):
            for a in self._actions:
                if isinstance(a, argparse._SubParsersAction):
                    for name, p in a.choices.items():
                        seen[name] = sorted(o for act in p._actions
                                            for o in act.option_strings)
            raise SystemExit(0)

        argparse.ArgumentParser.parse_args = capture
        try:
            with pytest.raises(SystemExit):
                mod.main([])
        finally:
            argparse.ArgumentParser.parse_args = orig
        return seen

    jax_flags, port_flags = flags(jc), flags(cli)
    assert sorted(port_flags) == sorted(jax_flags)
    for cmd, opts in jax_flags.items():
        assert set(opts) <= set(port_flags[cmd]), cmd
        extra = set(port_flags[cmd]) - set(opts)
        assert extra <= {"--device", "--gwas"}, (cmd, extra)
