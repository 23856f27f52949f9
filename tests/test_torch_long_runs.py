"""Long runs in the port (kgwas_tpu_torch/engine/resilience.py,
engine/checkpoint.py's train state, engine/watchdog.py, and the options of
KGWAS.train) against the JAX package's, after tests/test_resilience.py and
tests/test_engine.py::test_checkpoint_resume.

  * the classification table: every case of the JAX package's test gives
    the same answer from both functions; the CUDA cases on their side;
  * the backoff schedule;
  * a run with an injected transient fault ends bitwise equal to the clean
    run on the CPU, and its per-epoch losses match the JAX package's faulty
    run from the same initial parameters (params_from_jax) at rtol 1e-4;
    fatal errors raise; the restart budget runs out;
  * checkpoint_every + resume: the saved and the restored train states are
    bitwise the run's at that step; the resumed losses match the JAX
    package's (scan_steps=0, one step per dispatch as in the port) at rtol
    1e-4; a partly written step_N.tmp is never the newest state;

The watchdog's tests are in tests/test_torch_watchdog.py (a file of their
own: the end-to-end one waits out a stall). The JAX runs share one
configuration, so their compiles hit the JAX package's persistent
compilation cache after the first.
"""
import os

import jax
import numpy as np
import pytest
import torch

from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.engine import resilience as jres
from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.engine import checkpoint, params_from_jax
from kgwas_tpu_torch.engine import resilience
from kgwas_tpu_torch.engine.resilience import (RetryPolicy,
                                               is_transient_backend_error)
from torch_threads import few_torch_threads  # noqa: F401,E402

DATA = dict(n_snp=300, n_gene=60, n_go=25, seed=5)
MODEL = dict(gnn_num_layers=2, gnn_hidden_dim=16, no_relu=True)
TRAIN = dict(batch_size=64, lr=1e-3, save_best_model=False)


class _FakeXlaRuntimeError(RuntimeError):
    pass


_FakeXlaRuntimeError.__name__ = "XlaRuntimeError"

# the cases of tests/test_resilience.py::test_classification
JAX_CASES = {
    "internal": (RuntimeError("INTERNAL: TPU backend error"), True),
    "xla-unavailable": (_FakeXlaRuntimeError("UNAVAILABLE: socket closed"),
                        True),
    "connection": (ConnectionError("relay went away"), True),
    "remote-compile": (RuntimeError(
        "http://127.0.0.1:8103/remote_compile: HTTP 500"), True),
    "oom": (RuntimeError("RESOURCE_EXHAUSTED: out of memory allocating 4G"),
            False),
    "invalid-argument": (RuntimeError(
        "INTERNAL error while INVALID_ARGUMENT: shape"), False),
    "value-error": (ValueError("INTERNAL"), False),
    "keyboard": (KeyboardInterrupt(), False),
}

# the CUDA failure modes: sticky errors poison the context (fatal), a busy
# or unavailable card can be had later (transient)
CUDA_CASES = {
    "cuda-oom": (torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"), False),
    "accelerator-illegal": (torch.AcceleratorError(
        "CUDA error: an illegal memory access was encountered"), False),
    "accelerator-assert": (torch.AcceleratorError(
        "CUDA error: device-side assert triggered"), False),
    "accelerator-busy": (torch.AcceleratorError(
        "CUDA error: CUDA-capable device(s) is/are busy or unavailable"),
        True),
    "runtime-illegal": (RuntimeError(
        "CUDA error: an illegal memory access was encountered"), False),
    "runtime-assert": (RuntimeError(
        "CUDA error: device-side assert triggered\nCUDA kernel errors "
        "might be asynchronously reported"), False),
    "launch-failure": (RuntimeError(
        "CUDA error: unspecified launch failure"), False),
    "ecc": (RuntimeError(
        "CUDA error: uncorrectable ECC error encountered"), False),
    "cublas-internal": (RuntimeError(
        "CUDA error: CUBLAS_STATUS_INTERNAL_ERROR when calling "
        "`cublasSgemm( handle, opa, opb, m, n, k, &alpha, a, lda, b, ldb, "
        "&beta, c, ldc)`"), False),
    "cublas-exec": (RuntimeError(
        "CUDA error: CUBLAS_STATUS_EXECUTION_FAILED when calling "
        "`cublasSgemm`"), False),
    "runtime-busy": (RuntimeError(
        "CUDA error: CUDA-capable device(s) is/are busy or unavailable"),
        True),
}


@pytest.mark.parametrize("name", list(JAX_CASES))
def test_classification_matches_jax(name):
    exc, transient = JAX_CASES[name]
    assert is_transient_backend_error(exc) is transient
    assert jres.is_transient_backend_error(exc) is transient


@pytest.mark.parametrize("name", list(CUDA_CASES))
def test_classification_of_cuda_errors(name):
    exc, transient = CUDA_CASES[name]
    assert is_transient_backend_error(exc) is transient


def test_backoff_schedule():
    p = RetryPolicy(max_restarts=5, backoff_s=2.0, backoff_mult=3.0,
                    max_backoff_s=10.0)
    assert [p.wait(i) for i in (1, 2, 3)] == [2.0, 6.0, 10.0]
    slept = []
    resilience.sleep_backoff(p, 2, sleep=slept.append)
    assert slept == [6.0]
    q = jres.RetryPolicy(max_restarts=5, backoff_s=2.0, backoff_mult=3.0,
                         max_backoff_s=10.0)
    assert [q.wait(i) for i in range(1, 6)] == [p.wait(i)
                                                for i in range(1, 6)]


# ------------------------------------------------------ in-process restarts

def _transient_at(step):
    fired = {"n": 0}

    def hook(global_step):
        if global_step == step and fired["n"] == 0:
            fired["n"] += 1
            raise RuntimeError("INTERNAL: backend error (injected)")
    return hook


def _port_data(root):
    data = KGWAS_Data.from_synthetic(data_path=str(root), **DATA)
    data.load_synthetic_gwas(seed=5)
    data.process_gwas_file()
    data.prepare_split()
    return data


def _jax_run(root, tag):
    data = JaxData.from_synthetic(data_path=str(root) + "/", **DATA)
    data.load_synthetic_gwas(seed=5)
    data.process_gwas_file()
    data.prepare_split()
    run = JaxKGWAS(data, exp_name=tag, seed=5)
    run.initialize_model(**MODEL)
    return run


@pytest.fixture(scope="module")
def no_backoff():
    saved = resilience.sleep_backoff, jres.sleep_backoff
    resilience.sleep_backoff = jres.sleep_backoff = lambda *a, **k: None
    yield
    resilience.sleep_backoff, jres.sleep_backoff = saved


@pytest.fixture(scope="module")
def restarted(tmp_path_factory, no_backoff):
    """The port clean and with a transient fault before step 7 (in epoch 2
    of 3), and the JAX package's faulty run, from the same parameters."""
    root = tmp_path_factory.mktemp("restart")
    jrun = _jax_run(root / "jax", "faulty")
    init = jax.tree_util.tree_map(np.array, jrun.params)
    jrun._fault_hook = _transient_at(7)
    jrun.train(epoch=3, max_restarts=2, **TRAIN)
    data = _port_data(root / "port")
    runs = {}
    for tag in ("clean", "faulty"):
        run = KGWAS(data, device="cpu", exp_name=tag, seed=5)
        run.initialize_model(**MODEL)
        run.model.load_state_dict(params_from_jax(init))
        if tag == "faulty":
            run._fault_hook = _transient_at(7)
        run.train(epoch=3, max_restarts=2 if tag == "faulty" else 0, **TRAIN)
        runs[tag] = run
    return runs, jrun


def test_recovery_completes_training(restarted):
    runs, jrun = restarted
    faulty = runs["faulty"]
    assert faulty.restart_count == jrun.restart_count == 1
    assert len(faulty.train_history) == 3
    assert ((faulty.kgwas_res["KGWAS_P"] >= 0)
            & (faulty.kgwas_res["KGWAS_P"] <= 1)).all()
    assert np.isfinite(faulty.predict_all()).all()
    assert len(faulty.snapshot_seconds) == 4        # at start, 3 epoch ends
    assert len(faulty.recovery_seconds) == 1


def test_recovery_is_bitwise_the_clean_run(restarted):
    runs, _ = restarted
    clean, faulty = runs["clean"], runs["faulty"]
    assert clean.restart_count == 0
    assert faulty.epoch_losses == clean.epoch_losses
    assert [r["loss"] for r in faulty.train_history] == [
        r["loss"] for r in clean.train_history]
    for k in clean.params:
        assert torch.equal(faulty.params[k], clean.params[k]), k
        assert torch.equal(faulty.best_params[k], clean.best_params[k]), k
    assert faulty.best_epoch == clean.best_epoch


def test_recovery_losses_match_jax(restarted):
    runs, jrun = restarted
    faulty = runs["faulty"]
    assert [len(e) for e in faulty.epoch_losses] == [
        len(e) for e in jrun.epoch_losses]
    # float32 in another summation order, and Adam, whose update is about
    # lr whatever the gradient's size (tests/test_torch_train.py)
    for got, want in zip(faulty.epoch_losses, jrun.epoch_losses):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert faulty.best_epoch == jrun.best_epoch


@pytest.mark.parametrize("exc", [
    RuntimeError("RESOURCE_EXHAUSTED: out of memory"),
    torch.cuda.OutOfMemoryError("CUDA out of memory."),
    torch.AcceleratorError("CUDA error: device-side assert triggered"),
    ValueError("INTERNAL"),
])
def test_fatal_errors_still_raise(tmp_path, no_backoff, exc):
    run = KGWAS(_port_data(tmp_path), device="cpu", exp_name="fatal", seed=6)
    run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=8)

    def hook(global_step):
        if global_step == 2:
            raise exc

    run._fault_hook = hook
    with pytest.raises(type(exc)):
        run.train(batch_size=64, epoch=2, lr=1e-3, max_restarts=3,
                  save_best_model=False)
    assert run.restart_count == 0


def test_restart_budget_exhausted(tmp_path, no_backoff):
    run = KGWAS(_port_data(tmp_path), device="cpu", exp_name="budget",
                seed=7)
    run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=8)

    def hook(global_step):
        raise RuntimeError("INTERNAL: backend error (always)")

    run._fault_hook = hook
    with pytest.raises(RuntimeError, match="INTERNAL"):
        run.train(batch_size=64, epoch=2, lr=1e-3, max_restarts=2,
                  save_best_model=False)
    assert run.restart_count == 2


# ------------------------------------------------- checkpoint_every, resume

def _state_at(run, step, out):
    """A fault hook that keeps copies of the model's and the optimizer's
    state when global_step reaches step (after that many steps)."""
    import copy

    def hook(global_step):
        if global_step == step and "model" not in out:
            out["model"] = copy.deepcopy(run.model.state_dict())
            out["optimizer"] = copy.deepcopy(run.optimizer.state_dict())
    return hook


def _assert_state_equal(got, want):
    if isinstance(want, torch.Tensor):
        assert torch.equal(got, want)
    elif isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_state_equal(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_state_equal(a, b)
    else:
        assert got == want


@pytest.fixture(scope="module")
def resumed(tmp_path_factory):
    """Both packages: a run with checkpoint_every=3, then a run with
    resume=True, from the same initial parameters; the port's states at
    step 6 (saved) and at the resumed run's start kept by fault hooks."""
    root = tmp_path_factory.mktemp("resume")
    jruns = []
    for kw in (dict(checkpoint_every=3), dict(resume=True)):
        jrun = _jax_run(root / "jax", "ckpt")
        if not jruns:
            init = jax.tree_util.tree_map(np.array, jrun.params)
        jrun.train(epoch=2, scan_steps=0, **kw, **TRAIN)
        jruns.append(jrun)
    data = _port_data(root / "port")
    runs, states = [], []
    for kw in (dict(checkpoint_every=3), dict(resume=True)):
        run = KGWAS(data, device="cpu", exp_name="ckpt", seed=5)
        run.initialize_model(**MODEL)
        run.model.load_state_dict(params_from_jax(init))
        state = {}
        run._fault_hook = _state_at(run, 6 if not runs else 0, state)
        if runs:
            # a write cut short is never the newest state
            with open(os.path.join(ckpt_dir, "step_999.tmp"), "wb") as f:
                f.write(b"partial")
            assert checkpoint.latest_train_state(ckpt_dir).endswith("step_6")
        run.train(epoch=2, **kw, **TRAIN)
        ckpt_dir = os.path.join(str(root / "port"), "model", "ckpt",
                                "train_state")
        runs.append(run)
        states.append(state)
    return runs, states, jruns, ckpt_dir


def test_checkpoint_files(resumed):
    runs, _, jruns, ckpt_dir = resumed
    steps = sorted(int(f.split("_")[1]) for f in os.listdir(ckpt_dir)
                   if f.split("_")[1].isdigit())
    # one step at a time: every multiple of checkpoint_every (8 steps)
    assert steps == [3, 6]
    assert sum(len(e) for e in runs[0].epoch_losses) == 8


def test_saved_state_is_bitwise_the_runs(resumed):
    _, states, _, ckpt_dir = resumed
    model_state, opt_state = checkpoint.restore_train_state(
        os.path.join(ckpt_dir, "step_6"))
    _assert_state_equal(model_state, states[0]["model"])
    _assert_state_equal(opt_state, states[0]["optimizer"])


def test_resumed_run_starts_from_the_newest_state(resumed):
    _, states, _, ckpt_dir = resumed
    model_state, opt_state = checkpoint.restore_train_state(
        checkpoint.latest_train_state(ckpt_dir))
    _assert_state_equal(states[1]["model"], model_state)
    _assert_state_equal(states[1]["optimizer"], opt_state)


def test_resumed_losses_match_jax(resumed):
    runs, _, jruns, _ = resumed
    for run, jrun in zip(runs, jruns):
        assert [len(e) for e in run.epoch_losses] == [
            len(e) for e in jrun.epoch_losses]
        for got, want in zip(run.epoch_losses, jrun.epoch_losses):
            np.testing.assert_allclose(got, want, rtol=1e-4)
    # the resumed run starts where step 6 left off, not from the start
    assert not np.allclose(runs[1].epoch_losses[0][0],
                           runs[0].epoch_losses[0][0], rtol=1e-6)


def test_partial_state_file_is_ignored(tmp_path):
    assert checkpoint.latest_train_state(str(tmp_path / "none")) is None
    (tmp_path / "step_3").write_bytes(b"x")
    (tmp_path / "step_12.tmp").write_bytes(b"")
    (tmp_path / "step_x").write_bytes(b"")
    assert checkpoint.latest_train_state(str(tmp_path)) == str(
        tmp_path / "step_3")
