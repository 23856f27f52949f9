"""The port's process-level stall watchdog (kgwas_tpu_torch/engine/
watchdog.py), the three watchdog cases of tests/test_resilience.py: a
stalled process is killed by process group and relaunched, a persistent
stall exhausts the budget, and a KGWAS.train run of the port wedged
mid-training (alive, no exception, no progress) is relaunched and resumes
from the newest train state its first attempt saved
(checkpoint_every=1, resume=True). The port has no compile step, so the
stall timeouts are short: they cover start-up, the data and a first step.
"""
import json
import pathlib
import sys
import textwrap

import pytest

from kgwas_tpu_torch.engine.watchdog import WatchdogStall, run_with_watchdog
from torch_threads import few_torch_threads  # noqa: F401,E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_watchdog_restarts_stalled_process(tmp_path):
    """A process that heartbeats then hangs is killed by process group and
    relaunched; the relaunch completes."""
    hb = tmp_path / "hb"
    mark = tmp_path / "attempt"
    script = tmp_path / "job.py"
    script.write_text(textwrap.dedent(f"""
        import pathlib, sys, time
        hb = pathlib.Path({str(hb)!r})
        mark = pathlib.Path({str(mark)!r})
        n = int(mark.read_text()) if mark.exists() else 0
        mark.write_text(str(n + 1))
        if n == 0:
            hb.touch()
            time.sleep(3600)        # hang: no further heartbeats
        for _ in range(3):
            hb.touch()
            time.sleep(0.05)
        sys.exit(0)
    """))
    rc = run_with_watchdog(
        [sys.executable, "-S", str(script)], heartbeat=str(hb),
        stall_timeout_s=2.0, max_restarts=1, poll_s=0.2,
    )
    assert rc == 0
    assert int(mark.read_text()) == 2


def test_watchdog_gives_up_after_budget(tmp_path):
    """Persistent hangs exhaust max_restarts and raise WatchdogStall."""
    script = tmp_path / "hang.py"
    script.write_text("import time\ntime.sleep(3600)\n")
    with pytest.raises(WatchdogStall):
        run_with_watchdog(
            [sys.executable, "-S", str(script)],
            heartbeat=str(tmp_path / "hb"),
            stall_timeout_s=0.8, max_restarts=1, poll_s=0.2,
        )


# the child process of the end-to-end test: the first attempt wedges after
# four heartbeats (alive, no exception, no progress); every attempt trains
# with checkpoint_every=1 and resume=True
WEDGED_TRAIN = """
import json, pathlib, sys, time
sys.path.insert(0, {root!r})
mark = pathlib.Path({mark!r})
attempt = int(mark.read_text()) if mark.exists() else 0
mark.write_text(str(attempt + 1))
if attempt == 0:
    import kgwas_tpu_torch.engine.watchdog as wd
    _orig = wd.touch_heartbeat
    calls = [0]
    def wedged_touch(path):
        calls[0] += 1
        if calls[0] > 4:
            time.sleep(3600)
        _orig(path)
    wd.touch_heartbeat = wedged_touch

from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.engine.checkpoint import latest_train_state
data = KGWAS_Data.from_synthetic(n_snp=300, n_gene=60, n_go=25, seed=5,
                                 data_path={base!r})
data.load_synthetic_gwas(seed=5)
data.process_gwas_file()
data.prepare_split()
run = KGWAS(data, device="cpu", exp_name="wedge", seed=5)
run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=16, no_relu=True)
latest = latest_train_state({base!r} + "model/wedge/train_state")
run.train(batch_size=64, epoch=3, lr=1e-3, save_best_model=False,
          checkpoint_every=1, resume=True, heartbeat_path={hb!r})
pathlib.Path({result!r}).write_text(json.dumps(dict(
    attempt=attempt, epochs=len(run.train_history), resumed_from=latest)))
"""


def test_watchdog_recovers_wedged_training_e2e(tmp_path):
    """A KGWAS.train run of the port wedges silently mid-training; the
    watchdog kills its process group and relaunches it; the relaunch
    resumes from the newest train state the first attempt saved and
    completes. The port has no compile step, so the stall timeout covers
    start-up, data and the first step only."""
    hb, mark, result = (str(tmp_path / n) for n in ("hb", "attempt",
                                                    "result.json"))
    script = tmp_path / "train_job.py"
    script.write_text(WEDGED_TRAIN.format(
        root=str(ROOT), mark=mark, base=str(tmp_path / "data") + "/", hb=hb,
        result=result))
    rc = run_with_watchdog([sys.executable, str(script)], heartbeat=hb,
                           stall_timeout_s=40.0, max_restarts=1, poll_s=0.5)
    assert rc == 0
    assert int(pathlib.Path(mark).read_text()) == 2, "one relaunch"
    out = json.loads(pathlib.Path(result).read_text())
    assert out["attempt"] == 1, "completion must come from the relaunch"
    assert out["epochs"] == 3
    # four steps ran before the wedge, each saved
    assert out["resumed_from"].endswith("step_4")
