"""The port's training observability and bench entry against the JAX
package's:

  * ``ThroughputMeter`` writes the JAX meter's records and JSON lines for
    the same calls (the clock mocked);
  * ``KGWAS.train(profile_dir=..., metrics_log=...)`` on the CPU writes a
    Chrome trace that parses, asks the profiler for no CUDA activity, and
    appends one JSON line per epoch with the JAX package's keys;
  * ``weight_bias_track=True`` with a stub ``wandb`` module: the same
    sequence of ``init`` and ``log`` keys as ``kgwas_tpu.KGWAS`` gives with
    the same stub; without wandb it raises ImportError, as the JAX
    package's does;
  * ``bench_lib.main(device="cpu")`` at a tiny size prints one JSON line
    with the JAX module's keys (``edge_pad`` beside ``node_pad``), its
    edge count that of the JAX package's ``compile_graph`` at the same
    edge padding, a finite positive value; the JAX module's options the
    port does not run raise NotImplementedError naming their items.
"""
import glob
import itertools
import json
import math
import os
import sys
import types

import numpy as np
import pytest
import torch

from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.engine import profiling as jax_profiling
from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg

from kgwas_tpu_torch import KGWAS, KGWAS_Data, bench_lib
from kgwas_tpu_torch.engine import profiling
from torch_threads import few_torch_threads  # noqa: F401,E402

JAX_RECORD_KEYS = ["epoch", "steps", "epoch_time_s", "edges_per_sec", "loss",
                   "val_mse", "val_pearsonr"]
SMALL = dict(n_snp=120, n_gene=24, n_go=10, seed=4)


def _clock(monkeypatch, module):
    ticks = itertools.count(start=10.0, step=0.75)
    monkeypatch.setattr(module.time, "perf_counter", lambda: next(ticks))


def test_throughput_meter_writes_the_jax_records(tmp_path, monkeypatch):
    logs = {}
    for name, mod in (("port", profiling), ("jax", jax_profiling)):
        _clock(monkeypatch, mod)
        logs[name] = str(tmp_path / f"{name}.jsonl")
        meter = mod.ThroughputMeter(1234, log_path=logs[name])
        for ep, steps in ((1, 3), (2, 0), (3, 5)):
            meter.start_epoch()
            for _ in range(steps):
                meter.step()
            meter.end_epoch(ep, extra={"loss": 0.5 * ep} if ep != 2 else None)
        logs[name + "_history"] = meter.history
    assert logs["port_history"] == logs["jax_history"]
    with open(logs["port"]) as a, open(logs["jax"]) as b:
        assert a.read() == b.read()


def _small_data(pkg, path):
    data = pkg.from_synthetic(data_path=path, **SMALL)
    data.load_synthetic_gwas(seed=4)
    data.process_gwas_file()
    data.prepare_split()
    return data


def test_train_writes_trace_and_metrics_log(tmp_path, monkeypatch):
    from torch import profiler

    asked = []
    real = profiler.profile

    def recording_profile(*args, activities=None, **kw):
        asked.append(list(activities))
        return real(*args, activities=activities, **kw)

    monkeypatch.setattr(profiler, "profile", recording_profile)
    run = KGWAS(_small_data(KGWAS_Data, str(tmp_path)), device="cpu",
                seed=4).initialize_model(gnn_hidden_dim=16, no_relu=True)
    log = str(tmp_path / "metrics.jsonl")
    trace_dir = str(tmp_path / "trace")
    run.train(batch_size=32, epoch=2, lr=1e-3, save_best_model=False,
              profile_dir=trace_dir, metrics_log=log)
    # epoch 1 only, and the CPU alone without a card
    assert asked == [[profiler.ProfilerActivity.CPU]]
    traces = glob.glob(os.path.join(trace_dir, "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::" in n for n in names)
    assert not any(e.get("cat") == "kernel" for e in events)
    with open(log) as f:
        recs = [json.loads(line) for line in f]
    assert [list(r) for r in recs] == [JAX_RECORD_KEYS] * 2
    assert [r["epoch"] for r in recs] == [1, 2]
    assert recs == run.train_history
    steps = len(run.epoch_losses[0])
    assert recs[0]["steps"] == steps > 0
    assert recs[0]["loss"] == run.epoch_losses[0][-1]


def _wandb_stub(calls):
    stub = types.ModuleType("wandb")
    stub.init = lambda **kw: calls.append(("init", sorted(kw.items())))
    stub.log = lambda d: calls.append(("log", sorted(d)))
    return stub


def test_wandb_hooks_match_jax(tmp_path, monkeypatch):
    calls = {"port": [], "jax": []}
    kw = dict(weight_bias_track=True, proj_name="P", exp_name="E", seed=4)
    monkeypatch.setitem(sys.modules, "wandb", _wandb_stub(calls["port"]))
    port = KGWAS(_small_data(KGWAS_Data, str(tmp_path / "port")),
                 device="cpu", **kw).initialize_model(gnn_hidden_dim=16)
    port.train(batch_size=32, epoch=2, lr=1e-3, save_best_model=False)
    monkeypatch.setitem(sys.modules, "wandb", _wandb_stub(calls["jax"]))
    jrun = JaxKGWAS(_small_data(JaxData, str(tmp_path / "jax")), **kw)
    jrun.initialize_model(gnn_hidden_dim=16)
    jrun.train(batch_size=32, epoch=2, lr=1e-3, save_best_model=False)
    assert calls["port"] == calls["jax"]
    assert calls["port"][0] == ("init", [("name", "E"), ("project", "P")])
    logged = [c[1] for c in calls["port"][1:]]
    assert logged.count(["training_loss"]) == sum(
        map(len, port.epoch_losses))
    assert logged[-2:] == [["test_mse"], ["test_pearsonr"]]
    # without wandb: the import fails, as in the JAX package
    monkeypatch.setitem(sys.modules, "wandb", None)
    with pytest.raises(ImportError):
        KGWAS(port.data, device="cpu", weight_bias_track=True)


BENCH_ENV = dict(BENCH_N_SNP="200", BENCH_N_GENE="40", BENCH_N_GO="15",
                 BENCH_STEPS="4", BENCH_HIDDEN="32")


def test_bench_prints_one_json_line(monkeypatch, capsys):
    for k, v in BENCH_ENV.items():
        monkeypatch.setenv(k, v)
    bench_lib.main(device="cpu")
    out = capsys.readouterr()
    lines = out.out.strip().split("\n")
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert list(rec) == ["metric", "value", "unit", "vs_baseline", "config"]
    assert rec["metric"] == "kg_edge_traversals_per_sec_per_chip"
    assert rec["unit"] == "edge_traversals/s"
    assert list(rec["config"]) == ["node_pad", "edge_pad", "n_snp", "edges",
                                   "layers", "dtype", "scan", "step_ms"]
    cg = jax_compile_graph(jax_make_kg(
        n_snp=200, n_gene=40, n_go=15, snp_dim=20, gene_dim=128, go_dim=128,
        avg_degree=6, seed=0), edge_pad_multiple=8192)
    assert rec["config"]["edges"] == cg.total_real_edges()
    assert (rec["config"]["edge_pad"], rec["config"]["node_pad"]) == (8192,
                                                                      512)
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    assert rec["vs_baseline"] == round(
        rec["value"] / bench_lib.REF_EDGE_TRAVERSALS_PER_SEC_A100, 3)
    assert out.err.startswith("# device=cpu edges=")


def test_bench_runs_with_heads(monkeypatch, capsys):
    """BENCH_HEADS=2 (the JAX module's meaning): each step runs the merged
    GAT layer once per head of each group and layer that reaches the head,
    3 groups at 2 layers: 6 calls a step."""
    from kgwas_tpu_torch.ops import gat_layer

    for k, v in BENCH_ENV.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setenv("BENCH_HEADS", "2")
    monkeypatch.setenv("BENCH_STEPS", "2")
    calls = []
    fwd = gat_layer.merged_gat_forward
    monkeypatch.setattr(gat_layer, "merged_gat_forward",
                        lambda *a, **k: calls.append(1) or fwd(*a, **k))
    bench_lib.main(device="cpu")
    rec = json.loads(capsys.readouterr().out.strip())
    assert math.isfinite(rec["value"]) and rec["value"] > 0
    # the warm-up, then max(steps // 4, 1) and steps timed steps
    assert len(calls) == 2 * 3 * (1 + 1 + 2)


@pytest.mark.parametrize("env,item", [
    ({"BENCH_DTYPE": "bfloat16"}, 7),
    ({"BENCH_STREAM_DTYPE": "bfloat16"}, 7),
    ({"BENCH_SCAN": "2"}, 4),
])
def test_bench_unported_options_raise(monkeypatch, capsys, env, item):
    """The options once unported run (at the small BENCH_ENV sizes) and the
    JSON line reports them: the dtypes of item 7, and BENCH_SCAN > 1 of
    item 4 (blocks of steps through TrainScan, PR 13), which no longer
    raises."""
    for k, v in {**BENCH_ENV, **env}.items():
        monkeypatch.setenv(k, v)
    bench_lib.main(device="cpu")
    rec = json.loads(capsys.readouterr().out.strip())
    # a slope of two host-clock series on the CPU: finite, its sign noise
    assert math.isfinite(rec["value"])
    if "BENCH_SCAN" in env:
        assert item == 4 and rec["config"]["scan"] == 2
        assert rec["config"]["dtype"] == "float32"
        return
    assert rec["config"]["dtype"] == (
        "bfloat16" if "BENCH_DTYPE" in env else "float32,stream=bfloat16")


def test_bench_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_lib.main()
