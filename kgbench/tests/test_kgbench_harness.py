"""The harness: every cell finds its files by name, a run's result line has
the keys the contract reads, and a run without a card prints no result."""
from __future__ import annotations

import importlib
import json
import re

import pytest

from kgbench import run
from kgbench.harness import Record
from kgbench.tests.tiny import tiny_cell
from kgbench.trace import Trace

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["kgbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names + WORKLOADS)
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}
    assert all(m["bound"] <= 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_finds_its_files(workload):
    cell = run.load_cell(run.ROOT, workload)
    driver = importlib.import_module(
        f"kgbench.drivers.{cell['traffic']['driver']}")
    assert callable(driver.run) and callable(driver.control)
    assert cell["limits"], "a cell compares at least one number"
    assert [m["name"] for m in cell["end_to_end"]][-1] == "setup_s"
    assert len(cell["end_to_end"]) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:
        assert callable(run.metric_reader(m["name"]))


@pytest.mark.parametrize("workload", WORKLOADS)
def test_tiny_cell_result_line(workload):
    cell = tiny_cell(workload)
    res = run.run_cell(workload, 2**31 + 7, 0.5, False, device="cpu",
                       cell=cell)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert set(res["checks"]) == set(cell["limits"])
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        res["device"])


def test_no_card_no_result(capsys):
    if __import__("torch").cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", WORKLOADS[0], "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 3
    assert capsys.readouterr().out == ""


def test_reader_files():
    """A metric split by cell is read by its shared part's file."""
    want = {"roofline.gat_fwd.train": "roofline.gat_fwd.py",
            "roofline.gat_fwd.forward": "roofline.gat_fwd.py",
            "roofline.gat_bwd.train": "roofline.gat_bwd.py",
            "train_idle_pct": "idle_pct.py", "seed_idle_pct": "idle_pct.py",
            "forward_mfu": "mfu.py", "train_gemm_ms": "train_gemm_ms.py",
            "seed_tail_s": "seed_tail_s.py"}
    for name, file in want.items():
        assert run.reader_file(name).name == file, name
    with pytest.raises(FileNotFoundError):
        run.reader_file("no_such.metric")


def test_readers_on_a_trace():
    cell = run.load_cell(run.ROOT, "fullkg2m.train")
    shapes = [[{"dst": "SNP", "R": 2, "N": 10, "S": 8, "E": 40,
                "src_rows": {"Gene": 8}}]]
    tr = Trace(device=[("merged_gat_fwd_kernel<0>", 0.0, 1e-3),
                       ("sm80_xmma_gemm_f32", 1e-3, 3e-3),
                       ("csc_items_kernel<1>", 4e-3, 5e-3)],
               window_s=5e-3, units=1)
    rec = Record(cell["config"], cell["peaks"], trace=tr, shapes=shapes,
                 encoded={"SNP": 10, "Gene": 4}, train=True)
    assert run.metric_reader("train_idle_pct")(rec) == pytest.approx(20.0)
    assert run.metric_reader("train_gemm_ms")(rec) == pytest.approx(2.0)
    fwd = run.metric_reader("roofline.gat_fwd.train")(rec)
    assert 0 < fwd < 100
    train_mfu = run.metric_reader("train_mfu")(rec)
    rec.train = False
    assert 0 < run.metric_reader("forward_mfu")(rec) < train_mfu
    rec.trace = None
    for name in ("train_idle_pct", "train_mfu", "roofline.gat_bwd.train"):
        assert run.metric_reader(name)(rec) is None
    bd = tr.breakdown()
    assert bd["device_ops"][0][0].startswith("sm80")
    assert bd["idle_gaps"] == [["host", pytest.approx(1e-3)]]
