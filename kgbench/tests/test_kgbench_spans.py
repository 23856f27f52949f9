"""The readers of the port's spans: on a hand-built Record (a trace with
kgwas.* host annotations, a filled span table) each reads its spans and
gives None where none of them ran or the port has no span table; a tiny
traced run of each cell prints its span metrics, and the set-up spans
count once over the whole run of a 2M cell."""
from __future__ import annotations

import pytest

from kgbench import run
from kgbench.harness import Record
from kgbench.tests.tiny import tiny_cell
from kgbench.trace import Trace
from kgwas_tpu_torch.engine import profiling
from kgwas_tpu_torch.engine.profiling import reset_spans, span, span_totals

SEED_METRICS = {
    "seed_first_blocks_s": ("kgwas.scan.eager", "kgwas.scan.capture"),
    "seed_eval_s": ("kgwas.train.eval",),
    "seed_calib_s": ("kgwas.tail.calibration",),
    "seed_csv_s": ("kgwas.tail.write_table",),
    "seed_loci_s": ("kgwas.loci",),
}
SETUP_SPANS = {
    "fullkg2m.train": {
        "setup_data_s.train": ("kgwas.data.transforms",
                               "kgwas.data.load_gwas",
                               "kgwas.data.process_gwas_file",
                               "kgwas.data.prepare_split"),
        "setup_layouts_s.train": ("kgwas.data.compile",
                                  "kgwas.layouts.merged",
                                  "kgwas.layouts.device")},
    "fullkg2m.forward": {
        "setup_layouts_s.forward": ("kgwas.data.compile",
                                    "kgwas.layouts.merged",
                                    "kgwas.layouts.device")},
}


@pytest.fixture(autouse=True)
def _empty_table():
    reset_spans()
    yield
    reset_spans()


def _record(host, units=2):
    cell = run.load_cell(run.ROOT, "calib50k.seed")
    tr = Trace(device=[("kernel", 0.0, 1.0)], host=host, window_s=10.0,
               units=units)
    return Record(cell["config"], cell["peaks"], trace=tr)


def test_seed_readers_on_a_trace():
    host = [("kgwas.train", 0.0, 9.0), ("aten::mm", 0.1, 0.2),
            ("kgwas.scan.eager", 0.5, 1.0), ("kgwas.scan.capture", 1.0, 1.5),
            ("kgwas.train.eval", 2.0, 2.25), ("kgwas.train.eval", 3.0, 3.25),
            ("kgwas.tail.calibration", 4.0, 4.5),
            ("kgwas.tail.write_table", 5.0, 5.75),
            ("kgwas.loci", 6.0, 6.1), ("kgwas.loci", 6.1, 6.3)]
    rec = _record(host)
    want = {"seed_first_blocks_s": 0.5, "seed_eval_s": 0.25,
            "seed_calib_s": 0.25, "seed_csv_s": 0.375, "seed_loci_s": 0.15}
    for name, v in want.items():
        assert run.reader_file(name).name == f"{name}.py"
        assert run.metric_reader(name)(rec) == pytest.approx(v), name


def test_seed_readers_none_without_their_spans():
    rec = _record([("kgwas.train", 0.0, 9.0), ("aten::mm", 0.1, 0.2)])
    for name, spans in SEED_METRICS.items():
        assert run.metric_reader(name)(rec) is None, name
        one = _record([(spans[0], 1.0, 2.0)], units=1)
        assert run.metric_reader(name)(one) == pytest.approx(1.0), name
    rec.trace = None
    for name in SEED_METRICS:
        assert run.metric_reader(name)(rec) is None


def test_setup_readers_on_the_span_table():
    rec = _record([])
    names = dict(SETUP_SPANS["fullkg2m.train"], **SETUP_SPANS[
        "fullkg2m.forward"])
    for name in names:
        assert run.metric_reader(name)(rec) is None, name
    for s in ("kgwas.data.transforms", "kgwas.data.compile",
              "kgwas.layouts.device", "kgwas.model.init"):
        with span(s):
            pass
    t = span_totals()
    data = run.metric_reader("setup_data_s.train")(rec)
    layouts = run.metric_reader("setup_layouts_s.train")(rec)
    assert data == t["kgwas.data.transforms"].total_s
    assert layouts == pytest.approx(t["kgwas.data.compile"].total_s
                                    + t["kgwas.layouts.device"].total_s)
    assert run.metric_reader("setup_layouts_s.forward")(rec) == layouts


def test_setup_readers_none_without_a_span_table(monkeypatch):
    with span("kgwas.data.transforms"):
        pass
    monkeypatch.delattr(profiling, "span_totals")
    assert run.metric_reader("setup_data_s.train")(_record([])) is None
    assert run.metric_reader("setup_layouts_s.forward")(_record([])) is None


@pytest.mark.parametrize("workload", ["fullkg2m.train", "fullkg2m.forward",
                                      "calib50k.seed"])
def test_tiny_traced_run_prints_the_span_metrics(workload):
    """On the CPU the scanned blocks all run eagerly (no capture); the
    set-up spans run once in a 2M cell, in set-up alone."""
    cell = tiny_cell(workload)
    res = run.run_cell(workload, 2**31 + 11, 0.5, True, device="cpu",
                       cell=cell)
    assert res["correct"] is True
    got = res["metrics"]
    want = SETUP_SPANS.get(workload, dict.fromkeys(SEED_METRICS))
    for name in want:
        assert got[name]["value"] > 0 and got[name]["unit"] == "s", name
    totals = span_totals()
    for name, spans in SETUP_SPANS.get(workload, {}).items():
        for s in spans:
            assert totals[s].count == 1, s
    if workload == "fullkg2m.forward":
        assert not any(n.startswith("kgwas.data.load_gwas") or
                       n.startswith("kgwas.train") for n in totals)
