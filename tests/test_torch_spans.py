"""The port's host spans (engine/profiling.span) and the timings read from
them:

  * with no profiler active a span never enters ``record_function``, and
    its count and seconds still grow;
  * self seconds are the total less the child spans', nesting is per
    thread, a span left by an exception is closed, and threads that close
    spans of one name at once lose no count;
  * a span's seconds in the table agree with its annotation's in a
    torch.profiler trace;
  * a tiny ``KGWAS.train`` with ``predict_all`` and ``count_loci`` under
    torch.profiler on the CPU emits exactly the documented names of the
    CPU path, as often as the table counts them, each child inside its
    parent;
  * ``train_seconds``, ``pred_csv_seconds``, ``snapshot_seconds`` and
    the calibration seed's host split are their spans' seconds.
"""
import sys
import threading
import time
from argparse import Namespace

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.engine import profiling
from kgwas_tpu_torch.engine.profiling import (reset_spans, span, span_seconds,
                                              span_totals)
from kgwas_tpu_torch.scripts import run_calibration
from kgwas_tpu_torch.scripts.loci import count_loci

from torch_threads import few_torch_threads  # noqa: F401,E402

# the spans of the CPU path of from_synthetic, KGWAS.train (scan_steps 2),
# predict_all and count_loci, with the parents each lies inside (None:
# the outermost); kgwas.ops.load, kgwas.scan.capture / .replay and
# kgwas.train.snapshot / .recovery run only on the card or under
# max_restarts
PARENTS = {
    "kgwas.data.transforms": None,
    "kgwas.data.load_gwas": None,
    "kgwas.data.process_gwas_file": None,
    "kgwas.data.prepare_split": None,
    "kgwas.model.init": None,
    "kgwas.data.compile": ("kgwas.model.init",),
    "kgwas.layouts.merged": ("kgwas.model.init",),
    "kgwas.train": None,
    "kgwas.train.setup": ("kgwas.train",),
    "kgwas.layouts.device": ("kgwas.train.setup",),
    "kgwas.train.epoch": ("kgwas.train",),
    "kgwas.scan.eager": ("kgwas.train.epoch",),
    "kgwas.train.eval": ("kgwas.train",),
    "kgwas.train.tail": ("kgwas.train",),
    "kgwas.forward": ("kgwas.train.eval", "kgwas.train.tail",
                      "kgwas.predict_all"),
    "kgwas.to_host": ("kgwas.train.eval", "kgwas.train.tail",
                      "kgwas.predict_all"),
    "kgwas.tail.calibration": ("kgwas.train.tail",),
    "kgwas.tail.pred_csv": ("kgwas.train.tail",),
    "kgwas.tail.write_table": ("kgwas.tail.pred_csv",),
    "kgwas.predict_all": None,
    "kgwas.loci": None,
}
EPOCHS = 2


@pytest.fixture(autouse=True)
def _empty_table():
    reset_spans()
    yield
    reset_spans()


def _data(path, n_snp=400):
    data = KGWAS_Data.from_synthetic(n_snp=n_snp, n_gene=80, n_go=30, seed=1,
                                     data_path=str(path))
    data.load_synthetic_gwas(seed=1)
    data.process_gwas_file()
    data.prepare_split()
    return data


def _train(data, **kw):
    run = KGWAS(data, exp_name="spans", seed=1, device="cpu")
    run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=16)
    table = run.train(batch_size=64, epoch=EPOCHS, lr=1e-3, scan_steps=2,
                      **kw)
    return run, table


def _annotations(prof) -> dict:
    """{name: [(start ns, end ns)]} of the trace's kgwas.* host spans."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("kgwas.") and e.device_type() == \
                torch.autograd.DeviceType.CPU:
            out.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(autograd_profiler, "record_function", refuse)
    assert not autograd_profiler._is_profiler_enabled

    @span("test.decorated")
    def decorated(v):
        return v + 1

    for _ in range(3):
        with span("test.block"):
            assert decorated(1) == 2
    totals = span_totals()
    assert totals["test.block"].count == 3
    assert totals["test.decorated"].count == 3
    assert totals["test.block"].total_s >= totals["test.decorated"].total_s


def test_self_time_is_the_total_less_the_children():
    with span("test.parent"):
        time.sleep(0.01)
        for _ in range(2):
            with span("test.child"):
                time.sleep(0.005)
                with span("test.grandchild"):
                    time.sleep(0.002)
    t = span_totals()
    parent, child, grand = (t["test.parent"], t["test.child"],
                            t["test.grandchild"])
    assert (parent.count, child.count, grand.count) == (1, 2, 2)
    assert parent.self_s == pytest.approx(parent.total_s - child.total_s,
                                          abs=1e-9)
    assert child.self_s == pytest.approx(child.total_s - grand.total_s,
                                         abs=1e-9)
    assert grand.self_s == grand.total_s >= 0.004
    assert parent.self_s >= 0.01 and child.total_s >= 0.014
    assert span_seconds({}, "test.child", "test.grandchild") == \
        pytest.approx(child.total_s + grand.total_s)


def test_nesting_is_per_thread_and_an_exception_closes_the_span():
    def other():
        with span("test.other_thread"):
            time.sleep(0.02)

    with span("test.main"):
        worker = threading.Thread(target=other)
        worker.start()
        worker.join()
    t = span_totals()
    # the other thread's span is no child of the main thread's
    assert t["test.main"].self_s == t["test.main"].total_s >= 0.02
    assert t["test.other_thread"].self_s == t["test.other_thread"].total_s

    with pytest.raises(ValueError):
        with span("test.outer"):
            with span("test.raises"):
                raise ValueError("inside")
    assert profiling._LOCAL.frames == []
    with span("test.after"):
        pass
    t = span_totals()
    assert t["test.raises"].count == t["test.outer"].count == 1
    assert t["test.outer"].self_s == pytest.approx(
        t["test.outer"].total_s - t["test.raises"].total_s, abs=1e-9)
    assert t["test.after"].self_s == t["test.after"].total_s
    reset_spans()
    assert span_totals() == {}


def test_threads_lose_no_update():
    """More threads than cores close spans of one name while the
    interpreter switches threads every microsecond: no count is lost."""
    threads, per_thread = 16, 1000

    def work():
        for _ in range(per_thread):
            with span("test.shared"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        pool = [threading.Thread(target=work) for _ in range(threads)]
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in pool)
    shared = span_totals()["test.shared"]
    assert shared.count == threads * per_thread
    assert shared.self_s == shared.total_s > 0


def test_table_seconds_agree_with_the_annotation():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("test.first"):     # record_function's first use
            pass
        for pause in (0.02, 0.03):
            with span("test.annotated"):
                time.sleep(pause)
    assert not autograd_profiler._is_profiler_enabled
    spans = _annotations_named(prof, "test.annotated")
    total = span_totals()["test.annotated"]
    assert len(spans) == total.count == 2
    annotated = sum(b - a for a, b in spans) / 1e9
    # the table's clock reads inside the annotation, which adds only
    # record_function's own enter and exit
    assert 0 <= annotated - total.total_s < 2e-3 * total.count
    assert total.total_s >= 0.05


def _annotations_named(prof, name):
    return [(e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name() == name]


def _inside(iv, parents):
    a, b = iv
    return any(pa <= a and b <= pb for pa, pb in parents)


def test_train_predict_and_loci_emit_the_documented_spans(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        data = _data(tmp_path)
        run, table = _train(data)
        pred = run.predict_all()
        loci = count_loci(table, "KGWAS_P", data._synth_sumstats)
    assert len(pred) == 400 and loci >= 0
    got = _annotations(prof)
    assert set(got) == set(PARENTS)
    totals = span_totals()
    assert {k: len(v) for k, v in got.items()} == {
        k: totals[k].count for k in PARENTS}
    assert totals["kgwas.train.epoch"].count == EPOCHS
    assert totals["kgwas.train.eval"].count == EPOCHS
    assert totals["kgwas.forward"].count == EPOCHS + 2
    for name, parents in PARENTS.items():
        if parents is None:
            continue
        outer = [iv for p in parents for iv in got[p]]
        for iv in got[name]:
            assert _inside(iv, outer), (name, parents)


def test_train_timings_are_their_spans_seconds(tmp_path):
    data = _data(tmp_path)
    reset_spans()
    run, _ = _train(data, max_restarts=1)
    t = span_totals()
    assert run.train_seconds == {
        "setup": t["kgwas.train.setup"].total_s,
        "epochs": t["kgwas.train.epoch"].total_s
        + t["kgwas.train.eval"].total_s,
        "tail": t["kgwas.train.tail"].total_s}
    assert run.pred_csv_seconds == t["kgwas.tail.pred_csv"].total_s > 0
    assert t["kgwas.tail.pred_csv"].total_s >= \
        t["kgwas.tail.write_table"].total_s
    # a snapshot at the start and at each epoch end, none recovered
    assert len(run.snapshot_seconds) == t["kgwas.train.snapshot"].count \
        == EPOCHS + 1
    assert sum(run.snapshot_seconds) == pytest.approx(
        t["kgwas.train.snapshot"].total_s)
    assert run.recovery_seconds == [] and "kgwas.train.recovery" not in t
    # a second run's timings are its own spans' seconds
    _, _ = _train(data)
    again = span_totals()
    assert run.train_seconds["setup"] == t["kgwas.train.setup"].total_s
    assert again["kgwas.train.setup"].count == 2


def test_calibration_host_split_reads_the_spans(tmp_path):
    args = Namespace(n_snp=600, hidden=8, batch_size=64, epochs=1, cpu=True)
    data = run_calibration.calibration_kg(600, str(tmp_path))
    reset_spans()
    split = {}
    run_calibration.run_seed(data, {}, "null", 1, args, split)
    t = span_totals()
    assert split == {
        "data": t["kgwas.calibration.prepare_seed"].total_s,
        "model": t["kgwas.model.init"].total_s,
        "device_state": t["kgwas.train.setup"].total_s,
        "epochs": t["kgwas.train.epoch"].total_s
        + t["kgwas.train.eval"].total_s,
        "tail": t["kgwas.train.tail"].total_s,
        "pred_csv": t["kgwas.tail.pred_csv"].total_s}
    assert t["kgwas.data.process_gwas_file"].total_s <= split["data"]
    assert t["kgwas.loci"].count == 2
