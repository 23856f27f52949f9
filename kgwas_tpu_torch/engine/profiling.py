"""Tracing and throughput counters of a training run.

Counterpart of ``kgwas_tpu/engine/profiling.py``:

  * ``profile_trace(log_dir)``: a ``torch.profiler`` trace of the enclosed
    block, written into ``log_dir`` in the Chrome / TensorBoard format
    (``*.pt.trace.json``, ``torch.profiler.tensorboard_trace_handler``).
    It records CPU activity always and CUDA activity (the kernels, by
    name) when a card is present.
  * ``ThroughputMeter``: edge-traversals/s and epoch time per epoch, with
    one JSON line per epoch appended to ``log_path`` (the JAX package's
    record keys).
  * ``span(name)``: a named host span (a context manager, or a decorator)
    with per-name count, total and self seconds in one process-wide table
    (``span_totals()``, ``reset_spans()``), timed on the clock of
    torch.profiler's events (Unix time, ns). While a torch profiler is
    active a span also enters ``torch.profiler.record_function(name)``,
    so the trace shows it on the kernels' clock beside them; otherwise it
    costs a flag check, two clock reads and a locked table update.

The port's spans (what they time):

  * data layer: ``kgwas.data.transforms`` (``standard_kg_transforms``),
    ``kgwas.data.load_gwas`` (the sumstats loaders),
    ``kgwas.data.process_gwas_file``, ``kgwas.data.prepare_split``,
    ``kgwas.data.compile`` (``compile_graph``, when it compiles);
  * layouts and kernels: ``kgwas.layouts.merged`` (``merged_layouts``,
    when it builds), ``kgwas.layouts.device`` (``KGWAS._device_state``,
    when it builds), ``kgwas.ops.load`` (a kernel library's first load,
    its nvcc build included);
  * ``kgwas.model.init`` (``KGWAS.initialize_model``);
  * ``kgwas.train`` and its parts ``kgwas.train.setup`` (device state,
    labels, optimizer), ``kgwas.train.epoch`` (an epoch's blocks up to its
    losses on the host), ``kgwas.train.eval`` (the epoch-end forward, val
    metrics, the best state), ``kgwas.train.tail`` (all after the last
    epoch), ``kgwas.train.snapshot`` and ``kgwas.train.recovery``
    (``max_restarts``);
  * the scanned steps: ``kgwas.scan.eager``, ``kgwas.scan.capture``,
    ``kgwas.scan.replay`` (a block's copy-in and replay);
  * serving: ``kgwas.predict_all``, ``kgwas.forward`` (the full-graph
    forward's enqueue), ``kgwas.to_host`` (the predictions' copy to the
    host, which waits for the card);
  * the host tail: ``kgwas.tail.calibration`` (``finalize_predictions``),
    ``kgwas.tail.write_table`` (``utils.write_table``),
    ``kgwas.tail.pred_csv`` (``KGWAS.train``'s pred.csv, written and
    copied), ``kgwas.loci`` (``scripts/loci.count_loci``),
    ``kgwas.calibration.prepare_seed`` (a calibration seed's draw and
    data layer).

No span opens inside a training step, the model's forward or a captured
CUDA graph.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import torch
import torch.autograd.profiler as _autograd_profiler


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """Trace the enclosed block with torch.profiler and write the trace
    into log_dir on exit. No-op when log_dir is falsy."""
    if not log_dir:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            # the block's kernels end inside the trace
            torch.cuda.synchronize()


@dataclass
class ThroughputMeter:
    """Counts edge traversals (edges x layers per full-graph step)."""

    edges_per_step: int
    log_path: Optional[str] = None
    history: list = field(default_factory=list)
    _t0: float = 0.0
    _steps: int = 0

    def start_epoch(self):
        self._t0 = time.perf_counter()
        self._steps = 0

    def step(self):
        self._steps += 1

    def end_epoch(self, epoch: int, extra: Optional[dict] = None) -> dict:
        dt = time.perf_counter() - self._t0
        rec = {
            "epoch": epoch,
            "steps": self._steps,
            "epoch_time_s": dt,
            "edges_per_sec": (self.edges_per_step * self._steps / dt)
            if dt > 0
            else 0.0,
        }
        if extra:
            rec.update(extra)
        self.history.append(rec)
        if self.log_path:
            with open(self.log_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        return rec


class SpanTotal(NamedTuple):
    count: int
    total_s: float
    self_s: float     # total_s less the time its child spans cover


class _Local(threading.local):
    def __init__(self):
        self.frames = []    # the thread's open spans: [child ns, rf, t0 ns]


_LOCAL = _Local()
_SPANS: dict = {}       # name -> _Span: the table, one row a name
_ROWS = threading.Lock()   # a row's three fields change together
_clock_ns = time.time_ns   # the clock of torch.profiler's events


class _Span:
    """One name's row of the table ([count, total ns, self ns]) and its
    context manager; the open spans' state lives on each thread's stack,
    so one _Span serves nested and concurrent spans of its name."""

    __slots__ = ("name", "row")

    def __init__(self, name: str):
        self.name = name
        self.row = [0, 0, 0]

    def __enter__(self):
        rf = None
        if _autograd_profiler._is_profiler_enabled:
            rf = _autograd_profiler.record_function(self.name)
            rf.__enter__()
        _LOCAL.frames.append([0, rf, _clock_ns()])
        return self

    def __exit__(self, exc_type, exc, tb):
        t1 = _clock_ns()
        frames = _LOCAL.frames
        child, rf, t0 = frames.pop()
        dt = t1 - t0
        row = self.row
        _ROWS.acquire()
        row[0] += 1
        row[1] += dt
        row[2] += dt - child
        _ROWS.release()
        if frames:
            frames[-1][0] += dt
        if rf is not None:
            rf.__exit__(exc_type, exc, tb)
        return False

    def __call__(self, fn):
        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with self:
                return fn(*args, **kwargs)
        return spanned


def span(name: str) -> _Span:
    """The span of this name: ``with span("kgwas.x"):`` or, on a function,
    ``@span("kgwas.x")``. On exit it adds its count, its seconds and its
    self seconds (less its children's, which nest per thread) to the
    table, also when the block raises. It enters ``record_function(name)``
    only while a torch profiler is active."""
    s = _SPANS.get(name)
    if s is None:   # setdefault: threads that name it first share one row
        s = _SPANS.setdefault(name, _Span(name))
    return s


def span_totals() -> dict:
    """{name: SpanTotal} of the spans closed since the last reset."""
    with _ROWS:
        rows = [(n, list(s.row)) for n, s in list(_SPANS.items())]
    return {n: SpanTotal(c, t / 1e9, x / 1e9) for n, (c, t, x) in rows if c}


def reset_spans():
    with _ROWS:
        for s in list(_SPANS.values()):
            s.row[:] = (0, 0, 0)


def span_seconds(since: dict, *names) -> float:
    """The seconds that spans of these names added since ``since`` (an
    earlier span_totals())."""
    now = span_totals()
    zero = SpanTotal(0, 0.0, 0.0)
    return sum(now.get(n, zero).total_s - since.get(n, zero).total_s
               for n in names)
