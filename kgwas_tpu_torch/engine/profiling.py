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
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

import torch


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
