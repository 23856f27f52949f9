"""What a traffic driver is given and what it returns, and the comparison
helpers every driver uses.

A driver (``kgbench/drivers/<traffic's "driver">.py``) has one function,
``run(ctx) -> Outcome``: it builds the cell's state from ``ctx.seed``
(set-up), warms every shape the window uses, measures for
``ctx.seconds`` seconds, traces a further segment when ``ctx.trace``,
then checks what the timed path produced against the reference, after the
peak memory has been read and the program's state freed.
"""
from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from .trace import Trace


@dataclass
class Context:
    workload: str
    config: dict
    traffic: dict
    limits: dict          # check name -> limit
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float        # the process's start, host clock
    tmp: str              # the run's scratch directory (under TMPDIR)
    peaks: dict           # the card's published peaks


@dataclass
class Record:
    """What the per-layer metric readers read (kgbench/metrics/<name>.py)."""
    config: dict
    peaks: dict
    trace: Optional[Trace] = None
    shapes: list = field(default_factory=list)   # graph.group_shapes
    train: bool = False   # the traced unit is a training step
    encoded: dict = field(default_factory=dict)  # encoded type -> rows
    spans: dict = field(default_factory=dict)    # name -> [seconds]


@dataclass
class Outcome:
    attempted: int
    failed: int
    metrics: dict                       # end-to-end name -> value
    checks: list                        # (name, value, limit)
    record: Record
    memory_peak_bytes: int = 0


def log(msg: str):
    """A progress line on standard error."""
    print(f"kgbench: {msg}", file=sys.stderr, flush=True)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def peak_bytes(device) -> int:
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def release(device):
    """Frees what the dropped program state held on the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def rel_gap(got, want) -> float:
    """max |got - want| / max |want| (0 over an empty or zero want: then
    the largest |got|)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if not got.size:
        return 0.0
    err = float(np.max(np.abs(got - want)))
    scale = float(np.max(np.abs(want)))
    if not np.isfinite(err):
        return float("inf")
    return err / scale if scale > 0 else err


def leaf_gaps(got: dict, want: dict, grads_ref: dict) -> dict:
    """Per leaf, |‖got‖ - ‖want‖| over max(‖want‖, the median leaf's
    ‖want‖), for the leaves whose reference gradient is at least a
    thousandth of the median leaf's (a smaller one is nought to rounding:
    such a leaf moves under Adam by round-off alone). The median is over
    the leaves with a gradient: those with no path to the loss have none."""
    gn = {k: float(torch.linalg.vector_norm(v.double())) for k, v in
          grads_ref.items()}
    live = [v for v in gn.values() if v > 0]
    if not live:   # nothing moved the reference: no comparison can pass
        return {"no leaf with a gradient": float("inf")}
    g_med = float(np.median(live))
    keep = [k for k in want if gn[k] >= 1e-3 * g_med]
    wn = {k: float(torch.linalg.vector_norm(want[k].double())) for k in keep}
    med = float(np.median(list(wn.values())))
    out = {}
    for k in keep:
        g = float(torch.linalg.vector_norm(got[k].double()))
        out[k] = (abs(g - wn[k]) / max(wn[k], med) if np.isfinite(g)
                  else float("inf"))
    return out


def train_gaps(got, want, scan_steps: int, n_steps: int):
    """A training run's numbers against the reference's. got, want:
    (losses of the n_steps checked steps, the first gradient {leaf},
    {t: the parameters' change after t steps} for t in 3, scan_steps and
    n_steps). The first three steps: the losses, the gradient by the worst
    leaf, the change by the median leaf; the steps after the first block
    (the replayed ones): the losses, the change over them by the median
    and by the worst leaf. Returns (numbers, their per-leaf gaps)."""
    (gl, gg, gc), (wl, wg, wc) = got, want
    S, n = scan_steps, n_steps

    def over_replays(c):
        return {k: c[n][k] - c[S][k] for k in c[n]}

    per_leaf = {"grad": leaf_gaps(gg, wg, wg),
                "change": leaf_gaps(gc[3], wc[3], wg),
                "replay": leaf_gaps(over_replays(gc), over_replays(wc), wg)}
    numbers = {
        "loss_gap": rel_gap(gl[:3], wl[:3]),
        "grad_gap": max(per_leaf["grad"].values()),
        "change_gap": float(np.median(list(per_leaf["change"].values()))),
        "replay_loss_gap": rel_gap(gl[S:n], wl[S:n]),
        "replay_change_gap": float(np.median(list(
            per_leaf["replay"].values()))),
        "replay_worst_gap": max(per_leaf["replay"].values()),
    }
    return numbers, per_leaf


def worst(gaps: dict, n: int = 3) -> str:
    return ", ".join(f"{k} {v:.3e}" for k, v in
                     sorted(gaps.items(), key=lambda kv: -kv[1])[:n])


def check(name: str, value: float, limits: dict):
    """(name, value, limit) for the cell's limit of that name."""
    return (name, float(value), float(limits[name]))
