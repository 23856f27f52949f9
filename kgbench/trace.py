"""A torch.profiler trace of a run's traced segment, reduced to what the
per-layer metrics read: the device's operations (kernels, copies, sets)
with their intervals, the host's operations, the benchmark's own spans
(``record_function`` names starting with ``kgbench.``), the busy time (the
union of the device intervals) and the traced window.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import numpy as np
import torch

LABELLED = 200
DEVICE_KINDS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_KINDS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver"}


@dataclass
class Trace:
    device: list = field(default_factory=list)   # (name, start_s, end_s)
    host: list = field(default_factory=list)     # (name, start_s, end_s)
    window_s: float = 0.0
    units: int = 0        # the driver's units traced (steps, calls, seeds)

    @property
    def busy_s(self) -> float:
        busy, end = 0.0, float("-inf")
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            if b > end:
                busy += b - max(a, end)
                end = b
        return busy

    def summary(self) -> str:
        return (f"traced {self.units} units: {len(self.device)} device ops, "
                f"busy {self.busy_s:.4f} s of {self.window_s:.4f} s")

    def seconds_of(self, patterns) -> float:
        """Device seconds of the operations whose name holds one of the
        patterns (case-insensitive)."""
        pats = [p.lower() for p in patterns]
        return sum(b - a for n, a, b in self.device
                   if any(p in n.lower() for p in pats))

    def breakdown(self, top: int = 10) -> dict:
        by_name = {}
        for n, a, b in self.device:
            by_name[n] = by_name.get(n, 0.0) + (b - a)
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:200], s] for n, s in ops],
                "idle_gaps": self.idle_gaps(top)}

    def idle_gaps(self, top: int) -> list:
        """The device's idle seconds between its operations, by what the host
        ran meanwhile: each of the LABELLED longest gaps is named by the
        innermost host operation that covers its middle ("host" where none
        does), and the seconds are summed by name; the other gaps' seconds
        go under "shorter gaps"."""
        if not self.device:
            return []
        iv = np.array(sorted((a, b) for _, a, b in self.device))
        ends = np.maximum.accumulate(iv[:, 1])
        length = iv[1:, 0] - ends[:-1]
        start = ends[:-1][length > 0]
        length = length[length > 0]
        order = np.argsort(-length)[:LABELLED]
        hs = np.array([e[1] for e in self.host])
        he = np.array([e[2] for e in self.host])
        by_name = {}
        for i in order:
            mid = start[i] + length[i] / 2
            cover = np.flatnonzero((hs <= mid) & (he >= mid)) if len(hs) else []
            name = ("host" if not len(cover) else
                    self.host[cover[np.argmin(he[cover] - hs[cover])]][0])
            by_name[name] = by_name.get(name, 0.0) + float(length[i])
        rest = float(length.sum() - length[order].sum())
        if rest > 0:
            by_name["shorter gaps"] = rest
        return [[n[:200], s] for n, s in
                sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def _kind(e) -> str:
    """The event's Kineto activity kind; where the installed torch does not
    expose it, from its device and whether it is a user annotation."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return str(at()).lower()
    annotation = getattr(e, "is_user_annotation", lambda: False)()
    if e.device_type() == torch.autograd.DeviceType.CUDA:
        return "gpu_user_annotation" if annotation else "kernel"
    return "user_annotation" if annotation else "cpu_op"


@contextlib.contextmanager
def traced(out: Trace, device: torch.device):
    """Profiles the enclosed block into out; the block's device work ends
    inside the window (synchronised)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        yield out
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.window_s = time.perf_counter() - t0
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        iv = (e.name(), e.start_ns() / 1e9,
              (e.start_ns() + e.duration_ns()) / 1e9)
        if kind in DEVICE_KINDS:
            out.device.append(iv)
        elif kind in HOST_KINDS:
            out.host.append(iv)


def trace_calls(device: torch.device, calls: int, fn,
                units_per_call: int = 1) -> Trace:
    """A trace of calls calls of fn(), each units_per_call of the driver's
    units (steps, calls, seeds)."""
    out = Trace()
    with traced(out, device):
        for _ in range(calls):
            fn()
    out.units = calls * units_per_call
    return out
