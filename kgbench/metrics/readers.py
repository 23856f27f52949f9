"""What the per-layer metric readers share: the traced time of one unit
(a step, a call, a seed), the device's idle share, a share of a
roofline, the model's operations from the run's shapes."""
from __future__ import annotations

from . import counts


def per_unit_s(record):
    """The traced window's seconds per unit, or None without a trace."""
    tr = record.trace
    if tr is None or not tr.device or not tr.units:
        return None
    return tr.window_s / tr.units


def idle_pct(record):
    tr = record.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(record, kernels, op):
    """100 x the least time of the operation's launches in one unit (op:
    counts.gat_fwd or counts.gat_bwd over every group the model runs) over
    the device time of its kernels in one unit; None where they never ran."""
    tr = record.trace
    if tr is None or not tr.units:
        return None
    measured = tr.seconds_of(kernels) / tr.units
    if measured <= 0:
        return None
    d = record.config["model"]["hidden"]
    bound = sum(counts.roofline_s(*op(g, d), record.peaks)
                for layer in record.shapes for g in layer)
    return 100.0 * bound / measured


def mfu_pct(record, train: bool):
    unit = per_unit_s(record)
    if unit is None:
        return None
    cfg = record.config
    dims = {t: cfg["feature_dims"]["GO" if t not in ("SNP", "Gene") else t]
            for t in record.encoded}
    flops = counts.model_flops(record.shapes, record.encoded, dims,
                               cfg["model"]["hidden"], cfg["kg"]["n_snp"],
                               train)
    return 100.0 * flops / unit / record.peaks["f32_flops_per_s"]


def mean_span(record, name):
    v = record.spans.get(name)
    return sum(v) / len(v) if v else None
