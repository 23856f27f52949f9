"""Serving a trained model: a closed loop of ``KGWAS.predict_all()`` calls,
each the full-graph forward and the copy of every SNP's prediction to the
host, the next call sent when the last returns.

Set-up builds the model, loads the benchmark's parameters and makes one
call (the device state and the kernels' schedules). Each call is timed on
the host clock from the call to the predictions on the host. The outputs
of ``kept_calls`` calls drawn from the seed among the first
``min_calls``, and the last call's, are compared with the reference's
forward on the same parameters, every SNP.

Traffic keys: kept_calls, min_calls, trace_calls.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .. import program
from ..harness import (Outcome, Record, check, log, now, peak_bytes,
                       rel_gap, release, sync)
from ..inputs import kg, params, sub_seed
from ..reference import graph as ref_graph
from ..reference import model as ref_model
from ..trace import trace_calls


def inputs(ctx):
    """The raw KG (features on the card), its relations after the
    reference's transforms, and the parameters served."""
    cfg, m = ctx.config, ctx.config["model"]
    raw = kg.make_kg(cfg["kg"], cfg["feature_dims"], ctx.seed, ctx.device)
    return SimpleNamespace(
        raw=raw, rels=ref_graph.transform(raw.edges, raw.num_nodes),
        p0=params.make_params(cfg["feature_dims"], m["hidden"], m["layers"],
                              ctx.seed, ctx.device))


def reference_forward(ctx, inp, feats, tf32=False):
    """Every SNP's prediction by the reference (on the host)."""
    m = ctx.config["model"]
    program.allow_tf32(tf32)
    try:
        with torch.no_grad():
            return ref_model.forward(inp.p0, feats, inp.rels,
                                     inp.raw.num_nodes, m["layers"],
                                     m["relu_head"]).cpu().numpy()
    finally:
        program.allow_tf32(False)


def run(ctx) -> Outcome:
    cfg, dev, m, tr = ctx.config, ctx.device, ctx.config["model"], ctx.traffic
    inp = inputs(ctx)
    raw, rels, p0 = inp.raw, inp.rels, inp.p0
    shapes = ref_graph.group_shapes(rels, raw.num_nodes, m["layers"])
    _, encoded = ref_graph.live_groups(rels, m["layers"])
    log(f"inputs at {now() - ctx.t_start:.2f} s")
    data = program.make_data(raw, ctx.tmp)
    raw.features = None
    run_ = program.make_model(data, m, p0, dev, sub_seed(ctx.seed, 6))
    log(f"model at {now() - ctx.t_start:.2f} s")
    run_.predict_all()
    sync(dev)
    setup_s = now() - ctx.t_start
    log(f"set-up {setup_s:.2f} s")

    rng = np.random.default_rng(sub_seed(ctx.seed, 10))
    keep = set(rng.choice(int(tr["min_calls"]), int(tr["kept_calls"]),
                          replace=False).tolist())
    kept, times = {}, []
    t0 = now()
    deadline = t0 + ctx.seconds
    last = None
    while now() < deadline or len(times) < int(tr["min_calls"]):
        ts = now()
        last = run_.predict_all()
        times.append(now() - ts)
        if len(times) - 1 in keep:
            kept[len(times) - 1] = last
    window = now() - t0
    kept[len(times) - 1] = last
    log(f"window {window:.3f} s, {len(times)} calls")
    record = Record(cfg, ctx.peaks, shapes=shapes,
                    encoded={t: raw.num_nodes[t] for t in encoded})
    if ctx.trace:
        record.trace = trace_calls(dev, int(tr["trace_calls"]),
                                   run_.predict_all)
    failed = sum(int(not np.isfinite(v).all()) for v in kept.values())
    peak = peak_bytes(dev)
    t_ref = now()
    if record.trace is not None:
        log(record.trace.summary())
    del run_, data
    release(dev)

    feats = kg.make_features(cfg["kg"], cfg["feature_dims"], ctx.seed, dev)
    ref = reference_forward(ctx, inp, feats)
    gap = max(rel_gap(v, ref) for v in kept.values())
    log(f"reference {now() - t_ref:.2f} s")
    checks = [check("pred_gap", gap, ctx.limits)]
    t_ms = np.asarray(times) * 1e3
    metrics = {"setup_s": setup_s,
               "forward_ms": window * 1e3 / len(times),
               "forward_p95_ms": float(np.percentile(t_ms, 95))}
    return Outcome(len(times), failed, metrics, checks, record, peak)


def control(ctx) -> dict:
    """The control's reading: the reference's forward with TF32 on (the
    precision below the stated float32 with TF32 off) in the program's
    place; and the float32 forward again, for its own rounding."""
    inp = inputs(ctx)
    feats = inp.raw.features
    base = reference_forward(ctx, inp, feats)
    return {"f32_again": {"pred_gap": rel_gap(
                reference_forward(ctx, inp, feats), base)},
            "tf32": {"pred_gap": rel_gap(
                reference_forward(ctx, inp, feats, True), base)}}
