"""Training in scanned blocks: the window drives the port's
``engine/loop.TrainScan`` (S steps a call: on the card one replay of a
CUDA graph of S captured ``train_step``s) over the split's training
batches in order, block after block, epoch after epoch (the epoch's last
batches that do not fill a block are left out).

Set-up builds one TrainScan (model, optimizer, features, layouts, labels)
and drives it through CHECKED_BLOCKS blocks: block 0 runs eagerly (the
optimizer's state after step 1 and the parameters after step 3 read by a
hook on the optimizer), block 1 captures the graph and replays it, block 2
copies its batches in and replays it as every window block does. The
window continues from block 3, one block in flight beyond the one that
runs.

Checked against the reference (reference/model.train_steps from the same
initial parameters over the same 3 S batches, on its own labels, weights
and split): the first three steps' losses, the first gradient as the
optimizer got it (exp_avg / (1 - beta1) - wd p0) by the worst leaf, the
parameters' change after three steps by the median leaf; and for the
replayed blocks 1 and 2, their losses and the parameters' change over
them, by the median and by the worst leaf (the worst leaf's change after
three steps swings with the float32 reference's own rounding: Adam
divides each element by its gradient's magnitude plus eps, and the
atomics of a float32 sum reorder from run to run).

Traffic keys: scan_steps, trace_blocks.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .. import program
from ..harness import (Outcome, Record, check, log, now, peak_bytes,
                       release, sync, train_gaps, worst)
from ..inputs import gwas, kg, params, sub_seed
from ..reference import data as ref_data
from ..reference import graph as ref_graph
from ..reference import model as ref_model
from ..trace import trace_calls

CHECKED_BLOCKS = 3


def inputs(ctx):
    """The cell's inputs from the seed: the raw KG (features on the card),
    its relations after the reference's transforms, the sumstats, the LD
    scores, the split's seed and the initial parameters."""
    cfg, m = ctx.config, ctx.config["model"]
    n = cfg["kg"]["n_snp"]
    raw = kg.make_kg(cfg["kg"], cfg["feature_dims"], ctx.seed, ctx.device)
    return SimpleNamespace(
        raw=raw, rels=ref_graph.transform(raw.edges, raw.num_nodes),
        sumstats=gwas.make_sumstats(n, cfg["gwas"]["n_causal"],
                                    cfg["gwas"]["sample_size"], ctx.seed),
        ld=gwas.make_ld_scores(n, ctx.seed), split_seed=sub_seed(ctx.seed, 6),
        p0=params.make_params(cfg["feature_dims"], m["hidden"], m["layers"],
                              ctx.seed, ctx.device))


def checked_batches(batches: list, steps: int) -> list:
    """The batches of the checked blocks, block k being batches
    k S .. k S + S - 1 of the epoch (k modulo the epoch's whole blocks)."""
    n_blocks = len(batches) // steps
    return [batches[(k % n_blocks) * steps + i]
            for k in range(CHECKED_BLOCKS) for i in range(steps)]


def reference_steps(ctx, inp, feats, batch_fn=None, tf32=False,
                    dtype=torch.float32, frozen=False):
    """The reference's losses, first gradient and changes after 3, S and
    CHECKED_BLOCKS S steps (float64 copies on the host), computed in dtype.
    batch_fn maps the list of the checked steps' batches, frozen leaves
    the state unchanged (the control's faults)."""
    cfg, m, tc = ctx.config, ctx.config["model"], ctx.config["train"]
    S = int(ctx.traffic["scan_steps"])
    dev = ctx.device
    y = torch.as_tensor(ref_data.chi2_labels(inp.sumstats), dtype=dtype,
                        device=dev)
    w = torch.as_tensor(ref_data.ldsc_weights(inp.sumstats, *inp.ld),
                        dtype=dtype, device=dev)
    train, _, _ = ref_data.split(cfg["kg"]["n_snp"], inp.split_seed)
    bs = [torch.as_tensor(b, device=dev) for b in checked_batches(
        ref_data.batches(train, tc["batch_size"]), S)]
    if batch_fn is not None:
        bs = batch_fn(bs)
    program.allow_tf32(tf32)
    try:
        losses, g1, changes = ref_model.train_steps(
            {k: v.to(dtype, copy=True) for k, v in inp.p0.items()},
            {t: v.to(dtype) for t, v in feats.items()}, inp.rels,
            inp.raw.num_nodes, m["layers"], bs, y, w,
            0.0 if frozen else tc["lr"], 0.0 if frozen else tc["weight_decay"],
            m["relu_head"], keep=(3, S))
    finally:
        program.allow_tf32(False)
    return (losses, {k: v.double().cpu() for k, v in g1.items()},
            {t: {k: v.double().cpu() for k, v in c.items()}
             for t, c in changes.items()})


def run(ctx) -> Outcome:
    from kgwas_tpu_torch.engine.loop import TrainScan, epoch_batches
    from kgwas_tpu_torch.engine.optim import build_optimizer

    cfg, dev, m = ctx.config, ctx.device, ctx.config["model"]
    tc = cfg["train"]
    S = int(ctx.traffic["scan_steps"])
    inp = inputs(ctx)
    raw = inp.raw
    shapes = ref_graph.group_shapes(inp.rels, raw.num_nodes, m["layers"])
    _, encoded = ref_graph.live_groups(inp.rels, m["layers"])
    real_edges = sum(int(s.numel()) for s, _ in inp.rels.values())

    log(f"inputs at {now() - ctx.t_start:.2f} s")
    data = program.make_data(raw, ctx.tmp, inp.ld)
    raw.features = None
    program.load_gwas(data, inp.sumstats, inp.split_seed)
    log(f"data layer at {now() - ctx.t_start:.2f} s")
    run_ = program.make_model(data, m, inp.p0, dev, inp.split_seed)
    model = run_.model
    cg, x, layouts = run_._device_state()
    y_node, w_node = run_._labels(cg)
    log(f"model and device state at {now() - ctx.t_start:.2f} s")
    opt = build_optimizer(model.parameters(), tc["lr"], tc["weight_decay"])
    scan = TrainScan(model, opt, x, layouts, y_node, w_node, S)
    batches = epoch_batches(np.asarray(data.train_mask), tc["batch_size"],
                            False, None)
    n_blocks = len(batches) // S

    def block(k):
        k %= n_blocks
        return np.stack(batches[k * S:(k + 1) * S])

    names = [n for n, _ in model.named_parameters()]
    leaves = [p for _, p in model.named_parameters()]
    snaps, steps_seen = {}, [0]

    def params_now():
        return {n: p.detach().clone() for n, p in zip(names, leaves)}

    def hook(optimizer, args, kwargs):
        steps_seen[0] += 1
        if steps_seen[0] == 1:
            snaps["m1"] = {n: optimizer.state[p]["exp_avg"].detach().clone()
                           for n, p in zip(names, leaves)}
        if steps_seen[0] == 3:
            snaps[3] = params_now()

    handle = opt.register_step_post_hook(hook)
    checked = [scan(block(0))]
    handle.remove()
    snaps[S] = params_now()
    log(f"eager block at {now() - ctx.t_start:.2f} s")
    for k in range(1, CHECKED_BLOCKS):
        checked.append(scan(block(k)))
    snaps[CHECKED_BLOCKS * S] = params_now()
    checked = torch.cat(checked).cpu().numpy()
    sync(dev)
    setup_s = now() - ctx.t_start
    log(f"set-up {setup_s:.2f} s")

    losses, k = [], CHECKED_BLOCKS
    t0 = now()
    deadline = t0 + ctx.seconds
    prev = None
    while True:
        losses.append(scan(block(k)))
        k += 1
        if dev.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            if prev is not None:
                prev.synchronize()
            prev = ev
        if now() >= deadline:
            break
    sync(dev)
    window = now() - t0
    steps = (k - CHECKED_BLOCKS) * S
    log(f"window {window:.3f} s, {steps} steps")
    record = Record(cfg, ctx.peaks, shapes=shapes, train=True,
                    encoded={t: raw.num_nodes[t] for t in encoded})
    if ctx.trace:
        blocks = iter(range(k, k + int(ctx.traffic["trace_blocks"])))
        record.trace = trace_calls(
            dev, int(ctx.traffic["trace_blocks"]),
            lambda: losses.append(scan(block(next(blocks)))), S)
    window_losses = torch.cat(losses).cpu().numpy()
    failed = int(np.count_nonzero(~np.isfinite(window_losses)))
    peak = peak_bytes(dev)
    t_ref = now()
    if record.trace is not None:
        log(record.trace.summary())

    # a program whose optimizer never stepped has no state: moments 0
    start = {k_: v.double().cpu() for k_, v in inp.p0.items()}
    m1 = {n: v.double().cpu() for n, v in snaps.get("m1", {
        n: torch.zeros_like(p) for n, p in zip(names, leaves)}).items()}
    got_changes = {t: {n: snaps.get(t, snaps[S])[n].double().cpu() - start[n]
                       for n in names} for t in (3, S, CHECKED_BLOCKS * S)}
    got_g1 = {n: m1[n] / (1 - 0.9) - tc["weight_decay"] * start[n]
              for n in m1}
    del scan, opt, run_, model, x, layouts, cg, y_node, w_node, leaves, snaps
    data = None
    release(dev)

    feats = kg.make_features(cfg["kg"], cfg["feature_dims"], ctx.seed, dev)
    want = reference_steps(ctx, inp, feats)
    gaps, leaves_of = train_gaps((list(checked), got_g1, got_changes), want,
                                 S, CHECKED_BLOCKS * S)
    log(f"reference {now() - t_ref:.2f} s; first losses {list(checked[:3])} "
        f"against {want[0][:3]}; worst leaves, gradient: "
        f"{worst(leaves_of['grad'])}; change: {worst(leaves_of['change'])}; "
        f"replayed change: "
        f"{worst(leaves_of['replay'])}; {len(leaves_of['grad'])} of "
        f"{len(want[1])} leaves counted")
    checks = [check(name, v, ctx.limits) for name, v in gaps.items()]
    metrics = {"setup_s": setup_s,
               "train_edges_per_s": real_edges * m["layers"] * steps / window}
    return Outcome(steps, failed, metrics, checks, record, peak)


def control(ctx) -> dict:
    """The control's readings of this cell's numbers: the reference put in
    the program's place with TF32 on (the precision below the stated
    float32 with TF32 off); with half of each batch left out (the mean
    over the rest); with block 2 run on block 1's batches (a replay that
    reads a stale batch buffer); with steps that leave the state unchanged;
    and the float32 reference run again, for its own rounding. Besides,
    "f32_vs_f64": the float32 reference against the same arithmetic in
    float64, a witness of how far float32 rounding alone moves each number
    on the seed."""
    S = int(ctx.traffic["scan_steps"])
    n = CHECKED_BLOCKS * S
    inp = inputs(ctx)
    feats = inp.raw.features
    base = reference_steps(ctx, inp, feats)
    runs = {
        "f32_again": reference_steps(ctx, inp, feats),
        "tf32": reference_steps(ctx, inp, feats, tf32=True),
        "half_batch": reference_steps(
            ctx, inp, feats, lambda bs: [b[:len(b) // 2] for b in bs]),
        "stale_batch": reference_steps(
            ctx, inp, feats, lambda bs: bs[:n - S] + bs[n - 2 * S:n - S]),
        "unchanged": reference_steps(ctx, inp, feats, frozen=True),
    }
    out = {name: train_gaps(r, base, S, n)[0] for name, r in runs.items()}
    out["f32_vs_f64"] = train_gaps(base, reference_steps(
        ctx, inp, feats, dtype=torch.float64), S, n)[0]
    return out
