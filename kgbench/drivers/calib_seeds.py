"""The calibration protocol's seeds, back to back in one process on one
fixed KG (the port's ``scripts/run_calibration.run_seeds``, with the
benchmark's draws): per seed j a fresh sumstats draw (null for even j,
``n_causal`` causal SNPs for odd j), ``process_gwas_file`` ->
``prepare_split`` -> ``KGWAS(...).initialize_model(...)`` with the
benchmark's parameters -> ``KGWAS.train(batch_size, epoch,
save_best_model=False)`` -> ``scripts/loci.count_loci`` of GWAS and of
KGWAS.

Set-up builds the KG and runs ``warm_seeds`` untimed seeds. The window
runs seeds until its seconds are over; the seed running then completes.
Every window seed is checked against the reference: the data layer (LDSC
weights, chi^2 labels, the split); the losses of the first CHECKED_STEPS
steps against the reference trained from the same initial parameters on
the same batches: the first three (eager) apart from those of the blocks
after the first, which KGWAS.train replays from a CUDA graph (block 1
captures and replays, block 2 copies its batches in and replays); the
trained model's predictions (the reference's forward on the parameters
the port trained: the steps between are not followed); and KGWAS_P (the
reference's tail on the port's predictions).

Traffic keys: warm_seeds, trace_seeds.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from .. import program
from ..harness import (Outcome, Record, check, log, now, peak_bytes,
                       rel_gap, release, sync)
from ..inputs import gwas, kg, params, sub_seed
from ..reference import calib as ref_calib
from ..reference import data as ref_data
from ..reference import graph as ref_graph
from ..reference import model as ref_model
from ..trace import trace_calls

SCAN_STEPS = 8          # KGWAS.train's default scan_steps
CHECKED_STEPS = 3 * SCAN_STEPS
SEED_NUMBERS = ("split_mismatch", "weight_gap", "label_gap", "loss_gap",
                "replay_loss_gap", "pred_gap", "kgwas_p_gap")


def inputs(ctx):
    """The fixed KG of every seed (features on the card), its relations
    after the reference's transforms, and its LD scores."""
    cfg = ctx.config
    raw = kg.make_kg(cfg["kg"], cfg["feature_dims"], ctx.seed, ctx.device)
    return SimpleNamespace(
        raw=raw, rels=ref_graph.transform(raw.edges, raw.num_nodes),
        ld=gwas.make_ld_scores(cfg["kg"]["n_snp"], ctx.seed))


def seed_inputs(ctx, j):
    """Seed j's sumstats draw (null for even j), its split's seed and its
    initial parameters."""
    cfg, m, pr = ctx.config, ctx.config["model"], ctx.config["protocol"]
    return SimpleNamespace(
        sumstats=gwas.make_sumstats(cfg["kg"]["n_snp"],
                                    pr["n_causal"] if j % 2 else 0,
                                    pr["sample_size"], ctx.seed, 7, j),
        seed=sub_seed(ctx.seed, 8, j),
        p0=params.make_params(cfg["feature_dims"], m["hidden"], m["layers"],
                              ctx.seed, ctx.device, j))


def reference_losses(ctx, inp, sj, feats, batch_fn=None, tf32=False,
                     frozen_after=None):
    """The reference's losses over the first CHECKED_STEPS batches of seed
    sj's split, from its initial parameters. batch_fn maps the list of
    batches; the steps after the first frozen_after leave the state
    unchanged (the control's faults)."""
    cfg, dev, m, pr = ctx.config, ctx.device, ctx.config["model"], \
        ctx.config["protocol"]
    train = ref_data.split(cfg["kg"]["n_snp"], sj.seed)[0]
    bs = [torch.as_tensor(b, device=dev) for b in
          ref_data.batches(train, pr["batch_size"])[:CHECKED_STEPS]]
    if batch_fn is not None:
        bs = batch_fn(bs)
    y = torch.as_tensor(ref_data.chi2_labels(sj.sumstats),
                        dtype=torch.float32, device=dev)
    w = torch.as_tensor(ref_data.ldsc_weights(sj.sumstats, *inp.ld),
                        dtype=torch.float32, device=dev)
    cut = len(bs) if frozen_after is None else frozen_after
    p = {k: v.clone() for k, v in sj.p0.items()}
    program.allow_tf32(tf32)
    try:
        return [loss for part, lr, wd in (
                    (bs[:cut], pr["lr"], pr["weight_decay"]),
                    (bs[cut:], 0.0, 0.0)) if part
                for loss in ref_model.train_steps(
                    p, feats, inp.rels, inp.raw.num_nodes, m["layers"], part,
                    y, w, lr, wd, m["relu_head"])[0]]
    finally:
        program.allow_tf32(False)


def loss_gaps(got, want) -> dict:
    """The first three steps' losses, and the replayed blocks'."""
    return {"loss_gap": rel_gap(got[:3], want[:3]),
            "replay_loss_gap": rel_gap(got[SCAN_STEPS:CHECKED_STEPS],
                                       want[SCAN_STEPS:CHECKED_STEPS])}


def one_seed(ctx, data, j, spans):
    """Seed j of the protocol through the port: its outputs to check."""
    from kgwas_tpu_torch.scripts.loci import count_loci

    m, pr = ctx.config["model"], ctx.config["protocol"]
    sj = seed_inputs(ctx, j)
    t0 = now()
    program.load_gwas(data, sj.sumstats, sj.seed)
    t1 = now()
    run_ = program.make_model(data, m, sj.p0, ctx.device, sj.seed,
                              "kgbench_seed")
    t2 = now()
    res = run_.train(batch_size=pr["batch_size"], lr=pr["lr"],
                     weight_decay=pr["weight_decay"], epoch=pr["epochs"],
                     save_best_model=False, scan_steps=SCAN_STEPS)
    t3 = now()
    loci = (count_loci(res, "P", sj.sumstats),
            count_loci(res, "KGWAS_P", sj.sumstats))
    t4 = now()
    sec = run_.train_seconds
    for k, v in (("data", t1 - t0), ("init", t2 - t1 + sec["setup"]),
                 ("epochs", sec["epochs"]), ("tail", sec["tail"] + t4 - t3)):
        spans.setdefault(k, []).append(v)
    log(f"seed {j}: {t4 - t0:.3f} s")
    return {
        "j": j, "inputs": sj,
        "weights": program.ldsc_weight_column(data),
        "labels": np.asarray(data.y, dtype=np.float64),
        "split": [np.asarray(data.train_mask), np.asarray(data.val_mask),
                  np.asarray(data.test_mask)],
        "losses": list(run_.epoch_losses[0][:CHECKED_STEPS]),
        "trained": {k: v.detach().clone() for k, v in
                    run_.model.state_dict().items()},
        "pred": np.asarray(res["pred"], dtype=np.float64),
        "kgwas_p": np.asarray(res["KGWAS_P"], dtype=np.float64),
        "p": np.asarray(res["P"], dtype=np.float64),
        "loci": loci,
    }


def run(ctx) -> Outcome:
    cfg, dev, m, tr = ctx.config, ctx.device, ctx.config["model"], ctx.traffic
    n = cfg["kg"]["n_snp"]
    inp = inputs(ctx)
    log(f"inputs at {now() - ctx.t_start:.2f} s")
    data = program.make_data(inp.raw, ctx.tmp, inp.ld)
    inp.raw.features = None
    spans = {}
    j = 0
    for _ in range(int(tr["warm_seeds"])):
        one_seed(ctx, data, j, {})
        log(f"warm seed {j} at {now() - ctx.t_start:.2f} s")
        j += 1
    sync(dev)
    setup_s = now() - ctx.t_start
    log(f"set-up {setup_s:.2f} s")

    done = []
    t0 = now()
    deadline = t0 + ctx.seconds
    while now() < deadline:
        done.append(one_seed(ctx, data, j, spans))
        j += 1
    window = now() - t0
    log(f"window {window:.3f} s, {len(done)} seeds: " + ", ".join(
        f"{k} {np.mean(v):.3f}" for k, v in spans.items()))
    record = Record(cfg, ctx.peaks, spans=spans)
    if ctx.trace:
        traced_seeds = iter(range(j, j + int(tr["trace_seeds"])))
        record.trace = trace_calls(
            dev, int(tr["trace_seeds"]),
            lambda: one_seed(ctx, data, next(traced_seeds), {}))
    peak = peak_bytes(dev)
    t_ref = now()
    if record.trace is not None:
        log(record.trace.summary())
    del data
    release(dev)

    feats = kg.make_features(cfg["kg"], cfg["feature_dims"], ctx.seed, dev)
    gaps = dict.fromkeys(SEED_NUMBERS, 0.0)
    failed = 0
    for s in done:
        sj = s["inputs"]
        ss = sj.sumstats
        ref_split = ref_data.split(n, sj.seed)
        mism = sum(int(not np.array_equal(a, b))
                   for a, b in zip(s["split"], ref_split))
        y = ref_data.chi2_labels(ss)
        r_losses = reference_losses(ctx, inp, sj, feats)
        with torch.no_grad():
            pred = ref_model.forward(s["trained"], feats, inp.rels,
                                     inp.raw.num_nodes, m["layers"],
                                     m["relu_head"]).cpu().numpy()
        seed_gaps = {
            "split_mismatch": mism,
            "weight_gap": rel_gap(s["weights"],
                                  ref_data.ldsc_weights(ss, *inp.ld)),
            "label_gap": rel_gap(s["labels"], y),
            **loss_gaps(s["losses"], r_losses),
            "pred_gap": rel_gap(s["pred"], pred),
            "kgwas_p_gap": float(np.max(np.abs(
                s["kgwas_p"] - ref_calib.kgwas_p(s["pred"], s["p"])))),
        }
        bad = False
        for k, v in seed_gaps.items():
            gaps[k] = max(gaps[k], v)
            bad |= not v <= ctx.limits[k]
        failed += int(bad)
    log(f"reference {now() - t_ref:.2f} s")
    checks = [check(k, v, ctx.limits) for k, v in gaps.items()]
    metrics = {"setup_s": setup_s, "seeds_per_h": 3600.0 * len(done) / window}
    return Outcome(len(done), failed, metrics, checks, record, peak)


def control(ctx) -> dict:
    """The control's readings on seeds 1 (causal) and 2 (null) of the
    protocol: the reference with TF32 on in the program's place (the
    checked steps' losses; the forward, on the seed's initial parameters),
    the float64 data layer and tail computed in float32 (the tail on the
    float32 reference's predictions), half of each batch left out, block 2
    run on block 1's batches (a replay that reads a stale batch buffer),
    steps that leave the state unchanged (all, or those after the first
    block: the replays), and the float32 reference again."""
    cfg, m = ctx.config, ctx.config["model"]
    inp = inputs(ctx)
    feats = inp.raw.features
    n, S = CHECKED_STEPS, SCAN_STEPS
    out = {"f32_again": {}, "tf32": {}, "float32": {}, "half_batch": {},
           "stale_batch": {}, "unchanged": {}, "replay_unchanged": {}}

    def put(kind, name, v):
        """The float32 reference's largest reading (its own rounding), the
        others' smallest (an upper reading is the smallest)."""
        pick = max if kind == "f32_again" else min
        old = out[kind].get(name)
        out[kind][name] = float(v) if old is None else pick(old, float(v))

    def forward(p0, tf32=False):
        program.allow_tf32(tf32)
        try:
            with torch.no_grad():
                return ref_model.forward(p0, feats, inp.rels,
                                         inp.raw.num_nodes, m["layers"],
                                         m["relu_head"]).cpu().numpy()
        finally:
            program.allow_tf32(False)

    for j in (1, 2):
        sj = seed_inputs(ctx, j)
        ss = sj.sumstats
        base_l = reference_losses(ctx, inp, sj, feats)
        base_p = forward(sj.p0)
        for kind, losses in (
                ("f32_again", reference_losses(ctx, inp, sj, feats)),
                ("tf32", reference_losses(ctx, inp, sj, feats, tf32=True)),
                ("half_batch", reference_losses(
                    ctx, inp, sj, feats,
                    lambda bs: [b[:len(b) // 2] for b in bs])),
                ("stale_batch", reference_losses(
                    ctx, inp, sj, feats,
                    lambda bs: bs[:n - S] + bs[n - 2 * S:n - S])),
                ("unchanged", reference_losses(ctx, inp, sj, feats,
                                               frozen_after=0)),
                ("replay_unchanged", reference_losses(
                    ctx, inp, sj, feats, frozen_after=S))):
            for k, v in loss_gaps(losses, base_l).items():
                put(kind, k, v)
        put("f32_again", "pred_gap", rel_gap(forward(sj.p0), base_p))
        put("tf32", "pred_gap", rel_gap(forward(sj.p0, True), base_p))
        p = np.asarray(ss["P"])
        w = ref_data.ldsc_weights(ss, *inp.ld)
        put("float32", "weight_gap", rel_gap(
            ref_data.ldsc_weights(ss, *inp.ld, np.float32), w))
        put("float32", "label_gap", rel_gap(
            ref_data.chi2_labels(ss, np.float32), ref_data.chi2_labels(ss)))
        put("float32", "kgwas_p_gap", np.max(np.abs(
            ref_calib.kgwas_p(base_p, p, np.float32)
            - ref_calib.kgwas_p(base_p, p))))
    return out
