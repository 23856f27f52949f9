"""The calibration protocol: null and causal simulations on one fixed KG.

Counterpart of the JAX package's ``scripts/run_calibration.py``, the
reference's null / causal simulation analysis at protocol scale:

  * null arm: one fixed 50k-SNP KG; per seed a fresh pure-null sumstats
    draw (z ~ N(0, 1), no causal SNP), the full pipeline
    (``process_gwas_file`` -> ``prepare_split`` -> a 10-epoch
    ``KGWAS.train`` -> KGWAS_P), then the hits and the independent loci
    (mega-clumps, ``scripts/loci.py``) below 5e-8 of GWAS and of KGWAS;
  * causal arm: per seed n_snp / 20 causal SNPs; the causal SNPs among
    each method's hits (true positives) and the rest (false positives).

The KG is built once and serves every seed. One JSON per seed in
``--out-dir`` (the JAX runner's keys, and ``wall_s``); a seed whose JSON
exists is skipped, so a run resumes. Each seed's host seconds are printed
by part (the draw with ``process_gwas_file`` and ``prepare_split``; model
init with the device state; the epochs; the test forward,
``finalize_predictions`` and pred.csv), and kept out of the JSON.

    python -m kgwas_tpu_torch.scripts.run_calibration --null-seeds 100 \\
        --causal-seeds 20                       # on the CUDA card
    python -m kgwas_tpu_torch.scripts.run_calibration --cpu --n-snp 2000 \\
        --hidden 16 --epochs 1 --null-seeds 1 --causal-seeds 1
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ..graph.synthetic import make_synthetic_sumstats
from ..kgwas import KGWAS, resolve_device
from ..kgwas_data import KGWAS_Data
from .loci import T_P, count_loci

SPLIT_KEYS = ("data", "model", "device_state", "epochs", "tail", "pred_csv")


def calibration_kg(n_snp: int, out_dir: str) -> KGWAS_Data:
    """The protocol's one KG: n_snp SNPs, n_snp / 10 genes, max(n_snp / 17,
    100) terms per GO type, seed 0, under out_dir/kg."""
    return KGWAS_Data.from_synthetic(
        n_snp=n_snp, n_gene=n_snp // 10, n_go=max(n_snp // 17, 100), seed=0,
        data_path=os.path.join(out_dir, "kg"))


def prepare_seed(data, n_snp, n_causal, seed, **sumstats_kw):
    """The seed's sumstats draw (seed + 10_000) on the fixed KG, through
    process_gwas_file and prepare_split: (sumstats, causal_idx)."""
    sumstats, causal_idx = make_synthetic_sumstats(
        n_snp, n_causal=n_causal, seed=seed + 10_000, return_causal=True,
        **sumstats_kw)
    data._synth_sumstats = sumstats
    data.load_synthetic_gwas(seed=seed)
    data.process_gwas_file()
    data.prepare_split()
    return sumstats, causal_idx


def run_seed(data, base_sumstats_kw, arm, seed, args, split=None):
    """One seed of one arm on the fixed KG: its result dict with the JAX
    runner's keys and wall_s. split: a dict that receives the seed's host
    seconds by part (SPLIT_KEYS): the draw with process_gwas_file and
    prepare_split; model init in two parts ("model": KGWAS and
    initialize_model; "device_state": train's set-up); the epochs; the
    tail, and pred.csv's share of it."""
    t0 = time.perf_counter()
    n_causal = 0 if arm == "null" else args.n_snp // 20
    sumstats, causal_idx = prepare_seed(data, args.n_snp, n_causal, seed,
                                        **base_sumstats_kw)
    t_init = time.perf_counter()

    run = KGWAS(data, exp_name=f"calib_{arm}_{seed}", seed=seed,
                device="cpu" if args.cpu else None)
    run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=args.hidden)
    t_train = time.perf_counter()
    res = run.train(batch_size=args.batch_size, epoch=args.epochs,
                    save_best_model=False)

    p, kp = np.asarray(res["P"]), np.asarray(res["KGWAS_P"])
    out = {
        "arm": arm, "seed": seed,
        "gwas_hits": int((p < T_P).sum()),
        "kgwas_hits": int((kp < T_P).sum()),
        "gwas_loci": count_loci(res, "P", sumstats),
        "kgwas_loci": count_loci(res, "KGWAS_P", sumstats),
        "scale_factor": float(getattr(run, "scale_factor", float("nan"))),
    }
    if arm == "causal":
        causal_ids = set(f"rs{i}" for i in causal_idx)
        ids = np.asarray(res["ID"])
        for col, key in ((p, "gwas"), (kp, "kgwas")):
            hit_ids = set(ids[col < T_P].tolist())
            out[f"{key}_true_pos"] = len(hit_ids & causal_ids)
            out[f"{key}_false_pos"] = len(hit_ids - causal_ids)
        out["n_causal"] = int(n_causal)
    out["wall_s"] = round(time.perf_counter() - t0, 1)
    if split is not None:
        sec = run.train_seconds
        split.update(data=t_init - t0,
                     model=t_train - t_init, device_state=sec["setup"],
                     epochs=sec["epochs"], tail=sec["tail"],
                     pred_csv=getattr(run, "pred_csv_seconds", 0.0))
    return out


def split_text(split: dict) -> str:
    init = split["model"] + split["device_state"]
    return (f"data {split['data']:.2f} s, init {init:.2f} s "
            f"(model {split['model']:.2f}, device state "
            f"{split['device_state']:.2f}), epochs {split['epochs']:.2f} s, "
            f"tail {split['tail']:.2f} s (pred.csv {split['pred_csv']:.2f})")


def summary_lines(out_dir: str) -> list:
    """The JAX runner's closing summary of every JSON in out_dir."""
    rows = []
    for fn in sorted(os.listdir(out_dir)):
        if fn.endswith(".json"):
            with open(os.path.join(out_dir, fn)) as f:
                rows.append(json.load(f))
    lines = []
    for arm in ("null", "causal"):
        sub = [r for r in rows if r["arm"] == arm]
        if not sub:
            continue
        gl = np.array([r["gwas_loci"] for r in sub])
        kl = np.array([r["kgwas_loci"] for r in sub])
        lines.append(f"[calib] {arm}: {len(sub)} seeds | "
                     f"GWAS loci mean={gl.mean():.3f} max={gl.max()} | "
                     f"KGWAS loci mean={kl.mean():.3f} max={kl.max()}")
        if arm == "causal":
            tp_g = np.mean([r["gwas_true_pos"] for r in sub])
            tp_k = np.mean([r["kgwas_true_pos"] for r in sub])
            lines.append(f"[calib] causal power: GWAS TP mean={tp_g:.1f} "
                         f"KGWAS TP mean={tp_k:.1f} (of {sub[0]['n_causal']})")
    return lines


def seed_jobs(null_seeds: int, causal_seeds: int) -> list:
    return ([("null", s) for s in range(1, null_seeds + 1)]
            + [("causal", s) for s in range(1, causal_seeds + 1)])


def run_seeds(data, jobs, args, out_dir):
    """Runs the (arm, seed) jobs whose JSON is not in out_dir yet, writing
    each JSON and printing its loci and host split; returns the seeds run
    as (arm, seed, result, split)."""
    done = []
    for arm, seed in jobs:
        fp = os.path.join(out_dir, f"{arm}_{seed}.json")
        if os.path.exists(fp):
            continue
        split = {}
        out = run_seed(data, {}, arm, seed, args, split)
        with open(fp, "w") as f:
            json.dump(out, f)
        print(f"[calib] {arm} seed {seed}: gwas_loci={out['gwas_loci']} "
              f"kgwas_loci={out['kgwas_loci']} ({out['wall_s']}s)",
              flush=True)
        print(f"[calib] {arm} seed {seed} host split: {split_text(split)}",
              flush=True)
        done.append((arm, seed, out, split))
    return done


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n-snp", type=int, default=50_000)
    ap.add_argument("--null-seeds", type=int, default=100)
    ap.add_argument("--causal-seeds", type=int, default=20)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=512)
    # not the JAX runner's benchmarks/calib_v2: its JSONs would be skipped
    ap.add_argument("--out-dir", default="calib_results")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device("cpu" if args.cpu else None)
    os.makedirs(args.out_dir, exist_ok=True)
    print(f"[calib] device={device} n_snp={args.n_snp} "
          f"epochs={args.epochs} hidden={args.hidden}", flush=True)

    data = calibration_kg(args.n_snp, args.out_dir)
    run_seeds(data, seed_jobs(args.null_seeds, args.causal_seeds), args,
              args.out_dir)
    for line in summary_lines(args.out_dir):
        print(line)


if __name__ == "__main__":
    main()
