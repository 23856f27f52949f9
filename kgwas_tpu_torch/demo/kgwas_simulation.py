"""The null / causal simulation analysis (counterpart of the JAX package's
``demo/kgwas_simulation.py``, the reference's ``kgwas_simulation``
notebook): one KGWAS training per simulation seed, then the GWAS and
KGWAS hits below 5e-8.

With the real bundle it reads simulation_gwas/*.fastGWA (the reference's
500 null seeds); offline it builds a synthetic KG per seed, and for the
null type replaces its sumstats by a draw with one causal SNP. Seeds run
one after another; ``scripts/run_sweep.py`` shards them over processes.

    python -m kgwas_tpu_torch.demo.kgwas_simulation --seeds 1 6 [--cpu]
"""
from __future__ import annotations

import argparse
import json

from ..graph.synthetic import make_synthetic_sumstats
from ..kgwas import KGWAS, resolve_device
from ..kgwas_data import KGWAS_Data
from ..scripts.loci import T_P
from .kgwas_101 import have_bundle


def run_one_seed(args, seed, simulation_type):
    if have_bundle(args.data_path):
        data = KGWAS_Data(data_path=args.data_path)
        data.load_kg(snp_init_emb="random", go_init_emb="random",
                     gene_init_emb="random", sample_edges=True,
                     sample_ratio=0.1)
        data.load_simulation_gwas(simulation_type, seed)
    else:
        data = KGWAS_Data.from_synthetic(
            n_snp=2000, n_gene=400, n_go=150, seed=seed,
            data_path=args.data_path,
        )
        if simulation_type == "null":
            data._synth_sumstats = make_synthetic_sumstats(
                2000, n_causal=1, seed=seed + 10000)
        data.load_synthetic_gwas(seed=seed)

    data.process_gwas_file()
    data.prepare_split()
    run = KGWAS(data, exp_name=f"sim_{simulation_type}_{seed}", seed=seed,
                device="cpu" if args.cpu else None)
    run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=args.hidden)
    res = run.train(batch_size=args.batch_size, epoch=args.epochs,
                    save_best_model=False)
    return {"seed": seed, "type": simulation_type,
            "gwas_hits": int((res["P"] < T_P).sum()),
            "kgwas_hits": int((res["KGWAS_P"] < T_P).sum())}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-path", default="./data/")
    ap.add_argument("--simulation-type", default="null",
                    choices=["null", "causal", "causal_link"])
    ap.add_argument("--seeds", type=int, nargs=2, default=[1, 6],
                    metavar=("START", "END"))
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--hidden", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--out", default="simulation_results.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    resolve_device("cpu" if args.cpu else None)

    results = []
    for seed in range(args.seeds[0], args.seeds[1]):
        out = run_one_seed(args, seed, args.simulation_type)
        print(out)
        results.append(out)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    if args.simulation_type == "null":
        fp = [r["kgwas_hits"] for r in results]
        print(f"[simulation] null false positives per seed: {fp} "
              f"(calibration requires ~= GWAS: "
              f"{[r['gwas_hits'] for r in results]})")
    return results


if __name__ == "__main__":
    main()
