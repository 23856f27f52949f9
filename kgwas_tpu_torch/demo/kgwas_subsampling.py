"""The subsampled-cohort power analysis (counterpart of the JAX package's
``demo/kgwas_subsampling.py``, the reference's ``kgwas_subsampling``
notebook): per sample size and seed, train KGWAS on the subsampled
cohort's sumstats and score its independent loci at 5e-8 against the
full-cohort gold GWAS's (recall and precision at k). Needs the real
bundle (subsample_gwas/, full_gwas/, the LD dictionaries, the .bim map).

    python -m kgwas_tpu_torch.demo.kgwas_subsampling --data-path ./data/ \\
        --pheno biochemistry_Creatinine --sample-sizes 5000 [--cpu]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

from ..kgwas import KGWAS, resolve_device
from ..kgwas_data import KGWAS_Data
from ..stats.clumps import (get_clumps_gold_label, get_curve,
                            get_mega_clump_query, get_meta_clumps)
from ..scripts.loci import T_P
from ..utils import rename, sort_order


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-path", default="./data/")
    ap.add_argument("--pheno", default="biochemistry_Creatinine")
    ap.add_argument("--sample-sizes", type=int, nargs="+", default=[5000])
    ap.add_argument("--seeds", type=int, nargs="+", default=[1])
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--out", default="subsampling_results.json")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)

    results = []
    for sample_size in args.sample_sizes:
        for seed in args.seeds:
            data = KGWAS_Data(data_path=args.data_path)
            data.load_kg(snp_init_emb="enformer", go_init_emb="random",
                         gene_init_emb="esm")
            data.load_gwas_subsample(args.pheno, sample_size, seed)
            data.process_gwas_file()
            data.prepare_split()
            run = KGWAS(data, exp_name=f"{args.pheno}_{sample_size}_{seed}",
                        seed=seed, device=device)
            run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=args.hidden)
            res = run.train(epoch=args.epochs)

            # gold: the full-cohort GWAS's mega-clumps
            gold_data = KGWAS_Data(data_path=args.data_path)
            gold_data.idx2id = data.idx2id
            gold_data.id2idx = data.id2idx
            gold_data.load_full_gwas(args.pheno)
            gold = rename(gold_data.lr_uni, {"ID": "SNP"})
            gold_clumps = get_clumps_gold_label(args.data_path, gold)
            _, gold_rsid, _ = get_meta_clumps(gold_clumps, args.data_path)

            # every row ranked by KGWAS_P, then the hits kept
            order = sort_order(res["KGWAS_P"])
            hits = np.asarray(res["ID"])[order][
                np.asarray(res["KGWAS_P"])[order] < T_P]
            _, pred_rsid, _ = get_mega_clump_query(
                args.data_path, gold_clumps, hits)
            recall_k, precision_k, _ = get_curve(
                list(pred_rsid.values()), list(gold_rsid.values()))
            k = len(pred_rsid)
            row = {
                "pheno": args.pheno,
                "sample_size": sample_size,
                "seed": seed,
                "kgwas_loci": k,
                "recall_at_k": recall_k.get(k, 0),
                "precision_at_k": precision_k.get(k, 0),
            }
            print(row)
            results.append(row)

    with open(args.out, "w") as f:
        json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
