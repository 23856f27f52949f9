"""The power-analysis table of a synthetic subsampling sweep.

Counterpart of the JAX package's ``scripts/summarize_subsample.py``: the
same Markdown from the same directory of ``run_sweep --mode subsample
--synthetic-n-snp ...`` JSONs (of either package). Per trait (pheno seed)
the gold run is the job at sample_size == --ref-n; for every (sample
size, seed) job: GWAS / KGWAS hits and loci, causal recovery, and the
KGWAS loci replicated in the gold run's GWAS loci (same chromosome,
within 0.1 cM, the mega-clump merge radius).

    python -m kgwas_tpu_torch.scripts.summarize_subsample \\
        --out-dir sweep_results/ --ref-n 50000
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from collections import defaultdict


def replicated(loci, gold_loci, radius=0.1):
    hits = 0
    for chrom, cm in loci:
        if any(gc == chrom and abs(gcm - cm) < radius
               for gc, gcm in gold_loci):
            hits += 1
    return hits


def summary(out_dir: str, ref_n: int) -> str:
    jobs = []
    for fp in sorted(glob.glob(os.path.join(out_dir, "*.json"))):
        with open(fp) as f:
            jobs.append(json.load(f))
    by_trait = defaultdict(list)
    for j in jobs:
        if j["job"][0] != "subsample":
            continue
        _, pheno, n, seed = j["job"]
        by_trait[str(pheno)].append((int(n), int(seed), j))

    out = ["# Synthetic subsampling power analysis\n",
           "Workflow: `scripts/run_sweep.py --mode subsample "
           "--synthetic-n-snp ... --phenos <trait seeds> --sample-sizes ...` "
           "— the synthetic analog of the reference's 21-trait x 8-size x "
           "5-seed cohort subsampling suite (reference kgwas_data.py:367-389, "
           "demo/kgwas_subsampling.ipynb), run end-to-end through the full "
           "KGWAS pipeline (KG compile -> train -> SR calibration -> "
           "mega-clump loci).\n"]
    for pheno in sorted(by_trait):
        # by (n, seed), as the JAX script's sort of (n, seed, dict) tuples
        # orders them; two JSONs of one job keep their file order here,
        # where comparing their dicts raises there
        rows = sorted(by_trait[pheno], key=lambda r: r[:2])
        gold = [j for n, s, j in rows if n == ref_n]
        if not gold:
            out.append(f"(trait {pheno}: no gold run at N={ref_n}, skipped)")
            continue
        gold_j = gold[0]
        gold_loci = [tuple(x) for x in gold_j["gwas_loci"]]
        out.append(f"\n## Trait seed {pheno} (gold: N={ref_n}, "
                   f"{len(gold_loci)} GWAS loci, {gold_j['n_causal']} causal "
                   "SNPs)\n")
        out.append("| N | seed | GWAS hits | KGWAS hits | GWAS loci | "
                   "KGWAS loci | KGWAS loci replicated in gold | causal found "
                   "GWAS | causal found KGWAS |")
        out.append("|---|---|---|---|---|---|---|---|---|")
        for n, seed, j in rows:
            kg_loci = [tuple(x) for x in j["kgwas_loci"]]
            rep = replicated(kg_loci, gold_loci)
            out.append(f"| {n} | {seed} | {j['gwas_hits_5e8']} | "
                       f"{j['kgwas_hits_5e8']} | {len(j['gwas_loci'])} | "
                       f"{len(kg_loci)} | {rep}/{len(kg_loci)} | "
                       f"{j['gwas_causal_recovered']}/{j['n_causal']} | "
                       f"{j['kgwas_causal_recovered']}/{j['n_causal']} |")
    return "".join(line + "\n" for line in out)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", default="./sweep_results/")
    ap.add_argument("--ref-n", type=int, default=50_000)
    args = ap.parse_args(argv)
    print(summary(args.out_dir, args.ref_n), end="")


if __name__ == "__main__":
    main()
