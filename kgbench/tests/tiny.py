"""A cell of BENCHMARK.json cut to a size the CPU tests run in seconds: the
same files, fewer nodes, narrower tables."""
from __future__ import annotations

from kgbench.run import ROOT, load_cell

# the training cells hold three blocks of 8 batches of 512 an epoch
TINY_SNPS = {"fullkg2m.train": 15_000, "fullkg2m.forward": 3_000,
             "calib50k.seed": 15_000}


def tiny_cell(workload: str) -> dict:
    cell = load_cell(ROOT, workload)
    cfg = cell["config"]
    cfg["kg"].update(n_snp=TINY_SNPS[workload], n_gene=300, n_go=150)
    cfg["feature_dims"]["Gene"] = 64
    cfg["model"]["hidden"] = 16
    if "protocol" in cfg:
        cfg["protocol"].update(epochs=1, n_causal=150)
    if "gwas" in cfg:
        cfg["gwas"]["n_causal"] = 150
    return cell
