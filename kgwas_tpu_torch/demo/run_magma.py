"""MAGMA's gene-level analysis of a trained model's KGWAS_P (counterpart
of the JAX package's ``demo/run_magma.py``, the reference's ``run_magma``
notebook): loads the checkpoint --model-name under <data-path>/model/ and
runs the MAGMA binary on its pred.csv (``external/magma.py``). The model
is built on the KG the other demos train on (the bundle's with random
embeddings and a tenth of its edges, else the synthetic KG); the JAX demo
loads no KG and so raises before MAGMA runs.

    python -m kgwas_tpu_torch.demo.run_magma --magma-bin ./magma \\
        --bfile ./g1000_eur [--cpu]
"""
from __future__ import annotations

import argparse
import os

from ..kgwas import KGWAS, resolve_device
from ..kgwas_data import KGWAS_Data
from .kgwas_101 import have_bundle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-path", default="./data/")
    ap.add_argument("--model-name", default="kgwas_101")
    ap.add_argument("--magma-bin", required=True)
    ap.add_argument("--bfile", required=True,
                    help="PLINK bfile prefix for the reference panel")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)

    if have_bundle(args.data_path):
        data = KGWAS_Data(data_path=args.data_path, offline=True)
        data.load_kg(snp_init_emb="random", go_init_emb="random",
                     gene_init_emb="random", sample_edges=True, sample_ratio=0.1)
    else:
        data = KGWAS_Data.from_synthetic(
            n_snp=2000, n_gene=400, n_go=150, seed=42, data_path=args.data_path)
    run = KGWAS(data, exp_name=args.model_name, device=device)
    run.load_pretrained(os.path.join(args.data_path, "model", args.model_name))
    out_prefix = run.run_magma(args.magma_bin, args.bfile)
    print("MAGMA output prefix:", out_prefix)
    return out_prefix


if __name__ == "__main__":
    main()
