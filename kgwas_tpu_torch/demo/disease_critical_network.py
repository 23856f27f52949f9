"""The disease-critical network (counterpart of the JAX package's
``demo/disease_critical_network.py``, the reference's notebook of that
name): a trained model's attention over the KG, its variant
interpretation, and the network around the hits, saved as CSV.

It loads the checkpoint --model-name under <data-path>/model/, or trains
a small model first; on the real bundle when --data-path holds it, else
on the offline synthetic KG.

    python -m kgwas_tpu_torch.demo.disease_critical_network [--cpu]
"""
from __future__ import annotations

import argparse
import os

from ..kgwas import KGWAS, resolve_device
from ..kgwas_data import KGWAS_Data
from ..utils import head_text, n_rows, write_table
from .kgwas_101 import have_bundle


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-path", default="./data/")
    ap.add_argument("--model-name", default="kgwas_101")
    ap.add_argument("--variant-threshold", type=float, default=5e-8)
    ap.add_argument("--magma-path", default=None)
    ap.add_argument("--num-cpus", type=int, default=1)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)

    if have_bundle(args.data_path):
        data = KGWAS_Data(data_path=args.data_path)
        data.load_kg(snp_init_emb="random", go_init_emb="random",
                     gene_init_emb="random", sample_edges=True, sample_ratio=0.1)
        data.load_external_gwas(example_file=True)
    else:
        print("[demo] synthetic mode")
        data = KGWAS_Data.from_synthetic(
            n_snp=2000, n_gene=400, n_go=150, seed=42, data_path=args.data_path
        )
        data.load_synthetic_gwas()
    data.process_gwas_file()
    data.prepare_split()

    run = KGWAS(data, exp_name=args.model_name, seed=42, device=device)
    ckpt = os.path.join(data.data_path, "model", args.model_name)
    if os.path.exists(ckpt):
        run.load_pretrained(ckpt)
    else:
        print("[demo] no checkpoint found; training a small model first")
        run.initialize_model(gnn_hidden_dim=64)
        run.train(epoch=2, batch_size=512)

    net, variants, dcn = run.get_disease_critical_network(
        variant_threshold=args.variant_threshold,
        magma_path=args.magma_path,
        num_cpus=args.num_cpus,
    )
    print("edge-weight rows:", n_rows(net))
    print("disease critical network:")
    print(head_text(dcn, 20))
    print("variant interpretation rows:", n_rows(variants))
    out = os.path.join(data.data_path, "disease_critical_network.csv")
    write_table(dcn, out, sep=",")
    print("saved to", out)
    return net, variants, dcn


if __name__ == "__main__":
    main()
