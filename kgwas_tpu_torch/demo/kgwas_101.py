"""The end-to-end KGWAS workflow (counterpart of the JAX package's
``demo/kgwas_101.py``, the reference's ``kgwas_101`` notebook).

Runs on the real data bundle when --data-path holds it, else (or with
--synthetic) on the offline synthetic KG; trains, prints the KGWAS_P
table's first rows, the scale factor and the test metrics, and reloads
the checkpoint.

    python -m kgwas_tpu_torch.demo.kgwas_101 --synthetic [--cpu]
"""
from __future__ import annotations

import argparse
import os

from ..kgwas import KGWAS, resolve_device
from ..kgwas_data import KGWAS_Data
from ..utils import head_text


def have_bundle(data_path: str) -> bool:
    return os.path.exists(
        os.path.join(data_path, "cell_kg/network/edge_index.pkl"))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-path", default="./data/")
    ap.add_argument("--synthetic", action="store_true",
                    help="force the offline synthetic KG")
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--sample-ratio", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else None
    resolve_device(device)

    if args.synthetic or not have_bundle(args.data_path):
        print("[demo] using synthetic KG (pass --data-path with the real "
              "bundle for the full demo)")
        data = KGWAS_Data.from_synthetic(
            n_snp=2000, n_gene=400, n_go=150, seed=args.seed,
            data_path=args.data_path,
        )
        data.load_synthetic_gwas(seed=args.seed)
    else:
        data = KGWAS_Data(data_path=args.data_path)
        # the reference's fast demo configuration
        data.load_kg(
            snp_init_emb="random", go_init_emb="random", gene_init_emb="random",
            sample_edges=True, sample_ratio=args.sample_ratio,
        )
        data.load_external_gwas(example_file=True)

    data.process_gwas_file()
    data.prepare_split()

    run = KGWAS(data, exp_name="kgwas_101", seed=args.seed, device=device)
    run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=args.hidden)
    res = run.train(batch_size=args.batch_size, epoch=args.epochs)

    print(head_text(res, 10, ["ID", "P", "pred", "P_weighted", "KGWAS_P"]))
    print(f"[demo] scale factor: {run.scale_factor:.4f}")
    print(f"[demo] test metrics: {run.test_metrics}")

    # the checkpoint round trip (the reference's load_pretrained)
    run2 = KGWAS(data, exp_name="reload", seed=args.seed, device=device)
    run2.load_pretrained(os.path.join(data.data_path, "model", "kgwas_101"))
    print("[demo] reloaded checkpoint OK")
    return run, run2


if __name__ == "__main__":
    main()
