"""kgwas_tpu_torch command-line interface.

Counterpart of ``kgwas_tpu/cli.py``, with its subcommands and flags: train,
predict, interpret, magma, classic-gwas, warm-cache and bench.

    python -m kgwas_tpu_torch.cli train --data-path ./data --gwas sumstats.fastGWA
    python -m kgwas_tpu_torch.cli predict --data-path ./data --name KGWAS
    python -m kgwas_tpu_torch.cli interpret --data-path ./data --name KGWAS

The model runs on the CUDA card unless ``--device`` names another device
(``--device cpu``); with no card and no ``--device`` a command raises
before it loads any data. ``train --mesh N`` trains over N processes (one
per device, started by ``torchrun --nproc-per-node N -m
kgwas_tpu_torch.cli train --mesh N``; NCCL on the cards, gloo with
``--device cpu``). Every ``--backbone``, ``--aggr`` and ``--dtype`` trains
so: each rank runs the layer kernels on its block of each layer's rows,
contiguous blocks of row tiles that need not be equal
(``parallel/shard.py``). Outside torchrun (no process group of N ranks)
it raises ValueError before loading.
``train --watchdog-timeout T`` runs the same command again in a child
process under the stall watchdog, as the JAX package's CLI does.
``main`` returns what the command made (the trained KGWAS, the
predictions, the three interpretation tables, ...).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from . import kgwas


def _add_data_args(p):
    p.add_argument("--data-path", default="./data/")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--snp-emb", default="enformer")
    p.add_argument("--go-emb", default="random")
    p.add_argument("--gene-emb", default="esm")
    p.add_argument("--sample-edges", action="store_true")
    p.add_argument("--sample-ratio", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    _add_device_arg(p)


def _add_device_arg(p):
    p.add_argument("--device",
                   help="torch device of the model (default: the CUDA card; "
                        "'cpu' runs the kernels' plain versions)")


def _device(args):
    return kgwas.resolve_device(args.device)


def _load_data(args, need_gwas=True):
    from . import KGWAS_Data

    if args.synthetic:
        data = KGWAS_Data.from_synthetic(
            n_snp=2000, n_gene=400, n_go=150, seed=args.seed,
            data_path=args.data_path,
        )
        if need_gwas:
            data.load_synthetic_gwas(seed=args.seed)
    else:
        data = KGWAS_Data(data_path=args.data_path)
        data.load_kg(
            snp_init_emb=args.snp_emb,
            go_init_emb=args.go_emb,
            gene_init_emb=args.gene_emb,
            sample_edges=args.sample_edges,
            sample_ratio=args.sample_ratio,
        )
        if need_gwas:
            if getattr(args, "gwas", None):
                data.load_external_gwas(path=args.gwas, seed=args.seed)
            else:
                data.load_external_gwas(example_file=True, seed=args.seed)
    if need_gwas:
        data.process_gwas_file()
        data.prepare_split()
    return data


def _checked_train_args(args):
    """Raise for a backbone or aggregation the port does not know, before
    loading."""
    from .config import ModelConfig
    from .models.hetero_gnn import check_supported

    check_supported(ModelConfig(gnn_backbone=args.backbone,
                                gnn_aggr=args.aggr, compute_dtype=args.dtype))


def _pretrained(args, need_gwas):
    from . import KGWAS

    device = _device(args)
    data = _load_data(args, need_gwas=need_gwas)
    run = KGWAS(data, device=device, exp_name=args.name)
    run.load_pretrained(os.path.join(args.data_path, "model", args.name))
    return run


def _under_watchdog(args):
    """Run this same command again in a child process under the stall
    watchdog (engine/watchdog.run_with_watchdog): the child trains with
    heartbeats (KGWAS_HEARTBEAT), and a stall kills it and relaunches it,
    up to --watchdog-restarts times. Returns the exit code (0)."""
    import sys
    import tempfile

    from .engine.watchdog import run_with_watchdog

    hb = os.path.join(tempfile.mkdtemp(prefix="kgwas_wd_"), "heartbeat")
    # the child imports this package as the parent did
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, KGWAS_UNDER_WATCHDOG="1", KGWAS_HEARTBEAT=hb,
               PYTHONPATH=root + (os.pathsep + path if path else ""))
    return run_with_watchdog(
        [sys.executable, "-m", "kgwas_tpu_torch.cli"] + args.raw_argv,
        heartbeat=hb,
        stall_timeout_s=args.watchdog_timeout,
        max_restarts=args.watchdog_restarts,
        env=env,
    )


def cmd_train(args):
    from . import KGWAS

    _checked_train_args(args)
    device = _device(args)
    if args.watchdog_timeout and not os.environ.get("KGWAS_UNDER_WATCHDOG"):
        return _under_watchdog(args)
    if args.mesh > 1 or (args.mesh and "RANK" in os.environ):
        # one process per device, as torchrun starts them
        from .parallel.mesh import init_distributed

        init_distributed("gloo" if device.type == "cpu" else "nccl")
        device = _device(args)
    data = _load_data(args)
    run = KGWAS(data, device=device, exp_name=args.name, seed=args.seed,
                weight_bias_track=args.wandb)
    run.initialize_model(
        gnn_num_layers=args.layers,
        gnn_hidden_dim=args.hidden,
        gnn_backbone=args.backbone,
        gnn_aggr=args.aggr,
        gat_num_head=args.heads,
        compute_dtype=args.dtype,
        use_pallas=args.pallas,
        remat=args.remat,
        matmul_precision="highest",
    )
    res = run.train(
        batch_size=args.batch_size,
        lr=args.lr,
        weight_decay=args.weight_decay,
        epoch=args.epochs,
        profile_dir=args.profile_dir,
        metrics_log=args.metrics_log,
        heartbeat_path=os.environ.get("KGWAS_HEARTBEAT"),
        mesh=args.mesh or None,
    )
    if run.mesh is not None and run.mesh.rank != 0:
        return run
    cols = ("ID", "P", "pred", "KGWAS_P")
    print("\t".join(cols))
    for row in zip(*(res[c][:5].tolist() for c in cols)):
        print("\t".join(map(str, row)))
    print(json.dumps({"test_metrics": run.test_metrics,
                      "scale_factor": run.scale_factor}))
    return run


def cmd_predict(args):
    import numpy as np

    run = _pretrained(args, need_gwas=False)
    pred = run.predict_all()
    out = args.out or "predictions.npy"
    np.save(out, pred)
    print(f"saved {len(pred)} per-SNP predictions to {out}")
    return pred


def cmd_interpret(args):
    from .utils import n_rows, write_table

    run = _pretrained(args, need_gwas=True)
    tables = run.get_disease_critical_network(
        variant_threshold=args.variant_threshold,
        magma_path=args.magma_results,
        num_cpus=args.num_cpus,
    )
    dcn = tables[2]
    write_table(dcn, args.out, sep=",")
    print(f"disease critical network ({n_rows(dcn)} rows) -> {args.out}")
    return tables


def cmd_magma(args):
    run = _pretrained(args, need_gwas=False)
    return run.run_magma(args.magma_bin, args.bfile)


def cmd_classic_gwas(args):
    from .external.gwas_runner import GwasToolConfig, run_classic_gwas
    from .utils import n_rows, write_table

    cfg = GwasToolConfig(
        bfile=args.bfile,
        result_dir=args.result_dir,
        covar_file=args.covar,
        grm_sparse=args.grm,
        plink2_bin=args.plink2_bin,
        gcta_bin=args.gcta_bin,
        threads=args.threads,
    )
    table = run_classic_gwas(cfg, args.pheno, args.name, args.sample_size,
                             binary=args.binary)
    out = os.path.join(args.result_dir, args.name + ".sumstats.tsv")
    write_table(table, out, sep="\t")
    print(f"sumstats ({n_rows(table)} SNPs) -> {out}")
    return table


def cmd_bench(args):
    os.environ.setdefault("BENCH_STEPS", str(args.steps))
    from .bench_lib import main as bench_main

    return bench_main(device=args.device)


def cmd_warm_cache(args):
    """Build every CUDA kernel of ops/csrc (nvcc, one process per source,
    all started together) into the build directory, so that the first real
    run finds them built."""
    import time

    from .ops import build

    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[warm-cache] kernels built in {time.perf_counter() - t0:.1f} s: "
          f"{sorted(built) or 'all were built already'} -> {build.build_dir()}")
    return built


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kgwas-tpu-torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train", help="train KGWAS and emit KGWAS_P sumstats")
    _add_data_args(t)
    t.add_argument("--gwas", help="path to GWAS sumstats (.fastGWA etc.)")
    t.add_argument("--name", default="KGWAS")
    t.add_argument("--layers", type=int, default=2)
    t.add_argument("--hidden", type=int, default=128)
    t.add_argument("--backbone", default="GAT",
                   choices=["GAT", "SAGE", "GCN", "SGC"])
    t.add_argument("--aggr", default="sum")
    t.add_argument("--heads", type=int, default=1)
    t.add_argument("--epochs", type=int, default=10)
    t.add_argument("--batch-size", type=int, default=512)
    t.add_argument("--lr", type=float, default=1e-4)
    t.add_argument("--weight-decay", type=float, default=5e-4)
    t.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    t.add_argument("--pallas", action="store_true",
                   help="accepted and ignored: the TPU kernels' switch")
    t.add_argument("--remat", action="store_true")
    t.add_argument("--wandb", action="store_true")
    t.add_argument("--profile-dir")
    t.add_argument("--metrics-log")
    t.add_argument("--watchdog-timeout", type=float, default=0,
                   help="stall watchdog: kill+restart training if no "
                        "step progress for this many seconds (0 = off)")
    t.add_argument("--watchdog-restarts", type=int, default=2)
    t.add_argument("--mesh", type=int, default=0,
                   help="ranks on the mesh's 'data' axis (0 = single "
                        "device): every layer's rows split over them, for "
                        "every backbone, aggr and dtype; run one process "
                        "per rank with torchrun")
    t.set_defaults(fn=cmd_train)

    p = sub.add_parser("predict", help="per-SNP predictions from a checkpoint")
    _add_data_args(p)
    p.add_argument("--name", default="KGWAS")
    p.add_argument("--out")
    p.set_defaults(fn=cmd_predict)

    i = sub.add_parser("interpret", help="disease critical network")
    _add_data_args(i)
    i.add_argument("--gwas", help="path to GWAS sumstats (default: the "
                   "example sumstats, which the JAX package's CLI reads)")
    i.add_argument("--name", default="KGWAS")
    i.add_argument("--variant-threshold", type=float, default=5e-8)
    i.add_argument("--magma-results")
    i.add_argument("--num-cpus", type=int, default=1)
    i.add_argument("--out", default="disease_critical_network.csv")
    i.set_defaults(fn=cmd_interpret)

    m = sub.add_parser("magma", help="MAGMA gene analysis on KGWAS output")
    _add_data_args(m)
    m.add_argument("--name", default="KGWAS")
    m.add_argument("--magma-bin", required=True)
    m.add_argument("--bfile", required=True)
    m.set_defaults(fn=cmd_magma)

    c = sub.add_parser("classic-gwas", help="run PLINK2/fastGWA upstream GWAS")
    c.add_argument("--bfile", required=True)
    c.add_argument("--pheno", required=True)
    c.add_argument("--name", default="gwas")
    c.add_argument("--result-dir", default="./gwas_results/")
    c.add_argument("--covar")
    c.add_argument("--grm")
    c.add_argument("--sample-size", type=int, required=True)
    c.add_argument("--binary", action="store_true")
    c.add_argument("--plink2-bin", default="plink2")
    c.add_argument("--gcta-bin", default="gcta64")
    c.add_argument("--threads", type=int, default=20)
    c.set_defaults(fn=cmd_classic_gwas)

    wc = sub.add_parser(
        "warm-cache",
        help="build the CUDA kernels once, before the first real run")
    wc.add_argument("--shapes", nargs="+", default=["demo", "calib"],
                    choices=["bench", "calib", "demo"],
                    help="accepted and without effect: the kernels take "
                         "their shapes at run time, so one build serves "
                         "every shape")
    wc.set_defaults(fn=cmd_warm_cache)

    b = sub.add_parser("bench", help="one-card throughput benchmark")
    b.add_argument("--steps", type=int, default=20)
    _add_device_arg(b)
    b.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    args.raw_argv = list(argv) if argv is not None else sys.argv[1:]
    return args.fn(args)


if __name__ == "__main__":
    main()
