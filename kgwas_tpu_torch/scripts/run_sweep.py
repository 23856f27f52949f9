"""The trait x sample-size x seed sweeps: subsampling and simulation.

Counterpart of the JAX package's ``scripts/run_sweep.py`` (the
reference's subsampling suite, 21 traits x 8 sizes x 5 seeds, and its 500
simulation seeds). Each job is a full training run and writes one JSON
(the JAX runner's keys) named by the job; a job whose JSON exists is
skipped, so a sweep resumes.

Processes, in torch's idiom:

  * the job list is sharded over processes, process i of n running jobs
    i, i + n, ...: n and i from ``--num-hosts`` / ``--host-index``, else
    from an initialised ``torch.distributed`` group, else from torchrun's
    ``RANK`` / ``WORLD_SIZE``, else one process. Each writes its own
    jobs' JSONs; under torchrun each takes the card of its LOCAL_RANK;
  * ``--coordinator host:port`` with ``--num-processes`` and
    ``--process-id`` joins a process group
    (``parallel.mesh.init_distributed`` over ``tcp://host:port``), and
    ``--mesh-data N`` trains each job over N ranks (``KGWAS.train(mesh=
    N)``; under torchrun the group comes from its environment). Then
    every rank walks the same job list in lockstep, and rank 0 alone
    writes each JSON (every rank gets the same table).

    python -m kgwas_tpu_torch.scripts.run_sweep --mode subsample \\
        --synthetic-n-snp 50000 --phenos 1 2 --sample-sizes 12500 50000
    torchrun --nproc-per-node 4 -m kgwas_tpu_torch.scripts.run_sweep ...
    torchrun --nproc-per-node 2 -m kgwas_tpu_torch.scripts.run_sweep \\
        --mesh-data 2 ...
"""
from __future__ import annotations

import argparse
import itertools
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..kgwas import KGWAS, resolve_device
from ..kgwas_data import KGWAS_Data
from .loci import T_P, loci_leads


def job_list(args):
    if args.mode == "simulation":
        seeds = range(args.seed_start, args.seed_end)
        return [("simulation", args.simulation_type, s) for s in seeds]
    combos = itertools.product(
        args.phenos, args.sample_sizes, range(args.seed_start, args.seed_end)
    )
    return [("subsample", p, n, s) for p, n, s in combos]


def host_slot(args):
    """(this process's index, the number of processes) over which the job
    list is sharded."""
    if args.host_index is not None:
        return args.host_index, args.num_hosts or 1
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    if "RANK" in os.environ:
        return int(os.environ["RANK"]), int(os.environ.get("WORLD_SIZE", 1))
    return 0, 1


def load_job_data(job, args):
    """The KG and the job's sumstats, processed and split."""
    if args.synthetic_n_snp:
        n = args.synthetic_n_snp
        data = KGWAS_Data.from_synthetic(
            n_snp=n, n_gene=max(n // 10, 40), n_go=max(n // 17, 20),
            snp_dim=20, gene_dim=128, go_dim=128, avg_degree=6,
            seed=0, data_path=args.data_path)
    else:
        data = KGWAS_Data(data_path=args.data_path)
        data.load_kg(
            snp_init_emb=args.snp_emb,
            go_init_emb=args.go_emb,
            gene_init_emb=args.gene_emb,
            sample_edges=args.sample_edges,
            sample_ratio=args.sample_ratio,
        )
    if job[0] == "simulation":
        _, sim_type, seed = job
        data.load_simulation_gwas(sim_type, seed)
        name = f"sim_{sim_type}_{seed}"
    elif args.synthetic_n_snp:
        _, pheno, n, seed = job
        data.load_synthetic_gwas_subsample(int(pheno), n, seed,
                                           ref_n=args.ref_n)
        name = f"syn{pheno}_{n}_{seed}"
    else:
        _, pheno, n, seed = job
        data.load_gwas_subsample(pheno, n, seed)
        name = f"{pheno}_{n}_{seed}"
    data.process_gwas_file()
    data.prepare_split()
    return data, name


def run_job(job, args):
    """One job's full training run: its result dict (the JAX runner's
    keys)."""
    data, name = load_job_data(job, args)
    run = KGWAS(data, exp_name=name, seed=job[-1],
                device="cpu" if getattr(args, "cpu", False) else None)
    run.initialize_model(
        gnn_num_layers=args.layers, gnn_hidden_dim=args.hidden
    )
    train_kwargs = {}
    if getattr(args, "mesh_data", None):
        train_kwargs["mesh"] = args.mesh_data
    res = run.train(epoch=args.epochs, batch_size=args.batch_size,
                    save_best_model=False, **train_kwargs)
    p, kp = np.asarray(res["P"]), np.asarray(res["KGWAS_P"])
    out = {
        "job": list(job),
        "gwas_hits_5e8": int((p < T_P).sum()),
        "kgwas_hits_5e8": int((kp < T_P).sum()),
        "test_metrics": run.test_metrics,
        "scale_factor": run.scale_factor,
    }
    # loci and causal recovery for the power analysis (summarize_subsample)
    out["gwas_loci"] = loci_leads(res, "P")
    out["kgwas_loci"] = loci_leads(res, "KGWAS_P")
    causal = getattr(data, "_synth_causal_idx", None)
    if causal is not None:
        causal_ids = {f"rs{i}" for i in causal}
        ids = np.asarray(res["ID"]).tolist()
        is_causal = np.fromiter((i in causal_ids for i in ids), dtype=bool,
                                count=len(ids))
        out["n_causal"] = len(causal_ids)
        out["gwas_causal_recovered"] = int(((p < T_P) & is_causal).sum())
        out["kgwas_causal_recovered"] = int(((kp < T_P) & is_causal).sum())
    return out


def parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--data-path", default="./data/")
    ap.add_argument("--out-dir", default="./sweep_results/")
    ap.add_argument("--mode", choices=["simulation", "subsample"],
                    default="simulation")
    ap.add_argument("--simulation-type", default="null")
    ap.add_argument("--phenos", nargs="+", default=["biochemistry_Creatinine"])
    ap.add_argument("--sample-sizes", type=int, nargs="+", default=[5000])
    ap.add_argument("--seed-start", type=int, default=1)
    ap.add_argument("--seed-end", type=int, default=6)
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--hidden", type=int, default=128)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch-size", type=int, default=512)
    ap.add_argument("--snp-emb", default="enformer")
    ap.add_argument("--go-emb", default="random")
    ap.add_argument("--gene-emb", default="esm")
    ap.add_argument("--sample-edges", action="store_true")
    ap.add_argument("--synthetic-n-snp", type=int, default=0,
                    help="run the sweep on a synthetic KG of this many SNPs"
                         " (phenos are integer trait seeds; subsample mode"
                         " uses load_synthetic_gwas_subsample)")
    ap.add_argument("--ref-n", type=int, default=50_000,
                    help="full-cohort N for the synthetic power scaling"
                         " (the gold run is sample_size == ref_n)")
    ap.add_argument("--sample-ratio", type=float, default=1.0)
    ap.add_argument("--host-index", type=int, default=None)
    ap.add_argument("--num-hosts", type=int, default=None)
    ap.add_argument("--coordinator", default=None,
                    help="host:port of rank 0: join a process group of"
                         " --num-processes ranks as --process-id")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--mesh-data", type=int, default=None,
                    help="train each job over this many ranks on the"
                         " 'data' axis (under torchrun, or with"
                         " --coordinator)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions; gloo"
                         " between ranks)")
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    resolve_device("cpu" if args.cpu else None)

    backend = "gloo" if args.cpu else None
    if args.coordinator is not None:
        from ..parallel.mesh import init_distributed

        init_distributed(backend, f"tcp://{args.coordinator}",
                         args.num_processes, args.process_id)
    elif args.mesh_data and "RANK" in os.environ:
        from ..parallel.mesh import init_distributed

        init_distributed(backend)
    elif (not args.cpu and "LOCAL_RANK" in os.environ):
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))

    host_index, num_hosts = host_slot(args)
    os.makedirs(args.out_dir, exist_ok=True)
    jobs = job_list(args)
    # one process group trains each job: every rank walks the whole list
    together = args.coordinator is not None or bool(args.mesh_data)
    my_jobs = jobs if together else jobs[host_index::num_hosts]
    writer = not together or host_index == 0
    print(f"[sweep] host {host_index}/{num_hosts}: {len(my_jobs)} of "
          f"{len(jobs)} jobs")

    for job in my_jobs:
        tag = "_".join(str(x) for x in job)
        out_path = os.path.join(args.out_dir, tag + ".json")
        if os.path.exists(out_path):
            print(f"[sweep] {tag}: already done, skipping")
            continue
        result = run_job(job, args)
        if writer:
            with open(out_path, "w") as f:
                json.dump(result, f, indent=2)
        print(f"[sweep] {tag}: {result}")


if __name__ == "__main__":
    main()
