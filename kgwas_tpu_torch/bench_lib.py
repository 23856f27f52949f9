"""Benchmark: hetero message-passing training throughput on one card.

    python3 -m kgwas_tpu_torch.bench_lib

Counterpart of ``kgwas_tpu/bench_lib.py``, on the port's training step
(``engine/loop.train_step``: the full-graph GAT forward through the merged
GAT forward kernel, the backward through the merged GAT backward and CSC
segment-sum kernels, and Adam) with the model at the engine defaults (GAT,
sum aggregation, float32, TF32 off). It runs on a synthetic KG sized like
the fast-mode demo config and reports KG edge-traversals/sec/chip: each
real edge counts once per GNN layer per step.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "config": {...}}
and a comment line naming the device on stderr.

The KG, its padding and the labels are the JAX module's: 200,000 SNPs,
20,000 genes, 12,000 terms per GO type, degree 6, seed 0; edges padded to
a multiple of 8192 per relation (``config.edge_pad``; ``chip_smoke.py``
pads to 512), node rows to 512 (the JAX module's max(256, BN) with BN =
512, and the merged layout's tile); labels from ``default_rng(0)``,
weights of one, one fixed batch. Timing is a slope: n1 = steps // 4
steps, then n2 = steps steps, each series ending in one synchronise;
dt = (t2 - t1) / (n2 - n1) * steps, on CUDA events (on the CPU, which
only a test asks for, on ``perf_counter``).

BENCH_SCAN=S > 1 runs S steps a call through ``engine/loop.TrainScan``
(the JAX module's ``make_train_scan``): on the card one replay of a CUDA
graph of S captured steps, on the CPU S eager steps. Its batches are a
matrix ``rng.integers(0, n_snp, (S, B))`` drawn after the fixed batch from
the same generator; two untimed calls (the eager warm-up, then the
capture and its first replay), then n1 = max(steps // (4 S), 1) and n2 =
max(steps // S, n1 + 1) calls; steps = (n2 - n1) S and dt = t2 - t1, as
the JAX module times it. ``config.scan`` is S and ``config.step_ms`` is
per step.

Environment variables (the JAX module's): BENCH_N_SNP, BENCH_N_GENE,
BENCH_N_GO, BENCH_AVG_DEGREE, BENCH_HIDDEN, BENCH_LAYERS, BENCH_BATCH,
BENCH_STEPS, BENCH_HEADS (GAT heads, each a merged GAT launch per group
and layer), BENCH_DTYPE (the compute dtype, float32 or bfloat16) and
BENCH_STREAM_DTYPE (the stream dtype), both reported in the JSON line's
config, and BENCH_SCAN (above). The
TPU execution variables BENCH_PALLAS, BENCH_GATHER_CHUNK,
BENCH_BWD_WINDOW, BENCH_MM_PRECISION, BENCH_REL_FOLD and BENCH_NODE_PAD
are not read.

vs_baseline compares against a LABELED ESTIMATE of an A100 PyG reference
throughput, 2.0e7 edge-traversals/s for the same model (2-layer GAT,
hidden 128, 1 head), the JAX module's constant: the reference publishes
no numbers, and the estimate is deliberately generous to the baseline.
"""
import json
import os
import sys
import time
from typing import Optional

import numpy as np
import torch

# LABELED ESTIMATE for the A100/PyG reference (the reference publishes no
# numbers): the reference pipeline sustained ~2.4e6 edge-traversals/s on a
# CPU, scaled by ~8x for an A100 (the JAX module's constant)
REF_EDGE_TRAVERSALS_PER_SEC_A100 = 2.0e7
EDGE_PAD = 8192
NODE_PAD = 512


def _dtypes():
    """(compute dtype, stream dtype or None) from BENCH_DTYPE and
    BENCH_STREAM_DTYPE, as the JAX module reads them."""
    return (os.environ.get("BENCH_DTYPE", "float32"),
            os.environ.get("BENCH_STREAM_DTYPE") or None)


def _timer(device):
    """(mark, seconds between two marks) on CUDA events on the card, on
    the host clock on the CPU; a mark ends a series with one sync."""
    if device.type == "cuda":
        def mark():
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            ev.synchronize()
            return ev
        return mark, lambda a, b: a.elapsed_time(b) / 1e3
    return time.perf_counter, lambda a, b: b - a


def main(device: Optional[str] = None):
    from .config import ModelConfig
    from .engine.loop import TrainScan, train_step
    from .engine.optim import build_optimizer
    from .graph import build_merged_layouts, compile_graph, make_synthetic_kg
    from .kgwas import resolve_device
    from .models import HeteroGNN, device_layouts

    dtype, stream_dtype = _dtypes()
    scan_steps = int(os.environ.get("BENCH_SCAN", "0"))
    n_snp = int(os.environ.get("BENCH_N_SNP", 200_000))
    n_gene = int(os.environ.get("BENCH_N_GENE", 20_000))
    n_go = int(os.environ.get("BENCH_N_GO", 12_000))
    avg_degree = int(os.environ.get("BENCH_AVG_DEGREE", 6))
    hidden = int(os.environ.get("BENCH_HIDDEN", 128))
    layers = int(os.environ.get("BENCH_LAYERS", 2))
    batch = int(os.environ.get("BENCH_BATCH", 512))
    steps = int(os.environ.get("BENCH_STEPS", 20))
    heads = int(os.environ.get("BENCH_HEADS", 1))
    device = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False

    g = make_synthetic_kg(
        n_snp=n_snp,
        n_gene=n_gene,
        n_go=n_go,
        snp_dim=20,
        gene_dim=128,
        go_dim=128,
        avg_degree=avg_degree,
        seed=0,
    )
    cg = compile_graph(g, edge_pad_multiple=EDGE_PAD,
                       node_pad_multiple=NODE_PAD)
    cfg = ModelConfig(gnn_hidden_dim=hidden, gnn_num_layers=layers,
                      gat_num_head=heads, gnn_backbone="GAT",
                      compute_dtype=dtype, stream_dtype=stream_dtype)
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    model = HeteroGNN(cfg, rel_types, 20, 128, 128, seed=0).to(device)
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=NODE_PAD),
                             device, cg)
    x = {t: torch.from_numpy(v).to(device) for t, v in cg.node_x.items()}
    optimizer = build_optimizer(model.parameters(), 1e-4, 5e-4)

    n_pad = cg.padded_nodes["SNP"]
    rng = np.random.default_rng(0)
    y_node = torch.from_numpy(rng.random(n_pad, dtype=np.float32)).to(device)
    w_node = torch.ones(n_pad, dtype=torch.float32, device=device)
    batch_idx = torch.from_numpy(
        rng.integers(0, cg.num_nodes["SNP"], batch).astype(np.int64)
    ).to(device)

    def step():
        return train_step(model, optimizer, x, layouts, batch_idx, y_node,
                          w_node)

    mark, seconds = _timer(device)
    if scan_steps > 1:
        batch_mat = rng.integers(0, cg.num_nodes["SNP"], (scan_steps, batch))
        scan = TrainScan(model, optimizer, x, layouts, y_node, w_node,
                         scan_steps)
        for _ in range(2):   # eager warm-up; capture and first replay
            float(scan(batch_mat)[-1])

        def run_n(n):
            t0 = mark()
            for _ in range(n):
                out = scan(batch_mat)[-1]
            return seconds(t0, mark()), out

        n1 = max(steps // (4 * scan_steps), 1)
        n2 = max(steps // scan_steps, n1 + 1)
        t1, _ = run_n(n1)
        t2, loss = run_n(n2)
        steps = (n2 - n1) * scan_steps
        dt = t2 - t1
    else:
        loss = step()   # warm-up: the kernels' first launches, the allocator
        float(loss)

        # slope timing: n1 then n2 chained steps, each series ended by one
        # sync; the difference cancels the fixed dispatch and sync latency
        def run_n(n):
            t0 = mark()
            for _ in range(n):
                out = step()
            return seconds(t0, mark()), out

        n1 = max(steps // 4, 1)
        n2 = steps
        t1, _ = run_n(n1)
        t2, loss = run_n(n2)
        dt = (t2 - t1) / (n2 - n1) * steps  # normalized to `steps` steps

    real_edges = cg.total_real_edges()
    value = real_edges * layers * steps / dt
    print(json.dumps({
        "metric": "kg_edge_traversals_per_sec_per_chip",
        "value": round(value, 1),
        "unit": "edge_traversals/s",
        "vs_baseline": round(value / REF_EDGE_TRAVERSALS_PER_SEC_A100, 3),
        "config": {
            "node_pad": NODE_PAD,
            "edge_pad": EDGE_PAD,
            "n_snp": n_snp,
            "edges": real_edges,
            "layers": layers,
            "dtype": (dtype if stream_dtype is None
                      else f"{dtype},stream={stream_dtype}"),
            "scan": scan_steps,
            "step_ms": round(dt / steps * 1e3, 2),
        },
    }), flush=True)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"# device={name} edges={real_edges} layers={layers} "
          f"steps={steps} step_time={dt / steps * 1e3:.1f}ms dtype={dtype} "
          f"loss={float(loss):.4f}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
