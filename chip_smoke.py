"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving and training paths (kgwas_tpu_torch) end to end
on the card and holds every CUDA kernel of those paths against its plain
PyTorch version:

  1. card and kernel: nvidia-smi name and power limit, build the kernels
     from ops/csrc with nvcc (build/kernels/); what ptxas did (registers,
     shared memory, spills) and the resident warps per SM it allows;
     (b) the gather ceiling: gather_probe.cu reads random 512-byte rows in
     the order of the full-width layouts' index streams (and shuffled),
     from a table that L2 holds and from one it does not, at 1-16 rows in
     flight a warp, and each layer kernel's gather floor (its gathered
     rows over that rate); the same on 256-byte bf16 rows, and the bf16
     instances' gather floors
  2. the merged GAT forward and backward kernels vs plain on a 20k-SNP
     synthetic KG, every merged group, the softmax/sigmoid/raw modes, fold
     off and on, on the default schedule and with max_edges 8 (real rows
     cut into chunks), and on a stream with a hub node of thousands of
     edges per slot; two runs bitwise equal
  3. the serving slice at full width: the 200k-SNP synthetic KG (20k
     genes, 12k GO terms per GO type, degree 6), hidden 128, 2 layers,
     random weights from seed 0 -> save_model -> load_pretrained ->
     predict_all (the kernel must launch once per group and layer that
     reaches the head) -> the same forward through the plain layer op ->
     finalize_predictions
  4. timing with CUDA events: predict_all, and every kernel launch of one
     forward against its plain version and its bound, without the trash
     rows' pad edges, and with other max_edges (schedules built before the
     timing)
  5. the training slice on the same KG: prepare_split, batch 512, lr 1e-4;
     (a) every backward launch of one step (merged_gat_bwd and
     csc_segment_sum) against the plain versions, two runs bitwise equal;
     (b) three steps through the kernels against three through the plain
     layer op; (d) train step ms, training edge-traversals/s, each
     backward kernel's ms per step against its bound, its plain version
     and, for the CSC sum, index_add_; (c) KGWAS.train(epoch=1), which
     must launch every kernel per step, ending in KGWAS_P in [0, 1]
  6. the model variants: (a) on the 20k-SNP KG, the per-relation GAT
     kernels (segment_softmax_spmm_fwd / _bwd) on every relation's stream,
     the CSR segment sum (with and without weights) and the CSC sum without
     logit term on every merged group, the backward and the CSR sum also on
     schedules with max_edges 8 and on a stream with a hub row of 3001
     edges and empty rows, against their plain versions, two runs bitwise
     equal; (b) GAT with max and min aggregation, SAGE, GCN and
     SGC at full width on the 200k-SNP KG: predict_all through the kernels
     against the plain ops, KGWAS_P (GAT-max, GCN), KGWAS.train over three
     steps (counts zeroed just before each entry point: per forward and
     per step one launch per relation of each group that reaches the head
     for GAT-max/min, 10; one CSR sum per such group and one CSC sum in the
     backward for the others, 3 for SAGE and 2 for GCN and SGC, which read
     no destination row) against three steps through the plain ops; (c)
     forward ms, train step ms with a profiler split of each, and each
     new kernel's ms against its bound, its plain version and, for the
     CSR sum, torch.sparse.mm

  7. interpretation: KGWAS.get_disease_critical_network on phase 5's
     trained model and KGWAS_P table (the default variant_threshold 5e-8
     where it leaves 100-2000 hit SNPs, else the P below which 1000 lie),
     then on a GAT-max model of the 20k-SNP KG: the merged GAT forward in
     its raw mode (fold R, then fold 0) must launch once per group and
     layer (10), each launch held against its plain version, α (layer 1
     bitwise, layer 2 at rtol/atol) and the three tables against a run
     with the plain version on the same card (equal rows up to counted
     near-ties; an importance, a z score of a weight, within what a
     weight within rtol/atol moves it); each stage's host seconds
  8. the bench entry (python3 -m kgwas_tpu_torch.bench_lib at its
     defaults, edges padded to 8192; its JSON line printed) beside phase
     5d's train step, then KGWAS.train(epoch=1) over three batches with
     profile_dir and metrics_log: the trace parses and names the three
     kernels of the step, the log holds one record with the JAX package's
     keys; the device idle share of the traced window

  9. the real-data path at full width through the CLI: a bundle in the
     real one's layout (every REQUIRED_FILES entry; the 200k-SNP KG's raw
     relations, enformer rows 20 wide for 99% of the SNPs, esm rows 5120
     wide for 90% of the genes, LD scores for 98% of the SNPs) and a
     fastGWA file (98% of the KG's SNPs and 10,000 outside it), written
     under build/chip_smoke/real/; then kgwas_tpu_torch.cli train (one
     epoch: merged_gat_fwd, merged_gat_bwd and csc_segment_sum counted
     from 0 just before), predict (bitwise the trained run's predict_all)
     and interpret --variant-threshold 5e-8 (a non-empty network CSV);
     each stage's host seconds, and the train step with Gene rows 5120
     wide beside phase 5d's 128, with the device idle share of each

 10. the JAX package's other model options at full width (after phase 8,
     on the same data): GAT sum with 4 heads, GAT max with 2, sigmoid GAT
     max, SAGE max, GCN min, GAT sum with remat, with dropout 0.1 and with
     edge_dim 4 and pheno_condition 'ATT': the launches of every layer
     kernel per forward and per step (counts set to 0 just before
     predict_all and KGWAS.train), predict_all and three steps against the
     plain ops, two kernel runs bitwise equal, forward and step ms with the
     device's busy share; dropout: KGWAS.train's losses are the dropout-0
     run's (no generator), a step with a dropout generator runs #6 / #7
     with the multiplier against the plain ops on the same mask; remat:
     one step's gradients bitwise those without, and the peak memory of
     each; edge_dim: predict_all equal to the merged path's at the same
     weights; the new forms of #6 / #7 (multiplier) and #8 (d_w): ms,
     device ms, bound, gather floor, plain version, and the same launches
     without the flag

 11. long runs, host-streamed features and the cohort builder: (a) at
     full width, KGWAS.train(max_restarts=1) over 2 epochs of 120 batches
     (352 before PR 13) clean and with a transient fault injected in
     epoch 2 (one restart; final and best parameters bitwise the clean
     run's), the snapshot's host time per epoch and the time to recover;
     (b) checkpoint_every=100 over an epoch of 220 batches (352 before PR
     13) beside the same epoch without saves (each step's host time, with
     and without a save after it), the saved state and the state
     resume=True restores bitwise the run's at step 200; (c) a device-side assert in a child
     process, classified fatal, and the next CUDA call failing too; (d)
     the stall watchdog with the first attempt wedged: python -m
     kgwas_tpu_torch.cli train --watchdog-timeout on --synthetic, and
     KGWAS.train(checkpoint_every, resume=True) on a KG that size under
     run_with_watchdog (exactly one relaunch each, the second resuming
     from the newest step_N; the two side by side since PR 13), both
     recovery times; (e) Gene rows 57,742
     wide (4.62 GB of host table): three train steps in device memory and
     streamed from the host from the same initial state, step ms, bytes to
     the device and the rate beside a pinned copy, the host gather time,
     then KGWAS.train and predict_all streamed; (f) the UK Biobank cohort
     builder on 120,000 fabricated participants (UKBB; cut from 502,000
     to pay for phases 12's relation runs and 14), host seconds by stage.
     Launches of merged_gat_fwd, merged_gat_bwd and csc_segment_sum are
     counted from 0 just before each entry point and checked

 12. the bf16 dtypes at full width (after phase 10): (a) the bf16
     instances of #1, #2, #8 (with the logit term) and #10 against their
     plain bf16 versions on random bf16 tables of the GAT-sum layer's
     Gene and SNP groups (at most 1e-3 of the rows, or 1e-4 of d_xs's
     values, off the f32 tolerances, each within a bf16 rounding of its
     neighbour), bitwise repeatable, with ms, device ms, plain ms, bound
     (2-byte rows), bf16 gather floor, the f32 instance on the same
     values and, for #10, torch.sparse.mm in bf16 where the card's
     PyTorch takes it; (b)-(d) GAT sum under stream_dtype and
     compute_dtype (beside the f32 GAT sum's forward and step ms; its
     checks are phase 5's), and GCN, SAGE and sigmoid GAT max under
     compute_dtype:
     predict_all and KGWAS.train over three batches with every layer
     kernel counted from 0 just before (the bf16 instances where the
     table is bf16), against the plain ops, two kernel runs bitwise,
     forward and step ms with the device's busy share; the per-relation
     softmax GAT (GAT max, GAT min, GAT sum with edge_dim 4) under
     stream_dtype and compute_dtype the same way (no profile: forward and
     step ms beside phase 6c's float32 GAT max / min), and every launch of
     #6 / #7 on a bf16 table in one forward and one step held against its
     plain version (the float64 rule) and bitwise the float32 instance on
     the widened operands; GAT max's launches timed (ms, device ms, plain
     ms, bound at 2-byte rows, #7's with the saved out on its chunked rows
     only, bf16 gather floor, the float32 instance on the widened values);
     every #10 bf16 launch of the GCN and SAGE runs' forward and step run
     twice (the same bits) and held against its plain version. The kernel
     table's epoch_launches are a full-width epoch's step count times one
     train_step's bf16 launches (each of the three steps counted). The
     runs of a phase on the full-width graph share one device state per
     layer path (shared_state)
 13. the bf16 quality gate (scripts/exp_stream_gate.py's KG and model):
     f32, stream_dtype, compute_dtype and f32 with TF32 matmuls trained
     30 epochs; KGWAS_P's Spearman and top-50 overlap against f32 (a
     finding: only a crash or a non-finite KGWAS_P fails the phase)
 14. multi-device training (kgwas_tpu_torch/parallel) on the one card:
     (a) KGWAS.train(mesh=1) at full width in a one-rank NCCL process
     group for GAT sum (merged), GAT max (per relation), SAGE sum ('mp')
     and GAT max under stream_dtype (launches counted from 0 just before,
     losses against the same steps on the device alone), the all-gather and
     reduce-scatter ms at world size 1, a train step over the mesh beside
     one on the device alone; (b) the blocks of 2, 3 and 4 ranks in this
     process: every relation stream of the Gene and SNP groups through #6,
     #7 and #8 (f32, and bf16: #6 / #7 bitwise the f32 instance on the
     widened values), the 'mp' Gene and SNP streams through #10 and #8,
     the merged Gene and SNP groups through #1, #2 and #8; the ranks' rows
     and summed gradients against the unsharded kernels, each kernel
     launched once a rank. Two ranks over NCCL need two cards: not run
     here
 15. scanned dispatch (KGWAS.train(scan_steps=8): each full block of 8
     steps one replay of a CUDA graph of 8 captured steps,
     engine/loop.TrainScan): (a) full-width GAT sum over 3 blocks and a
     3-step tail, scanned and with scan_steps=0 from one initial state
     (losses, parameters and Adam's state bitwise; launches counted from 0
     just before each run: the eager first block, the capture, the tail;
     one captured block's launches), the step's ms both ways (slope on
     CUDA events) with each one's device idle share, the eager step's
     peak memory beside the capture's and the graph pool's; (b) one
     replayed block of GAT max, GCN, compute_dtype bf16, param_dtype bf16
     (Bf16Adam) and remat, bitwise the same steps eager, with step ms;
     (c) bench_lib with BENCH_SCAN=8 (its JSON line printed) beside phase
     8's BENCH_SCAN=0; (d) KGWAS.train(max_restarts=1, scan_steps=8) on
     the 20k-SNP KG over 2 epochs, clean and with a transient fault in
     epoch 2: bitwise the clean run. The other phases that count launches
     from KGWAS.train pass scan_steps=0; phase 9's CLI trains scanned and
     its count is the eager steps' and the capture's
 16. the full knowledge graph (after phase 11f, the earlier phases' device
     state freed): scripts/exp_fullkg.py's 2,000,000 SNPs (200,000 genes,
     117,647 terms per GO type, degree 6; 33,588,130 real edges), GAT sum
     at hidden 128, 2 layers, float32: (a) each host step's seconds, and
     compile and the merged layouts through the native ops
     (kgwas_tpu_torch/native) and through their numpy versions, bitwise
     equal; (b) predict_all (#1 counted from 0: once per live group and
     layer) against the same forward through the plain ops, forward ms and
     edge-traversals/s; (c) three train_steps with exact launches, the
     eager step's ms (slope) and peak memory with a profile, a captured
     block's scanned step ms and graph pool, then KGWAS.train(epoch=1) over
     19 batches at its defaults (its launches, KGWAS_P in [0, 1], the
     pred.csv's host seconds) and the epoch these imply; (d) the
     dst-range sub-layouts under KGWAS_MERGED_MAX_EDGES=
     "Gene:10000000,SNP:4000000" (Gene 2, SNP 4): predict_all against
     (b)'s, three train_steps against (c)'s, the launches per sub-layout,
     peak memory, forward and step ms beside the unsplit run's, the split's
     host seconds
 17. the experiment scripts (kgwas_tpu_torch/scripts, kgwas_tpu_torch/
     demo), last: (a) the calibration protocol through run_calibration's
     own functions on its 50,000-SNP KG (5,000 genes, 2,941 terms per GO
     type, seed 0), GAT sum at hidden 128, 2 layers, batch 512, 10
     epochs, float32: 2 null seeds and 1 causal seed into a fresh
     directory, each with #1, #2 and #8 counted from 0 just before it
     (the epochs' steps under scan_steps=8 and the forwards they imply);
     every JSON holds the JAX runner's keys, its GWAS side equals a
     recount from the seed's sumstats draw alone, its pred.csv's KGWAS_P
     is finite in [0, 1]; a second call on the directory trains and
     writes nothing; summarize_calibration on it; null seed 1's path
     against the plain ops at its shapes (its draw, the protocol's model
     with no_relu): predict_all, and CMP_STEPS train_steps from one state
     through the kernels and through the plain ops; each seed's host split,
     seeds per hour, and the null seeds' KGWAS loci beside their GWAS loci
     (a finding). (b) run_sweep.main in subsample mode on the 50,000-SNP
     synthetic KG, trait 1 at sample sizes 12,500 and 50,000, seed 1, 2
     epochs of the default 10 (the cut), then summarize_subsample, with
     the same checks of the keys and the GWAS side; (c)
     demo.kgwas_101.main(["--synthetic", ...]) to its checkpoint reload,
     the reloaded model serving the trained one's predictions bitwise

  Every phase's seconds are logged, and their list before the kernel
  table, with the script's wall time. From phase 6b-c to phase 11e,
  KGWAS.train writes only pred.csv's header (pred_csv_header_only): those
  phases check kernels and layer paths, and phases 5, 9, 16 and 17 write
  and check the whole file. Phase 4 times one other max_edges (SWEEP_MAX_EDGES) beside the
  default.

  Phase 5 also writes its KGWAS_P table with write_table and with the row
  writer it replaced, and checks that the bytes are equal.

  Phases 5d (GAT sum) and 6c (GAT-max, SAGE, GCN) also time the segment
  kernels launch by launch (segment_launches: the CSC sum in each;
  segment_softmax_spmm_fwd and _bwd on GAT-max; csr_segment_sum on SAGE
  and GCN): each as it runs, without its trash rows' pad edges, on
  schedules with other max_edges, the CSC sum with w and dz dropped (its
  gather alone), and the CSR sum beside gather_probe.cu on its own index
  stream.

Kernel ms is host-paced: the launches issued one by one from Python with
CUDA events around them, so a wrapper's host time counts where it is
longer than its launch; device ms beside it replays the same launches from
a CUDA graph.

With KGWAS_PARENT_CSRC set to an earlier checkout's
kgwas_tpu_torch/ops/csrc, phases 1, 4, 5d and 6c also build that
checkout's kernels and time them on the same launches: its merged GAT
kernels (this checkout's C interface), and its segment kernels through its
own wrappers; 5d (GAT sum) and 6c (GAT-max, SAGE) also time the train
step, and 6c (SAGE, GCN) the forward, with its segment kernels in place
of this checkout's, alternating; phase 12 holds every bf16 kernel's
launches bit for bit against that checkout's and times them in turns.

Prints the bench's JSON lines (phases 8 and 15c) on earlier lines, and at the end
the kernel table as one JSON line, then the card's name and power limit,
then the result line. Exits non-zero, printing no
result, without a CUDA device or without the package beside this file.
"""
import contextlib
import copy
import dataclasses
import functools
import importlib
import importlib.util
import inspect
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
SEED = 0
FULL_KG = dict(n_snp=200_000, n_gene=20_000, n_go=12_000, snp_dim=20,
               gene_dim=128, go_dim=128, avg_degree=6)
SMALL_KG = dict(n_snp=20_000, n_gene=2_000, n_go=1_200, snp_dim=20,
                gene_dim=128, go_dim=128, avg_degree=6)
HIDDEN, LAYERS = 128, 2
DEVICE = "cuda"
# kernel vs plain, float32 with another summation order: real rows at
# rtol/atol; each relation's trash row sums up to 511 pad edges, at TRASH_RTOL
RTOL, ATOL, TRASH_RTOL = 1e-5, 1e-5, 1e-4
# predict_all through the kernel vs through the plain op: two layers and a
# head of float32 sums in another order
PRED_RTOL, PRED_ATOL = 1e-4, 1e-5
# backward kernels vs their plain versions, both against the plain version
# evaluated in float64: the kernel's max abs error may be at most
# GRAD_ERR_RATIO times the float32 plain version's plus GRAD_FLOOR of the
# largest value. Unit-free, because some gradients cancel to float noise:
# a_dst shifts every logit of a softmax row alike, so d_a_dst and the sums
# of dz_e are differences of nearly equal terms (about 1e-13 against terms
# near 1e-7 in the last layer), and no tolerance fixed in advance fits them
GRAD_ERR_RATIO, GRAD_FLOOR = 8.0, 1e-6
# training: batch 512, lr 1e-4 (the engine defaults); three steps through the
# kernels against three through the plain layer op. Adam moves a parameter
# by about lr whatever its gradient's size, so a gradient near 0 whose sign
# differs in the last bits can move it by up to 2 lr per step
BATCH, LR, CMP_STEPS = 512, 1e-4, 3
# max_edges of the merged GAT schedule timed beside the default (phase 4)
SWEEP_MAX_EDGES = (256,)
LOSS_RTOL, PARAM_ATOL = 1e-4, 2 * LR * CMP_STEPS
# published H100 SXM peaks (dense): HBM bytes/s and f32 FLOP/s outside the
# tensor cores
HBM_BPS, F32_FLOPS = 3.35e12, 67e12


def log(msg):
    print(msg, flush=True)


# Hopper's limits per SM (H100): 64 warps, 32 blocks, 64K registers
# allocated per warp in units of 256, 228 KB of shared memory with 1 KB
# reserved per block
SM_WARPS, SM_BLOCKS, SM_REGS, SM_SMEM = 64, 32, 65536, 233472


def warps_per_sm(regs, threads, smem):
    """Resident warps per SM of a kernel using regs registers a thread,
    threads a block and smem bytes of shared memory a block."""
    warps = threads // 32
    per_warp = -(-regs * 32 // 256) * 256
    blocks = min((SM_REGS // per_warp) // warps, SM_BLOCKS, SM_WARPS // warps)
    if smem:
        blocks = min(blocks, SM_SMEM // (smem + 1024))
    return blocks * warps


# block size and dynamic shared memory at D = 128 of the scheduled kernels'
# entry functions (the merged GAT kernels: csrc/gat_items.cuh
# warp_smem_floats, 4 warps, a ring of 2 x 8 rows, the staging arrays, the
# backward's 8 cotangent rows and per-edge z and m; the segment kernels
# stage in static shared memory), and of the gather probe
KERNEL_LAUNCH = {
    "merged_gat_fwd_kernel": (128, 4 * 4 * (16 * 128 + 704)),
    "merged_gat_combine_kernel": (128, 0),
    "merged_gat_bwd_kernel": (128, 4 * 4 * (24 * 128 + 960)),
    "merged_gat_bwd_combine_kernel": (128, 0),
    "segment_softmax_spmm_fwd_kernel": (256, 0),
    "segment_softmax_combine_kernel": (256, 0),
    "segment_softmax_spmm_bwd_kernel": (256, 0),
    "csc_items_kernel": (256, 0),
    "csc_combine_kernel": (256, 0),
    "group_sum_kernel": (256, 0),
    "slot_sum_kernel": (256, 0),
    "csr_segment_sum_kernel": (256, 0),
    "csr_combine_kernel": (256, 0),
    "gather_probe_kernel": (256, 0),
    "gather_probe_bf16_kernel": (256, 0),
    # the bf16 instances: a ring of 2 stages of 8 256-byte rows,
    # the staging arrays (merged_gat_fwd.cu fwd_bf16_words, merged_gat_bwd.cu
    # bwd_bf16_words: the backward's 8 cotangent rows too), the score pass
    "merged_gat_fwd_bf16_kernel": (128, 4 * 4 * (2 * 8 * 64 + 1248)),
    "merged_gat_chunk_max_bf16_kernel": (128, 0),
    "merged_gat_a_src_kernel": (128, 0),
    "merged_gat_bwd_bf16_kernel": (128, 4 * 4 * (8 * 128 + 2 * 8 * 64
                                                  + 1216)),
    "merged_gat_bwd_combine_bf16_kernel": (128, 0),
    # #6 bf16: a ring of 3 stages of 8 256-byte rows and the item's
    # arrays for items of 128 edges (the relation schedules':
    # segment_softmax_spmm_fwd.cu bf16_warp_words); #8 bf16's are static
    "segment_softmax_spmm_fwd_bf16_kernel": (128, 4 * 4 * (3 * 8 * 64
                                                          + 320)),
    "csc_items_bf16_kernel": (128, 0),
    # #7 and #10 bf16: a ring of 2 stages of 8 256-byte rows and their
    # items' arrays (the relation schedules' 128 edges, without the
    # multiplier: src, p, m, each row's lse and dot_r, the keys; the CSR
    # schedule's 128, the unweighted sum: src), segment_softmax_spmm_bwd.cu
    # and csr_segment_sum.cu bf16_warp_words
    "segment_softmax_spmm_bwd_bf16_kernel": (128, 4 * 4 * (2 * 8 * 64
                                                          + 480)),
    "csr_segment_sum_bf16_kernel": (128, 4 * 4 * (2 * 8 * 64 + 128)),
}
# template arguments of the entries reported: D = 128 (softmax mode, with
# and without the logit term, the segment kernels' multiplier and d_w, the
# bf16 instances), and
# the probe's rows in flight
D128 = ("<0, true, 1>", "<0>", "<true, 1>", "<true, 1, true>",
        "<true, 1, false>", "<true, 1, true, false>",
        "<true, 1, false, false>", "<true, 1, false, true>", "<8>", "<16>",
        "<0, true, 1, 0>", "<0, true, 1, 1>", "<true, 1, true, false, false>",
        "<true, 1, false, false, false>", "<true, 1, false, true, false>",
        "<true, 1, true, false, true>", "<true, 1, false, false, true>",
        "<true, 1, false, true, true>", "<true, 1, true, true, true>",
        "<true, 1, true, true, false>", "<true, 1, true, true>",
        "<0, true, 1, 2>")


def report_ptxas(build, name, text, launch=None):
    """Logs what ptxas did for one library: the most registers and spills
    over its entry functions, and for the entries at D = 128 (D128, and the
    D-free ones) registers, shared memory, spills and, given launch
    {entry: (threads, dynamic smem)}, the resident warps per SM."""
    entries = build.ptxas_entries(text)
    if not entries:
        log(f"  {name}: no ptxas output")
        return
    top = max(entries, key=lambda e: e[1])
    log(f"  {name}: {len(entries)} entry functions; most registers {top[1]} "
        f"({top[0]}); most local bytes (stack frame and spills) "
        f"{max(e[3] for e in entries)}")
    for kern, regs, smem, spill in entries:
        if "<" in kern and not kern.endswith(D128):
            continue
        occ = ""
        base = kern.split("<")[0].replace("void ", "")
        if launch and base in launch:
            threads, dyn = launch[base]
            w = warps_per_sm(regs, threads, smem + dyn)
            occ = (f", {threads} threads and {smem + dyn} B smem a block: "
                   f"{w} warps per SM ({w / SM_WARPS:.0%} occupancy)")
        log(f"    {kern}: {regs} registers, {smem} B static smem, {spill} B "
            f"stack and spills{occ}")


class ParentKernels:
    """The kernels of an earlier checkout (KGWAS_PARENT_CSRC: its
    kgwas_tpu_torch/ops/csrc), built from its sources, for timing beside
    this checkout's on the same launches. The merged GAT kernels' f32
    instances have this checkout's C interface and run through its
    wrappers with the earlier library swapped in (fwd, bwd take the
    wrappers' arguments and sched); their bf16 instances run through the
    earlier wrappers (fwd_bf16, bwd_bf16; has_bf16 False where the earlier
    checkout has none).
    The segment kernels (SEGMENT) run through the earlier checkout's own
    wrappers (its package imported as parent_kgwas_tpu_torch, its kernels
    built by its own ops/build.py), so their host-paced times carry that
    checkout's wrapper cost; seg_fwd, seg_bwd, csc and csr take this
    checkout's wrapper arguments, and pass sched on where the earlier
    wrapper takes one; seg_fwd_bf16, seg_bwd_bf16, csc_bf16 and csr_bf16
    pass every argument on (the earlier wrappers launch their bf16
    instances on a bf16 table)."""

    SEGMENT = ("segment_softmax_spmm_fwd", "segment_softmax_spmm_bwd",
               "csc_segment_sum", "csr_segment_sum")

    def __init__(self, build, csrc):
        self.build = build
        self.csrc = Path(csrc)
        self.libs = {
            name: build.build_source(self.csrc / build.KERNELS[name][0],
                                     f"parent_{name}", build.KERNELS[name][1],
                                     build.KERNELS[name][2])
            for name in ("merged_gat_fwd", "merged_gat_bwd")}
        pkg = import_parent(self.csrc.parents[2])
        self.pbuild = importlib.import_module(f"{pkg}.ops.build")
        self.psegment = importlib.import_module(f"{pkg}.ops.segment")
        self.psoftmax = importlib.import_module(f"{pkg}.ops.segment_softmax")
        self.pgat = importlib.import_module(f"{pkg}.ops.gat_layer")
        self.pbuild.build_all(self.SEGMENT)
        # its bf16 merged GAT instances (phase 12a), from the libraries
        # built above, through its own wrappers (its C interface)
        self.has_bf16 = True
        logs = dict(build.build_log)
        for name in ("merged_gat_fwd", "merged_gat_bwd"):
            entry = self.pbuild.KERNELS.get(f"{name}_bf16")
            if entry is None:
                self.has_bf16 = False
                continue
            self.pbuild._loaded[f"{name}_bf16"] = build.build_source(
                self.csrc / entry[0], f"parent_{name}", entry[1], entry[2])
        # its score pass, in its forward's library
        entry = self.pbuild.KERNELS["merged_gat_a_src_bf16"]
        self.pbuild._loaded["merged_gat_a_src_bf16"] = build.build_source(
            self.csrc / entry[0], "parent_merged_gat_fwd", entry[1], entry[2])
        build.build_log.update(logs)

    def build_logs(self):
        """{name: build record} of the earlier segment kernels."""
        return {f"parent_{k}": v for k, v in self.pbuild.build_log.items()
                if k in self.SEGMENT}

    def _swapped(self, name, fn, *args, **kwargs):
        old = self.build._loaded.get(name)
        self.build._loaded[name] = self.libs[name]
        try:
            return fn(*args, **kwargs)
        finally:
            self.build._loaded[name] = old

    def fwd(self, *args, **kwargs):
        from kgwas_tpu_torch.ops import gat_layer
        return self._swapped("merged_gat_fwd", gat_layer.merged_gat_forward,
                             *args, **kwargs)

    def bwd(self, *args, **kwargs):
        from kgwas_tpu_torch.ops import gat_layer
        return self._swapped("merged_gat_bwd", gat_layer.merged_gat_bwd,
                             *args, **kwargs)

    def a_src_bf16(self, xs, att, src_base):
        """The earlier score pass's a_src."""
        return self.pgat.merged_gat_a_src(xs, att, src_base)

    def fwd_bf16(self, xs, *args, sched=None, src_base=None):
        """The earlier bf16 forward (#1 bf16) through the earlier wrapper,
        after its score pass over src_base (args[2] is att)."""
        return self.pgat.merged_gat_forward(
            xs, *args, sched=sched,
            a_src=self.a_src_bf16(xs, args[2], src_base))

    def bwd_bf16(self, *args, sched=None, a_src=None):
        """The earlier bf16 edge backward (#2 bf16), the same way, on the
        earlier pass's scores a_src."""
        return self.pgat.merged_gat_bwd(*args, sched=sched, a_src=a_src)

    def seg_fwd_bf16(self, *args, **kwargs):
        """The earlier #6 bf16 (a bf16 table) through the earlier wrapper,
        with this checkout's wrapper arguments."""
        return self.psoftmax.segment_softmax_spmm_fwd(*args, **kwargs)

    def seg_bwd_bf16(self, *args, **kwargs):
        """The earlier #7 bf16 (a bf16 table) the same way."""
        return self.psoftmax.segment_softmax_spmm_bwd(*args, **kwargs)

    def csc_bf16(self, *args, **kwargs):
        """The earlier #8 bf16 (a bf16 table) the same way."""
        return self.psegment.csc_segment_sum(*args, **kwargs)

    def csr_bf16(self, *args, **kwargs):
        """The earlier #10 bf16 (a bf16 table) the same way."""
        return self.psegment.csr_segment_sum(*args, **kwargs)

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def _takes_sched(fn):
        return "sched" in inspect.signature(fn).parameters

    def _call(self, fn, args, sched):
        """fn(*args), with sched when fn takes one."""
        if sched is not None and self._takes_sched(fn):
            return fn(*args, sched=sched)
        return fn(*args)

    @staticmethod
    def _without(**flags):
        """The earlier kernels have no multiplier and no d_w: raises for a
        launch that asks for either."""
        if flags.get("mult") is not None or flags.get("edge_grad"):
            raise ValueError("the earlier kernels take no multiplier and "
                             "give no d_w")

    def seg_fwd(self, xs, src, logits, ro, sched=None, mult=None):
        self._without(mult=mult)
        return self._call(self.psoftmax.segment_softmax_spmm_fwd,
                          (xs, src, logits, ro), sched)

    def seg_bwd(self, *args, sched=None, mult=None):
        self._without(mult=mult)
        return self._call(self.psoftmax.segment_softmax_spmm_bwd, args[:8],
                          sched)

    def csc(self, g, w, dz, xs, att, layout, fold=0, edge_grad=False):
        self._without(edge_grad=edge_grad)
        return self.psegment.csc_segment_sum(g, w, dz, xs, att, layout, fold)

    def csr(self, x, src, ro, w=None, sched=None):
        return self._call(self.psegment.csr_segment_sum, (x, src, ro, w),
                          sched)

    def model_kernels(self):
        """A context in which the model's layer ops run the earlier segment
        kernels (#6, #7, #8, #10) through the earlier wrappers."""
        from kgwas_tpu_torch.ops import segment, segment_softmax
        stack = contextlib.ExitStack()
        stack.enter_context(swapped(segment, csc_segment_sum=self.csc,
                                    csr_segment_sum=self.csr))
        stack.enter_context(swapped(segment_softmax,
                                    segment_softmax_spmm_fwd=self.seg_fwd,
                                    segment_softmax_spmm_bwd=self.seg_bwd))
        return stack


def import_parent(root):
    """The package kgwas_tpu_torch of the checkout at root, imported under
    the name parent_kgwas_tpu_torch (its modules import each other
    relatively). Returns that name."""
    name = "parent_kgwas_tpu_torch"
    if name not in sys.modules:
        pkg = Path(root) / "kgwas_tpu_torch"
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return name


def parent_kernels(build):
    """ParentKernels of KGWAS_PARENT_CSRC, or None when it is not set."""
    csrc = os.environ.get("KGWAS_PARENT_CSRC")
    return ParentKernels(build, csrc) if csrc else None


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean ms of fn over reps runs, timed with CUDA events after one
    warm-up run."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def host_ms(fn, reps):
    """Mean host ms to issue fn, over reps runs issued with no
    synchronisation between them, after one warm-up run: where it exceeds
    the device time, the host paces the launches (cuda_ms)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / reps


def fmt_ms(values):
    """Times in ms, each to 4 places, joined by '/'."""
    return "/".join(f"{v:.4f}" for v in values) or "none"


def graph_ms(fn, reps):
    """Mean device ms of fn over reps calls captured in one CUDA graph and
    replayed, timed with CUDA events: the launches run back to back, with
    no host time between them (a kernel wrapper's Python checks and
    allocations can take longer than a short launch). After one warm-up
    call on a side stream, as graph capture asks."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / reps


def trash_mask(n_rows, n_per_rel, n_real):
    mask = np.zeros(n_rows, dtype=bool)
    mask[n_real::n_per_rel] = True
    return mask


def row_rtol(mask, like):
    """Each row's rtol, float64 on like's device: TRASH_RTOL on the rows
    mask (a host array) marks, RTOL elsewhere."""
    rtol = torch.full((len(mask),), RTOL, dtype=torch.float64,
                      device=like.device)
    rtol[torch.from_numpy(np.asarray(mask, dtype=bool)).to(like.device)] = (
        TRASH_RTOL)
    return rtol


def compare(got, want, mask, what):
    """(max abs err, max rel err); raises over the stated tolerance. mask
    marks the trash rows. In float64 on the tensors' device (the host's
    numpy took most of a check's time at full width)."""
    g, w = got.detach().double(), want.detach().double()
    err = (g - w).abs()
    rtol = row_rtol(mask, w)
    if err.dim() > 1:
        rtol = rtol[:, None]
    bad = err > ATOL + rtol * w.abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{what}: {int(bad.sum())} values over tolerance, max abs err "
            f"{float(err.max()):.3e}")
    if not err.numel():
        return 0.0, 0.0
    return (float(err.max()),
            float((err / w.abs().clamp_min(1e-30)).max()))


def layer_bound(xs_all, src, row_offsets, att, a_dst, out):
    """(bytes ms, operations ms) of one launch: each input read once and
    each output written once, and 4*D flops per edge (dot product and
    weighted sum), at the card's published peaks."""
    n_rows = row_offsets.numel() - 1
    words = (xs_all.numel() + src.numel() + row_offsets.numel() + att.numel()
             + a_dst.numel() + out.numel() + 2 * n_rows)
    edges = int(row_offsets[-1])
    return (4 * words / HBM_BPS * 1e3,
            4 * xs_all.shape[1] * edges / F32_FLOPS * 1e3)


def phase_kernel_vs_plain(device, gat_layer, kgwas_pkg, tmp):
    """Phase 2: the merged GAT kernels against their plain versions on the
    20k-SNP KG and on a stream with a hub node. Returns the worst abs errors
    of the forward and the backward."""
    from kgwas_tpu_torch.graph import build_merged_layouts

    data = kgwas_pkg.KGWAS_Data.from_synthetic(
        seed=SEED + 1, data_path=str(tmp / "small"), **SMALL_KG)
    cg = data.compile()
    layouts = build_merged_layouts(cg, tile_rows=512)
    rng = np.random.default_rng(SEED)
    worst = worst_bwd = 0.0
    cases = 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    for dst_t, L in layouts.items():
        R = len(L.rel_keys)
        xs = t((rng.standard_normal((L.n_src_total, HIDDEN)) * 0.1
                ).astype(np.float32))
        att = t((rng.standard_normal((R, HIDDEN)) * 0.2).astype(np.float32))
        a_dst = t((rng.standard_normal(L.n_rows_total) * 0.5
                   ).astype(np.float32))
        src, ro = t(L.src), t(L.row_offsets)
        g_rows = t(rng.standard_normal((L.n_rows_total, HIDDEN)).astype(
            np.float32))
        n_real = cg.num_nodes[dst_t]
        for mode in gat_layer.MODES:
            for fold in (0, R):
                args = (xs, src, ro, att, a_dst, L.n_rows_per_rel, fold, mode,
                        0.2, 1.0)
                # the default schedule, and max_edges = 8: real rows cut too
                for k in (gat_layer.MAX_EDGES, 8):
                    sched = gat_layer.schedule(L.row_offsets,
                                               L.n_rows_per_rel, fold,
                                               k).to(device)
                    what = f"{dst_t} R={R} {mode} fold={fold} K={k}"
                    a, stats = check_forward(gat_layer, args, sched, n_real,
                                             what)
                    worst = max(worst, a)
                    g = g_rows[:L.n_rows_per_rel] if fold else g_rows
                    # the backward's chunks: at most max_edges edges
                    sched = gat_layer.schedule(L.row_offsets,
                                               L.n_rows_per_rel, fold, k,
                                               k).to(device)
                    b = check_backward(gat_layer, args, stats, g, sched, what)
                    worst_bwd = max(worst_bwd, b)
                    log(f"  {what}: forward max_abs_err={a:.3e}, backward "
                        f"{b:.3e}")
                    cases += 1
    # a hub node of several thousand edges in each slot, chunk borders
    # mid-row, held as the trash rows are
    src_h, ro_h, n_h, hub = hub_stream(rng)
    xs_h = t((rng.standard_normal((4096, HIDDEN)) * 0.1).astype(np.float32))
    att_h = t((rng.standard_normal((3, HIDDEN)) * 0.2).astype(np.float32))
    ad_h = t((rng.standard_normal(3 * n_h) * 0.5).astype(np.float32))
    g_h = t(rng.standard_normal((3 * n_h, HIDDEN)).astype(np.float32))
    for mode in gat_layer.MODES:
        for fold in (0, 3):
            sched = gat_layer.schedule(ro_h, n_h, fold).to(device)
            if hub not in sched.split_units.tolist():
                raise AssertionError("the hub node was not cut into chunks")
            args = (xs_h, t(src_h), t(ro_h), att_h, ad_h, n_h, fold, mode,
                    0.2, 1.0)
            what = f"hub {mode} fold={fold}"
            a, stats = check_forward(gat_layer, args, sched, hub, what)
            sched = gat_layer.schedule(
                ro_h, n_h, fold,
                chunk_edges=gat_layer.BWD_CHUNK_EDGES).to(device)
            b = check_backward(gat_layer, args, stats,
                               g_h[:n_h] if fold else g_h, sched, what)
            worst, worst_bwd = max(worst, a), max(worst_bwd, b)
            log(f"  {what}: {int(ro_h[-1])} edges, hub {hub} with "
                f"{int(np.diff(ro_h)[hub::n_h].sum())}: forward "
                f"max_abs_err={a:.3e}, backward {b:.3e}")
            cases += 1
    log(f"phase 2 ok: {cases} cases (forward and backward) over "
        f"{len(layouts)} groups and the hub stream, max_edges "
        f"{gat_layer.MAX_EDGES} and 8, bitwise repeatable, worst abs err "
        f"forward {worst:.3e}, backward {worst_bwd:.3e}")
    return worst, worst_bwd


def hub_stream(rng, n=2048, n_rel=3, n_src=4096, hub=100,
               hub_edges=(3001, 2503, 1709)):
    """(src, row_offsets, N, hub) int32 of a merged stream whose node hub
    has thousands of edges in each slot (lengths no chunk size divides),
    the other rows ~6."""
    deg = rng.poisson(6, n_rel * n)
    for r, e in enumerate(hub_edges):
        deg[r * n + hub] = e
    ro = np.zeros(n_rel * n + 1, dtype=np.int64)
    np.cumsum(deg, out=ro[1:])
    src = rng.integers(0, n_src, ro[-1])
    return src.astype(np.int32), ro.astype(np.int32), n, hub


def check_forward(gat_layer, args, sched, long_row, what):
    """The forward kernel twice on sched (the same bits) against the plain
    version; rows long_row + r*N (the trash rows, or a hub) at TRASH_RTOL.
    Returns (max abs err, the kernel's row_max and row_sum)."""
    got = gat_layer.merged_gat_forward(*args, sched=sched)
    again = gat_layer.merged_gat_forward(*args, sched=sched)
    want = gat_layer.merged_gat_forward_plain(*args)
    torch.cuda.synchronize()
    worst = 0.0
    for i, name in enumerate(("out", "row_max", "row_sum")):
        if not torch.equal(got[i], again[i]):
            raise AssertionError(f"{what}: two runs of {name} differ")
        mask = trash_mask(got[i].shape[0], args[5], long_row)
        worst = max(worst, compare(got[i], want[i], mask,
                                   f"{what} {name}")[0])
    return worst, got[1:]


def check_backward(gat_layer, args, stats, g, sched, what):
    """The backward kernel twice on sched (the same bits) against the plain
    version by grad_compare. Returns the max abs err."""
    bargs = args[:5] + tuple(stats) + (g,) + args[5:]
    got = gat_layer.merged_gat_bwd(*bargs, sched=sched)
    again = gat_layer.merged_gat_bwd(*bargs, sched=sched)
    want = gat_layer.merged_gat_bwd_plain(*bargs)
    exact = gat_layer.merged_gat_bwd_plain(*as_double(bargs))
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b, p, e in zip(("w", "dz", "d_a_dst"), got, again, want,
                                exact):
        if not torch.equal(a, b):
            raise AssertionError(f"{what}: two runs of {name} differ")
        worst = max(worst, grad_compare(a, p, e, f"{what} {name}"))
    return worst


def profile_device(fn, fn_ms, what, reps=3):
    """torch.profiler over reps calls: device time per call by kernel
    (device events only: an operator's row would count its kernels twice),
    and their sum against the call's CUDA-event time fn_ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # user annotations (Optimizer.step#Adam.step) span kernels listed
    # on their own rows
    rows = sorted(((ev.self_device_time_total / 1e3 / reps, ev.key,
                    ev.count // reps) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA
                   and not getattr(ev, "is_user_annotation", False)
                   and "#" not in ev.key), reverse=True)
    busy = sum(r[0] for r in rows)
    log(f"  profile: device busy {busy:.4f} ms per {what}, "
        f"{busy / fn_ms:.1%} of the {what}'s {fn_ms:.3f} ms (idle "
        f"{1 - busy / fn_ms:.1%})")
    for ms, key, count in rows[:16]:
        log(f"    {ms:8.4f} ms  x{count:<4d} {key[:90]}")
    return busy


def without_trash_rows(L, n_real):
    """(src, row_offsets) of layout L with every trash row's edges taken
    out: a diagnostic stream, not the layer's input."""
    deg = np.diff(L.row_offsets.astype(np.int64))
    rows = np.repeat(np.arange(len(deg)), deg)
    keep = rows % L.n_rows_per_rel != n_real
    deg[n_real::L.n_rows_per_rel] = 0
    ro = np.zeros(len(deg) + 1, dtype=np.int64)
    np.cumsum(deg, out=ro[1:])
    return (torch.from_numpy(np.ascontiguousarray(L.src[keep])),
            torch.from_numpy(ro.astype(np.int32)))


@contextlib.contextmanager
def swapped(module, **fns):
    """Module attributes replaced for the duration of a with block."""
    old = {k: getattr(module, k) for k in fns}
    for k, f in fns.items():
        setattr(module, k, f)
    try:
        yield
    finally:
        for k, f in old.items():
            setattr(module, k, f)


def without_sched(plain):
    """A plain version in its kernel wrapper's place: the layer ops pass
    the kernels' schedule and the merged GAT layer its per-source-row
    scores, which the plain version does not take (its other keywords
    pass on)."""
    def fn(*args, sched=None, a_src=None, **kwargs):
        return plain(*args, **kwargs)
    return fn


def group_of(layouts, src):
    """The destination group whose edge stream a launch read."""
    for t, L in layouts.items():
        if L.src is src:
            return t
    raise KeyError("a launch on an unknown edge stream")


def grad_compare(got, plain, exact, what):
    """Max abs err of got against the float32 plain version; raises unless
    got's error against the float64 one is within GRAD_ERR_RATIO of the
    float32 plain version's plus GRAD_FLOOR of the largest value."""
    if not got.numel():
        return 0.0
    k_err = float((got.double() - exact).abs().max())
    p_err = float((plain.double() - exact).abs().max())
    scale = float(exact.abs().max())
    if k_err > GRAD_ERR_RATIO * p_err + GRAD_FLOOR * scale:
        raise AssertionError(
            f"{what}: max abs err against float64 {k_err:.3e}, the float32 "
            f"plain version's {p_err:.3e}, largest value {scale:.3e}")
    return float((got - plain).abs().max())


def detached(args):
    return tuple(a.detach() if torch.is_tensor(a) and a.requires_grad else a
                 for a in args)


def as_double(args):
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


def bound_ms(words, flops):
    """(bytes ms, operations ms) at the card's published peaks."""
    return 4 * words / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3


def bwd_bound(args):
    """merged_gat_bwd: reads xs, src, row_offsets, att, a_dst, row_max,
    row_sum, g once, writes w, dz [E] and d_a_dst; two D-wide dot products
    per edge."""
    xs, src, ro, att, a_dst, row_max, row_sum, g = args[:8]
    e = int(ro[-1])
    words = (sum(t.numel() for t in (xs, src, ro, att, a_dst, row_max,
                                     row_sum, g)) + 2 * e + a_dst.numel())
    return bound_ms(words, 4 * xs.shape[1] * e)


def csc_bound(g, w, dz, xs, att, layout):
    """csc_segment_sum: reads g, w, dz, xs, att, dst, csc_perm, csc_offsets
    once, writes d_xs and d_att; an fma per column per edge, and c_s att and
    c_s xs per source row."""
    words = (sum(t.numel() for t in (g, w, dz, xs, att, layout.dst,
                                     layout.csc_perm, layout.csc_offsets))
             + xs.numel() + att.numel())
    d = xs.shape[1]
    return bound_ms(words, 2 * d * w.numel() + 4 * d * xs.shape[0])


def stream_without_trash(src, dst, row_offsets, csc_perm, csc_offsets,
                         n_per_rel, n_real, src_base, fold, device,
                         row_edges=()):
    """An edge stream (a merged group's, or one relation's) with every trash
    row's (pad) edges taken out, its CSC rebuilt over the kept edges' CSC
    source rows and its schedules built (row_schedule with the item sizes
    row_edges, the relation streams' by default): a diagnostic stream, not
    a layer's input. Returns the layout and the kept edges' mask on the
    device."""
    from kgwas_tpu_torch.ops import gat_layer, schedule, segment

    deg = np.diff(row_offsets.astype(np.int64))
    keep = np.repeat(np.arange(len(deg)), deg) % n_per_rel != n_real
    deg[n_real::n_per_rel] = 0
    ro = np.zeros(len(deg) + 1, dtype=np.int64)
    np.cumsum(deg, out=ro[1:])
    ro = ro.astype(np.int32)
    n_src = int(src_base[-1])
    csc_src = np.empty(len(src), dtype=np.int64)   # each edge's CSC row
    csc_src[csc_perm] = np.repeat(np.arange(n_src),
                                  np.diff(csc_offsets.astype(np.int64)))
    kept_src = csc_src[keep]
    perm = np.argsort(kept_src, kind="stable").astype(np.int32)
    off = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(np.bincount(kept_src, minlength=n_src), out=off[1:])
    off = off.astype(np.int32)
    kept_dst = dst[keep]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    lay = SimpleNamespace(
        src=t(src[keep]), row_offsets=t(ro), dst=t(kept_dst),
        csc_perm=t(perm), csc_offsets=t(off),
        src_base=tuple(int(b) for b in src_base), n_rows_per_rel=n_per_rel,
        row_schedule=schedule.row_schedule(ro, *row_edges).to(device),
        **segment.csc_fields(kept_dst, perm, off, n_per_rel, src_base, fold,
                             device),
        gat_bwd_schedule=gat_layer.schedule(
            ro, n_per_rel, fold,
            chunk_edges=gat_layer.BWD_CHUNK_EDGES).to(device)
        if fold else None)
    return lay, t(keep)


def layout_without_trash(L, n_real, device):
    """stream_without_trash of a merged layout L, with the fold."""
    return stream_without_trash(L.src, L.dst, L.row_offsets, L.csc_perm,
                                L.csc_offsets, L.n_rows_per_rel, n_real,
                                L.src_base, len(L.rel_keys), device)


class HostTimer:
    """Wraps a host function to add up the seconds its calls take (with
    sync, each call ends in a synchronise: its launches' device time)."""

    def __init__(self, fn, sync=False):
        self.fn, self.seconds, self.sync = fn, 0.0, sync

    def __call__(self, *args, **kwargs):
        t0 = time.perf_counter()
        try:
            out = self.fn(*args, **kwargs)
            if self.sync:
                torch.cuda.synchronize()
            return out
        finally:
            self.seconds += time.perf_counter() - t0


class Recorder:
    """Wraps the model's layer op to keep each launch's inputs (and, with
    keep_outputs, its results)."""

    def __init__(self, fn, keep_outputs=False):
        self.fn, self.calls, self.outputs = fn, [], []
        self.keep_outputs = keep_outputs

    def __call__(self, *args, **kwargs):
        self.calls.append((args, kwargs))
        out = self.fn(*args, **kwargs)
        if self.keep_outputs:
            self.outputs.append(out)
        return out


@contextlib.contextmanager
def pred_csv_header_only():
    """KGWAS.train writes pred.csv's header line alone: for the runs of
    the phases that check kernels and layer paths (6b-c to 11e), whose
    200,000 rows' text costs 5-6 s a run on the card's host. Phases 5, 9,
    16 and 17 write and check the whole file."""
    from kgwas_tpu_torch import kgwas

    write = kgwas.write_table

    def header(table, path, sep="\t"):
        write({k: v[:0] for k, v in table.items()}, path, sep)

    with swapped(kgwas, write_table=header):
        yield


def write_table_by_rows(table, path, sep="\t"):
    """The row-by-row pred.csv writer that utils.write_table replaced,
    timed beside it on the same table."""
    from kgwas_tpu_torch.utils import _cell_text

    names = list(table)
    cols = [_cell_text(table[k]) for k in names]
    with open(path, "w") as f:
        f.write(sep.join(names) + "\n")
        for row in zip(*cols):
            f.write(sep.join(row) + "\n")


def phase_train(kt, data, cg, device, card, parent=None):
    """Phase 5: the training slice at full width. Returns the kernel table
    rows of merged_gat_bwd and csc_segment_sum, every kernel's launch
    count in one KGWAS.train epoch, the trained KGWAS (phase 7 interprets
    it) and 5d's train step ms and its device busy ms. parent: the earlier
    merged GAT kernels, timed beside merged_gat_bwd, or None."""
    from kgwas_tpu_torch import kgwas
    from kgwas_tpu_torch.engine.loop import epoch_batches, train_step
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.ops import gat_layer, segment

    t0 = time.perf_counter()
    data.prepare_split()
    trainer = kt.KGWAS(data, exp_name="chip_smoke_train", seed=SEED)
    trainer.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN)
    model = trainer.model
    _, x, layouts = trainer._device_state()
    y_node, w_node = trainer._labels(cg)
    batches = [torch.from_numpy(b).to(device) for b in
               epoch_batches(data.train_mask, BATCH, False, None)]
    live, _ = model.live_groups(layouts)
    per_step = sum(len(g) for g in live)
    init = copy.deepcopy(model.state_dict())
    log(f"phase 5: training set-up {time.perf_counter() - t0:.1f} s: "
        f"{len(data.train_mask)} train SNPs, {len(batches)} steps of {BATCH} "
        f"per epoch; {per_step} launches of each layer kernel per step "
        f"(groups per layer: {live})")

    # (a) every backward launch of one step against the plain versions
    rec_bwd = Recorder(gat_layer.merged_gat_bwd)
    rec_csc = Recorder(segment.csc_segment_sum)
    opt = build_optimizer(model.parameters(), LR, 5e-4)
    with swapped(gat_layer, merged_gat_bwd=rec_bwd), \
            swapped(segment, csc_segment_sum=rec_csc):
        train_step(model, opt, x, layouts, batches[0], y_node, w_node)
    torch.cuda.synchronize()
    if len(rec_bwd.calls) != per_step or len(rec_csc.calls) != per_step:
        raise AssertionError(
            f"one step launched the backward kernels {len(rec_bwd.calls)} and "
            f"{len(rec_csc.calls)} times, expected {per_step}")
    launches = [(detached(b[0]), detached(c[0]), b[1]["sched"])
                for b, c in zip(rec_bwd.calls, rec_csc.calls)]
    worst = {"merged_gat_bwd": 0.0, "csc_segment_sum": 0.0, "layer": 0.0}
    for i, (bargs, cargs, sched) in enumerate(launches):
        if sched is None:
            raise AssertionError("the layer op launched without a schedule")
        dst_t = group_of(layouts, bargs[1])
        xs, _, _, att, a_dst, rmax, rsum, g, _, fold, mode, slope, temp = bargs
        largs = (xs, att, a_dst, rmax, rsum, g, layouts[dst_t], fold, mode,
                 slope, temp)
        checks = (
            ("merged_gat_bwd", ("w", "dz", "d_a_dst"), bargs,
             functools.partial(gat_layer.merged_gat_bwd, sched=sched),
             gat_layer.merged_gat_bwd_plain),
            ("csc_segment_sum", ("d_xs_all", "d_att"), cargs,
             segment.csc_segment_sum, segment.csc_segment_sum_plain),
            ("layer", ("d_xs_all", "d_att", "d_a_dst"), largs,
             gat_layer.merged_gat_backward,
             gat_layer.merged_gat_backward_plain),
        )
        for kernel, names, args, fn, plain_fn in checks:
            got, again = fn(*args), fn(*args)
            want, exact = plain_fn(*args), plain_fn(*as_double(args))
            torch.cuda.synchronize()
            for name, a, b, c, e in zip(names, got, again, want, exact):
                if not torch.equal(a, b):
                    raise AssertionError(
                        f"{kernel} {dst_t}: two runs of {name} differ")
                err = grad_compare(a, c, e, f"{kernel} {dst_t} {name}")
                worst[kernel] = max(worst[kernel], err)
            del want, exact
        log(f"  backward launch {i} {dst_t:18s} {mode} fold={fold}: kernels "
            f"vs plain within tolerance, bitwise repeatable")
    log(f"  phase 5a ok: worst abs err merged_gat_bwd "
        f"{worst['merged_gat_bwd']:.3e}, csc_segment_sum "
        f"{worst['csc_segment_sum']:.3e}, layer gradient {worst['layer']:.3e}")

    # (b) CMP_STEPS steps through the kernels against the plain layer op
    def run_steps(ctx):
        model.load_state_dict(init)
        opt = build_optimizer(model.parameters(), LR, 5e-4)
        with ctx:
            losses = [train_step(model, opt, x, layouts, b, y_node, w_node)
                      for b in batches[:CMP_STEPS]]
        return (torch.stack(losses).cpu().numpy(),
                {k: v.detach().clone() for k, v in model.state_dict().items()})

    loss_k, par_k = run_steps(contextlib.nullcontext())
    loss_p, par_p = run_steps(swapped(
        gat_layer, merged_gat_forward=without_sched(
            gat_layer.merged_gat_forward_plain),
        merged_gat_backward=gat_layer.merged_gat_backward_plain))
    np.testing.assert_allclose(loss_k, loss_p, rtol=LOSS_RTOL)
    par_err = max(float((par_k[k] - par_p[k]).abs().max()) for k in par_k)
    moved = max(float((par_k[k] - init[k]).abs().max()) for k in par_k)
    if par_err > PARAM_ATOL:
        raise AssertionError(f"parameters after {CMP_STEPS} steps differ by "
                             f"{par_err:.3e} > {PARAM_ATOL:.1e}")
    log(f"  phase 5b ok: {CMP_STEPS} steps, losses kernel {loss_k.tolist()} "
        f"plain {loss_p.tolist()}; parameters differ by at most "
        f"{par_err:.3e} (moved by up to {moved:.3e})")

    # (d) timing: steps, then each backward launch of one step
    model.load_state_dict(init)
    opt = build_optimizer(model.parameters(), LR, 5e-4)
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    for b in batches[:25]:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        train_step(model, opt, x, layouts, b, y_node, w_node)
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
    step_ms = statistics.median(step_ms[5:])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if parent:
        cycle = itertools.cycle(batches[:25])
        step_vs_parent("GAT-sum", lambda: train_step(
            model, opt, x, layouts, next(cycle), y_node, w_node), parent)
    step_busy = profile_device(lambda: train_step(
        model, opt, x, layouts, batches[0], y_node, w_node), step_ms,
        "training step")
    tot = {k: dict.fromkeys(("ms", "device_ms", "ms_no_trash", "plain_ms",
                             "bound_ms", "bytes", "operations",
                             "library_ms"), 0.0)
           for k in ("merged_gat_bwd", "csc_segment_sum")}
    parent_tot = {"ms": 0.0, "ms_no_trash": 0.0}
    for i, (bargs, cargs, sched) in enumerate(launches):
        dst_t = group_of(layouts, bargs[1])
        g, w, dz, xs, att, lay, fold = cargs
        lay_nt, keep = layout_without_trash(
            trainer.layouts[dst_t], cg.num_nodes[dst_t], device)
        bargs_nt = (xs, lay_nt.src, lay_nt.row_offsets) + bargs[3:]
        cargs_nt = (g, w[keep], dz[keep], xs, att, lay_nt, fold)
        # the library yardstick of the CSC sum: index_add_ of the
        # materialised [E, D] message cotangent
        n = lay.n_rows_per_rel
        dst = lay.dst.long()
        d_msgs = (w[:, None] * g[dst % n if fold else dst]
                  + dz[:, None] * att[dst // n])
        src = lay.src.long()
        bwd = lambda: gat_layer.merged_gat_bwd(*bargs, sched=sched)  # noqa: B023, E731
        csc = lambda: segment.csc_segment_sum(*cargs)  # noqa: B023, E731
        times = {
            "merged_gat_bwd": (
                cuda_ms(bwd, 20), graph_ms(bwd, 20),
                cuda_ms(lambda: gat_layer.merged_gat_bwd(  # noqa: B023
                    *bargs_nt, sched=lay_nt.gat_bwd_schedule), 20),  # noqa: B023
                cuda_ms(lambda: gat_layer.merged_gat_bwd_plain(*bargs), 3),  # noqa: B023
                None, bwd_bound(bargs)),
            "csc_segment_sum": (
                cuda_ms(csc, 20), graph_ms(csc, 20),
                cuda_ms(lambda: segment.csc_segment_sum(*cargs_nt), 20),  # noqa: B023
                cuda_ms(lambda: segment.csc_segment_sum_plain(*cargs), 3),  # noqa: B023
                cuda_ms(lambda: torch.zeros_like(xs).index_add_(  # noqa: B023
                    0, src, d_msgs), 5),  # noqa: B023
                csc_bound(g, w, dz, xs, att, lay)),
        }
        del d_msgs
        parts = []
        if parent:   # the earlier kernel on the same launch, this call
            p_ms = cuda_ms(lambda: parent.bwd(  # noqa: B023
                *bargs, sched=sched), 20)  # noqa: B023
            p_nt = cuda_ms(lambda: parent.bwd(  # noqa: B023
                *bargs_nt, sched=lay_nt.gat_bwd_schedule), 20)  # noqa: B023
            parent_tot["ms"] += p_ms
            parent_tot["ms_no_trash"] += p_nt
            parts.append(f"earlier merged_gat_bwd {p_ms:.4f} ms (without "
                         f"trash rows {p_nt:.4f})")
        for kernel, (ms, dev_ms, ms_nt, plain_ms, lib_ms,
                     (t_b, t_o)) in times.items():
            t = tot[kernel]
            t["ms"] += ms
            t["device_ms"] += dev_ms
            t["ms_no_trash"] += ms_nt
            t["plain_ms"] += plain_ms
            t["library_ms"] += lib_ms or 0.0
            t["bytes"] += t_b
            t["operations"] += t_o
            t["bound_ms"] += max(t_b, t_o)
            parts.append(
                f"{kernel} {ms:.4f} ms (device {dev_ms:.4f}; without trash "
                f"rows {ms_nt:.4f}) | "
                f"plain {plain_ms:.4f} | "
                + (f"index_add_ {lib_ms:.4f} | " if lib_ms else "")
                + f"bound {max(t_b, t_o):.4f} "
                f"({'bytes' if t_b >= t_o else 'operations'})")
        log(f"  backward launch {i} {dst_t:18s} " + " || ".join(parts))
    edges = cg.total_real_edges()
    rate = edges * LAYERS / (step_ms / 1e3)
    log(f"phase 5d [{card}]: train step {step_ms:.3f} ms median of 20; "
        f"training edge-traversals/s {rate:.4g} ({edges} real edges x "
        f"{LAYERS} layers); peak memory {peak_gb:.2f} GB; per step: "
        + "; ".join(f"{k} {t['ms']:.4f} ms (device {t['device_ms']:.4f}; "
                    f"without trash rows {t['ms_no_trash']:.4f}) / plain "
                    f"{t['plain_ms']:.4f} / "
                    f"bound {t['bound_ms']:.4f}" for k, t in tot.items())
        + (f"; earlier merged_gat_bwd {parent_tot['ms']:.4f} ms (without "
           f"trash rows {parent_tot['ms_no_trash']:.4f})" if parent else ""))
    segment_launches("GAT-sum", "csc_segment_sum",
                     [(c, {}) for _, c, _ in launches], trainer.layouts,
                     layouts, cg, device, parent)

    # (c) the public entry point, counts set to 0 just before
    model.load_state_dict(init)
    tail = {name: HostTimer(getattr(kgwas, name))
            for name in ("save_model", "finalize_predictions", "write_table")}
    gat_layer.launches = gat_layer.bwd_launches = segment.launches = 0
    t0 = time.perf_counter()
    with swapped(kgwas, **tail):
        table = trainer.train(batch_size=BATCH, epoch=1, lr=LR,
                              scan_steps=0)
    train_s = time.perf_counter() - t0
    counts = {"merged_gat_fwd": gat_layer.launches,
              "merged_gat_bwd": gat_layer.bwd_launches,
              "csc_segment_sum": segment.launches}
    steps = len(trainer.epoch_losses[0])
    # each step's forward and backward, and two full-graph forwards: the
    # epoch's validation and the best state's test and KGWAS_P
    want = {"merged_gat_fwd": per_step * (steps + 2),
            "merged_gat_bwd": per_step * steps,
            "csc_segment_sum": per_step * steps}
    if steps != len(batches) or counts != want:
        raise AssertionError(f"KGWAS.train: {steps} steps, launches {counts}, "
                             f"expected {len(batches)} steps, {want}")
    kp = table["KGWAS_P"]
    if not (np.isfinite(kp).all() and (kp >= 0).all() and (kp <= 1).all()):
        raise AssertionError("KGWAS_P after training not finite in [0, 1]")
    losses = np.asarray(trainer.epoch_losses[0])
    if not np.isfinite(losses).all():
        raise AssertionError("non-finite training loss")
    rec = trainer.train_history[0]
    log(f"phase 5 ok: KGWAS.train(batch_size={BATCH}, epoch=1) in "
        f"{train_s:.1f} s ({rec['epoch_time_s']:.2f} s epoch, {steps} steps, "
        f"host tail: "
        + ", ".join(f"{k} {v.seconds:.2f} s" for k, v in tail.items())
        + "; "
        f"{rec['edges_per_sec']:.4g} edge-traversals/s with the epoch's "
        f"evaluation); launches {counts}; loss first {losses[0]:.4f} last "
        f"{losses[-1]:.4f}; val pearson {rec['val_pearsonr']:.4f}; test "
        f"{trainer.test_metrics}; {len(kp)} KGWAS_P finite in [0, 1]")
    # the pred.csv writer: whole columns at once, against the row writer it
    # replaced, on the same table
    paths = [os.path.join(data.data_path, f"pred_{k}.csv")
             for k in ("columns", "rows")]
    write_s = []
    for writer, path in zip((kgwas.write_table, write_table_by_rows), paths):
        t0 = time.perf_counter()
        writer(table, path)
        write_s.append(time.perf_counter() - t0)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        if a.read() != b.read():
            raise AssertionError("write_table's bytes differ from the row "
                                 "writer's")
    log(f"  phase 5 pred.csv writer ({len(kp)} rows): write_table "
        f"{write_s[0]:.2f} s, the row writer it replaced {write_s[1]:.2f} s, "
        f"bytes equal")

    rows = []
    for name, src, replaces in (
            ("merged_gat_bwd", "merged_gat_bwd.cu",
             "kgwas_tpu/ops/pallas_gat_layer.py:387"),
            ("csc_segment_sum", "csc_segment_sum.cu",
             "kgwas_tpu/ops/pallas_segment.py:659")):
        t = tot[name]
        rows.append({
            "name": name,
            "route": "cuda",
            "source": f"kgwas_tpu_torch/ops/csrc/{src}",
            "replaces": replaces,
            "launches": counts[name],
            "max_abs_err": worst[name],
            "ms": t["ms"],
            "device_ms": t["device_ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": ("bytes" if t["bytes"] >= t["operations"]
                         else "operations"),
            "library_ms": t["library_ms"] if name == "csc_segment_sum"
            else None,
        })
    return rows, counts, trainer, (step_ms, step_busy)


VARIANTS = {
    "GAT-max": dict(gnn_aggr="max"),
    "GAT-min": dict(gnn_aggr="min"),
    "SAGE": dict(gnn_backbone="SAGE"),
    "GCN": dict(gnn_backbone="GCN"),
    "SGC": dict(gnn_backbone="SGC"),
}
VARIANT_KERNELS = ("segment_softmax_spmm_fwd", "segment_softmax_spmm_bwd",
                   "csr_segment_sum", "csc_segment_sum")
# phase 6c's float32 forward / step ms of each variant, beside phase 12's
F32_TIMES = {}


def variant_counts(zero=False):
    """The launch counts of the variant paths' kernels (every count set to
    0 first with zero=True)."""
    counts = model_counts(zero)
    return {k: counts[k] for k in VARIANT_KERNELS}


def as_tuple(v):
    return v if isinstance(v, tuple) else (v,)


def repeat_equal(fn, args, what):
    """fn(*args) twice; raises unless both give the same bits."""
    got, again = map(as_tuple, (fn(*args), fn(*args)))
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        if a is not None and not torch.equal(a, b):
            raise AssertionError(f"{what}: two runs differ")
    return got


def phase_variant_kernels(kt, device, tmp):
    """Phase 6a: every new kernel against its plain version on the 20k-SNP
    KG. Returns each kernel's worst abs err against the float32 plain
    version."""
    from kgwas_tpu_torch.graph import build_merged_layouts
    from kgwas_tpu_torch.models import device_layouts
    from kgwas_tpu_torch.ops import schedule, segment, segment_softmax

    data = kt.KGWAS_Data.from_synthetic(
        seed=SEED + 1, data_path=str(tmp / "small"), **SMALL_KG)
    cg = data.compile()
    layouts = build_merged_layouts(cg, tile_rows=512)
    rel = device_layouts(layouts, device, cg, "relations")
    mp = device_layouts(layouts, device, cg, "mp")
    rng = np.random.default_rng(SEED + 6)
    t = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.float32)).to(device)
    worst = dict.fromkeys(VARIANT_KERNELS, 0.0)
    csc_plain = segment.csc_segment_sum_plain

    def held(kernel, got, args, plain_fn, what):
        want, exact = plain_fn(*args), plain_fn(*as_double(args))
        for a, p, e in zip(*map(as_tuple, (got, want, exact))):
            if a is not None:
                worst[kernel] = max(worst[kernel],
                                    grad_compare(a, p, e, what))

    for dst_t, L in rel.items():
        n_real = cg.num_nodes[dst_t]
        for rk, RL in zip(L.rel_keys, L.relations):
            xs = t(rng.standard_normal((RL.src_base[-1], HIDDEN)) * 0.1)
            logits = t(rng.standard_normal(RL.src.shape[0]) * 1.5)
            g = t(rng.standard_normal((RL.n_rows_per_rel, HIDDEN)))
            fargs = (xs, RL.src, logits, RL.row_offsets)
            got = repeat_equal(segment_softmax.segment_softmax_spmm_fwd,
                               fargs, f"{rk} forward")
            want = segment_softmax.segment_softmax_spmm_fwd_plain(*fargs)
            for name, a, b in zip(("out", "row_max", "row_sum"), got, want):
                err, _ = compare(a, b, trash_mask(a.shape[0],
                                                  RL.n_rows_per_rel, n_real),
                                 f"{rk} {name}")
                worst["segment_softmax_spmm_fwd"] = max(
                    worst["segment_softmax_spmm_fwd"], err)
            bargs = fargs + (got[1], got[2], got[0], g)
            # the layout's schedule, and max_edges 8: real rows cut too
            for sched in (RL.row_schedule, schedule.row_schedule(
                    cg.relations[rk].row_offsets, 8, 8).to(device)):
                what = f"{rk} backward max_edges {sched.max_edges}"
                edge = repeat_equal(functools.partial(
                    segment_softmax.segment_softmax_spmm_bwd, sched=sched),
                    bargs, what)
                held("segment_softmax_spmm_bwd", edge, bargs,
                     segment_softmax.segment_softmax_spmm_bwd_plain, what)
            cargs = (g, edge[0], None, xs, None, RL)
            held("csc_segment_sum",
                 repeat_equal(segment.csc_segment_sum, cargs, f"{rk} csc"),
                 cargs, csc_plain, f"{rk} csc")
    for dst_t, DL in mp.items():
        x = t(rng.standard_normal((DL.src_base[-1], HIDDEN)) * 0.1)
        g = t(rng.standard_normal((DL.row_offsets.shape[0] - 1, HIDDEN)))
        scheds = (DL.row_schedule, schedule.row_schedule(
            layouts[dst_t].row_offsets, 8, 8).to(device))
        for w in (None, DL.sym_e):
            what = f"{dst_t} {'weighted' if w is not None else 'unweighted'}"
            rargs = (x, DL.src, DL.row_offsets, w)
            for sched in scheds:
                held("csr_segment_sum", repeat_equal(
                    functools.partial(segment.csr_segment_sum, sched=sched),
                    rargs, f"{what} csr"),
                    rargs, segment.csr_segment_sum_plain,
                    f"{what} csr max_edges {sched.max_edges}")
            cargs = (g, w, None, x, None, DL)
            held("csc_segment_sum",
                 repeat_equal(segment.csc_segment_sum, cargs, f"{what} csc"),
                 cargs, csc_plain, f"{what} csc")
    # a stream with a hub row of 3001 edges, cut into chunks, and empty
    # rows, for the backward and the CSR sum
    n_h, hub = 2048, 100
    deg = rng.poisson(4, n_h)
    deg[rng.choice(n_h, 40, replace=False)] = 0
    deg[hub] = 3001
    ro_np = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    ro_h = torch.from_numpy(ro_np).to(device)
    src_h = torch.from_numpy(rng.integers(0, 4096, ro_np[-1]).astype(
        np.int32)).to(device)
    xs = t(rng.standard_normal((4096, HIDDEN)) * 0.1)
    logits = t(rng.standard_normal(src_h.shape[0]) * 1.5)
    g = t(rng.standard_normal((n_h, HIDDEN)))
    w = t(rng.random(src_h.shape[0]))
    for k in (schedule.ROW_MAX_EDGES, 8):
        sched = schedule.row_schedule(ro_np, k, k).to(device)
        if hub not in sched.split_units.tolist():
            raise AssertionError("the hub row was not cut into chunks")
        out, row_max, row_sum = segment_softmax.segment_softmax_spmm_fwd(
            xs, src_h, logits, ro_h)
        bargs = (xs, src_h, logits, ro_h, row_max, row_sum, out, g)
        what = f"hub stream backward max_edges {k}"
        held("segment_softmax_spmm_bwd", repeat_equal(functools.partial(
            segment_softmax.segment_softmax_spmm_bwd, sched=sched), bargs,
            what), bargs, segment_softmax.segment_softmax_spmm_bwd_plain,
            what)
        for wh in (None, w):
            what = f"hub stream csr max_edges {k}"
            rargs = (xs, src_h, ro_h, wh)
            held("csr_segment_sum", repeat_equal(functools.partial(
                segment.csr_segment_sum, sched=sched), rargs, what), rargs,
                segment.csr_segment_sum_plain, what)
    log(f"phase 6a ok: {sum(len(L.rel_keys) for L in rel.values())} "
        f"relation streams, {len(mp)} merged groups and a hub stream, "
        f"kernels vs plain within tolerance (#7 and #10 also at max_edges "
        f"8), bitwise repeatable; worst abs err "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()))
    return worst


def kernel_bound(name, args, out, kwargs=None):
    """(bytes ms, operations ms) of one launch of a variant kernel: each
    input read once and each output written once, and its flops. kwargs:
    the launch's keywords: a multiplier (#6, #7) is one more word an edge
    read; the weights' gradient (#8, edge_grad) reads xs and writes one
    word an edge, with a D-wide dot product an edge."""
    kwargs = kwargs or {}
    mult = kwargs.get("mult") is not None
    if name == "csc_segment_sum":      # without logit term
        g, w, _, xs, _, lay = args[:6]
        e = lay.csc_perm.numel()
        dw = bool(kwargs.get("edge_grad"))
        words = (g.numel() + (e if w is not None else 0) + 2 * e
                 + lay.csc_offsets.numel() + xs.numel()
                 + (xs.numel() + e if dw else 0))
        return bound_ms(words, 2 * xs.shape[1] * e * (2 if dw else 1))
    if name == "csr_segment_sum":      # x, src, row_offsets, w or None
        x, src, ro, w = args
        e = int(ro[-1])
        words = (x.numel() + src.numel() + ro.numel() + out.numel()
                 + (e if w is not None else 0))
        return bound_ms(words, 2 * x.shape[1] * e)
    xs, src, logits, ro = args[:4]
    d = xs.shape[1]
    e = int(ro[-1])
    n_rows = ro.numel() - 1
    if name == "segment_softmax_spmm_fwd":   # out, row_max, row_sum
        words = (xs.numel() + src.numel() + ro.numel() + logits.numel()
                 + (e if mult else 0))
        return bound_ms(words + n_rows * d + 2 * n_rows, 2 * d * e)
    nb = softmax_bwd_bytes(*args[:8], sched=kwargs.get("sched"),
                           mult=kwargs.get("mult"))
    return bound_ms(nb / 4, 2 * d * (e + n_rows))


def softmax_bwd_bytes(xs, src, logits, ro, row_max, row_sum, out, g,
                      sched=None, mult=None):
    """The bytes one launch of #7 (segment_softmax_spmm_bwd) must move,
    each array at its own width: xs, src, logits (and mult), row_offsets,
    row_max, row_sum and g read once, w and d_logits (float32 [E]) written
    once, and the saved out read only on the rows the kernel reads it, the
    schedule's chunked rows (sched.split_units; the schedule the wrapper
    builds when sched is None): a packed row's dot_r comes from its own
    edges."""
    if sched is None:
        from kgwas_tpu_torch.ops.schedule import row_schedule
        sched = row_schedule(ro)
    n_out = sched.split_units.numel() * out.shape[1] * out.element_size()
    return (nbytes(xs, src, logits, ro, row_max, row_sum, g, mult)
            + 2 * 4 * src.numel() + n_out)


def time_launches(name, calls, fn, plain_fn, library=None):
    """Sums over the recorded launches (args, kwargs; the kernel takes both,
    the plain version the args and the keywords but sched): kernel ms
    (host-paced, mean of 10) and device ms (graph_ms), plain ms (mean of
    2), bound ms and its parts, library ms; and the worst abs err of the
    kernel against the plain version."""
    tot = dict.fromkeys(("ms", "device_ms", "plain_ms", "bound_ms", "bytes",
                         "operations", "library_ms"), 0.0)
    worst = 0.0
    for args, kwargs in calls:
        args = detached(args)
        pkw = {k: v for k, v in kwargs.items() if k != "sched"}
        pkw64 = dict(zip(pkw, as_double(tuple(pkw.values()))))
        got_t, want_t, exact_t = map(as_tuple, (
            fn(*args, **kwargs), plain_fn(*args, **pkw),
            plain_fn(*as_double(args), **pkw64)))
        for a, p, x in zip(got_t, want_t, exact_t):
            if a is not None:
                worst = max(worst, grad_compare(a, p, x, f"full-width {name}"))
        del want_t, exact_t
        t_b, t_o = kernel_bound(name, args, got_t[0], kwargs)
        tot["bytes"] += t_b
        tot["operations"] += t_o
        tot["bound_ms"] += max(t_b, t_o)
        tot["ms"] += cuda_ms(lambda: fn(*args, **kwargs), 10)  # noqa: B023
        tot["device_ms"] += graph_ms(lambda: fn(*args, **kwargs), 10)  # noqa: B023
        tot["plain_ms"] += cuda_ms(lambda: plain_fn(*args, **pkw), 2)  # noqa: B023
        if library is not None:
            tot["library_ms"] += cuda_ms(library(*args), 10)
    return tot, worst


def sparse_mm(x, src, ro, w):
    """The library yardstick of csr_segment_sum: torch.sparse.mm of the
    CSR matrix (values w, or 1) against x."""
    vals = w if w is not None else torch.ones(src.numel(), device=x.device)
    with warnings.catch_warnings():   # sparse CSR is "beta" in torch
        warnings.simplefilter("ignore")
        a = torch.sparse_csr_tensor(ro, src, vals, size=(ro.numel() - 1,
                                                         x.shape[0]),
                                    check_invariants=False)
    return lambda: torch.sparse.mm(a, x)


def phase_variants(kt, data, cg, device, card, worst_small, parent=None):
    """Phase 6b-c: each model variant at full width. Returns the kernel
    table rows of the three new kernels; worst_small holds phase 6a's worst
    errors. parent: the earlier kernels, timed beside #6 and #8 on the
    GAT-max launches, or None."""
    from kgwas_tpu_torch.engine.loop import epoch_batches, train_step
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.ops import segment, segment_softmax
    from kgwas_tpu_torch.stats.calibration import finalize_predictions

    # the training entry point over CMP_STEPS batches of the split that
    # phase 5 prepared: a copy of the data with a shorter train list
    data_v = copy.copy(data)
    data_v.train_mask = np.asarray(data.train_mask)[:CMP_STEPS * BATCH]
    batches = [torch.from_numpy(b).to(device) for b in
               epoch_batches(data_v.train_mask, BATCH, False, None)]
    launches = dict.fromkeys(VARIANT_KERNELS, 0)
    summary, timed = {}, {}
    worst = dict.fromkeys(VARIANT_KERNELS, 0.0)
    for name, kw in VARIANTS.items():
        t0 = time.perf_counter()
        gat = name.startswith("GAT")
        run = kt.KGWAS(data_v, exp_name=f"chip_smoke_{name}", seed=SEED)
        # no_relu: a dead ReLU head gives constant predictions, a NaN val
        # Pearson, and KGWAS.train then keeps the initial state
        run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN,
                             no_relu=True, **kw)
        shared_state(run)
        init = copy.deepcopy(run.model.state_dict())
        run.predict_all()   # device state, allocator warm-up
        torch.cuda.synchronize()
        # launches per forward and per step: one per relation of each group
        # that reaches the head (GAT), one per such group (the others)
        live, _ = run.model.live_groups(run.layouts)
        n = sum(len(run.layouts[t].rel_keys) if gat else 1
                for groups in live for t in groups)
        per = ({"segment_softmax_spmm_fwd": n} if gat
               else {"csr_segment_sum": n})
        if gat:
            plain = functools.partial(
                swapped, segment_softmax,
                segment_softmax_spmm_fwd=without_sched(
                    segment_softmax.segment_softmax_spmm_fwd_plain),
                segment_softmax_spmm_backward=(
                    segment_softmax.segment_softmax_spmm_backward_plain))
        else:
            plain = functools.partial(
                swapped, segment,
                csr_segment_sum=without_sched(segment.csr_segment_sum_plain),
                csc_segment_sum=segment.csc_segment_sum_plain)

        # (b) serving: counts set to 0 just before the entry point
        variant_counts(zero=True)
        pred = run.predict_all()
        counts = variant_counts()
        if counts != {k: per.get(k, 0) for k in VARIANT_KERNELS}:
            raise AssertionError(f"{name}: predict_all launched {counts}, "
                                 f"expected {per}")
        for k, v in counts.items():
            launches[k] += v
        if pred.shape != (cg.num_nodes["SNP"],) or not np.isfinite(
                pred).all():
            raise AssertionError(f"{name}: bad predictions")
        with plain():
            pred_plain = run.predict_all()
        np.testing.assert_allclose(pred, pred_plain, rtol=PRED_RTOL,
                                   atol=PRED_ATOL)
        pred_err = float(np.abs(pred - pred_plain).max())
        kp_note = ""
        if name in ("GAT-max", "GCN"):
            table, _ = finalize_predictions(data.lr_uni, pred[data.all_ids])
            kp = table["KGWAS_P"]
            if not (np.isfinite(kp).all() and (kp >= 0).all()
                    and (kp <= 1).all()):
                raise AssertionError(f"{name}: KGWAS_P not finite in [0, 1]")
            kp_note = f"; {len(kp)} KGWAS_P finite in [0, 1]"

        # (b) training: KGWAS.train over CMP_STEPS steps, counts set to 0
        # just before, against CMP_STEPS steps through the plain ops
        variant_counts(zero=True)
        run.train(batch_size=BATCH, epoch=1, lr=LR, save_best_model=False,
                  scan_steps=0)
        counts = variant_counts()
        steps = len(run.epoch_losses[0])
        want = ({"segment_softmax_spmm_fwd": n * (steps + 2),
                 "segment_softmax_spmm_bwd": n * steps} if gat
                else {"csr_segment_sum": n * (steps + 2)})
        want["csc_segment_sum"] = n * steps
        want = {k: want.get(k, 0) for k in VARIANT_KERNELS}
        if steps != CMP_STEPS or counts != want:
            raise AssertionError(f"{name}: KGWAS.train took {steps} steps "
                                 f"with launches {counts}, expected "
                                 f"{CMP_STEPS} and {want}")
        for k, v in counts.items():
            launches[k] += v
        loss_k = np.asarray(run.epoch_losses[0])
        # the parameters after the same steps (KGWAS.train keeps its best
        # state, which is the initial one when the val Pearson is NaN),
        # through the kernels and through the plain ops
        model = run.model
        _, x, layouts = run._device_state()
        y_node, w_node = run._labels(cg)

        def steps_from_init(ctx):
            model.load_state_dict(init)
            opt = build_optimizer(model.parameters(), LR, 5e-4)
            with ctx:
                losses = [train_step(model, opt, x, layouts, b, y_node,
                                     w_node) for b in batches]
            return (torch.stack(losses).cpu().numpy(),
                    {k: v.detach().clone()
                     for k, v in model.state_dict().items()})

        _, par_k = steps_from_init(contextlib.nullcontext())
        loss_p, par_p = steps_from_init(plain())
        np.testing.assert_allclose(loss_k, loss_p, rtol=LOSS_RTOL)
        par_err = max(float((par_k[k] - par_p[k]).abs().max())
                      for k in par_k)
        moved = max(float((par_k[k] - init[k]).abs().max()) for k in par_k)
        if par_err > PARAM_ATOL or moved == 0:
            raise AssertionError(f"{name}: parameters after {CMP_STEPS} "
                                 f"steps differ by {par_err:.3e}, moved by "
                                 f"{moved:.3e}")
        log(f"  phase 6b {name}: groups per layer {live}; predict_all "
            f"launches {per}, vs plain ops "
            f"max abs err {pred_err:.3e}{kp_note}; KGWAS.train "
            f"{CMP_STEPS} steps launches "
            + str({k: v for k, v in counts.items() if v})
            + f", losses kernel {loss_k.tolist()} plain {loss_p.tolist()}, "
            f"parameters differ by {par_err:.3e} (moved {moved:.3e})")

        # (c) timing: forward and step, then each new kernel's launches
        model.load_state_dict(init)
        opt = build_optimizer(model.parameters(), LR, 5e-4)
        fwd_ms, step_ms = [], []
        for i in range(12):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            run.predict_all()
            stop.record()
            torch.cuda.synchronize()
            fwd_ms.append(start.elapsed_time(stop))
        for i in range(13):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            train_step(model, opt, x, layouts, batches[i % len(batches)],
                       y_node, w_node)
            stop.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(stop))
        fwd_ms = statistics.median(fwd_ms[2:])
        step_ms = statistics.median(step_ms[3:])
        if parent and name in ("GAT-max", "SAGE"):
            cycle = itertools.cycle(batches)
            step_vs_parent(name, lambda: train_step(  # noqa: B023
                model, opt, x, layouts, next(cycle), y_node,  # noqa: B023
                w_node), parent)  # noqa: B023
        if parent and name in ("SAGE", "GCN"):
            step_vs_parent(name, run.predict_all, parent, "forward")
        profile_device(run.predict_all, fwd_ms, f"{name} forward")
        profile_device(lambda: train_step(model, opt, x, layouts,  # noqa: B023
                                          batches[0], y_node, w_node),
                       step_ms, f"{name} training step")
        fwd_name = "segment_softmax_spmm_fwd" if gat else "csr_segment_sum"
        fwd_mod = segment_softmax if gat else segment
        rec_f = Recorder(getattr(fwd_mod, fwd_name))
        with swapped(fwd_mod, **{fwd_name: rec_f}):
            run.predict_all()
        rec_b = Recorder(segment_softmax.segment_softmax_spmm_bwd)
        rec_c = Recorder(segment.csc_segment_sum)
        with swapped(segment_softmax, segment_softmax_spmm_bwd=rec_b), \
                swapped(segment, csc_segment_sum=rec_c):
            train_step(model, opt, x, layouts, batches[0], y_node, w_node)
        torch.cuda.synchronize()
        plain_of = {
            "segment_softmax_spmm_fwd": (
                segment_softmax.segment_softmax_spmm_fwd,
                segment_softmax.segment_softmax_spmm_fwd_plain, None),
            "segment_softmax_spmm_bwd": (
                segment_softmax.segment_softmax_spmm_bwd,
                segment_softmax.segment_softmax_spmm_bwd_plain, None),
            "csr_segment_sum": (segment.csr_segment_sum,
                                segment.csr_segment_sum_plain, sparse_mm),
            "csc_segment_sum": (segment.csc_segment_sum,
                                segment.csc_segment_sum_plain, None),
        }
        recs = {fwd_name: rec_f, "csc_segment_sum": rec_c}
        if gat:
            recs["segment_softmax_spmm_bwd"] = rec_b
        # the segment kernels launch by launch: #6, #7 and #8 on GAT-max,
        # #10 and #8 (without w, and with it) on SAGE and GCN
        if name in ("GAT-max", "SAGE", "GCN"):
            for k, rec in recs.items():
                segment_launches(name, k, rec.calls, run.layouts, layouts,
                                 cg, device, parent)
        parts = []
        for k, rec in recs.items():
            fn, plain_fn, lib = plain_of[k]
            tot, err = time_launches(k, rec.calls, fn, plain_fn, lib)
            tot["launches"] = len(rec.calls)
            timed[(name, k)] = tot
            worst[k] = max(worst[k], err)
            parts.append(
                f"{k} x{len(rec.calls)} {tot['ms']:.4f} ms (device "
                f"{tot['device_ms']:.4f}) | plain "
                f"{tot['plain_ms']:.4f} | "
                + (f"sparse.mm {tot['library_ms']:.4f} | " if lib else "")
                + f"bound {tot['bound_ms']:.4f} ("
                + ("bytes" if tot["bytes"] >= tot["operations"]
                   else "operations") + ")")
        summary[name] = {"forward_ms": fwd_ms, "step_ms": step_ms}
        F32_TIMES[name] = (fwd_ms, step_ms)
        edges = cg.total_real_edges()
        log(f"  phase 6c {name} [{card}]: forward {fwd_ms:.3f} ms median of "
            f"10 ({edges * LAYERS / (fwd_ms / 1e3):.4g} edge-traversals/s), "
            f"train step {step_ms:.3f} ms median of 10 "
            f"({edges * LAYERS / (step_ms / 1e3):.4g}); per forward or "
            f"step: " + " || ".join(parts)
            + f"; {time.perf_counter() - t0:.1f} s")
        del run, model, opt, x, layouts, init, par_k, par_p, rec_f, rec_b, rec_c
        torch.cuda.empty_cache()
    log(f"phase 6 ok [{card}]: {len(VARIANTS)} variants served and trained "
        f"through the kernels; launches {launches}; "
        + "; ".join(f"{k} forward {v['forward_ms']:.3f} ms, step "
                    f"{v['step_ms']:.3f} ms" for k, v in summary.items()))

    rows = []
    for k, cfg_name, src, replaces in (
            ("segment_softmax_spmm_fwd", "GAT-max",
             "segment_softmax_spmm_fwd.cu",
             "kgwas_tpu/ops/pallas_segment.py:220"),
            ("segment_softmax_spmm_bwd", "GAT-max",
             "segment_softmax_spmm_bwd.cu",
             "kgwas_tpu/ops/pallas_segment.py:370"),
            ("csr_segment_sum", "GCN", "csr_segment_sum.cu",
             "kgwas_tpu/ops/pallas_segment.py:1150")):
        tot = timed[(cfg_name, k)]
        rows.append({
            "name": k,
            "route": "cuda",
            "source": f"kgwas_tpu_torch/ops/csrc/{src}",
            "replaces": replaces,
            "launches": launches[k],
            "max_abs_err": max(worst[k], worst_small[k]),
            "ms": tot["ms"],
            "device_ms": tot["device_ms"],
            "plain_ms": tot["plain_ms"],
            "bound_ms": tot["bound_ms"],
            "bound_by": ("bytes" if tot["bytes"] >= tot["operations"]
                         else "operations"),
            "library_ms": tot["library_ms"] if k == "csr_segment_sum"
            else None,
        })
    return rows


# rows in flight per warp of the gather probe, and a table that L2 holds
# (the card's L2 is 50 MB; above this a table is read from device memory)
PROBE_U = (1, 2, 4, 8, 16)
L2_TABLE_BYTES = 25e6


def probe_streams(layouts, cg):
    """{name: (table rows, index stream int32)}: the gathers of the CSC sum
    on the merged GAT layer's Gene and SNP groups (g rows, dst[csc_perm] %
    N), and of segment_softmax_spmm_fwd on a SNP -> Gene relation and the
    merged SNP group's source table (xs rows, src)."""
    from kgwas_tpu_torch.ops.segment import csc_rows_of

    out = {}
    for t in ("Gene", "SNP"):
        L = layouts[t]
        out[f"CSC {t} (g {L.n_rows_per_rel} rows)"] = (
            L.n_rows_per_rel,
            csc_rows_of(L.dst, L.csc_perm, L.n_rows_per_rel, True))
    rk = next(k for k, r in cg.relations.items()
              if r.src_type == "SNP" and r.dst_type == "Gene")
    r = cg.relations[rk]
    out[f"{rk} (xs {cg.padded_nodes['SNP']} rows)"] = (
        cg.padded_nodes["SNP"], r.src)
    L = layouts["SNP"]
    out[f"merged SNP src (xs_all {L.n_src_total} rows)"] = (L.n_src_total,
                                                            L.src)
    return {k: (int(n), np.ascontiguousarray(i, dtype=np.int32))
            for k, (n, i) in out.items()}


def probe_call(fn, table, idx, u, per_warp=256):
    """(a gather_probe launch over the int32 indices idx into table [S,
    128], u rows in flight a warp and per_warp indices a warp, its output
    [warps, 128])."""
    n = idx.numel()
    out = torch.empty(-(-n // per_warp), HIDDEN, device=table.device)

    def go():
        err = fn(table.data_ptr(), idx.data_ptr(), n, per_warp,
                 out.data_ptr(), u, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"gather_probe: cudaError {err}")
    return go, out


def phase_probe(build, layouts, cg, device, card, bf16=False):
    """Phase 1b: the gather ceiling. gather_probe.cu sums random 512-byte
    rows (float4 a lane, a warp a row, U rows in flight a warp) from a
    random table, in the order of the real layouts' index streams and of a
    shuffled copy of each; with bf16, 256-byte bf16 rows (8 bytes a lane:
    the bf16 instances' gather). Returns {"l2": TB/s, "hbm": TB/s}: the
    best rate over U on the real orders from a table that L2 holds and
    from one it does not."""
    fn = build.library("gather_probe_bf16" if bf16 else "gather_probe")
    rng = np.random.default_rng(SEED + 9)
    gen = torch.Generator(device=device).manual_seed(SEED + 9)
    best = {"l2": 0.0, "hbm": 0.0}
    label = " (bf16)" if bf16 else ""
    for name, (n_rows, idx) in probe_streams(layouts, cg).items():
        table = torch.randn(n_rows, HIDDEN, device=device, generator=gen)
        if bf16:
            table = table.to(torch.bfloat16)
        row_bytes = HIDDEN * table.element_size()
        kind = "l2" if n_rows * row_bytes <= L2_TABLE_BYTES else "hbm"
        for order in ("real", "shuffled"):
            i = idx if order == "real" else rng.permutation(idx)
            i = torch.from_numpy(i).to(device)
            n = i.numel()
            rates = {}
            for u in PROBE_U:
                go, out = probe_call(fn, table, i, u)
                ms = cuda_ms(go, 20)
                rates[u] = n * row_bytes / (ms * 1e-3) / 1e12
            want = table[i.long()].float().sum(0)
            got = out.sum(0)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=1e-3, atol=1e-2 * n ** 0.5):
                raise AssertionError(f"gather_probe {name}: wrong sums")
            top = max(rates, key=rates.get)
            if order == "real":
                best[kind] = max(best[kind], rates[top])
            log(f"  probe{label} {name}, {order} order, {n} rows of "
                f"{row_bytes} B from a {n_rows * row_bytes / 1e6:.1f} MB "
                f"table ({kind}): "
                + ", ".join(f"U={u} {r:.3f} TB/s" for u, r in rates.items())
                + f"; best U={top}")
        del table
    log(f"phase 1b{label} ok [{card}]: gather ceiling {best['l2']:.3f} TB/s "
        f"from a table L2 holds, {best['hbm']:.3f} TB/s from device memory")
    return best


def gather_floors(cg, layouts, rates):
    """The gather floor of each layer kernel over one forward or step: its
    gathered rows (one 512-byte row per edge, pad edges included) over the
    probe's rate for its table (L2 or device memory). Logs and returns
    {kernel: ms}."""
    def ms(edges, table_rows):
        kind = ("l2" if table_rows * HIDDEN * 4 <= L2_TABLE_BYTES
                else "hbm")
        return edges * HIDDEN * 4 / (rates[kind] * 1e12) * 1e3

    # the groups that reach the head: Gene once and SNP twice (GCN: once)
    live = {"Gene": 1, "SNP": 2}
    merged = sum(k * ms(len(layouts[t].src), layouts[t].n_src_total)
                 for t, k in live.items())
    csc = sum(k * ms(len(layouts[t].src), layouts[t].n_rows_per_rel)
              for t, k in live.items())
    rel_fwd = rel_csc = 0.0
    for t, k in live.items():
        for rk in layouts[t].rel_keys:
            r = cg.relations[rk]
            rel_fwd += k * ms(len(r.src), cg.padded_nodes[r.src_type])
            rel_csc += k * ms(len(r.src), cg.padded_nodes[r.dst_type])
    # the 'mp' path: the CSR sum gathers x rows of the merged source table,
    # the CSC sum g rows of the unfolded [R*N, D] cotangent; SAGE runs
    # Gene once and SNP twice, GCN each once
    def mp(kind, counts):
        return sum(k * ms(len(layouts[t].src), layouts[t].n_src_total
                          if kind == "csr" else layouts[t].n_rows_total)
                   for t, k in counts.items())

    gcn = dict.fromkeys(live, 1)
    floors = {"merged_gat_fwd": merged, "merged_gat_bwd": merged,
              "csc_segment_sum (GAT sum)": csc,
              "segment_softmax_spmm_fwd": rel_fwd,
              "segment_softmax_spmm_bwd": rel_fwd,
              "csc_segment_sum (GAT max)": rel_csc,
              "csr_segment_sum (SAGE)": mp("csr", live),
              "csr_segment_sum (GCN)": mp("csr", gcn),
              "csc_segment_sum (SAGE)": mp("csc", live),
              "csc_segment_sum (GCN)": mp("csc", gcn)}
    log("  gather floors per forward or step: "
        + "; ".join(f"{k} {v:.4f} ms" for k, v in floors.items()))
    return floors


def stream_of(host_layouts, dev_layouts, cg, layout):
    """(host arrays, label) of a DeviceLayout: a merged group's, or one
    relation's; the host arrays are stream_without_trash's arguments."""
    for t, DL in dev_layouts.items():
        if DL is layout:
            L = host_layouts[t]
            return ((L.src, L.dst, L.row_offsets, L.csc_perm, L.csc_offsets,
                     L.n_rows_per_rel, cg.num_nodes[t], L.src_base,
                     len(L.rel_keys)), t)
        for rk, RL in zip(DL.rel_keys, DL.relations or ()):
            if RL is layout:
                r = cg.relations[rk]
                return ((r.src, r.dst, r.row_offsets, r.csc_perm,
                         r.csc_offsets, cg.padded_nodes[r.dst_type],
                         cg.num_nodes[r.dst_type],
                         (0, cg.padded_nodes[r.src_type]), 0), rk)
    raise KeyError("a launch on an unknown layout")


# max_edges of the segment kernels' schedules timed beside each layout's
# own (the kernels stage at most 256 edges an item: kBwdMaxEdges)
SEGMENT_SWEEP = (64, 128, 256)


def launch_stream(kernel, args, host_layouts, dev_layouts, cg, device):
    """(label, the layout a segment kernel's launch read, the launch's stream
    without trash rows and its kept edges' mask) of one recorded call."""
    from kgwas_tpu_torch.ops import schedule

    if kernel == "csc_segment_sum":
        layout, fold = args[5], (args[6] if len(args) > 6 else 0)
    elif kernel == "csr_segment_sum":
        layout, fold = next(DL for DL in dev_layouts.values()
                            if DL.src is args[1]), 0
    else:
        layout, fold = next(RL for DL in dev_layouts.values()
                            for RL in (DL.relations or ())
                            if RL.src is args[1]), 0
    host, label = stream_of(host_layouts, dev_layouts, cg, layout)
    row_edges = ((schedule.CSR_MAX_EDGES, schedule.CSR_CHUNK_EDGES)
                 if kernel == "csr_segment_sum" else ())
    lay_nt, keep = stream_without_trash(*host[:-1], fold, device, row_edges)
    return label, layout, host, lay_nt, keep


def segment_launches(cfg_name, kernel, calls, host_layouts, dev_layouts, cg,
                     device, parent, reps=10):
    """One segment kernel (#6 segment_softmax_spmm_fwd, #7 _bwd, #8
    csc_segment_sum, #10 csr_segment_sum) launch by launch, on the recorded
    calls [(args, kwargs)] of one forward or step: host-paced (cuda_ms, the
    launches issued one by one from Python, as a step issues them) and
    device time (graph_ms) of each form:

      ms: the kernel as it runs;
      no_trash: without its trash rows' pad edges;
      max_edges K: on a schedule of another max_edges of SEGMENT_SWEEP;
      gather_only (#8): w and dz dropped, its gather alone;
      probe (#10): gather_probe.cu over the launch's index stream from its
        table, its best rows in flight: the gather without the writes;
      with KGWAS_PARENT_CSRC, parent and parent_no_trash: the earlier
        kernel through its own wrapper.

    Logs each launch and returns the totals {form: [ms, device ms]}."""
    from kgwas_tpu_torch.ops import build, schedule, segment, segment_softmax

    fns = {"segment_softmax_spmm_fwd": (
               segment_softmax.segment_softmax_spmm_fwd,
               parent.seg_fwd if parent else None),
           "segment_softmax_spmm_bwd": (
               segment_softmax.segment_softmax_spmm_bwd,
               parent.seg_bwd if parent else None),
           "csc_segment_sum": (segment.csc_segment_sum,
                               parent.csc if parent else None),
           "csr_segment_sum": (segment.csr_segment_sum,
                               parent.csr if parent else None)}
    fn, pfn = fns[kernel]
    tot = {}
    for i, (args, kwargs) in enumerate(calls):
        args = detached(args)
        label, layout, host, lay_nt, keep = launch_stream(
            kernel, args, host_layouts, dev_layouts, cg, device)
        forms = {"ms": lambda a=args, k=kwargs: fn(*a, **k)}  # noqa: E731
        if kernel == "csc_segment_sum":
            g, w, dz, xs, att, _ = args[:6]
            fold = args[6] if len(args) > 6 else 0
            nt_args = (g, None if w is None else w[keep],
                       None if dz is None else dz[keep], xs, att, lay_nt,
                       fold)
            nt_kw = {}
            own = layout.csc_schedule.max_edges
            forms["no_trash"] = lambda: fn(*nt_args)  # noqa: B023, E731
            forms["gather_only"] = lambda a=args, f=fold: fn(  # noqa: E731
                a[0], None, None, a[3], None, a[5], f)
            for k in SEGMENT_SWEEP:
                if k != own:
                    lay_k = dataclasses.replace(
                        layout, csc_schedule=segment.csc_schedule(
                            host[4], host[7], k).to(device))
                    forms[f"max_edges {k}"] = (
                        lambda a=args, lk=lay_k: fn(*a[:5], lk, *a[6:]))  # noqa: E731
        else:
            # the row kernels: (table, src, [logits,] row_offsets, ...)
            nt_args = list(args)
            nt_args[1] = lay_nt.src
            if kernel == "csr_segment_sum":
                nt_args[2] = lay_nt.row_offsets
                if args[3] is not None:
                    nt_args[3] = args[3][keep]
                edges = (schedule.CSR_CHUNK_EDGES,)
            else:
                nt_args[2] = args[2][keep]
                nt_args[3] = lay_nt.row_offsets
                edges = ()
            nt_kw = {"sched": lay_nt.row_schedule}
            own = kwargs["sched"].max_edges
            forms["no_trash"] = lambda: fn(*nt_args, **nt_kw)  # noqa: B023, E731
            for k in SEGMENT_SWEEP:
                if k != own:
                    sk = schedule.row_schedule(host[2], k, *edges).to(device)
                    forms[f"max_edges {k}"] = (
                        lambda a=args, sk=sk: fn(*a, sched=sk))  # noqa: E731
            if kernel == "csr_segment_sum":
                probe = build.library("gather_probe")
                best = None
                for u in PROBE_U:
                    go, _ = probe_call(probe, args[0], args[1], u)
                    t = graph_ms(go, reps)
                    if best is None or t < best[0]:
                        best = (t, go)
                forms["probe"] = best[1]
        if parent:
            forms["parent"] = lambda a=args, k=kwargs: pfn(*a, **k)  # noqa: E731
            forms["parent_no_trash"] = lambda: pfn(*nt_args, **nt_kw)  # noqa: B023, E731
        ms = {k: (cuda_ms(f, reps), graph_ms(f, reps))
              for k, f in forms.items()}
        for k, (h, d) in ms.items():
            t = tot.setdefault(k, [0.0, 0.0])
            t[0] += h
            t[1] += d
        log(f"  {cfg_name} {kernel} launch {i} {label}: "
            f"{int(layout.csc_perm.numel())} edges, {int(keep.sum())} "
            f"without trash rows, max_edges {own}: "
            + ", ".join(f"{k} {h:.4f} ms [{d:.4f}]"
                        for k, (h, d) in ms.items()))
    log(f"  {cfg_name} {kernel} x{len(calls)} per "
        f"{'step' if kernel.endswith(('bwd', 'csc_segment_sum')) else 'forward'}"
        " (host-paced ms [device ms]): "
        + ", ".join(f"{k} {h:.4f} [{d:.4f}]" for k, (h, d) in tot.items()))
    return tot


def step_times(step, n=10, warm=2):
    """Median ms of n calls of step after warm ones, CUDA events around
    each call."""
    times = []
    for _ in range(warm + n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times[warm:])


def step_vs_parent(cfg_name, step, parent, what="train step", rounds=3):
    """The train step (or another call: what) with this checkout's segment
    kernels and with the earlier ones (parent.model_kernels), in one call,
    alternating new, earlier, earlier, new, rounds times: step_times of
    each run. Logs both lists and returns (new medians, earlier
    medians)."""
    new, old = [], []
    for _ in range(rounds):
        new.append(step_times(step))
        for _ in range(2):
            with parent.model_kernels():
                old.append(step_times(step))
        new.append(step_times(step))
    log(f"  {cfg_name} {what}, this checkout's segment kernels vs the "
        f"earlier ones alternating: new "
        + " ".join(f"{t:.3f}" for t in new) + " ms (median "
        f"{statistics.median(new):.3f}), earlier "
        + " ".join(f"{t:.3f}" for t in old) + " ms (median "
        f"{statistics.median(old):.3f})")
    return new, old


def phase_serve(kt, data, cg, device, card, parent, tmp):
    """Phases 3 and 4: the serving slice at full width, then its timing.
    Returns phase 4's merged_gat_fwd totals and its worst abs err."""
    from kgwas_tpu_torch.engine.checkpoint import save_model
    from kgwas_tpu_torch.ops import gat_layer
    from kgwas_tpu_torch.stats.calibration import finalize_predictions
    from kgwas_tpu_torch.utils import write_table

    run = kt.KGWAS(data, exp_name="chip_smoke", seed=SEED)
    run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN)
    ckpt = tmp / "full" / "model" / "chip_smoke"
    save_model(run.model.state_dict(), run.config, str(ckpt))
    served = kt.KGWAS(data, exp_name="chip_smoke", seed=SEED + 1)
    served.load_pretrained(str(ckpt))
    for k, v in run.model.state_dict().items():
        if not torch.equal(v, served.model.state_dict()[k]):
            raise AssertionError(f"checkpoint round trip changed {k}")
    for t, L in served.layouts.items():
        log(f"  group {t:18s} R={len(L.rel_keys)} E_tot={len(L.src)} "
            f"rows={L.n_rows_total} src_rows={L.n_src_total}")
    live, _ = served.model.live_groups(served.layouts)
    per_forward = sum(len(g) for g in live)
    log(f"  groups per layer that reach the head: {live}")

    served.predict_all()   # first call: device state, allocator warm-up
    torch.cuda.synchronize()
    gat_layer.launches = 0
    pred = served.predict_all()
    launches = gat_layer.launches
    if launches != per_forward:
        raise AssertionError(
            f"predict_all launched the kernel {launches} times, expected "
            f"{per_forward}")
    log(f"  predict_all launched merged_gat_fwd {launches} times")
    if pred.shape != (cg.num_nodes["SNP"],) or not np.isfinite(pred).all():
        raise AssertionError(f"bad predictions: shape {pred.shape}")
    with swapped(gat_layer,
                 merged_gat_forward=without_sched(
                     gat_layer.merged_gat_forward_plain)):
        pred_plain = served.predict_all()
    np.testing.assert_allclose(pred, pred_plain, rtol=PRED_RTOL,
                               atol=PRED_ATOL)
    pred_err = float(np.abs(pred - pred_plain).max())
    log(f"  predict_all vs plain layer op: max abs err {pred_err:.3e}; "
        f"{float((pred > 0).mean()):.3f} of preds > 0, "
        f"range [{pred.min():.4g}, {pred.max():.4g}]")
    t0 = time.perf_counter()
    table, scale = finalize_predictions(data.lr_uni, pred[data.all_ids])
    tail_ms = (time.perf_counter() - t0) * 1e3
    kp = table["KGWAS_P"]
    if not (np.isfinite(kp).all() and (kp >= 0).all() and (kp <= 1).all()):
        raise AssertionError("KGWAS_P not finite in [0, 1]")
    write_table(table, str(ckpt / "pred.csv"))
    log(f"phase 3 ok: {len(kp)} KGWAS_P finite in [0, 1], scale factor "
        f"{scale}, min KGWAS_P {kp.min():.4g}; finalize_predictions "
        f"{tail_ms:.1f} ms on the host")

    # ---- phase 4: timing
    torch.cuda.reset_peak_memory_stats()
    fwd_ms = []
    for _ in range(12):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        served.predict_all()
        stop.record()
        torch.cuda.synchronize()
        fwd_ms.append(start.elapsed_time(stop))
    fwd_ms = statistics.median(fwd_ms[2:])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile_device(served.predict_all, fwd_ms, "forward")
    edges = cg.total_real_edges()
    rec = Recorder(gat_layer.merged_gat_forward)
    with swapped(gat_layer, merged_gat_forward=rec):
        served.predict_all()
    dev_layouts = served._device_state()[2]
    tot = dict.fromkeys(("ms", "device_ms", "ms_no_trash", "plain_ms",
                         "bound_ms", "bytes", "operations", "parent_ms",
                         "parent_no_trash"), 0.0)
    worst_full = 0.0
    sweep = {k: 0.0 for k in SWEEP_MAX_EDGES}
    for i, (args, kwargs) in enumerate(rec.calls):
        xs, src, ro, att, a_dst, n_per_rel, fold = args[:7]
        dst_t = group_of(dev_layouts, src)
        # the layout's schedule, built when the layout was: no host work in
        # the timed window
        if kwargs.get("sched") is None:
            raise AssertionError("the layer op launched without a schedule")
        call = lambda: gat_layer.merged_gat_forward(*args, **kwargs)  # noqa: E731
        plain = lambda: gat_layer.merged_gat_forward_plain(*args)  # noqa: E731
        ms = cuda_ms(call, 20)
        dev_ms = graph_ms(call, 20)
        plain_ms = cuda_ms(plain, 5)
        got, want = call(), plain()
        n_real = cg.num_nodes[dst_t]
        for j, name in enumerate(("out", "row_max", "row_sum")):
            a, _ = compare(got[j], want[j],
                           trash_mask(got[j].shape[0], n_per_rel, n_real),
                           f"full-width {dst_t} launch {i} {name}")
            worst_full = max(worst_full, a)
        t_bytes, t_ops = layer_bound(xs, src, ro, att, a_dst, got[0])
        bound = max(t_bytes, t_ops)
        by = "bytes" if t_bytes >= t_ops else "operations"
        tot["bytes"] += t_bytes
        tot["operations"] += t_ops
        tot["ms"] += ms
        tot["device_ms"] += dev_ms
        tot["plain_ms"] += plain_ms
        tot["bound_ms"] += bound
        # the same launch without the trash rows' (pad) edges, its schedule
        # built beforehand: how much of the kernel time the longest rows take
        src_nt, ro_nt = without_trash_rows(served.layouts[dst_t], n_real)
        sched_nt = gat_layer.schedule(ro_nt, n_per_rel, fold).to(device)
        args_nt = (xs, src_nt.to(device), ro_nt.to(device)) + args[3:]
        ms_nt = cuda_ms(lambda: gat_layer.merged_gat_forward(  # noqa: B023
            *args_nt, sched=sched_nt), 20)  # noqa: B023
        tot["ms_no_trash"] += ms_nt
        # other max_edges, schedules built beforehand
        scheds = {k: gat_layer.schedule(served.layouts[dst_t].row_offsets,
                                        n_per_rel, fold, k).to(device)
                  for k in SWEEP_MAX_EDGES}
        k_ms = {k: cuda_ms(lambda: gat_layer.merged_gat_forward(  # noqa: B023
            *args, sched=sc), 20) for k, sc in scheds.items()}  # noqa: B023
        for k, v in k_ms.items():
            sweep[k] += v
        old = ""
        if parent:   # the earlier kernel on the same launch, this call
            p_ms = cuda_ms(lambda: parent.fwd(*args, **kwargs), 20)  # noqa: B023
            p_nt = cuda_ms(lambda: parent.fwd(  # noqa: B023
                *args_nt, sched=sched_nt), 20)  # noqa: B023
            tot["parent_ms"] += p_ms
            tot["parent_no_trash"] += p_nt
            old = f" | earlier kernel {p_ms:.4f} ms (without trash rows {p_nt:.4f})"
        deg = np.diff(served.layouts[dst_t].row_offsets)
        per_node = deg.reshape(-1, n_per_rel).sum(0)
        sc = kwargs["sched"]
        log(f"  launch {i} {dst_t:18s} kernel {ms:.4f} ms (device "
            f"{dev_ms:.4f}; without trash rows {ms_nt:.4f}){old} | plain "
            f"{plain_ms:.4f} "
            f"ms | bound {bound:.4f} ms ({by}) | E_tot {src.numel()} | edges "
            f"per node: mean {per_node.mean():.1f}, max {per_node.max()} "
            f"(the trash node {n_real}: {per_node[n_real]}) | schedule "
            f"max_edges {sc.max_edges}: {sc.items.shape[0]} items, "
            f"{sc.split_units.numel()} units in {sc.n_parts} chunks | "
            "other max_edges: " + ", ".join(f"{k}: {v:.4f} ms"
                                            for k, v in k_ms.items()))
    rate = edges * LAYERS / (fwd_ms / 1e3)
    old = (f"; earlier kernel {tot['parent_ms']:.4f} ms (without trash rows "
           f"{tot['parent_no_trash']:.4f})" if parent else "")
    log(f"phase 4 [{card}]: forward (predict_all) {fwd_ms:.3f} ms median of "
        f"10; forward edge-traversals/s {rate:.4g} ({edges} real edges x "
        f"{LAYERS} layers); kernel {tot['ms']:.4f} ms (device "
        f"{tot['device_ms']:.4f}; without trash rows "
        f"{tot['ms_no_trash']:.4f}){old} / plain "
        f"{tot['plain_ms']:.4f} ms / bound {tot['bound_ms']:.4f} ms per "
        f"forward ({len(rec.calls)} launches; with max_edges "
        + ", ".join(f"{k}: {v:.4f}" for k, v in sweep.items())
        + f"); peak memory {peak_gb:.2f} GB")
    return tot, worst_full


# ---- phases 7 and 8: interpretation, the bench and the training trace

# hit SNPs phase 7 wants under its variant_threshold
INTERP_HITS = (100, 2000)
# the JAX package's ThroughputMeter record keys, metrics_log's lines
METRICS_KEYS = ["epoch", "steps", "epoch_time_s", "edges_per_sec", "loss",
                "val_mse", "val_pearsonr"]
# the device entry that names each kernel of the training step in a trace
TRACE_KERNELS = {"merged_gat_fwd": "merged_gat_fwd_kernel",
                 "merged_gat_bwd": "merged_gat_bwd_kernel",
                 "csc_segment_sum": "csc_items_kernel"}


def hit_threshold(kgwas_res):
    """The default variant_threshold 5e-8 where it leaves 100-2000 hit
    SNPs, else the P value below which at most 1000 SNPs lie."""
    p = np.asarray(kgwas_res["P"], dtype=np.float64)
    if INTERP_HITS[0] <= int((p < 5e-8).sum()) <= INTERP_HITS[1]:
        return 5e-8
    return float(np.sort(p)[1000])


def interpret(run, thr, plain):
    """KGWAS.get_disease_critical_network(thr) with the merged GAT forward
    (or, plain, its plain version) recorded. Returns (tables, alphas per
    layer, the forward's recorded calls and results, launches, stage host
    seconds, and with plain the z tables' weight_slack, else None)."""
    from kgwas_tpu_torch.interpret import attention, network
    from kgwas_tpu_torch.ops import gat_layer

    fwd = Recorder(without_sched(gat_layer.merged_gat_forward_plain) if plain
                   else gat_layer.merged_gat_forward, keep_outputs=True)
    alphas = Recorder(run.model.collect_attention, keep_outputs=True)
    forward = HostTimer(alphas, sync=True)
    tables = HostTimer(attention.attention_tables)
    zrec = Recorder(network._zscore, keep_outputs=True)
    zmax = [HostTimer(zrec), HostTimer(network._max_over_parallel)]
    local = HostTimer(network.get_local_interpretation)
    run.model.collect_attention = forward
    gat_layer.launches = 0
    t0 = time.perf_counter()
    try:
        with swapped(gat_layer, merged_gat_forward=fwd), \
                swapped(attention, attention_tables=tables), \
                swapped(network, _zscore=zmax[0], _max_over_parallel=zmax[1],
                        get_local_interpretation=local):
            out = run.get_disease_critical_network(variant_threshold=thr)
    finally:
        del run.model.collect_attention
    stages = {"forward": forward.seconds,
              "attention_tables": tables.seconds - forward.seconds,
              "z/max tables": sum(z.seconds for z in zmax),
              "local interpretation": local.seconds}
    total = time.perf_counter() - t0
    # generate_viz's filters, id columns and row index
    stages["other"] = total - sum(stages.values())
    stages["total"] = total
    slack = weight_slack(zrec.outputs) if plain else None
    return out, alphas.outputs[0], fwd, gat_layer.launches, stages, slack


def weight_slack(ztables):
    """(h_type, t_type) -> (sorted (h_idx, t_idx) keys, slack) from the
    z tables of one interpretation run: for each pair, the most that a
    weight within the network weight check's tolerance (RTOL, ATOL) moves
    its z = (weight - mean) / std, over the pair's parallel relations.
    The plain version sums in no fixed order, so its own runs differ by
    that much, and a z near 0 magnifies it past PRED_RTOL and PRED_ATOL."""
    parts = {}
    for t in ztables:
        if not len(t["weight"]):
            continue
        with np.errstate(divide="ignore", invalid="ignore"):
            s = (ATOL + RTOL * np.abs(np.asarray(t["weight"], np.float64))
                 ) / np.asarray(t["rel_type_std"], np.float64)
        s[~np.isfinite(s)] = 0.0
        key = (np.asarray(t["h_idx"], np.int64) << 32) | np.asarray(
            t["t_idx"], np.int64)
        parts.setdefault((t["h_type"][0], t["t_type"][0]), []).append(
            (key, s))
    out = {}
    for pair, kv in parts.items():
        keys, inv = np.unique(np.concatenate([k for k, _ in kv]),
                              return_inverse=True)
        s = np.zeros(len(keys))
        np.maximum.at(s, inv, np.concatenate([v for _, v in kv]))
        out[pair] = (keys, s)
    return out


def row_slack(t, slack):
    """Each row's weight slack (weight_slack) by its types and indices."""
    out = np.zeros(len(t["h_idx"]))
    key = (np.asarray(t["h_idx"], np.int64) << 32) | np.asarray(
        t["t_idx"], np.int64)
    for (h_type, t_type), (keys, s) in slack.items():
        sel = ((np.asarray(t["h_type"]) == h_type)
               & (np.asarray(t["t_type"]) == t_type))
        i = np.minimum(np.searchsorted(keys, key[sel]), len(keys) - 1)
        out[sel] = np.where(keys[i] == key[sel], s[i], 0.0)
    return out


def same_rows(a, b, float_col, rtol=PRED_RTOL, atol=PRED_ATOL):
    """Two column tables hold the same rows in the same order, floats
    within tolerance (atol a number or one for each row; NaN and inf in
    the same places)."""
    if list(a) != list(b) or len(a[float_col]) != len(b[float_col]):
        return False
    for c in a:
        x, y = np.asarray(a[c]), np.asarray(b[c])
        if c != float_col:
            if not np.array_equal(x, y):
                return False
            continue
        fin = np.isfinite(y)
        if not (np.array_equal(np.isfinite(x), fin)
                and np.array_equal(x[~fin], y[~fin], equal_nan=True)
                and np.all(np.abs(x[fin] - y[fin])
                           <= np.broadcast_to(atol, y.shape)[fin]
                           + rtol * np.abs(y[fin]))):
            return False
    return True


def near_ties(a, b, group, float_col, what, slack):
    """(0, 0) when the tables hold the same rows in order; else the number
    of groups (rows sharing the group columns) whose rows differ, each
    only at a near-tie: the same largest float_col value within tolerance
    (a pair whose kept relation differs, a neighbourhood whose genes
    differ), and the number of groups with the same rows whose float_col
    values need b's row_slack beside PRED_ATOL. The near-tie test grants
    the slack too. Raises beyond that, or past 1% of the groups."""
    if same_rows(a, b, float_col):
        return 0, 0

    def grouped(t):
        rows = {}
        for i, k in enumerate(zip(*(np.asarray(t[c]).tolist()
                                    for c in group))):
            rows.setdefault(k, []).append(i)
        return rows

    ga, gb = grouped(a), grouped(b)
    if ga.keys() != gb.keys():
        raise AssertionError(f"{what}: the groups differ")
    ties = slacked = 0
    for k, ra in ga.items():
        ta = {c: np.asarray(v)[ra] for c, v in a.items()}
        tb = {c: np.asarray(v)[gb[k]] for c, v in b.items()}
        if same_rows(ta, tb, float_col):
            continue
        atol = PRED_ATOL + row_slack(tb, slack)
        if same_rows(ta, tb, float_col, atol=atol):
            slacked += 1
            continue
        if not same_rows({"m": [np.nanmax(ta[float_col])]},
                         {"m": [np.nanmax(tb[float_col])]}, "m",
                         atol=atol.max()):
            raise AssertionError(f"{what}: group {k} differs beyond a "
                                 "near-tie")
        ties += 1
    if ties > max(1, 0.01 * len(ga)):
        raise AssertionError(f"{what}: {ties} near-ties of {len(ga)} groups")
    return ties, slacked


def interpret_vs_plain(run, cg, thr, folded, what):
    """Phase 7 on one model: get_disease_critical_network through the
    kernel, counts set to 0 just before, then with the plain version on the
    same card. Holds each forward launch against the plain version on its
    inputs, α (layer 1 bitwise: the same tensor code on the same inputs;
    layer 2 on layer 1's outputs at RTOL/ATOL) and the three tables.
    folded: each launch folds its group's R slot rows (sum, mean), else
    fold 0 (max, min). Returns the launches."""
    from kgwas_tpu_torch.ops import gat_layer

    _, _, layouts = run._device_state()
    got, alpha_k, rec, launches, stages, _ = interpret(run, thr, plain=False)
    want, alpha_p, _, plain_launches, _, slack = interpret(run, thr,
                                                          plain=True)
    torch.cuda.synchronize()
    n_groups = len(layouts) * LAYERS
    if launches != n_groups or plain_launches != 0:
        raise AssertionError(f"{what}: merged_gat_fwd launched {launches} "
                             f"times (plain run {plain_launches}), expected "
                             f"{n_groups}")
    worst = 0.0
    for (args, kwargs), outs in zip(rec.calls, rec.outputs):
        dst_t = group_of(layouts, args[1])
        n, n_real = args[5], cg.num_nodes[dst_t]
        sched = kwargs["sched"]
        fold = len(layouts[dst_t].rel_keys) if folded else 0
        if args[6] != fold or args[7] != "raw" or sched is None or (
                sched.fold_slots != (fold or 1)):
            raise AssertionError(f"{what} {dst_t}: launched with fold "
                                 f"{args[6]}, mode {args[7]}, schedule "
                                 f"{sched and sched.fold_slots}")
        plain = gat_layer.merged_gat_forward_plain(*args)
        for name, a, b in zip(("out", "row_max", "row_sum"), outs, plain):
            err, _ = compare(a, b, trash_mask(a.shape[0], n, n_real),
                             f"{what} {dst_t} {name}")
            worst = max(worst, err)
    for li, (ak, ap) in enumerate(zip(alpha_k, alpha_p)):
        if list(ak) != list(ap):
            raise AssertionError(f"{what}: layer {li + 1} relations differ")
        for rk in ak:
            if li == 0 and not torch.equal(ak[rk], ap[rk]):
                raise AssertionError(f"{what} l1 {rk}: α differs")
            err, _ = compare(ak[rk], ap[rk], np.zeros(len(ak[rk]), bool),
                             f"{what} l{li + 1} {rk} α")
            worst = max(worst, err)
    nw, vi, dcn = got
    if not same_rows(nw, want[0], "weight", RTOL, ATOL):
        raise AssertionError(f"{what}: the network weight tables differ")
    if set(nw["layer"]) != {"l1", "l2"} or len(set(nw["t_type"])) != 5:
        raise AssertionError(f"{what}: layers {set(nw['layer'])}, t_types "
                             f"{set(nw['t_type'])}")
    if not len(dcn["h_idx"]) or not len(vi["h_idx"]) or not np.isfinite(
            nw["weight"]).all():
        raise AssertionError(f"{what}: empty tables or a non-finite weight")
    if not set(dcn["Category"]) <= {"V2G", "G2G", "G2P"} or any(
            r.startswith("rev_") for r in dcn["rel_type"]):
        raise AssertionError(f"{what}: bad Category or rel_type")
    (ties, slacked) = zip(
        near_ties(dcn, want[2], ("Category", "h_idx", "t_idx"),
                  "importance", f"{what} disease-critical network", slack),
        near_ties(vi, want[1], ("QUERY_SNP",), "importance",
                  f"{what} variant interpretation", slack))
    hits = len(set(vi["QUERY_SNP"]))
    log(f"  phase 7 {what}: variant_threshold {thr:.3g}; merged_gat_fwd "
        f"raw {'fold R' if folded else 'fold 0'} x{launches} vs plain "
        f"within tolerance (worst abs err {worst:.3e}), α layer 1 bitwise; "
        f"tables: network weight "
        f"{len(nw['h_idx'])} rows, disease-critical network "
        f"{len(dcn['h_idx'])}, variant interpretation {len(vi['h_idx'])} "
        f"rows over {hits} hit SNPs, equal to the plain run's up to near-ties "
        f"{ties} (groups within the weight slack {slacked}); host s: "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))
    return launches


def phase_interpret(kt, trainer, cg, card, tmp):
    """Phase 7: KGWAS.get_disease_critical_network on phase 5's trained
    full-width model and its KGWAS_P table (GAT sum: fold R), then on a
    GAT-max model of the 20k-SNP KG (fold 0), each against the plain
    version on the same card."""
    t0 = time.perf_counter()
    thr = hit_threshold(trainer.kgwas_res)
    n_hits = int((np.asarray(trainer.kgwas_res["P"]) < thr).sum())
    log(f"phase 7: {n_hits} hit SNPs under variant_threshold {thr:.3g}")
    fold_r = interpret_vs_plain(trainer, cg, thr, True, "GAT-sum full width")
    data = kt.KGWAS_Data.from_synthetic(
        seed=SEED + 1, data_path=str(tmp / "interpret"), **SMALL_KG)
    data.load_synthetic_gwas(seed=SEED)
    data.process_gwas_file()
    run = kt.KGWAS(data, exp_name="chip_smoke_interpret", seed=SEED)
    run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN,
                         gnn_aggr="max", no_relu=True)
    run.kgwas_res = {"ID": data.lr_uni["ID"], "P": data.lr_uni["P"]}
    fold_0 = interpret_vs_plain(run, data.compile(),
                                hit_threshold(run.kgwas_res), False,
                                "GAT-max 20k SNPs")
    log(f"phase 7 ok [{card}]: interpretation through merged_gat_fwd raw "
        f"(fold R: {fold_r} launches, fold 0: {fold_0}); "
        f"{time.perf_counter() - t0:.1f} s")


def trace_idle_share(events):
    """1 - (the union of the device kernels' intervals / the trace's span
    from its first event to its last)."""
    spans = [(e["ts"], e["ts"] + e.get("dur", 0)) for e in events
             if "ts" in e and e.get("ph") == "X"]
    kernels = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                     if e.get("cat") == "kernel")
    busy, end = 0.0, -np.inf
    for a, b in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    window = max(b for _, b in spans) - min(a for a, _ in spans)
    return 1.0 - busy / window, busy / 1e3, window / 1e3


def phase_bench(kt, data, card, step_ms_5d, tmp):
    """Phase 8: the port's bench entry at its defaults (its JSON line
    printed here, on an earlier line), then KGWAS.train(epoch=1) over
    CMP_STEPS batches with profile_dir and metrics_log: the trace parses
    and names the three kernels of the step, the log holds one record with
    the JAX package's keys."""
    import io
    import shutil

    from kgwas_tpu_torch import bench_lib

    t0 = time.perf_counter()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        bench_lib.main()
    lines = out.getvalue().strip().split("\n")
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} lines")
    bench = json.loads(lines[0])
    print(lines[0], flush=True)
    if not (np.isfinite(bench["value"]) and bench["value"] > 0):
        raise AssertionError(f"bench value {bench['value']}")
    cfg = bench["config"]
    log(f"  phase 8 bench [{card}]: {bench['value']:.6g} training "
        f"edge-traversals/s, step_ms {cfg['step_ms']} (edge_pad "
        f"{cfg['edge_pad']}, {cfg['edges']} real edges) beside phase 5d's "
        f"train step {step_ms_5d:.3f} ms (edge padding 512); "
        f"{time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    data_v = copy.copy(data)
    data_v.train_mask = np.asarray(data.train_mask)[:CMP_STEPS * BATCH]
    run = kt.KGWAS(data_v, exp_name="chip_smoke_profile", seed=SEED)
    run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN)
    out_dir = tmp / "profile"
    shutil.rmtree(out_dir, ignore_errors=True)
    metrics = out_dir / "metrics.jsonl"
    run.train(batch_size=BATCH, epoch=1, lr=LR, save_best_model=False,
              profile_dir=str(out_dir / "trace"), metrics_log=str(metrics),
              scan_steps=0)
    traces = sorted((out_dir / "trace").glob("*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"{len(traces)} trace files")
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    names = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    found = {k: sum(entry in n for n in names)
             for k, entry in TRACE_KERNELS.items()}
    if not all(found.values()):
        raise AssertionError(f"the trace lacks kernels: {found}")
    with open(metrics) as f:
        recs = [json.loads(line) for line in f]
    if len(recs) != 1 or list(recs[0]) != METRICS_KEYS:
        raise AssertionError(f"metrics log {recs}")
    idle, busy_ms, window_ms = trace_idle_share(events)
    log(f"phase 8 ok [{card}]: KGWAS.train(epoch=1, {recs[0]['steps']} "
        f"steps) with profile_dir and metrics_log: trace "
        f"{traces[0].stat().st_size / 1e6:.1f} MB, {len(names)} kernel "
        f"events, entries {found}; device busy {busy_ms:.3f} ms of the "
        f"traced {window_ms:.3f} ms (idle {idle:.1%}); metrics record "
        f"{recs[0]}; {time.perf_counter() - t0:.1f} s")
    return bench


# ---- phase 9: the real-data path, a bundle in the real one's layout

# the share of SNPs with an enformer row, of genes with an esm row (5120
# wide), of SNPs in the LD-score files and of the KG's SNPs in the
# sumstats; and the sumstats' SNPs outside the KG
REAL_COVER = {"enformer": 0.99, "esm": 0.90, "ld": 0.98, "gwas": 0.98}
REAL_EXTRA_SNPS = 10_000
# KGWAS_Data's stages, timed inside the CLI's commands
REAL_STAGES = ("load_kg", "load_external_gwas", "process_gwas_file",
               "prepare_split", "compile")


def write_real_bundle(root):
    """A bundle with every REQUIRED_FILES entry under root: FULL_KG's raw
    relations (before standard_kg_transforms) under rs / ENSG / GO: ids,
    enformer (20 wide) and esm (5120 wide) rows for REAL_COVER's shares of
    the SNPs and genes, the two LD-score CSVs, the .bim and the two LD
    pickles; and a tab-separated fastGWA file: make_synthetic_sumstats'
    rows for REAL_COVER["gwas"] of the KG's SNPs and REAL_EXTRA_SNPS rows
    of SNPs outside it, shuffled. Returns (the sumstats' path, the rows of
    KG SNPs in it)."""
    from kgwas_tpu_torch.graph.synthetic import (GO_TYPES, make_synthetic_kg,
                                                 make_synthetic_sumstats)
    from kgwas_tpu_torch.kgwas_data import REQUIRED_FILES
    from kgwas_tpu_torch.utils import save_dict, take, write_table

    rng = np.random.default_rng(SEED + 9)
    g = make_synthetic_kg(seed=SEED, apply_transforms=False, **FULL_KG)
    n = {t: g.num_nodes(t) for t in g.node_features}
    ids = {"SNP": np.array([f"rs{i}" for i in range(n["SNP"])], dtype=object),
           "Gene": np.array([f"ENSG{i:011d}" for i in range(n["Gene"])],
                            dtype=object)}
    for k, t in enumerate(GO_TYPES):
        ids[t] = np.array([f"GO:{k * n[t] + i:07d}" for i in range(n[t])],
                          dtype=object)
    idx2id = {t: dict(enumerate(v.tolist())) for t, v in ids.items()}

    def path(rel):
        out = root / rel
        out.parent.mkdir(parents=True, exist_ok=True)
        return str(out)

    def some(t, share):
        return np.sort(rng.choice(n[t], int(share * n[t]), replace=False))

    save_dict(path("cell_kg/network/node_idx2id.pkl"), idx2id)
    save_dict(path("cell_kg/network/node_id2idx.pkl"),
              {t: {v: k for k, v in m.items()} for t, m in idx2id.items()})
    save_dict(path("cell_kg/network/edge_index.pkl"), dict(g.edge_index))
    for t, name, dim in (("SNP", "variant_emb/enformer_feat.pkl", 20),
                         ("Gene", "gene_emb/esm_feat.pkl", 5120)):
        keep = some(t, REAL_COVER["enformer" if t == "SNP" else "esm"])
        rows = rng.standard_normal((len(keep), dim), dtype=np.float32)
        save_dict(path(f"cell_kg/node_emb/{name}"),
                  dict(zip(ids[t][keep].tolist(), rows)))
    for name, lo, hi in (("filter_genotyped_ldscores.csv", 1.0, 100.0),
                         ("ldscores_from_data.csv", 0.5, 60.0)):
        keep = some("SNP", REAL_COVER["ld"])
        write_table({"SNP": ids["SNP"][keep],
                     "ldscore": rng.uniform(lo, hi, len(keep))},
                    path(f"ld_score/{name}"), sep=",")
    for name in ("ukb_white_ld_10MB_no_hla.pkl", "ukb_white_ld_10MB.pkl"):
        save_dict(path(f"ld_score/{name}"), {})
    cols = (rng.integers(1, 23, n["SNP"]).astype(str), ids["SNP"],
            np.linspace(0, 200, n["SNP"]).astype(str),
            np.arange(1, n["SNP"] + 1).astype(str))
    with open(path("misc_data/ukb_white_with_cm.bim"), "w") as f:
        f.write("".join(f"{c}\t{i}\t{m}\t{p}\tA\tG\n"
                        for c, i, m, p in zip(*cols)))
    missing = [f for f in REQUIRED_FILES if not (root / f).exists()]
    if missing:
        raise AssertionError(f"the bundle lacks {missing}")

    ss = take(make_synthetic_sumstats(n["SNP"], seed=SEED),
              some("SNP", REAL_COVER["gwas"]))
    n_kg = len(ss["SNP"])
    m = REAL_EXTRA_SNPS
    extra = {"CHR": rng.integers(1, 23, m),
             "SNP": np.array([f"rs{n['SNP'] + i}" for i in range(m)],
                             dtype=object),
             "POS": rng.integers(1, 2_000_000, m),
             "A1": np.full(m, "A", dtype=object),
             "A2": np.full(m, "G", dtype=object),
             "N": ss["N"][:1].repeat(m), "AF1": rng.uniform(0.05, 0.5, m),
             "BETA": rng.standard_normal(m) * 0.01, "SE": np.full(m, 0.01),
             "P": rng.uniform(0, 1, m)}
    order = rng.permutation(n_kg + m)
    ss = {k: np.concatenate([ss[k], extra[k]])[order] for k in ss}
    gwas = path("sumstats.fastGWA")
    write_table(ss, gwas, sep="\t")
    return gwas, n_kg


@contextlib.contextmanager
def timed_methods(cls, names, seconds):
    """Methods of cls wrapped for the duration of a with block, each
    adding the seconds of its calls to seconds[name]."""
    old = {k: getattr(cls, k) for k in names}

    def wrap(name, fn):
        @functools.wraps(fn)
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                seconds[name] = (seconds.get(name, 0.0)
                                 + time.perf_counter() - t0)
        return timed

    for k, fn in old.items():
        setattr(cls, k, wrap(k, fn))
    try:
        yield seconds
    finally:
        for k, fn in old.items():
            setattr(cls, k, fn)


def cli_call(cli, argv):
    """cli.main(argv), its printed lines logged with a prefix (none of them
    may pass for this script's own JSON lines); returns (what the command
    returned, its seconds)."""
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        result = cli.main(argv)
    seconds = time.perf_counter() - t0
    for line in out.getvalue().splitlines():
        log(f"    cli {argv[0]}: {line[:200]}")
    return result, seconds


def phase_real(kt, card, step_5d, tmp):
    """Phase 9: the real-data path at full width, through the CLI on the
    card: write the bundle, `train` one epoch (merged_gat_fwd,
    merged_gat_bwd and csc_segment_sum launched by the step), `predict`
    (bitwise the trained run's predict_all), `interpret` (a non-empty
    disease-critical network); each stage's host seconds; the train step
    on this KG (Gene rows 5120 wide) beside phase 5d's (128 wide), with
    the device idle share of each."""
    import shutil

    from kgwas_tpu_torch import cli, kgwas
    from kgwas_tpu_torch.engine.loop import epoch_batches, train_step
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.ops import gat_layer, segment
    from kgwas_tpu_torch.utils import n_rows

    root = tmp / "real"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    gwas, n_kg = write_real_bundle(root)
    write_s = time.perf_counter() - t0
    size_mb = sum(f.stat().st_size for f in root.rglob("*")
                  if f.is_file()) / 1e6
    log(f"phase 9: bundle written in {write_s:.2f} s ({size_mb:.0f} MB): "
        f"{FULL_KG['n_snp']} SNPs, {FULL_KG['n_gene']} genes (esm rows "
        f"5120 wide), sumstats with {n_kg} KG SNPs and {REAL_EXTRA_SNPS} "
        f"outside the KG")
    args = ["--data-path", str(root), "--seed", str(SEED), "--name", "real"]

    # train, counts set to 0 just before
    stages = {}
    tail = {k: HostTimer(getattr(kgwas, k))
            for k in ("save_model", "finalize_predictions", "write_table")}
    gat_layer.launches = gat_layer.bwd_launches = segment.launches = 0
    with timed_methods(kt.KGWAS_Data, REAL_STAGES, stages), \
            swapped(kgwas, **tail):
        run, train_s = cli_call(cli, ["train", *args, "--gwas", gwas,
                                      "--epochs", "1"])
    counts = {"merged_gat_fwd": gat_layer.launches,
              "merged_gat_bwd": gat_layer.bwd_launches,
              "csc_segment_sum": segment.launches}
    steps = len(run.epoch_losses[0])
    live, _ = run.model.live_groups(run._device_state()[2])
    per_step = sum(len(g) for g in live)
    # the CLI trains with KGWAS.train's default scan_steps: the wrappers
    # count the eager steps and the captured ones once
    counted = scan_counted_steps(steps)
    want = {"merged_gat_fwd": per_step * (counted + 2),
            "merged_gat_bwd": per_step * counted,
            "csc_segment_sum": per_step * counted}
    if counts != want or not steps:
        raise AssertionError(f"cli train: {steps} steps, launches {counts}, "
                             f"expected {want}")
    kp = run.kgwas_res["KGWAS_P"]
    if len(kp) != n_kg or not (np.isfinite(kp).all() and (kp >= 0).all()
                               and (kp <= 1).all()):
        raise AssertionError(f"KGWAS_P: {len(kp)} rows (the GWAS kept "
                             f"{n_kg}), not all finite in [0, 1]")
    if run.data.gene_init_dim_size != 5120:
        raise AssertionError("the Gene rows are not 5120 wide")
    rec = run.train_history[0]
    log(f"  phase 9 train: {steps} steps ({counted} counted: scanned), "
        f"launches {counts}; {len(kp)} "
        f"KGWAS_P finite in [0, 1]; loss first "
        f"{run.epoch_losses[0][0]:.4f} last {run.epoch_losses[0][-1]:.4f}; "
        f"val pearson {rec['val_pearsonr']:.4f}; {train_s:.1f} s")

    # predict: the checkpoint served bitwise as the trained state
    pred_train = run.predict_all()
    out = root / "predictions.npy"
    pred_cli, predict_s = cli_call(cli, ["predict", *args, "--out",
                                         str(out)])
    if (pred_cli.tobytes() != pred_train.tobytes()
            or np.load(out).tobytes() != pred_train.tobytes()):
        raise AssertionError("cli predict differs from the trained run's "
                             "predict_all()")

    # interpret: the disease-critical network, with commas
    csv = root / "disease_critical_network.csv"
    gat_layer.launches = 0
    tables, interpret_s = cli_call(cli, [
        "interpret", *args, "--gwas", gwas, "--variant-threshold", "5e-8",
        "--out", str(csv)])
    with open(csv) as f:
        n_lines = sum(1 for _ in f)
    if n_rows(tables[2]) == 0 or n_lines < 2:
        raise AssertionError("interpret wrote an empty network")
    log(f"  phase 9 predict: {len(pred_cli)} predictions, bitwise the "
        f"trained run's; interpret: {n_rows(tables[2])} rows in {csv.name} "
        f"({n_lines} lines), {n_rows(tables[1])} variant rows, "
        f"merged_gat_fwd raw launches {gat_layer.launches}")

    # the train step on this KG (Gene rows 5120 wide) beside 5d's (128)
    data = run.data
    cg, x, layouts = run._device_state()
    y_node, w_node = run._labels(cg)
    batches = [torch.from_numpy(b).to(x["SNP"].device) for b in
               epoch_batches(data.train_mask, BATCH, False, None)[:25]]
    opt = build_optimizer(run.model.parameters(), LR, 5e-4)
    step_ms = []
    for b in batches:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        train_step(run.model, opt, x, layouts, b, y_node, w_node)
        stop.record()
        torch.cuda.synchronize()
        step_ms.append(start.elapsed_time(stop))
    step_ms = statistics.median(step_ms[5:])
    busy = profile_device(lambda: train_step(
        run.model, opt, x, layouts, batches[0], y_node, w_node), step_ms,
        "training step (Gene rows 5120 wide)")
    ms_5d, busy_5d = step_5d
    log(f"phase 9 [{card}]: train step {step_ms:.3f} ms median of 20 (device "
        f"busy {busy:.3f} ms, idle {1 - busy / step_ms:.1%}) with Gene rows "
        f"5120 wide, beside phase 5d's {ms_5d:.3f} ms (busy {busy_5d:.3f} "
        f"ms, idle {1 - busy_5d / ms_5d:.1%}) with Gene rows 128 wide")
    host = {"bundle write": write_s, **{k: stages.get(k, 0.0)
                                        for k in REAL_STAGES},
            "epoch": rec["epoch_time_s"],
            "pred.csv writes": tail["write_table"].seconds,
            "predict": predict_s, "interpret": interpret_s}
    log(f"phase 9 ok [{card}]: host s (train's stages): "
        + ", ".join(f"{k} {v:.2f}" for k, v in host.items())
        + f"; cli train {train_s:.1f} s in all (save_model "
        f"{tail['save_model'].seconds:.2f}, finalize_predictions "
        f"{tail['finalize_predictions'].seconds:.2f})")


# phase 10: the JAX package's other model options, each on the full-width
# KG (KGWAS.train over CMP_STEPS batches with no_relu, as phase 6)
MODEL_VARIANTS = {
    "GAT-sum H4": dict(gat_num_head=4),
    "GAT-max H2": dict(gnn_aggr="max", gat_num_head=2),
    "GAT-max sigmoid": dict(gnn_aggr="max", sigmoid_gat=True),
    "SAGE-max": dict(gnn_backbone="SAGE", gnn_aggr="max"),
    "GCN-min": dict(gnn_backbone="GCN", gnn_aggr="min"),
    # the dropout-0 run of GAT sum: its losses are the dropout run's yardstick
    "GAT-sum remat": dict(remat=True),
    "GAT-sum dropout": dict(dropout=0.1),
    "GAT-sum edge_dim": dict(edge_dim=4, pheno_condition="ATT"),
}
MODEL_KERNELS = ("merged_gat_fwd", "merged_gat_bwd",
                 "segment_softmax_spmm_fwd", "segment_softmax_spmm_bwd",
                 "csr_segment_sum", "csc_segment_sum")


def model_counts(zero=False):
    """Launch counts of every layer kernel (set to 0 first with zero)."""
    from kgwas_tpu_torch.ops import gat_layer, segment, segment_softmax

    if zero:
        gat_layer.launches = gat_layer.bwd_launches = 0
        segment_softmax.launches = segment_softmax.bwd_launches = 0
        segment.csr_launches = segment.launches = 0
    return dict(zip(MODEL_KERNELS, (
        gat_layer.launches, gat_layer.bwd_launches, segment_softmax.launches,
        segment_softmax.bwd_launches, segment.csr_launches, segment.launches)))


# the device states (compiled graph, node features, device layouts) built
# so far, by compiled graph, merged layouts, device and layer paths: a
# layout never changes, so the runs on one graph and its layouts share
# their set-up (a run on the same graph's dst-range sub-layouts does not)
SHARED_STATE = {}


def shared_state(run):
    """Gives run the device state an earlier run on the same compiled graph,
    merged layouts, device and layer paths built (KGWAS._device_state), or
    keeps run's for the runs after it; a run with streamed features keeps
    its own."""
    from kgwas_tpu_torch.models import layer_paths

    if run.stream_features:
        return
    key = (id(run.data.compile()), id(run.layouts), str(run.device),
           layer_paths(run.model_cfg))
    if key in SHARED_STATE:
        run._graph, run._x_host = SHARED_STATE[key], {}
    else:
        t0 = time.perf_counter()
        SHARED_STATE[key] = run._device_state()
        log(f"  device state of the paths {key[3]} built in "
            f"{time.perf_counter() - t0:.1f} s, kept for the runs after")


def path_launches(model, layouts, training):
    """(per forward, per backward) launches of each layer kernel on the
    model's layer path: one per head and live group (merged), per head and
    relation of the live groups (per-relation GAT), per relation (the
    per-relation message passing), per live group ('mp')."""
    from kgwas_tpu_torch.models.hetero_gnn import layer_path

    cfg = model.cfg
    live, _ = model.live_groups(layouts)
    groups = sum(len(g) for g in live)
    rels = sum(len(layouts[t].rel_keys) for g in live for t in g)
    heads = cfg.gat_num_head if cfg.gnn_backbone == "GAT" else 1
    path = layer_path(cfg, training)
    if path == "merged":
        n = heads * groups
        return {"merged_gat_fwd": n}, {"merged_gat_bwd": n,
                                       "csc_segment_sum": n}
    if path == "mp":
        return {"csr_segment_sum": groups}, {"csc_segment_sum": groups}
    n = heads * rels
    if cfg.gnn_backbone == "GAT" and not cfg.sigmoid_gat:
        return ({"segment_softmax_spmm_fwd": n},
                {"segment_softmax_spmm_bwd": n, "csc_segment_sum": n})
    return {"csr_segment_sum": n}, {"csc_segment_sum": n}


def add_counts(*parts):
    out = dict.fromkeys(MODEL_KERNELS, 0)
    for k, part in parts:
        for name, v in part.items():
            out[name] += k * v
    return out


@contextlib.contextmanager
def plain_ops():
    """Every layer kernel's wrapper replaced by its plain version: the
    model's layer ops then run plain PyTorch on the card."""
    from kgwas_tpu_torch.ops import gat_layer, segment, segment_softmax

    with swapped(gat_layer,
                 merged_gat_a_src=gat_layer.merged_gat_a_src_plain,
                 merged_gat_forward=without_sched(
                     gat_layer.merged_gat_forward_plain),
                 merged_gat_backward=gat_layer.merged_gat_backward_plain), \
            swapped(segment_softmax,
                    segment_softmax_spmm_fwd=without_sched(
                        segment_softmax.segment_softmax_spmm_fwd_plain),
                    segment_softmax_spmm_backward=(
                        segment_softmax.segment_softmax_spmm_backward_plain)), \
            swapped(segment,
                    csr_segment_sum=without_sched(
                        segment.csr_segment_sum_plain),
                    csc_segment_sum=segment.csc_segment_sum_plain):
        yield


def new_form(name, calls, fn, plain_fn, flag, floor):
    """A kernel's new form (the multiplier of #6 / #7, the d_w of #8) on
    the launches recorded in one forward or step: host-paced and device ms,
    the bound, the plain version (float64 rule) and its gather floor, and
    the same launches without the flag (flag=None, or edge_grad=False).
    Returns (totals, worst abs err)."""
    tot, err = time_launches(name, calls, fn, plain_fn)
    off = [0.0, 0.0]
    for args, kwargs in calls:
        args = detached(args)
        kw = dict(kwargs)
        kw[flag] = False if flag == "edge_grad" else None
        off[0] += cuda_ms(lambda: fn(*args, **kw), 10)  # noqa: B023
        off[1] += graph_ms(lambda: fn(*args, **kw), 10)  # noqa: B023
    tot["off_ms"], tot["off_device_ms"] = off
    tot["floor_ms"] = floor
    tot["launches"] = len(calls)
    log(f"    {name} with {flag} x{len(calls)}: {tot['ms']:.4f} ms [device "
        f"{tot['device_ms']:.4f}], without {off[0]:.4f} [{off[1]:.4f}]; "
        f"bound {tot['bound_ms']:.4f}, gather floor {floor:.4f}, plain "
        f"{tot['plain_ms']:.4f}; max abs err {err:.3e}")
    return tot, err


def phase_models(kt, data, cg, device, card, floors):
    """Phase 10: the JAX package's other model options at full width (the
    synthetic KG of phases 4-6, 2 layers, hidden 128, f32, TF32 off),
    through KGWAS.initialize_model -> predict_all -> KGWAS.train over
    CMP_STEPS batches (no_relu): each configuration's launches per forward
    and per step (counts set to 0 just before each entry point),
    predict_all and CMP_STEPS steps through the kernels against the plain
    ops, two kernel runs bitwise equal, forward and step ms with the
    device's busy share; (e) dropout: KGWAS.train's losses equal those of
    the dropout-0 run (no dropout_rng, as the JAX engine), and a direct
    step with a dropout generator runs #6 / #7 with the multiplier, held
    against the plain ops on the same mask; (f) remat: one step's gradients
    bitwise those without, and each step's peak memory; (g) edge_dim:
    predict_all equal to the merged path's at the same weights. The new
    forms of #6, #7 (multiplier) and #8 (d_w) on their launches: ms, bound,
    gather floor, plain version, and the same launches without the flag.
    Returns ({kernel: launches}, {kernel: worst abs err}, [(kernel, the new
    form's totals)])."""
    from kgwas_tpu_torch.engine.loop import (batch_loss, epoch_batches,
                                             train_step)
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.ops import segment, segment_softmax

    t_phase = time.perf_counter()
    data_v = copy.copy(data)
    data_v.train_mask = np.asarray(data.train_mask)[:CMP_STEPS * BATCH]
    batches = [torch.from_numpy(b).to(device) for b in
               epoch_batches(data_v.train_mask, BATCH, False, None)]
    launches = dict.fromkeys(MODEL_KERNELS, 0)
    worst = dict.fromkeys(MODEL_KERNELS, 0.0)
    losses, rows = {}, []
    for name, kw in MODEL_VARIANTS.items():
        t0 = time.perf_counter()
        run = kt.KGWAS(data_v, exp_name="chip_smoke_models", seed=SEED)
        run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN,
                             no_relu=True, **kw)
        shared_state(run)
        model = run.model
        init = copy.deepcopy(model.state_dict())
        run.predict_all()          # device state, allocator warm-up
        _, x, layouts = run._device_state()
        y_node, w_node = run._labels(cg)
        f_eval, _ = path_launches(model, layouts, False)
        f_train, b_train = path_launches(model, layouts, True)
        remat = 2 if model.cfg.remat else 1
        per_step = add_counts((remat, f_train), (1, b_train))

        # serving: counts set to 0 just before the entry point
        model_counts(zero=True)
        pred = run.predict_all()
        counts = model_counts()
        if counts != add_counts((1, f_eval)):
            raise AssertionError(f"{name}: predict_all launched {counts}, "
                                 f"expected {f_eval}")
        for k, v in counts.items():
            launches[k] += v
        if pred.shape != (cg.num_nodes["SNP"],) or not np.isfinite(
                pred).all():
            raise AssertionError(f"{name}: bad predictions")
        again = run.predict_all()
        if not np.array_equal(pred, again):
            raise AssertionError(f"{name}: two forwards differ")
        with plain_ops():
            pred_plain = run.predict_all()
        np.testing.assert_allclose(pred, pred_plain, rtol=PRED_RTOL,
                                   atol=PRED_ATOL)
        pred_err = float(np.abs(pred - pred_plain).max())

        # training: KGWAS.train over CMP_STEPS batches, counts set to 0
        model_counts(zero=True)
        run.train(batch_size=BATCH, epoch=1, lr=LR, save_best_model=False,
                  scan_steps=0)
        counts = model_counts()
        steps = len(run.epoch_losses[0])
        want = add_counts((steps, per_step), (2, f_eval))
        if steps != CMP_STEPS or counts != want:
            raise AssertionError(f"{name}: KGWAS.train took {steps} steps "
                                 f"with launches {counts}, expected "
                                 f"{CMP_STEPS} and {want}")
        for k, v in counts.items():
            launches[k] += v
        losses[name] = np.asarray(run.epoch_losses[0])

        def steps_from_init(ctx):
            model.load_state_dict(init)
            opt = build_optimizer(model.parameters(), LR, 5e-4)
            with ctx:
                ls = [train_step(model, opt, x, layouts, b, y_node, w_node)
                      for b in batches]
            return (torch.stack(ls).cpu().numpy(),
                    {k: v.detach().clone()
                     for k, v in model.state_dict().items()})

        loss_k, par_k = steps_from_init(contextlib.nullcontext())
        loss_k2, par_k2 = steps_from_init(contextlib.nullcontext())
        if not (np.array_equal(loss_k, loss_k2) and all(
                torch.equal(par_k[k], par_k2[k]) for k in par_k)):
            raise AssertionError(f"{name}: two kernel runs of "
                                 f"{CMP_STEPS} steps differ")
        loss_p, par_p = steps_from_init(plain_ops())
        np.testing.assert_allclose(loss_k, loss_p, rtol=LOSS_RTOL)
        par_err = max(float((par_k[k] - par_p[k]).abs().max())
                      for k in par_k)
        moved = max(float((par_k[k] - init[k]).abs().max()) for k in par_k)
        if par_err > PARAM_ATOL or moved == 0:
            raise AssertionError(f"{name}: parameters after {CMP_STEPS} "
                                 f"steps differ by {par_err:.3e}, moved by "
                                 f"{moved:.3e}")
        del par_k2, par_p
        notes = []

        if name == "GAT-sum dropout":
            # KGWAS.train drops nothing (no generator): the dropout-0 losses
            np.testing.assert_allclose(losses[name],
                                       losses["GAT-sum remat"],
                                       rtol=LOSS_RTOL)
            # a direct step with a dropout generator: #6 / #7 with the
            # multiplier, against the plain ops on the same mask
            def dropout_step(ctx, seed=SEED + 10):
                model.load_state_dict(init)
                opt = build_optimizer(model.parameters(), LR, 5e-4)
                gen = torch.Generator(device=device).manual_seed(seed)
                with ctx:
                    loss = train_step(model, opt, x, layouts, batches[0],
                                      y_node, w_node, dropout_gen=gen)
                return float(loss), {k: v.detach().clone()
                                     for k, v in model.state_dict().items()}

            rec_f = Recorder(segment_softmax.segment_softmax_spmm_fwd)
            rec_b = Recorder(segment_softmax.segment_softmax_spmm_bwd)
            model_counts(zero=True)
            with swapped(segment_softmax, segment_softmax_spmm_fwd=rec_f,
                         segment_softmax_spmm_bwd=rec_b):
                l_k, p_k = dropout_step(contextlib.nullcontext())
            counts = model_counts()
            if counts != per_step:
                raise AssertionError(f"{name}: a step with a generator "
                                     f"launched {counts}, expected "
                                     f"{per_step}")
            mults = [c[1]["mult"] for c in rec_f.calls]
            zeros = float(sum((m == 0).sum() for m in mults)
                          / sum(m.numel() for m in mults))
            if not 0.05 < zeros < 0.15:
                raise AssertionError(f"{name}: {zeros:.3f} of the edges "
                                     "dropped, not about 0.1")
            l_p, p_p = dropout_step(plain_ops())
            if abs(l_k - l_p) > LOSS_RTOL * abs(l_p):
                raise AssertionError(f"{name}: dropout step loss {l_k} "
                                     f"against plain {l_p}")
            d_err = max(float((p_k[k] - p_p[k]).abs().max()) for k in p_k)
            if d_err > 2 * LR:
                raise AssertionError(f"{name}: a dropout step's parameters "
                                     f"differ by {d_err:.3e}")
            notes.append(f"KGWAS.train losses = the dropout-0 run's; a step "
                         f"with a generator drops {zeros:.4f} of the edges, "
                         f"its parameters within {d_err:.3e} of the plain "
                         f"ops'")
            for k, rec, plain_fn, fl in (
                    ("segment_softmax_spmm_fwd", rec_f,
                     segment_softmax.segment_softmax_spmm_fwd_plain,
                     floors["segment_softmax_spmm_fwd"]),
                    ("segment_softmax_spmm_bwd", rec_b,
                     segment_softmax.segment_softmax_spmm_bwd_plain,
                     floors["segment_softmax_spmm_bwd"])):
                tot, err = new_form(k, rec.calls, rec.fn, plain_fn, "mult",
                                    fl)
                worst[k] = max(worst[k], err)
                rows.append((k, tot))
        if name == "GAT-max sigmoid":
            rec_c = Recorder(segment.csc_segment_sum)
            with swapped(segment, csc_segment_sum=rec_c):
                train_step(model, build_optimizer(model.parameters(), LR,
                                                  5e-4),
                           x, layouts, batches[0], y_node, w_node)
            calls = [c for c in rec_c.calls if c[1].get("edge_grad")]
            if len(calls) != len(rec_c.calls) or not calls:
                raise AssertionError(f"{name}: the CSC sums of a step were "
                                     "not all taken with d_w")
            tot, err = new_form("csc_segment_sum", calls, rec_c.fn,
                                segment.csc_segment_sum_plain, "edge_grad",
                                floors["csc_segment_sum (GAT max)"])
            worst["csc_segment_sum"] = max(worst["csc_segment_sum"], err)
            rows.append(("csc_segment_sum", tot))
        if name == "GAT-sum remat":
            # one step's gradients with and without remat, and each one's
            # peak memory
            grads, peak = [], []
            for cfg in (model.cfg, dataclasses.replace(model.cfg,
                                                       remat=False)):
                model.cfg = cfg
                model.load_state_dict(init)
                model.zero_grad(set_to_none=True)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                batch_loss(model(x, layouts, training=True), batches[0],
                           y_node, w_node).backward()
                torch.cuda.synchronize()
                peak.append((torch.cuda.max_memory_allocated() - base) / 2**20)
                grads.append({k: p.grad.clone() for k, p in
                              model.named_parameters() if p.grad is not None})
            model.cfg = dataclasses.replace(model.cfg, remat=True)
            if sorted(grads[0]) != sorted(grads[1]) or not all(
                    torch.equal(grads[0][k], grads[1][k]) for k in grads[0]):
                raise AssertionError(f"{name}: remat gradients differ from "
                                     "those without")
            notes.append(f"one step's gradients bitwise those without "
                         f"remat; peak memory of a step above its start "
                         f"{peak[0]:.1f} MiB with remat, {peak[1]:.1f} MiB "
                         f"without")
            del grads
        if name == "GAT-sum edge_dim":
            ref = kt.KGWAS(data_v, exp_name="chip_smoke_models", seed=SEED)
            ref.initialize_model(gnn_num_layers=LAYERS,
                                 gnn_hidden_dim=HIDDEN, no_relu=True)
            shared_state(ref)
            keys = ref.model.state_dict().keys()
            ref.model.load_state_dict({k: v for k, v in
                                       model.state_dict().items()
                                       if k in keys})
            want = ref.predict_all()
            np.testing.assert_allclose(run.predict_all(), want,
                                       rtol=PRED_RTOL, atol=PRED_ATOL)
            notes.append("predict_all (per relation) equals the merged "
                         "path's at the same weights within rtol 1e-4, "
                         "atol 1e-5")
            del ref

        # timing: forward and step, with the device's busy share
        model.load_state_dict(init)
        opt = build_optimizer(model.parameters(), LR, 5e-4)
        fwd_ms = step_times(run.predict_all, n=6)
        cycle = itertools.cycle(batches)
        step = lambda: train_step(model, opt, x, layouts,  # noqa: E731
                                  next(cycle), y_node, w_node)
        step_ms = step_times(step, n=6)
        busy_f = profile_device(run.predict_all, fwd_ms, f"{name} forward",
                                reps=2)
        busy_s = profile_device(step, step_ms, f"{name} training step",
                                reps=2)
        edges = cg.total_real_edges()
        log(f"  phase 10 {name} [{card}]: launches per forward "
            f"{ {k: v for k, v in add_counts((1, f_eval)).items() if v} }, "
            f"per step { {k: v for k, v in per_step.items() if v} }; "
            f"predict_all vs plain ops max abs err {pred_err:.3e}, bitwise "
            f"repeatable; KGWAS.train {CMP_STEPS} steps, losses kernel "
            f"{loss_k.tolist()} plain {loss_p.tolist()}, parameters differ "
            f"by {par_err:.3e} (moved {moved:.3e}); forward {fwd_ms:.3f} ms "
            f"({edges * LAYERS / (fwd_ms / 1e3):.4g} edge-traversals/s, busy "
            f"{busy_f:.3f} ms, idle {1 - busy_f / fwd_ms:.1%}), train step "
            f"{step_ms:.3f} ms (busy {busy_s:.3f} ms, idle "
            f"{1 - busy_s / step_ms:.1%})"
            + "".join(f"; {n}" for n in notes)
            + f"; {time.perf_counter() - t0:.1f} s")
        del run, model, opt, x, layouts, init, par_k
        torch.cuda.empty_cache()
    log(f"phase 10 ok [{card}]: {len(MODEL_VARIANTS)} configurations served "
        f"and trained through the kernels in "
        f"{time.perf_counter() - t_phase:.1f} s; launches {launches}")
    return launches, worst, rows


# ---------------------------------------------------------------------------
# phase 11: long runs, host-streamed features and the cohort builder
# ---------------------------------------------------------------------------

# (a) a clean run and one with a transient fault before step FAULT_STEP of
# epoch 2, LONG_EPOCHS epochs each; (b) a train state every CKPT_EVERY steps
LONG_EPOCHS, FAULT_STEP, CKPT_EVERY = 2, 100, 100
# (a) and (b)'s epochs cut to these many batches of the full-width split
# (352 before PR 13), to pay for phase 15: the fault still lands in epoch
# 2, (b) still saves twice and resumes from the newest save
LONG_BATCHES, CKPT_BATCHES = 120, 220
# (d) the watchdog's stall timeout (s): start-up, data and a first step fit
# in it; the wedged attempt stops after WEDGE_CLI / WEDGE_SCRIPT heartbeats
WATCHDOG_T, WEDGE_CLI, WEDGE_SCRIPT = 45.0, 7, 15
# (d) the script's checkpoint_every (its newest state before the wedge),
# batch and KG: the CLI's --synthetic sizes, so that a process reaches its
# first step well inside the timeout
WEDGE_EVERY, WEDGE_BATCH = 10, 64
WEDGE_KG = dict(n_snp=2000, n_gene=400, n_go=150)
# (e) Gene rows at the PoPS width (reference kgwas_data.py:244)
POPS_DIM = 57_742
# (f) UK Biobank's cohort: participants, kinship pairs, ICD10 array width
# (field 41270 has hundreds of array entries; cut to 20), genotyping batches
UKBB = dict(n=120_000, kin_pairs=24_000, icd_width=20, batches=106)
LONG_KERNELS = ("merged_gat_fwd", "merged_gat_bwd", "csc_segment_sum")


class StopRun(Exception):
    """Raised by a fault hook to end a training run once it has what a
    check needs (not a backend failure: train does not retry it)."""


def long_counts(zero=False):
    """Launch counts of the merged GAT path's kernels (set to 0 first with
    zero)."""
    counts = model_counts(zero)
    return {k: counts[k] for k in LONG_KERNELS}


def to_host(obj):
    """A nested state dict with every tensor copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


def same_state(a, b, what):
    """Raise unless two nested state dicts are equal, tensors bitwise."""
    if isinstance(b, torch.Tensor):
        if not (isinstance(a, torch.Tensor) and torch.equal(a.cpu(),
                                                            b.cpu())):
            raise AssertionError(f"{what}: tensors differ")
    elif isinstance(b, dict):
        if sorted(map(str, a)) != sorted(map(str, b)):
            raise AssertionError(f"{what}: keys differ")
        for k in b:
            same_state(a[k], b[k], f"{what}/{k}")
    elif isinstance(b, (list, tuple)):
        if len(a) != len(b):
            raise AssertionError(f"{what}: lengths differ")
        for i, (x, y) in enumerate(zip(a, b)):
            same_state(x, y, f"{what}/{i}")
    elif a != b:
        raise AssertionError(f"{what}: {a!r} != {b!r}")


def expect_launches(counts, per_step, steps, forwards, what):
    want = {"merged_gat_fwd": per_step * (steps + forwards),
            "merged_gat_bwd": per_step * steps,
            "csc_segment_sum": per_step * steps}
    if counts != want:
        raise AssertionError(f"{what}: launches {counts}, expected {want}")


def phase_restart(kt, data, card):
    """(a) KGWAS.train(max_restarts=1) over LONG_EPOCHS epochs of
    LONG_BATCHES batches at full width, clean and with a transient fault before step FAULT_STEP of
    epoch 2: one restart, and the final and best parameters bitwise the
    clean run's (deterministic kernels); the snapshot's host time per
    epoch and the time to recover. Returns the launches of both runs."""
    from kgwas_tpu_torch.engine import resilience

    data = copy.copy(data)
    data.train_mask = np.asarray(data.train_mask)[:LONG_BATCHES * BATCH]
    steps = len(data.train_mask) // BATCH
    fault = steps + FAULT_STEP
    runs, counts, wall = {}, {}, {}
    sleep_backoff = resilience.sleep_backoff
    resilience.sleep_backoff = lambda *a, **k: None   # no backoff sleep
    try:
        for tag in ("clean", "faulty"):
            run = kt.KGWAS(data, exp_name=f"chip_smoke_{tag}", seed=SEED)
            run.initialize_model(gnn_num_layers=LAYERS,
                                 gnn_hidden_dim=HIDDEN)
            if tag == "faulty":
                fired = []

                def hook(global_step):
                    if global_step == fault and not fired:
                        fired.append(global_step)
                        raise RuntimeError(
                            "INTERNAL: injected transient backend failure")
                run._fault_hook = hook
            long_counts(zero=True)
            t0 = time.perf_counter()
            run.train(batch_size=BATCH, epoch=LONG_EPOCHS, lr=LR,
                      save_best_model=False, max_restarts=1, scan_steps=0)
            wall[tag] = time.perf_counter() - t0
            counts[tag] = long_counts()
            runs[tag] = run
    finally:
        resilience.sleep_backoff = sleep_backoff
    clean, faulty = runs["clean"], runs["faulty"]
    if (clean.restart_count, faulty.restart_count) != (0, 1):
        raise AssertionError(f"restarts {clean.restart_count}, "
                             f"{faulty.restart_count}, expected 0, 1")
    per_step = sum(len(g) for g in clean.model.live_groups(
        clean._device_state()[2])[0])
    expect_launches(counts["clean"], per_step, LONG_EPOCHS * steps,
                    LONG_EPOCHS + 1, "(a) clean")
    expect_launches(counts["faulty"], per_step,
                    LONG_EPOCHS * steps + FAULT_STEP, LONG_EPOCHS + 1,
                    "(a) faulty")
    same_state(faulty.params, clean.params, "(a) final parameters")
    same_state(faulty.best_params, clean.best_params, "(a) best parameters")
    if faulty.epoch_losses != clean.epoch_losses:
        raise AssertionError("(a) per-step losses differ")
    snap = clean.snapshot_seconds
    log(f"phase 11a ok [{card}]: restart: {LONG_EPOCHS} epochs of {steps} "
        f"steps, a transient fault before global step {fault}: restarts "
        f"{faulty.restart_count}, final and best parameters and "
        f"{sum(map(len, clean.epoch_losses))} losses bitwise the clean "
        f"run's; snapshot host s at start and per epoch "
        f"{[round(s, 4) for s in snap]}; time to recover (graph upload and "
        f"state restore) {faulty.recovery_seconds[0]:.3f} s; wall clean "
        f"{wall['clean']:.1f} s, faulty {wall['faulty']:.1f} s (replayed "
        f"{FAULT_STEP} steps); launches clean {counts['clean']}, faulty "
        f"{counts['faulty']}")
    return add_counts((1, counts["clean"]), (1, counts["faulty"]))


def phase_checkpoint(kt, data, card):
    """(b) KGWAS.train(checkpoint_every=CKPT_EVERY) over one epoch of
    CKPT_BATCHES batches beside
    the same epoch without saves: the host time of each step (between the
    fault hook's calls) with and without a save after it; the newest state
    saved (the last multiple of CKPT_EVERY) and the state resume=True
    restores, bitwise the run's at that step. Returns the launches."""
    import shutil

    from kgwas_tpu_torch.engine.checkpoint import (latest_train_state,
                                                   restore_train_state)

    name = "chip_smoke_ckpt"
    data = copy.copy(data)
    data.train_mask = np.asarray(data.train_mask)[:CKPT_BATCHES * BATCH]
    ckpt_dir = os.path.join(data.data_path, "model", name, "train_state")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    held_at = len(data.train_mask) // BATCH // CKPT_EVERY * CKPT_EVERY
    ms, counts, held = {}, {}, {}
    for tag, every in (("saves", CKPT_EVERY), ("none", None)):
        run = kt.KGWAS(data, exp_name=name if every else name + "_none",
                       seed=SEED)
        run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN)
        ticks = []

        def hook(global_step, run=run, ticks=ticks, every=every):
            ticks.append(time.perf_counter())
            if every and global_step == held_at:
                held["model"] = to_host(run.model.state_dict())
                held["optimizer"] = to_host(run.optimizer.state_dict())
        run._fault_hook = hook
        long_counts(zero=True)
        run.train(batch_size=BATCH, epoch=1, lr=LR, save_best_model=False,
                  checkpoint_every=every, scan_steps=0)
        counts[tag] = long_counts()
        ms[tag] = np.diff(ticks) * 1e3
    # step k's interval runs from its hook to the next one's: the step and,
    # when k + 1 is a multiple of CKPT_EVERY, the save after it
    saves = np.arange(CKPT_EVERY - 1, len(ms["saves"]), CKPT_EVERY)
    others = np.setdiff1d(np.arange(len(ms["saves"])),
                          np.concatenate([saves, [held_at]]))
    latest = latest_train_state(ckpt_dir)
    if not latest.endswith(f"step_{held_at}"):
        raise AssertionError(f"(b) newest train state {latest}")
    model_state, opt_state = restore_train_state(latest)
    same_state(model_state, held["model"], "(b) saved model state")
    same_state(opt_state, held["optimizer"], "(b) saved optimizer state")

    resumed = {}
    run = kt.KGWAS(data, exp_name=name, seed=SEED)
    run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN)

    def first_step(global_step):
        resumed["model"] = to_host(run.model.state_dict())
        resumed["optimizer"] = to_host(run.optimizer.state_dict())
        raise StopRun()
    run._fault_hook = first_step
    t0 = time.perf_counter()
    try:
        run.train(batch_size=BATCH, epoch=1, lr=LR, save_best_model=False,
                  resume=True, scan_steps=0)
    except StopRun:
        pass
    resume_s = time.perf_counter() - t0
    same_state(resumed["model"], held["model"], "(b) resumed model state")
    same_state(resumed["optimizer"], held["optimizer"],
               "(b) resumed optimizer state")
    steps = len(ms["none"]) + 1
    per_step = sum(len(g) for g in run.model.live_groups(
        run._device_state()[2])[0])
    for tag in counts:
        expect_launches(counts[tag], per_step, steps, 2, f"(b) {tag}")
    log(f"phase 11b ok [{card}]: checkpoint_every={CKPT_EVERY}: step host "
        f"ms median {np.median(ms['saves'][others]):.3f} without a save, "
        f"{[round(float(v), 3) for v in ms['saves'][saves]]} with one "
        f"(steps {(saves + 1).tolist()}); the run without saves: median "
        f"{np.median(ms['none']):.3f} ms, the same steps "
        f"{[round(float(v), 3) for v in ms['none'][saves]]}; "
        f"{os.path.basename(latest)} and the state resume=True restored "
        f"bitwise the run's at step {held_at} (resume to the first step "
        f"{resume_s:.2f} s); launches {counts}")
    return add_counts((1, counts["saves"]), (1, counts["none"]))


STICKY_SCRIPT = r"""
import json, sys
import torch
from kgwas_tpu_torch.engine.resilience import is_transient_backend_error
out = {}
x = torch.zeros(10, device="cuda")
try:
    x[torch.tensor([100], device="cuda")] += 1   # out of range: an assert
    torch.cuda.synchronize()
    out["first"] = None
except Exception as e:
    out["first"] = [type(e).__name__, str(e)[:160],
                    is_transient_backend_error(e)]
try:
    torch.ones(4, device="cuda").sum().item()
    out["next"] = None
except Exception as e:
    out["next"] = [type(e).__name__, str(e)[:160],
                   is_transient_backend_error(e)]
print("STICKY " + json.dumps(out), flush=True)
"""


def child_env(**extra):
    """The environment of a child process that imports this checkout's
    package (and, with the wedge directory first, its sitecustomize)."""
    path = os.environ.get("PYTHONPATH")
    paths = [p for p in (extra.pop("first", None), str(HERE), path) if p]
    return dict(os.environ, PYTHONPATH=os.pathsep.join(paths), **extra)


def phase_sticky(card):
    """(c) a device-side assert (an index out of range into a CUDA tensor)
    in a child process: is_transient_backend_error calls it fatal, and the
    next CUDA call of that process fails too, so no in-process restart can
    recover it; only the watchdog's new process (d) can."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", STICKY_SCRIPT],
                          capture_output=True, text=True, timeout=300,
                          env=child_env())
    line = [ln for ln in proc.stdout.splitlines() if ln.startswith("STICKY ")]
    if not line:
        raise AssertionError(f"(c) the child printed no result (rc "
                             f"{proc.returncode}): {proc.stderr[-2000:]}")
    out = json.loads(line[0][len("STICKY "):])
    first, nxt = out["first"], out["next"]
    if first is None or first[2] is not False:
        raise AssertionError(f"(c) the assert was not raised as fatal: "
                             f"{first}")
    if nxt is None or nxt[2] is not False:
        raise AssertionError(f"(c) the next CUDA call did not fail fatally: "
                             f"{nxt}")
    log(f"phase 11c ok [{card}]: a device-side assert raised {first[0]} "
        f"({first[1].splitlines()[0]!r}), classified fatal; the next CUDA "
        f"call of that process raised {nxt[0]}, fatal too; "
        f"{time.perf_counter() - t0:.1f} s")


WEDGE_SITE = r'''
"""Wedges the first training attempt of a watchdog test: the process that
trains (KGWAS_UNDER_WATCHDOG from the CLI, or KGWAS_WEDGE_CHILD) counts its
attempts in KGWAS_WEDGE_MARK and logs its heartbeats beside it; attempt 0
stops making progress after KGWAS_WEDGE_AFTER heartbeats (alive, no
exception). Then the site's own sitecustomize, if any, runs."""
import os
import sys

if os.environ.get("KGWAS_WEDGE_MARK") and (
        os.environ.get("KGWAS_UNDER_WATCHDOG")
        or os.environ.get("KGWAS_WEDGE_CHILD")):
    import json
    import pathlib
    import time

    _start = time.time()
    _mark = pathlib.Path(os.environ["KGWAS_WEDGE_MARK"])
    _n = int(_mark.read_text()) if _mark.exists() else 0
    _mark.write_text(str(_n + 1))
    _log = pathlib.Path(f"{_mark}.{_n}.json")
    _after = int(os.environ.get("KGWAS_WEDGE_AFTER", "5"))
    import kgwas_tpu_torch.engine.watchdog as _wd

    _touch, _beats = _wd.touch_heartbeat, []

    def touch_heartbeat(path):
        if _n == 0 and len(_beats) >= _after:
            time.sleep(3600)
        _touch(path)
        _beats.append(time.time())
        _log.write_text(json.dumps({"start": _start, "first": _beats[0],
                                    "last": _beats[-1], "n": len(_beats)}))

    _wd.touch_heartbeat = touch_heartbeat
    _log.write_text(json.dumps({"start": _start, "imported": time.time(),
                                "n": 0}))

_here = os.path.dirname(os.path.abspath(__file__))
import importlib.util  # noqa: E402
from importlib.machinery import PathFinder  # noqa: E402

_spec = PathFinder.find_spec("sitecustomize",
                             [p for p in sys.path
                              if os.path.abspath(p or ".") != _here])
if _spec is not None and _spec.loader is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
'''

WATCHDOG_SCRIPT = r"""
import json, sys
from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.engine.checkpoint import latest_train_state
from kgwas_tpu_torch.ops import gat_layer, segment
root, result, hb, kg, every, device, batch = sys.argv[1:8]
data = KGWAS_Data.from_synthetic(seed=0, data_path=root, **json.loads(kg))
data.load_synthetic_gwas(seed=0)
data.process_gwas_file()
data.prepare_split()
run = KGWAS(data, exp_name="wedge", seed=0, device=device)
run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=128)
latest = latest_train_state(root + "/model/wedge/train_state")
run.train(batch_size=int(batch), epoch=2, lr=1e-4, save_best_model=False,
          checkpoint_every=int(every), resume=True, heartbeat_path=hb,
          scan_steps=0)
with open(result, "w") as f:
    json.dump({"resumed_from": latest, "epochs": len(run.train_history),
               "steps": sum(map(len, run.epoch_losses)),
               "launches": {"merged_gat_fwd": gat_layer.launches,
                            "merged_gat_bwd": gat_layer.bwd_launches,
                            "csc_segment_sum": segment.launches}}, f)
"""


def attempt_log(mark, n):
    with open(f"{mark}.{n}.json") as f:
        return json.load(f)


def attempt_logs(root):
    """Every attempt's heartbeat log under root (for a failure's message)."""
    return {p.name: p.read_text() for p in root.glob("*attempt.*.json")}


def recovery(mark):
    """(the first attempt's heartbeats, the relaunch's, the time from the
    stall's detection, the last heartbeat plus the timeout, to the
    relaunch's first heartbeat)."""
    a0, a1 = attempt_log(mark, 0), attempt_log(mark, 1)
    return a0, a1, a1["first"] - (a0["last"] + WATCHDOG_T)


def phase_watchdog(card, tmp):
    """(d) the stall watchdog on the card, the first attempt wedged (a
    sitecustomize in a directory first on the child's path patches
    engine.watchdog.touch_heartbeat): python -m kgwas_tpu_torch.cli train
    --device cuda --watchdog-timeout --watchdog-restarts 1 on --synthetic
    (the CLI has no checkpoint flag: the relaunch starts afresh), and a
    script running KGWAS.train(checkpoint_every, resume=True,
    heartbeat_path) under run_with_watchdog on a KG of the same size:
    exactly one relaunch each, the script's resuming from the newest
    step_N.
    The two run side by side. Returns the script's launches."""
    import shutil

    root = tmp / "watchdog"
    shutil.rmtree(root, ignore_errors=True)
    (root / "site").mkdir(parents=True)
    (root / "site" / "sitecustomize.py").write_text(WEDGE_SITE)
    site = str(root / "site")

    # the CLI, in a child process, while this process runs the script's
    # case below (each waits out its own stall timeout: PR 13 runs them
    # side by side to pay for phase 15)
    mark = root / "cli_attempt"
    t0 = time.perf_counter()
    cli_log = open(root / "cli.log", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "kgwas_tpu_torch.cli", "train",
         "--synthetic", "--device", DEVICE, "--data-path",
         str(root / "cli"), "--name", "wd", "--epochs", "3",
         "--batch-size", str(BATCH), "--watchdog-timeout",
         str(WATCHDOG_T), "--watchdog-restarts", "1"],
        stdout=cli_log, stderr=subprocess.STDOUT,
        env=child_env(first=site, KGWAS_WEDGE_MARK=str(mark),
                      KGWAS_WEDGE_AFTER=str(WEDGE_CLI)))
    try:
        script = phase_watchdog_script(root, site)
        proc.wait(timeout=600)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        cli_log.close()
    cli_s = time.perf_counter() - t0
    if proc.returncode != 0 or mark.read_text() != "2":
        raise AssertionError(
            f"(d) CLI: rc {proc.returncode}, attempts {mark.read_text()}, "
            f"attempt logs {attempt_logs(root)}: "
            + (root / "cli.log").read_text()[-3000:])
    log(f"  (d) CLI: {json.dumps(attempt_log(mark, 0))} then "
        f"{json.dumps(attempt_log(mark, 1))}")
    a0, a1, cli_rec = recovery(mark)
    if not os.path.exists(root / "cli" / "model" / "wd" / "pred.csv"):
        raise AssertionError("(d) CLI: the relaunch wrote no checkpoint")
    mark, out, newest, script_s, launches = script
    b0, b1, script_rec = recovery(mark)
    log(f"phase 11d ok [{card}]: watchdog (stall timeout {WATCHDOG_T:.0f} "
        f"s): the CLI's first attempt wedged after {a0['n']} "
        f"heartbeats, one relaunch completed ({a1['n']} heartbeats; start "
        f"to first heartbeat {a1['first'] - a1['start']:.2f} s), recovery "
        f"after the stall's detection {cli_rec:.2f} s, wall {cli_s:.1f} s; "
        f"the script wedged after {b0['n']} heartbeats, one relaunch "
        f"resumed from {newest} and completed {out['epochs']} epochs "
        f"({out['steps']} steps), recovery {script_rec:.2f} s, wall "
        f"{script_s:.1f} s (the two side by side); the relaunch's launches "
        f"{launches}")
    return add_counts((1, launches))


def phase_watchdog_script(root, site):
    """(d)'s second case: KGWAS.train(checkpoint_every, resume=True,
    heartbeat_path) in a script under run_with_watchdog, the first attempt
    wedged; exactly one relaunch, resuming from the newest step_N.
    Returns (the attempt mark, the script's result, the newest state's
    name, wall s, the relaunch's launches)."""
    from kgwas_tpu_torch.engine.watchdog import run_with_watchdog

    mark = root / "script_attempt"
    script = root / "train_job.py"
    script.write_text(WATCHDOG_SCRIPT)
    result, hb = root / "result.json", root / "heartbeat"
    every = WEDGE_EVERY
    t0 = time.perf_counter()
    rc = run_with_watchdog(
        [sys.executable, str(script), str(root / "script"), str(result),
         str(hb), json.dumps(WEDGE_KG), str(every), DEVICE,
         str(WEDGE_BATCH)],
        heartbeat=str(hb), stall_timeout_s=WATCHDOG_T, max_restarts=1,
        poll_s=0.5,
        env=child_env(first=site, KGWAS_WEDGE_MARK=str(mark),
                      KGWAS_WEDGE_AFTER=str(WEDGE_SCRIPT),
                      KGWAS_WEDGE_CHILD="1"))
    script_s = time.perf_counter() - t0
    out = json.loads(result.read_text())
    newest = f"step_{WEDGE_SCRIPT // every * every}"
    if rc != 0 or mark.read_text() != "2" or not (
            out["resumed_from"] or "").endswith(newest):
        raise AssertionError(f"(d) script: rc {rc}, attempts "
                             f"{mark.read_text()}, {out}, expected a resume "
                             f"from {newest}; attempt logs "
                             f"{attempt_logs(root)}")
    launches = out["launches"]
    if min(launches.values()) <= 0:
        raise AssertionError(f"(d) script launches {launches}")
    return mark, out, newest, script_s, launches


def pinned_rate(nbytes, device, reps=5):
    """GB/s of a host-to-device copy of nbytes from pinned memory."""
    host = torch.empty(nbytes // 4, dtype=torch.float32, pin_memory=True)
    dev = torch.empty_like(host, device=device)
    ms = cuda_ms(lambda: dev.copy_(host, non_blocking=True), reps)
    return nbytes / (ms / 1e3) / 1e9


def phase_streamed(kt, data, cg, device, card):
    """(e) the full-width KG with Gene rows POPS_DIM wide (4.62 GB of host
    table): CMP_STEPS train steps in device memory and with
    stream_features=["Gene"] from the same initial state (losses at rtol
    1e-5, parameters within PARAM_ATOL), each step's ms, the host-to-device
    bytes per step (two passes over the table) and the rate reached beside
    a pinned copy of one chunk, the host gather time; then KGWAS.train and
    predict_all streamed (launches from 0 just before) against the
    in-device model at the same weights. Returns the launches."""
    from kgwas_tpu_torch.engine.loop import epoch_batches, train_step
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.engine.streamed import train_step_streamed
    from kgwas_tpu_torch.ops import streaming

    t0 = time.perf_counter()
    n_gene, n_pad = cg.num_nodes["Gene"], cg.padded_nodes["Gene"]
    wide = np.zeros((n_pad, POPS_DIM), dtype=np.float32)
    np.random.default_rng(SEED).random(out=wide[:n_gene], dtype=np.float32)
    data_w = copy.copy(data)
    data_w.compiled = dataclasses.replace(cg, node_x={**cg.node_x,
                                                      "Gene": wide})
    data_w.gene_init_dim_size = POPS_DIM
    data_w.train_mask = np.asarray(data.train_mask)[:CMP_STEPS * BATCH]
    runs = {}
    for tag, kw in (("hbm", {}), ("streamed", {"stream_features": ["Gene"]})):
        run = kt.KGWAS(data_w, exp_name=f"chip_smoke_{tag}", seed=SEED)
        run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN,
                             **kw)
        run._device_state()
        runs[tag] = run
    setup_s = time.perf_counter() - t0
    hbm, st = runs["hbm"], runs["streamed"]
    init = copy.deepcopy(hbm.model.state_dict())
    _, x_h, lay_h = hbm._device_state()
    cg_w, x_s, lay_s = st._device_state()
    y_node, w_node = hbm._labels(cg_w)
    batches = [torch.from_numpy(b).to(device) for b in
               epoch_batches(data_w.train_mask, BATCH, False, None)]
    losses = {"hbm": [], "streamed": []}
    ms = {"hbm": [], "streamed": []}
    gather_s, h2d = [], []
    opt_h = build_optimizer(hbm.model.parameters(), LR, 5e-4)
    opt_s = build_optimizer(st.model.parameters(), LR, 5e-4)
    long_counts(zero=True)
    for b in batches:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses["hbm"].append(float(train_step(hbm.model, opt_h, x_h, lay_h,
                                              b, y_node, w_node)))
        ms["hbm"].append((time.perf_counter() - t0) * 1e3)
        streaming.reset_stats()
        t0 = time.perf_counter()
        losses["streamed"].append(float(train_step_streamed(
            st.model, opt_s, x_s, lay_s, st._x_host, cg_w.padded_nodes, b,
            y_node, w_node)))
        ms["streamed"].append((time.perf_counter() - t0) * 1e3)
        gather_s.append(streaming.stats["gather_s"])
        h2d.append(streaming.stats["h2d_bytes"])
    counts = long_counts()
    table_bytes = n_gene * POPS_DIM * 4
    # two passes over the table a step (none cross on a CPU rehearsal)
    want = 2 * table_bytes if device.type == "cuda" else 0
    if h2d != [want] * len(batches):
        raise AssertionError(f"(e) host-to-device bytes per step {h2d}, "
                             f"expected {want}")
    np.testing.assert_allclose(losses["streamed"], losses["hbm"], rtol=1e-5)
    diff = max(float((a - b).abs().max()) for a, b in zip(
        st.model.state_dict().values(), hbm.model.state_dict().values()))
    if diff > PARAM_ATOL:
        raise AssertionError(f"(e) parameters differ by {diff:.3e}")
    per_step = sum(len(g) for g in st.model.live_groups(lay_s)[0])
    expect_launches(counts, 2 * per_step, len(batches), 0, "(e) steps")
    probe = pinned_rate(n_gene * streaming.COL_CHUNK * 4, device)
    log(f"phase 11e [{card}]: streamed Gene features {n_gene} x {POPS_DIM} "
        f"({table_bytes / 1e9:.2f} GB on the host; set-up {setup_s:.1f} s): "
        f"{len(batches)} steps, losses in device memory {losses['hbm']} "
        f"streamed {losses['streamed']}, parameters within {diff:.3e}; step "
        f"ms in device memory {[round(v, 3) for v in ms['hbm']]}, streamed "
        f"{[round(v, 3) for v in ms['streamed']]}; {h2d[-1] / 1e9:.3f} GB "
        f"to the device per step, {h2d[-1] / 1e9 / (ms['streamed'][-1] / 1e3):.2f} "
        f"GB/s over the streamed step against {probe:.2f} GB/s for a "
        f"pinned copy of one chunk; host gather "
        f"{[round(s, 3) for s in gather_s]} s per step")

    # the entry points: train over the same batches and predict_all
    st.model.load_state_dict(init)
    long_counts(zero=True)
    t0 = time.perf_counter()
    table = st.train(batch_size=BATCH, epoch=1, lr=LR, save_best_model=False,
                     scan_steps=0)
    train_s = time.perf_counter() - t0
    pred = st.predict_all()
    entry = long_counts()
    expect_launches(entry, per_step, len(batches), 3, "(e) train")
    hbm.model.load_state_dict(st.model.state_dict())
    ref = hbm.predict_all()
    np.testing.assert_allclose(pred, ref, rtol=PRED_RTOL, atol=PRED_ATOL)
    kp = table["KGWAS_P"]
    if not (np.isfinite(kp).all() and (kp >= 0).all() and (kp <= 1).all()):
        raise AssertionError("(e) KGWAS_P not finite in [0, 1]")
    log(f"phase 11e ok [{card}]: KGWAS.train streamed over {len(batches)} "
        f"batches in {train_s:.1f} s, predict_all equal to the in-device "
        f"forward at the same weights (rtol {PRED_RTOL}); launches of the "
        f"steps {counts}, of train and predict_all {entry}")
    del runs, hbm, st, wide, data_w
    torch.cuda.empty_cache()
    return add_counts((1, counts), (1, entry))


def write_ukbb(root, n, kin_pairs, icd_width, batches, seed=SEED):
    """Fabricated UK Biobank files at the cohort's size, in the showcase's
    layout: main.csv (eid; the QC fields 22006, 22018, 22019, 22001, 22010
    and sex 31; age 21003 and centre 54 over 4 visits; the 40 PCs of 22009;
    a phenotype, 50, over 4 visits; ICD10 codes of 41270), a kinship table
    (ID1 ID2 HetHet IBS0 Kinship) and a fam file of genotyping batches.
    Returns (their paths, the QC pass mask, the ICD10 level-2 grid)."""
    rng = np.random.default_rng(seed)
    eid = np.arange(1_000_000, 1_000_000 + n)

    def num(x, decimals=None):
        """Text cells: integers, or floats rounded to decimals as the
        showcase gives them; NaN as an empty cell."""
        nan = np.isnan(x)
        if decimals is None:
            text = np.where(nan, 0, x).astype(np.int64).astype(str)
        else:
            text = np.round(x, decimals).astype(str)
        text = text.astype(object)
        text[nan] = ""
        return text

    def missing(x, frac):
        x = x.astype(np.float64)
        x[rng.random(n) < frac] = np.nan
        return x

    cols = {"eid": eid.astype(str).astype(object)}
    sex = rng.integers(0, 2, n).astype(np.float64)
    cols["31-0.0"] = num(sex)
    for v in range(4):
        cols[f"50-{v}.0"] = num(missing(np.round(rng.normal(170, 10, n), 1),
                                        0.05 + 0.3 * v), 1)
    centres = np.arange(11001, 11023, dtype=np.float64)
    for v in range(4):
        cols[f"54-{v}.0"] = num(missing(rng.choice(centres, n),
                                        0.0 if v == 0 else 0.8))
    for v in range(4):
        cols[f"21003-{v}.0"] = num(missing(rng.integers(40, 71, n) + 4.0 * v,
                                           0.0 if v == 0 else 0.8))
    geno_sex = sex.copy()
    flip = rng.random(n) < 0.002
    geno_sex[flip] = 1 - geno_sex[flip]
    geno_sex = missing(geno_sex, 0.01)
    cols["22001-0.0"] = num(geno_sex)
    anc = np.where(rng.random(n) < 0.82, 1.0, np.nan)
    cols["22006-0.0"] = num(anc)
    for i in range(1, 41):
        cols[f"22009-0.{i}"] = num(missing(rng.normal(0, 20.0 / i, n), 0.01), 4)
    qc = {}
    for f, frac in (("22010-0.0", 0.001), ("22018-0.0", 0.0015),
                    ("22019-0.0", 0.001)):
        qc[f] = np.where(rng.random(n) < frac, 1.0, np.nan)
        cols[f] = num(qc[f])
    # ICD10: each participant's codes (Poisson, mean 3) from 1,600 codes of
    # 400 level-2 groups with a heavy-tailed frequency, first codes first
    groups = np.array([f"{chr(65 + i // 100)}{i % 100:02d}"
                       for i in range(400)], dtype=object)
    vocab = np.array([f"{g}{k}" for g in groups for k in range(4)],
                     dtype=object)
    p = 1.0 / np.arange(1, len(vocab) + 1) ** 1.1
    draws = rng.choice(len(vocab), (n, icd_width), p=p / p.sum())
    count = np.minimum(rng.poisson(3.0, n), icd_width)
    present = np.arange(icd_width)[None, :] < count[:, None]
    codes = vocab[draws]
    for k in range(icd_width):
        cells = codes[:, k].copy()
        cells[~present[:, k]] = ""
        cols[f"41270-0.{k}"] = cells
    main = root / "main.csv"
    names = list(cols)
    with open(main, "w") as f:
        f.write(",".join(names) + "\n")
        step = 50_000
        for s in range(0, n, step):
            block = [cols[c][s:s + step].tolist() for c in names]
            f.write("\n".join(map(",".join, zip(*block))) + "\n")

    pairs = rng.choice(eid, (kin_pairs, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    kin = root / "kinship.dat"
    with open(kin, "w") as f:
        f.write("ID1 ID2 HetHet IBS0 Kinship\n")
        f.writelines(f"{a} {b} 0.0{k} 0.00{k} 0.{k:03d}\n" for (a, b), k in
                     zip(pairs.tolist(), rng.integers(1, 300, len(pairs))))
    names_b = ([f"Batch_b{i:03d}" for i in range(1, batches - 10)]
               + [f"UKBiLEVEAX_b{i}" for i in range(1, 12)])
    genotyped = eid[rng.random(n) < 0.97]
    fam = root / "fam.csv"
    with open(fam, "w") as f:
        f.write("fid,trait\n")
        f.writelines(f"{e},{b}\n" for e, b in zip(
            genotyped.tolist(), rng.choice(names_b, len(genotyped)).tolist()))
    passed = ((anc == 1) & np.isnan(qc["22018-0.0"])
              & np.isnan(qc["22019-0.0"]) & (sex == geno_sex)
              & np.isnan(qc["22010-0.0"]))
    level2 = np.where(present, groups[draws // 4], "")
    return (main, kin, fam), passed, level2


def phase_cohort(kt, card, tmp):
    """(f) kgwas_tpu_torch.cohort.ukbb on fabricated UK Biobank files at
    the cohort's size (UKBB), end to end: __init__ (QC, kinship),
    get_covariates(to_plink=True), get_phenotype(to_plink=True,
    normalize="quantile_normalization", frac=0.1), get_icd10(to_plink=True);
    host seconds by stage, on numpy and scipy alone. Checks: the QC count
    against the fabrication's pass mask, the PLINK files' shapes, finite
    values, the ICD10 columns against the codes with more than 100 cases
    counted from the fabrication."""
    import shutil

    from kgwas_tpu_torch.cohort import ukbb

    root = tmp / "ukbb"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    t0 = time.perf_counter()
    (main, kin, fam), passed, level2 = write_ukbb(root, **UKBB)
    write_s = time.perf_counter() - t0
    size_mb = os.path.getsize(main) / 1e6
    stages = {}
    fam_path = ukbb.fam_path
    ukbb.fam_path = str(fam)
    try:
        t0 = time.perf_counter()
        c = ukbb.ukbb_cohort(str(main), str(root / "cohort"), "/nonexistent",
                             keep_relatives=False,
                             kinship_table_path=str(kin))
        stages["__init__"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        covar = c.get_covariates(to_plink=True)
        stages["get_covariates"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        pheno = c.get_phenotype(50, to_plink=True,
                                normalize="quantile_normalization", frac=0.1)
        stages["get_phenotype"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        icd = c.get_icd10(to_plink=True)
        stages["get_icd10"] = time.perf_counter() - t0
    finally:
        ukbb.fam_path = fam_path
    with_rel = ukbb.load_dict(str(root / "cohort"
                                  / "cohort_with_relatives.pkl"))
    if len(with_rel) != int(passed.sum()):
        raise AssertionError(f"(f) {len(with_rel)} pass QC, the fabrication "
                             f"says {int(passed.sum())}")
    n_cohort = len(c.cohort)
    if not (0 < n_cohort < len(with_rel)):
        raise AssertionError(f"(f) kinship pruning left {n_cohort}")
    if len(covar) != 21 or len(covar[0]) != UKBB["n"]:
        raise AssertionError(f"(f) covariates {len(covar)} columns, "
                             f"{len(covar[0])} rows")
    vals = np.asarray(pheno[2], dtype=np.float64)
    if not np.isfinite(vals).all() or len(pheno) != 3:
        raise AssertionError("(f) the phenotype file is not finite")
    keep = np.isin(np.arange(UKBB["n"]) + 1_000_000, c.cohort)
    cases = {}
    for row in level2[keep]:
        for g in set(row.tolist()) - {""}:
            cases[g] = cases.get(g, 0) + 1
    common = sorted(g for g, k in cases.items() if k > 100)
    if list(icd)[2:] != common or len(icd["FID"]) != n_cohort:
        raise AssertionError(f"(f) ICD10: {len(icd) - 2} codes, expected "
                             f"{len(common)}")
    with open(root / "cohort" / "icd10_plink_no_relatives_level2.txt") as f:
        head = [f.readline().split() for _ in range(2)]
    if head[0] != list(icd) or len(head[1]) != len(icd):
        raise AssertionError("(f) the ICD10 file's first lines")
    log(f"phase 11f ok [{card}]: cohort builder on {UKBB['n']} "
        f"participants ({size_mb:.0f} MB main table, {UKBB['icd_width']} "
        f"ICD10 columns, {UKBB['kin_pairs']} kinship pairs; written in "
        f"{write_s:.1f} s): {len(with_rel)} pass QC, {n_cohort} without "
        f"relatives; phenotype file {len(pheno[0])} rows, ICD10 "
        f"{len(common)} codes with more than 100 cases; host s "
        + ", ".join(f"{k} {v:.2f}" for k, v in stages.items()))


# ---------------------------------------------------------------------------
# phase 12: the bf16 dtypes (stream_dtype, compute_dtype) at full width, and
# phase 13: the quality gate of the bf16 modes
# ---------------------------------------------------------------------------

BF16_KERNELS = ("merged_gat_fwd_bf16", "merged_gat_bwd_bf16",
                "csc_segment_sum_bf16", "csr_segment_sum_bf16",
                "segment_softmax_spmm_fwd_bf16",
                "segment_softmax_spmm_bwd_bf16",
                # #1 and #2 bf16's scores per source row, one launch per
                # bf16 merged layer forward (no f32 instance)
                "merged_gat_a_src_bf16")
# the per-relation softmax GAT's (#6, #7): phase 12's relation runs
REL_BF16 = ("segment_softmax_spmm_fwd_bf16", "segment_softmax_spmm_bwd_bf16")
# phase 12's relation timing of #8 bf16: its launches after #7 bf16 (no
# logit term), reported beside phase 12a's GAT-sum row
REL_CSC = "csc_segment_sum_bf16 relation"
# each bf16 kernel's f32 family (path_launches counts the family)
BF16_FAMILY = {"merged_gat_fwd_bf16": "merged_gat_fwd",
               "merged_gat_bwd_bf16": "merged_gat_bwd",
               "csc_segment_sum_bf16": "csc_segment_sum",
               "csr_segment_sum_bf16": "csr_segment_sum",
               "segment_softmax_spmm_fwd_bf16": "segment_softmax_spmm_fwd",
               "segment_softmax_spmm_bwd_bf16": "segment_softmax_spmm_bwd"}
# the TPU kernel each replaces (its Pallas body), PERF.md's table
BF16_REPLACES = {
    "merged_gat_fwd_bf16": "kgwas_tpu/ops/pallas_gat_layer.py:210",
    "merged_gat_bwd_bf16": "kgwas_tpu/ops/pallas_gat_layer.py:387",
    "csc_segment_sum_bf16": "kgwas_tpu/ops/pallas_segment.py:659",
    "csr_segment_sum_bf16": "kgwas_tpu/ops/pallas_segment.py:659",
    "segment_softmax_spmm_fwd_bf16": "kgwas_tpu/ops/pallas_segment.py:220",
    "segment_softmax_spmm_bwd_bf16": "kgwas_tpu/ops/pallas_segment.py:370",
    # the score att . msgs in _logits_row, which #1 and #2's bodies call
    "merged_gat_a_src_bf16": "kgwas_tpu/ops/pallas_gat_layer.py:183",
}
BF16_SOURCE = {
    "merged_gat_fwd_bf16": "kgwas_tpu_torch/ops/csrc/merged_gat_fwd.cu",
    "merged_gat_bwd_bf16": "kgwas_tpu_torch/ops/csrc/merged_gat_bwd.cu",
    "csc_segment_sum_bf16": "kgwas_tpu_torch/ops/csrc/csc_segment_sum.cu",
    "csr_segment_sum_bf16": "kgwas_tpu_torch/ops/csrc/csr_segment_sum.cu",
    "segment_softmax_spmm_fwd_bf16":
        "kgwas_tpu_torch/ops/csrc/segment_softmax_spmm_fwd.cu",
    "segment_softmax_spmm_bwd_bf16":
        "kgwas_tpu_torch/ops/csrc/segment_softmax_spmm_bwd.cu",
    "merged_gat_a_src_bf16": "kgwas_tpu_torch/ops/csrc/merged_gat_fwd.cu",
}
# the published bf16 tensor-core peak (dense): the least time for the
# operations on bf16 inputs
BF16_FLOPS = 989e12
# a bf16 kernel against its plain bf16 version: the same rounding points,
# float32 sums in another order. A value both round to bf16 from float32
# values a few ulps apart can round to the neighbouring bf16 value: at
# most BF16_OFF_ROWS of the rows (of the values, for d_xs) miss the f32
# tolerances, each within BF16_RTOL (a weight's bf16 ulp, 2^-8, of its
# share) or 2^-8 of its row's largest value
BF16_OFF_ROWS, BF16_RTOL = 1e-3, 1e-2
# the model through the kernels against the plain ops, and the JAX
# package's port tests' bound (tests/test_torch_bf16_model.py)
BF16_PRED_RTOL, BF16_PRED_ATOL, BF16_LOSS_RTOL = 1e-2, 1e-3, 1e-2
BF16_VARIANTS = {
    "GAT-sum stream": dict(stream_dtype="bfloat16"),
    "GAT-sum compute": dict(compute_dtype="bfloat16"),
    "GCN compute": dict(gnn_backbone="GCN", compute_dtype="bfloat16"),
    "SAGE compute": dict(gnn_backbone="SAGE", compute_dtype="bfloat16"),
    "GAT-max sigmoid compute": dict(gnn_aggr="max", sigmoid_gat=True,
                                    compute_dtype="bfloat16"),
    # the per-relation softmax GAT (#6 and #7 in bf16), 3 batches each
    "GAT-max stream": dict(gnn_aggr="max", stream_dtype="bfloat16"),
    "GAT-max compute": dict(gnn_aggr="max", compute_dtype="bfloat16"),
    "GAT-min stream": dict(gnn_aggr="min", stream_dtype="bfloat16"),
    "GAT-min compute": dict(gnn_aggr="min", compute_dtype="bfloat16"),
    "GAT-sum edge_dim stream": dict(edge_dim=4, stream_dtype="bfloat16"),
    "GAT-sum edge_dim compute": dict(edge_dim=4, compute_dtype="bfloat16"),
}
# the runs whose bf16 launches over a full-width epoch of train_steps the
# kernel table reports (the epoch's step count times one step's launches,
# each of CMP_STEPS steps held to the first's): #1, #2 and #8 bf16 (and the
# score pass) under each dtype option; #6, #7 and #8 bf16 under
# stream_dtype; #10 and #8 bf16 under compute_dtype
EPOCH_VARIANTS = ("GAT-sum stream", "GAT-sum compute", "GAT-max stream",
                  "SAGE compute")
# the relation runs whose #6 / #7 launches are timed (the kernel table's
# rows: the compute dtype's, as --dtype bfloat16 sets it)
REL_TIMED = ("GAT-max stream", "GAT-max compute")


def bf16_counts(zero=False):
    """Launch counts of the six bf16 instances and the score pass (set to
    0 first with zero)."""
    from kgwas_tpu_torch.ops import gat_layer, segment, segment_softmax

    if zero:
        gat_layer.bf16_launches = gat_layer.bf16_bwd_launches = 0
        gat_layer.a_src_launches = 0
        segment.bf16_launches = segment.csr_bf16_launches = 0
        segment_softmax.bf16_launches = segment_softmax.bf16_bwd_launches = 0
    return dict(zip(BF16_KERNELS, (
        gat_layer.bf16_launches, gat_layer.bf16_bwd_launches,
        segment.bf16_launches, segment.csr_bf16_launches,
        segment_softmax.bf16_launches, segment_softmax.bf16_bwd_launches,
        gat_layer.a_src_launches)))


def all_counts(zero=False):
    """The f32 instances' counts and the bf16 instances', one dict."""
    return {**model_counts(zero), **bf16_counts(zero)}


def family_totals(counts):
    """The counts of each f32 family, its bf16 instance's added."""
    out = {k: counts[k] for k in MODEL_KERNELS}
    for k, fam in BF16_FAMILY.items():
        out[fam] += counts[k]
    return out


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def bf16_bound(nb, flops):
    """(bytes ms, operations ms) of bytes nb moved and flops on bf16
    inputs, at the card's published peaks."""
    return nb / HBM_BPS * 1e3, flops / BF16_FLOPS * 1e3


def bf16_rows_check(got, want, trash, what):
    """Rows of a forward output: at most BF16_OFF_ROWS of them outside the
    f32 tolerances (trash rows at TRASH_RTOL), every one within
    BF16_RTOL. Returns (max abs err, rows off)."""
    g = got.detach().double().reshape(len(trash), -1)
    w = want.detach().double().reshape(len(trash), -1)
    err = (g - w).abs()
    rtol = row_rtol(trash, w)[:, None]
    off = int((err > ATOL + rtol * w.abs()).any(dim=1).sum())
    if off > max(1, BF16_OFF_ROWS * len(trash)) or bool(
            (err > 1e-4 + BF16_RTOL * w.abs()).any()):
        raise AssertionError(f"{what}: {off} of {len(trash)} rows off, max "
                             f"abs err {float(err.max()):.3e}")
    return float(err.max()), off


def bf16_grad_check(got, want, what, rtol=1e-4):
    """A gradient: at most 1 value in 10^4 outside rtol with an absolute
    floor of 1e-5 of the largest value, each within 2^-8 of its row's
    largest |value|. Returns (max abs err, values off)."""
    g, w = got.detach().double(), want.detach().double()
    err, a = (g - w).abs(), w.abs()
    off = int((err > 1e-5 * a.max() + rtol * a).sum())
    scale = a.max() if w.dim() == 1 else a.amax(dim=1, keepdim=True)
    if off > max(1, err.numel() // 10 ** 4) or bool(
            (err > 2.0 ** -8 * scale + 1e-6).any()):
        raise AssertionError(f"{what}: {off} of {err.numel()} values off, "
                             f"max abs err {float(err.max()):.3e}")
    return float(err.max()), off


def gather_floors_bf16(cg, layouts, rates16, rates32):
    """The bf16 instances' gather floors over one GAT-sum forward or step
    (Gene once, SNP twice) and the SAGE forward's bf16 launches (layer 1:
    Gene and SNP once): the merged GAT kernels and the CSR sum gather
    256-byte bf16 rows at the bf16 probe's rate; the CSC sum gathers the
    float32 cotangent rows (512 bytes) at the f32 probe's."""
    def ms(edges, table_rows, row_bytes, rates):
        kind = "l2" if table_rows * row_bytes <= L2_TABLE_BYTES else "hbm"
        return edges * row_bytes / (rates[kind] * 1e12) * 1e3

    live = {"Gene": 1, "SNP": 2}
    merged = sum(k * ms(len(layouts[t].src), layouts[t].n_src_total,
                        HIDDEN * 2, rates16) for t, k in live.items())
    csc = sum(k * ms(len(layouts[t].src), layouts[t].n_rows_per_rel,
                     HIDDEN * 4, rates32) for t, k in live.items())
    csr = sum(ms(len(layouts[t].src), layouts[t].n_src_total, HIDDEN * 2,
                 rates16) for t in live)
    # #6 / #7: each relation's bf16 source rows, per forward or step
    rel = sum(k * ms(len(cg.relations[rk].src),
                     cg.padded_nodes[cg.relations[rk].src_type], HIDDEN * 2,
                     rates16)
              for t, k in live.items() for rk in layouts[t].rel_keys)
    # #8 after #7 (no logit term): each relation's float32 cotangent rows
    rel_csc = sum(k * ms(len(cg.relations[rk].src),
                         cg.padded_nodes[cg.relations[rk].dst_type],
                         HIDDEN * 4, rates32)
                  for t, k in live.items() for rk in layouts[t].rel_keys)
    floors = {"merged_gat_a_src_bf16": None,   # reads its rows in order
              "merged_gat_fwd_bf16": merged, "merged_gat_bwd_bf16": merged,
              "csc_segment_sum_bf16": csc, "csr_segment_sum_bf16": csr,
              "segment_softmax_spmm_fwd_bf16": rel,
              "segment_softmax_spmm_bwd_bf16": rel, REL_CSC: rel_csc}
    log("  bf16 gather floors per forward or step: "
        + "; ".join(f"{k} {v:.4f} ms" for k, v in floors.items()
                    if v is not None))
    return floors


def sparse_mm_bf16(x, src, ro, w):
    """torch.sparse.mm of the CSR matrix (values w, or 1, in bf16) against
    the bf16 table x, or None where the card's PyTorch refuses bf16 sparse
    CSR products (the reason logged)."""
    vals = (w if w is not None else torch.ones(src.numel(),
                                               device=x.device))
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            a = torch.sparse_csr_tensor(ro, src, vals.to(torch.bfloat16),
                                        size=(ro.numel() - 1, x.shape[0]),
                                        check_invariants=False)
            torch.sparse.mm(a, x)
            torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError) as e:
        log(f"    torch.sparse.mm in bf16 refused: {str(e).splitlines()[0]}")
        return None
    return lambda: torch.sparse.mm(a, x)


def phase_bf16_kernels(kt, cg, device, card, floors16, parent=None):
    """Phase 12a: each bf16 instance against its plain bf16 version at full
    width (the GAT-sum layer's Gene and SNP groups, fold R, softmax, random
    bf16 tables; the CSR sum on the merged SNP and Gene groups, unweighted
    and with the f32 and the bf16 norm), and its times over one forward or
    step: host-paced ms, device ms, plain ms, bound (each input read once
    and each output written once at its own width; operations at the bf16
    peak), gather floor, the f32 instance on the same values, and for the
    CSR sum torch.sparse.mm in bf16. #1 bf16 is timed with its score pass
    (merged_gat_a_src_bf16, a forward's first launch, also timed alone),
    #2 bf16 on the forward's scores, as the layer runs them; with parent
    (KGWAS_PARENT_CSRC) the earlier checkout's #1 and #2 bf16, which score
    every edge themselves, and its #8 and #10 bf16 are timed in turns with
    them (this, earlier, earlier, this) and their outputs compared bit for
    bit (#10 in its three forms).
    #8 bf16's library call: index_add_ of the materialised message
    cotangent, each row rounded to bf16 as the kernel rounds it (held in
    float32, so the sums are the kernel's function). Returns {kernel: row
    totals}."""
    from kgwas_tpu_torch.graph import build_merged_layouts
    from kgwas_tpu_torch.kgwas import TILE_ROWS
    from kgwas_tpu_torch.models import device_layouts
    from kgwas_tpu_torch.ops import gat_layer, segment
    from kgwas_tpu_torch.ops.segment_ref import round_bf16

    t0 = time.perf_counter()
    host = build_merged_layouts(cg, tile_rows=TILE_ROWS)
    dls = device_layouts(host, device, cg, ("merged", "mp"))
    gen = torch.Generator(device=device).manual_seed(SEED + 12)
    mine = [k for k in BF16_KERNELS if k not in REL_BF16]
    rows = {k: dict.fromkeys(("ms", "device_ms", "plain_ms", "bound_ms",
                              "bytes", "operations", "f32_ms",
                              "f32_device_ms"), 0.0)
            for k in mine}
    rows["csr_segment_sum_bf16"]["library_ms"] = 0.0
    rows["csc_segment_sum_bf16"]["library_ms"] = 0.0
    rows["merged_gat_a_src_bf16"].update(f32_ms=None, f32_device_ms=None)
    earlier = parent is not None and parent.has_bf16
    earlier_seg = parent is not None
    for k, e in (("merged_gat_fwd_bf16", earlier),
                 ("merged_gat_bwd_bf16", earlier),
                 ("csc_segment_sum_bf16", earlier_seg),
                 ("csr_segment_sum_bf16", earlier_seg)):
        rows[k].update(parent_ms=0.0, parent_device_ms=0.0) if e \
            else rows[k].update(parent_ms=None, parent_device_ms=None)
    not_bitwise = []   # (kernel, group, output) off the earlier bits
    worst = dict.fromkeys(mine, 0.0)
    off = dict.fromkeys(mine, 0)
    lib_ok = True

    def timed(name, k, fn, plain_fn, f32_fn, bound, parent_fn=None):
        """Adds k times the launch's times to its row; with parent_fn the
        earlier kernel's in turns (this, earlier, earlier, this)."""
        r = rows[name]
        ms, dev = [cuda_ms(fn, 10)], [graph_ms(fn, 10)]
        if parent_fn is not None:
            pms = [cuda_ms(parent_fn, 10) for _ in range(2)]
            pdev = [graph_ms(parent_fn, 10) for _ in range(2)]
            r["parent_ms"] += k * statistics.mean(pms)
            r["parent_device_ms"] += k * statistics.mean(pdev)
            ms.append(cuda_ms(fn, 10))
            dev.append(graph_ms(fn, 10))
        r["ms"] += k * statistics.mean(ms)
        r["device_ms"] += k * statistics.mean(dev)
        r["plain_ms"] += k * cuda_ms(plain_fn, 2)
        if f32_fn is not None:
            r["f32_ms"] += k * cuda_ms(f32_fn, 10)
            r["f32_device_ms"] += k * graph_ms(f32_fn, 10)
        r["bytes"] += k * bound[0]
        r["operations"] += k * bound[1]
        r["bound_ms"] += k * max(bound)

    def same_bits(name, t, names, got, old):
        for what, a, b in zip(names, got, old):
            if not torch.equal(a, b):
                not_bitwise.append((name, t, what))

    for t, k in (("Gene", 1), ("SNP", 2)):
        L, DL = host[t], dls[t]
        R, n, d = len(L.rel_keys), L.n_rows_per_rel, HIDDEN
        xs = (torch.randn(L.n_src_total, d, device=device, generator=gen)
              * 0.1).to(torch.bfloat16)
        xs32 = xs.float()
        att = torch.randn(R, d, device=device, generator=gen) * 0.2
        ad = torch.randn(L.n_rows_total, device=device, generator=gen) * 0.5
        g = torch.randn(n, d, device=device, generator=gen)
        e = DL.src.numel()
        sched = gat_layer.layout_schedule(DL, R)
        bsched = gat_layer.layout_schedule(DL, R, backward=True)
        fa = (DL.src, DL.row_offsets, att, ad, n, R, "softmax", 0.2, 1.0)
        base = DL.src_base
        trash = np.zeros(n, dtype=bool)
        trash[cg.num_nodes[t]] = True
        # the score pass: bitwise repeatable, against its plain version
        a_src = gat_layer.merged_gat_a_src(xs, att, base)
        if not torch.equal(a_src, gat_layer.merged_gat_a_src(xs, att, base)):
            raise AssertionError(f"merged_gat_a_src_bf16 {t}: two runs "
                                 "differ")
        a_plain = gat_layer.merged_gat_a_src_plain(xs, att, base)
        err = float((a_src - a_plain).abs().max())
        if not torch.allclose(a_src, a_plain, rtol=1e-5, atol=1e-6):
            raise AssertionError(f"merged_gat_a_src_bf16 {t}: max abs err "
                                 f"{err:.3e} against its plain version")
        worst["merged_gat_a_src_bf16"] = max(worst["merged_gat_a_src_bf16"],
                                             err)
        timed("merged_gat_a_src_bf16", k,
              lambda: gat_layer.merged_gat_a_src(xs, att, base),  # noqa: B023
              lambda: gat_layer.merged_gat_a_src_plain(xs, att, base),  # noqa: B023
              None, bf16_bound(nbytes(xs, att, a_src), 2 * d * xs.shape[0]))
        # #1: the score pass and the items, as the layer's forward runs them
        def fwd():
            return gat_layer.merged_gat_forward(
                xs, *fa, sched=sched,  # noqa: B023
                a_src=gat_layer.merged_gat_a_src(xs, att, base))  # noqa: B023

        out, again = fwd(), fwd()
        want = gat_layer.merged_gat_forward_plain(xs, *fa)
        if not all(torch.equal(a, b) for a, b in zip(out, again)):
            raise AssertionError(f"merged_gat_fwd_bf16 {t}: two runs differ")
        if earlier:
            same_bits("merged_gat_fwd_bf16", t, ("out", "row_max", "row_sum"),
                      out, parent.fwd_bf16(xs, *fa, sched=sched,
                                           src_base=base))
        err, o = bf16_rows_check(out[0], want[0], trash,
                                 f"merged_gat_fwd_bf16 {t}")
        slot_trash = np.zeros(L.n_rows_total, dtype=bool)
        slot_trash[cg.num_nodes[t]::n] = True
        for a, b in zip(out[1:], want[1:]):
            err = max(err, bf16_rows_check(a, b, slot_trash,
                                           f"merged_gat_fwd_bf16 {t} stats")
                      [0])
        worst["merged_gat_fwd_bf16"] = max(worst["merged_gat_fwd_bf16"], err)
        off["merged_gat_fwd_bf16"] += o
        timed("merged_gat_fwd_bf16", k, fwd,
              lambda: gat_layer.merged_gat_forward_plain(xs, *fa),  # noqa: B023
              lambda: gat_layer.merged_gat_forward(xs32, *fa, sched=sched),  # noqa: B023
              bf16_bound(nbytes(xs, DL.src, DL.row_offsets, att, ad, *out),
                         4 * d * e),
              functools.partial(parent.fwd_bf16, xs, *fa, sched=sched,
                                src_base=base)
              if earlier else None)
        # #2 on the forward's scores; its bound counts the bytes and dots
        # of the function, which scores each source row once
        ba = (DL.src, DL.row_offsets, att, ad, want[1], want[2], g, n, R,
              "softmax", 0.2, 1.0)
        bwd = functools.partial(gat_layer.merged_gat_bwd, xs, *ba,
                                sched=bsched, a_src=a_src)
        p_a_src = parent.a_src_bf16(xs, att, base) if earlier else None
        bk, bk2 = bwd(), bwd()
        bp = gat_layer.merged_gat_bwd_plain(xs, *ba)
        if not all(torch.equal(a, b) for a, b in zip(bk, bk2)):
            raise AssertionError(f"merged_gat_bwd_bf16 {t}: two runs differ")
        if earlier:
            same_bits("merged_gat_bwd_bf16", t, ("w", "dz", "d_a_dst"), bk,
                      parent.bwd_bf16(xs, *ba, sched=bsched,
                                      a_src=p_a_src))
        for a, b in zip(bk, bp):
            err, o = bf16_grad_check(a, b, f"merged_gat_bwd_bf16 {t}")
            worst["merged_gat_bwd_bf16"] = max(worst["merged_gat_bwd_bf16"],
                                               err)
            off["merged_gat_bwd_bf16"] += o
        timed("merged_gat_bwd_bf16", k, bwd,
              lambda: gat_layer.merged_gat_bwd_plain(xs, *ba),  # noqa: B023
              lambda: gat_layer.merged_gat_bwd(xs32, *ba, sched=bsched),  # noqa: B023
              bf16_bound(nbytes(xs, DL.src, DL.row_offsets, att, ad, want[1],
                                want[2], g, *bk),
                         4 * d * e + 2 * d * xs.shape[0]),
              functools.partial(parent.bwd_bf16, xs, *ba, sched=bsched,
                                a_src=p_a_src)
              if earlier else None)
        # #8 with the logit term
        w, dz = bk[0], bk[1]
        ck = segment.csc_segment_sum(g, w, dz, xs, att, DL, R)
        ck2 = segment.csc_segment_sum(g, w, dz, xs, att, DL, R)
        cp = segment.csc_segment_sum_plain(g, w, dz, xs, att, DL, R)
        if not all(torch.equal(a, b) for a, b in zip(ck, ck2)):
            raise AssertionError(f"csc_segment_sum_bf16 {t}: two runs differ")
        if earlier_seg:
            same_bits("csc_segment_sum_bf16", t, ("d_xs", "d_att"), ck,
                      parent.csc_bf16(g, w, dz, xs, att, DL, R))
        err, o = bf16_grad_check(ck[0], cp[0], f"csc_segment_sum_bf16 {t}")
        err2, _ = bf16_grad_check(ck[1], cp[1],
                                  f"csc_segment_sum_bf16 {t} d_att")
        worst["csc_segment_sum_bf16"] = max(worst["csc_segment_sum_bf16"],
                                            err, err2)
        off["csc_segment_sum_bf16"] += o
        timed("csc_segment_sum_bf16", k,
              lambda: segment.csc_segment_sum(g, w, dz, xs, att, DL, R),  # noqa: B023
              lambda: segment.csc_segment_sum_plain(g, w, dz, xs, att, DL,  # noqa: B023
                                                    R),
              lambda: segment.csc_segment_sum(g, w, dz, xs32, att, DL, R),  # noqa: B023
              bf16_bound(nbytes(g, w, dz, xs, att, DL.csc_rows, DL.csc_perm,
                                DL.csc_offsets, *ck), 4 * d * e),
              functools.partial(parent.csc_bf16, g, w, dz, xs, att, DL, R)
              if earlier_seg else None)
        # its library call: index_add_ of the bf16-rounded cotangent rows
        dst = DL.dst.long()
        d_msgs = round_bf16(w[:, None] * g[dst % n] + dz[:, None]
                            * att[dst // n])
        src_l = DL.src.long()
        rows["csc_segment_sum_bf16"]["library_ms"] += k * cuda_ms(
            lambda: torch.zeros_like(xs32).index_add_(0, src_l, d_msgs), 5)  # noqa: B023
        del d_msgs, dst, src_l
        del out, again, want, bk, bk2, bp, ck, ck2, cp
        # #10 on the merged group's stream ('mp': the SAGE / GCN sums)
        for wk in (None, DL.sym_e, DL.sym_e.to(torch.bfloat16)):
            args = (xs, DL.src, DL.row_offsets, wk)
            got = segment.csr_segment_sum(*args, sched=DL.row_schedule)
            got2 = segment.csr_segment_sum(*args, sched=DL.row_schedule)
            want = segment.csr_segment_sum_plain(*args)
            if not torch.equal(got, got2):
                raise AssertionError(f"csr_segment_sum_bf16 {t}: two runs "
                                     "differ")
            if earlier_seg:
                same_bits("csr_segment_sum_bf16", t,
                          (f"out ({'unweighted' if wk is None else wk.dtype})",),
                          (got,), (parent.csr_bf16(*args,
                                                   sched=DL.row_schedule),))
            rtrash = np.zeros(L.n_rows_total, dtype=bool)
            rtrash[cg.num_nodes[t]::n] = True
            err, o = bf16_rows_check(got, want, rtrash,
                                     f"csr_segment_sum_bf16 {t}")
            worst["csr_segment_sum_bf16"] = max(
                worst["csr_segment_sum_bf16"], err)
            off["csr_segment_sum_bf16"] += o
            if wk is None:   # the SAGE sum: layer 1, each group once
                timed("csr_segment_sum_bf16", 1,
                      lambda: segment.csr_segment_sum(  # noqa: B023
                          *args, sched=DL.row_schedule),  # noqa: B023
                      lambda: segment.csr_segment_sum_plain(*args),  # noqa: B023
                      lambda: segment.csr_segment_sum(  # noqa: B023
                          xs32, DL.src, DL.row_offsets, None,
                          sched=DL.row_schedule),
                      bf16_bound(nbytes(xs, DL.src, DL.row_offsets, got),
                                 2 * d * e),
                      functools.partial(parent.csr_bf16, *args,
                                        sched=DL.row_schedule)
                      if earlier_seg else None)
                lib = sparse_mm_bf16(*args) if lib_ok else None
                if lib is None:
                    lib_ok = False
                else:
                    rows["csr_segment_sum_bf16"]["library_ms"] += cuda_ms(
                        lib, 10)
        del xs, xs32, g
        torch.cuda.empty_cache()
    if not lib_ok:
        rows["csr_segment_sum_bf16"]["library_ms"] = None

    def opt(v):
        return "none" if v is None else f"{v:.4f}"

    for name, r in rows.items():
        r["max_abs_err"] = worst[name]
        r["floor_ms"] = floors16[name]
        log(f"  phase 12a {name} [{card}]: {r['ms']:.4f} ms [device "
            f"{r['device_ms']:.4f}]"
            + (f", earlier checkout's {r['parent_ms']:.4f} [device "
               f"{r['parent_device_ms']:.4f}]"
               if r.get("parent_ms") is not None else "")
            + f", f32 instance on the same values {opt(r['f32_ms'])} "
            f"[{opt(r['f32_device_ms'])}]; bound "
            f"{r['bound_ms']:.4f} ({r['bytes']:.4f} bytes, "
            f"{r['operations']:.4f} operations), gather floor "
            f"{opt(r['floor_ms'])}, plain {r['plain_ms']:.4f}"
            + (f", {'index_add_' if name == 'csc_segment_sum_bf16' else 'torch.sparse.mm'}"
               f" bf16 {r['library_ms']:.4f}" if r.get("library_ms") else "")
            + f"; max abs err {worst[name]:.3e}, {off[name]} rows or "
            f"values off the f32 tolerance (bf16 rounding neighbours)")
    note = ""
    if earlier or earlier_seg:   # each exception stays held by the bf16 rule
        note = ("; #1 / #2 / #8 / #10 bf16 bitwise the earlier checkout's "
                "on every launch" if not not_bitwise else
                f"; NOT bitwise the earlier checkout's on {not_bitwise}")
    del dls
    torch.cuda.empty_cache()
    log(f"phase 12a ok [{card}]: four bf16 instances and the score pass "
        f"against their plain versions at full width, bitwise repeatable"
        f"{note}; {time.perf_counter() - t0:.1f} s")
    return rows


def relation_bf16_launches(calls_f, calls_b, calls_c, timing,
                           n_timed_f=None, parent=None):
    """Phase 12's relation runs: every recorded launch of #6 and #7 on a
    bf16 table (one forward and one training step) against its plain
    version (the float64 rule) and bitwise the float32 instance on the
    widened operands under the same schedule, and every launch of #8 on a
    bf16 table in that step (after #7, no logit term) against its plain
    version (the bf16 rule); with timing, their sums over the launches:
    host-paced and device ms, plain ms, bound (each input read and each
    output written once at its own width; operations at the bf16 peak) and
    the float32 instance's ms on the widened operands, over the first
    n_timed_f forward launches (one forward's) and every backward launch.
    With parent (KGWAS_PARENT_CSRC), the earlier checkout's #6, #7 and #8
    bf16 on each launch, bit for bit and, with timing, in turns (this,
    earlier, earlier, this), each timed launch logged with its host issue
    time. #7's bound counts the saved out only on the chunked rows
    (softmax_bwd_bytes). Returns ({kernel: worst abs err}, {kernel: totals},
    [(kernel, launch) not bitwise the earlier checkout's]); #8's row is
    REL_CSC."""
    from kgwas_tpu_torch.ops import segment
    from kgwas_tpu_torch.ops import segment_softmax as ss

    earlier = parent is not None
    worst, rows, not_bitwise = {}, {}, []
    for name, calls, fn, plain, pfn in (
            ("segment_softmax_spmm_fwd_bf16", calls_f,
             ss.segment_softmax_spmm_fwd, ss.segment_softmax_spmm_fwd_plain,
             parent.seg_fwd_bf16 if earlier else None),
            ("segment_softmax_spmm_bwd_bf16", calls_b,
             ss.segment_softmax_spmm_bwd, ss.segment_softmax_spmm_bwd_plain,
             parent.seg_bwd_bf16 if earlier else None),
            (REL_CSC, calls_c, segment.csc_segment_sum,
             segment.csc_segment_sum_plain,
             parent.csc_bf16 if earlier else None)):
        tot = dict.fromkeys(("ms", "device_ms", "plain_ms", "bound_ms",
                             "bytes", "operations", "f32_ms",
                             "f32_device_ms"), 0.0)
        if pfn is not None:
            tot.update(parent_ms=0.0, parent_device_ms=0.0)
        err = 0.0
        csc = name == REL_CSC
        xs_at = 3 if csc else 0
        # under compute_dtype the layers after a relation layer's float32
        # output run the float32 instance (their products promote)
        n_timed = n_timed_f if name == REL_BF16[0] else len(calls)
        calls = [(i < n_timed, c) for i, c in enumerate(calls)
                 if c[0][xs_at].dtype == torch.bfloat16]
        if not calls:
            raise AssertionError(f"{name}: no launch on a bf16 table")
        n_t = 0
        for li, (timed_call, (args, kwargs)) in enumerate(calls):
            args = detached(args)
            wide = tuple(a.float() if torch.is_tensor(a)
                         and a.dtype == torch.bfloat16 else a for a in args)
            got = as_tuple(fn(*args, **kwargs))
            if pfn is not None and not all(
                    torch.equal(a, b) for a, b in zip(
                        got, as_tuple(pfn(*args, **kwargs)))
                    if a is not None):
                not_bitwise.append((name, li))
            pkw = {k: v for k, v in kwargs.items() if k != "sched"}
            if csc:
                for a, p in zip(got, as_tuple(plain(*args, **pkw))):
                    if a is not None:
                        err = max(err, bf16_grad_check(
                            a, p, f"full-width {name}")[0])
            else:
                f32 = as_tuple(fn(*wide, **kwargs))
                if not all(torch.equal(a, b) for a, b in zip(got, f32)):
                    raise AssertionError(f"{name}: not bitwise the float32 "
                                         "instance on the widened operands")
                pkw64 = dict(zip(pkw, as_double(tuple(pkw.values()))))
                for a, p, x in zip(got, as_tuple(plain(*args, **pkw)),
                                   as_tuple(plain(*as_double(args),
                                                  **pkw64))):
                    err = max(err, grad_compare(a, p, x,
                                                f"full-width {name}"))
            if not (timing and timed_call):
                continue
            n_t += 1
            if csc:
                # xs is read (with its D-wide dot an edge) only for d_w,
                # as the float32 bound counts it (kernel_bound)
                g, w, _, xs, _, lay = args[:6]
                d, e = xs.shape[1], lay.csc_perm.numel()
                dw = bool(kwargs.get("edge_grad"))
                flops = 2 * d * e * (2 if dw else 1)
                ins = (g, w, xs if dw else None, lay.csc_rows,
                       lay.csc_offsets,
                       None if w is None and not dw else lay.csc_perm)
            else:
                d, ro = args[0].shape[1], args[3]
                e, n_rows = int(ro[-1]), ro.numel() - 1
                flops = 2 * d * (e if name == REL_BF16[0] else e + n_rows)
                ins = tuple(a for a in args if torch.is_tensor(a)) + (
                    kwargs.get("mult"),)
            if name == REL_BF16[1]:   # out only on the chunked rows
                nb = softmax_bwd_bytes(*args[:8], sched=kwargs.get("sched"),
                                       mult=kwargs.get("mult"))
            else:
                nb = nbytes(*ins, *got)
            b_ms, o_ms = bf16_bound(nb, flops)
            tot["bytes"] += b_ms
            tot["operations"] += o_ms
            tot["bound_ms"] += max(b_ms, o_ms)
            call = lambda: fn(*args, **kwargs)  # noqa: B023, E731
            f32_call = lambda: fn(*wide, **kwargs)  # noqa: B023, E731
            ms, dev = [cuda_ms(call, 10)], [graph_ms(call, 10)]
            pms = pdev = ()
            if pfn is not None:
                pcall = lambda: pfn(*args, **kwargs)  # noqa: B023, E731
                pms = [cuda_ms(pcall, 10) for _ in range(2)]
                pdev = [graph_ms(pcall, 10) for _ in range(2)]
                tot["parent_ms"] += statistics.mean(pms)
                tot["parent_device_ms"] += statistics.mean(pdev)
                ms.append(cuda_ms(call, 10))
                dev.append(graph_ms(call, 10))
            tot["ms"] += statistics.mean(ms)
            tot["device_ms"] += statistics.mean(dev)
            tot["plain_ms"] += cuda_ms(lambda: plain(*args, **pkw), 2)  # noqa: B023
            f32_ms, f32_dev = cuda_ms(f32_call, 10), graph_ms(f32_call, 10)
            tot["f32_ms"] += f32_ms
            tot["f32_device_ms"] += f32_dev
            if pfn is not None:   # where the time goes, launch by launch
                hosts = [host_ms(c, 10) for c in (call, f32_call, pcall)]
                sched = lay.csc_schedule if csc else kwargs.get("sched")
                log(f"    {name} launch {li} ("
                    f"{'no' if sched is None else sched.items.shape[0]} items, "
                    f"{e} edges, {args[xs_at].shape[0]} source rows): "
                    f"host-paced "
                    f"{fmt_ms(ms)} [device {fmt_ms(dev)}], earlier "
                    f"{fmt_ms(pms)} [{fmt_ms(pdev)}], float32 instance "
                    f"{f32_ms:.4f} [{f32_dev:.4f}]; host issue a call "
                    f"{fmt_ms(hosts)} (this, float32, earlier)")
        worst[name] = err
        rows[name] = dict(tot, launches_timed=n_t)
    return worst, rows, not_bitwise


def csr_bf16_launches(calls, parent=None):
    """Phase 12's message-passing runs: every recorded launch of #10 on a
    bf16 table (one forward and one step) run twice (the same bits) and
    held against its plain version by the float64 rule and, with parent
    (KGWAS_PARENT_CSRC), bit for bit against the earlier checkout's.
    Returns (worst abs err, bf16 launches, [launch not bitwise the earlier
    checkout's])."""
    from kgwas_tpu_torch.ops import segment

    worst, n, off_bits = 0.0, 0, []
    for i, (args, kwargs) in enumerate(calls):
        args = detached(args)
        if args[0].dtype != torch.bfloat16:
            continue
        n += 1
        got = segment.csr_segment_sum(*args, **kwargs)
        if not torch.equal(got, segment.csr_segment_sum(*args, **kwargs)):
            raise AssertionError(f"csr_segment_sum_bf16 launch {i}: two "
                                 "runs differ")
        worst = max(worst, grad_compare(
            got, segment.csr_segment_sum_plain(*args),
            segment.csr_segment_sum_plain(*as_double(args)),
            f"csr_segment_sum_bf16 launch {i}"))
        if parent is not None and not torch.equal(
                got, parent.csr_bf16(*args, **kwargs)):
            off_bits.append(i)
    if not n:
        raise AssertionError("csr_segment_sum_bf16: no launch on a bf16 "
                             "table")
    return worst, n, off_bits


def phase_bf16_models(kt, data, cg, device, card, floors16, parent=None):
    """Phase 12b-d: BF16_VARIANTS at full width through KGWAS
    (initialize_model with the dtype option, no_relu): predict_all with
    every layer kernel counted from 0 just before (the bf16 instances where
    the table is bf16; each family's total per path_launches), against the
    plain ops at BF16_PRED_RTOL / ATOL and bitwise repeatable; KGWAS.train
    over CMP_STEPS batches, counted; CMP_STEPS steps from one state through
    the kernels twice (bitwise) and through the plain ops (losses at
    BF16_LOSS_RTOL, parameters within PARAM_ATOL); forward and step ms with
    the device's busy share, beside the f32 GAT sum's. The per-relation
    softmax GAT's runs (GAT max, GAT min, edge_dim under each option)
    also record #6 / #7 bf16 over one forward and one step, and #8 bf16
    after #7 in that step, each launch held against its plain version, #6
    and #7 bitwise the float32 instance on the widened operands
    (relation_bf16_launches; REL_TIMED's timed; with parent, #6, #7 and
    #8 bf16 bitwise and in turns with the earlier checkout's), their
    forward / step ms beside phase 6c's float32 GAT max / min (no
    profile). Returns ({kernel: launches}, {kernel: worst abs err},
    {variant: (fwd ms, step ms, busy fwd, busy step)}, {kernel: the timed
    relation run's row}, {variant: {kernel: bf16 launches of a full-width
    epoch of train_steps: its step count times one step's, each of the
    CMP_STEPS steps launching the first's}}, the last for EPOCH_VARIANTS
    only)."""
    from kgwas_tpu_torch.engine.loop import epoch_batches, train_step
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.models.hetero_gnn import layer_path
    from kgwas_tpu_torch.ops import segment, segment_softmax

    t_phase = time.perf_counter()
    data_v = copy.copy(data)
    data_v.train_mask = np.asarray(data.train_mask)[:CMP_STEPS * BATCH]
    batches = [torch.from_numpy(b).to(device) for b in
               epoch_batches(data_v.train_mask, BATCH, False, None)]
    launches = dict.fromkeys(BF16_KERNELS, 0)
    worst = dict.fromkeys(BF16_KERNELS, 0.0)
    times, rel_rows = {}, {}
    # the f32 GAT sum's forward and step ms, the bf16 runs' baseline (its
    # checks are phase 5's, on the same configuration)
    base = kt.KGWAS(data_v, exp_name="chip_smoke_bf16", seed=SEED)
    base.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN,
                          no_relu=True)
    shared_state(base)
    _, x, layouts = base._device_state()
    y_node, w_node = base._labels(cg)
    opt = build_optimizer(base.model.parameters(), LR, 5e-4)
    cycle = itertools.cycle(batches)
    times["GAT-sum f32"] = (
        step_times(base.predict_all, n=6),
        step_times(lambda: train_step(base.model, opt, x, layouts,
                                      next(cycle), y_node, w_node), n=6),
        float("nan"), float("nan"))
    log(f"  phase 12 GAT-sum f32 [{card}]: forward "
        f"{times['GAT-sum f32'][0]:.3f} ms, train step "
        f"{times['GAT-sum f32'][1]:.3f} ms (the baseline)")
    del base, opt, x, layouts
    # the steps of one full-width epoch: EPOCH_VARIANTS report their bf16
    # launches over that many train_steps
    n_epoch = len(epoch_batches(np.asarray(data.train_mask), BATCH, False,
                                None))
    epoch = {}
    for name, kw in BF16_VARIANTS.items():
        t0 = time.perf_counter()
        low = bool(kw.get("compute_dtype") or kw.get("stream_dtype"))
        run = kt.KGWAS(data_v, exp_name="chip_smoke_bf16", seed=SEED)
        run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN,
                             no_relu=True, **kw)
        shared_state(run)
        model = run.model
        init = copy.deepcopy(model.state_dict())
        run.predict_all()
        _, x, layouts = run._device_state()
        y_node, w_node = run._labels(cg)
        f_eval, _ = path_launches(model, layouts, False)
        f_train, b_train = path_launches(model, layouts, True)
        per_step = add_counts((1, f_train), (1, b_train))

        def checked(counts, want, what):
            fam = family_totals(counts)
            if fam != want:
                raise AssertionError(f"{name}: {what} launched {counts}, "
                                     f"expected the families {want}")
            bf = {k: counts[k] for k in BF16_KERNELS if counts[k]}
            if low and not bf or not low and bf:
                raise AssertionError(f"{name}: {what} launched the bf16 "
                                     f"instances {bf}")
            if counts["merged_gat_a_src_bf16"] != counts[
                    "merged_gat_fwd_bf16"]:
                raise AssertionError(f"{name}: {what} ran the score pass "
                                     "other than once per bf16 forward: "
                                     f"{bf}")
            for k in BF16_KERNELS:
                launches[k] += counts[k]
            return bf

        all_counts(zero=True)
        pred = run.predict_all()
        bf_fwd = checked(all_counts(), add_counts((1, f_eval)),
                         "predict_all")
        if pred.shape != (cg.num_nodes["SNP"],) or not np.isfinite(
                pred).all():
            raise AssertionError(f"{name}: bad predictions")
        if not np.array_equal(pred, run.predict_all()):
            raise AssertionError(f"{name}: two forwards differ")
        with plain_ops():
            pred_plain = run.predict_all()
        np.testing.assert_allclose(pred, pred_plain, rtol=BF16_PRED_RTOL,
                                   atol=BF16_PRED_ATOL)
        pred_err = float(np.abs(pred - pred_plain).max())

        all_counts(zero=True)
        run.train(batch_size=BATCH, epoch=1, lr=LR, save_best_model=False,
                  scan_steps=0)
        steps = len(run.epoch_losses[0])
        bf_train = checked(all_counts(),
                           add_counts((steps, per_step), (2, f_eval)),
                           "KGWAS.train")
        if steps != CMP_STEPS:
            raise AssertionError(f"{name}: KGWAS.train took {steps} steps")

        def steps_from_init(ctx, per_step=None):
            """CMP_STEPS train_steps from init under ctx; per_step: a list
            that receives each step's bf16 launches."""
            model.load_state_dict(init)
            opt = build_optimizer(model.parameters(), LR, 5e-4)
            ls = []
            with ctx:
                for b in batches:
                    before = bf16_counts()
                    ls.append(train_step(model, opt, x, layouts, b, y_node,
                                         w_node))
                    if per_step is not None:
                        after = bf16_counts()
                        per_step.append({k: after[k] - before[k]
                                         for k in after
                                         if after[k] - before[k]})
            return (torch.stack(ls).cpu().numpy(),
                    {k: v.detach().clone()
                     for k, v in model.state_dict().items()})

        bf16_counts(zero=True)
        one_step = []
        loss_k, par_k = steps_from_init(contextlib.nullcontext(), one_step)
        in_steps = {k: v for k, v in bf16_counts().items() if v}
        if any(c != one_step[0] for c in one_step):
            raise AssertionError(f"{name}: the {CMP_STEPS} train_steps "
                                 f"launched {one_step}")
        loss_k2, par_k2 = steps_from_init(contextlib.nullcontext())
        if not (np.array_equal(loss_k, loss_k2) and all(
                torch.equal(par_k[k], par_k2[k]) for k in par_k)):
            raise AssertionError(f"{name}: two kernel runs differ")
        loss_p, par_p = steps_from_init(plain_ops())
        np.testing.assert_allclose(loss_k, loss_p, rtol=BF16_LOSS_RTOL)
        par_err = max(float((par_k[k].float() - par_p[k].float()).abs().max())
                      for k in par_k)
        if par_err > PARAM_ATOL:
            raise AssertionError(f"{name}: parameters after {CMP_STEPS} "
                                 f"steps differ by {par_err:.3e}")
        for k in bf_fwd:
            worst[k] = max(worst[k], pred_err)
        del par_k2, par_p
        epoch_note = ""
        if name in EPOCH_VARIANTS:   # a full-width epoch of train_steps
            epoch[name] = {k: v * n_epoch for k, v in one_step[0].items()}
            epoch_note = (f"; bf16 launches of a {n_epoch}-step epoch of "
                          f"train_steps {epoch[name]} ({n_epoch} x one "
                          f"step's, each of {CMP_STEPS} steps counted)")

        rel = (model.cfg.gnn_backbone == "GAT" and not model.cfg.sigmoid_gat
               and layer_path(model.cfg, True) == "relations")
        rel_note = ""
        if rel:
            rec_f = Recorder(segment_softmax.segment_softmax_spmm_fwd)
            rec_b = Recorder(segment_softmax.segment_softmax_spmm_bwd)
            rec_c = Recorder(segment.csc_segment_sum)
            model.load_state_dict(init)
            opt = build_optimizer(model.parameters(), LR, 5e-4)
            with swapped(segment_softmax, segment_softmax_spmm_fwd=rec_f,
                         segment_softmax_spmm_bwd=rec_b), \
                    swapped(segment, csc_segment_sum=rec_c):
                run.predict_all()
                n_fwd = len(rec_f.calls)
                train_step(model, opt, x, layouts, batches[0], y_node,
                           w_node)
            errs, tots, off_bits = relation_bf16_launches(
                rec_f.calls, rec_b.calls, rec_c.calls, name in REL_TIMED,
                n_fwd, parent)
            for k, v in errs.items():
                worst[k if k != REL_CSC else "csc_segment_sum_bf16"] = max(
                    worst[k if k != REL_CSC else "csc_segment_sum_bf16"], v)
            if name in REL_TIMED:
                rel_rows[name] = tots
            rel_note = (f"; #6 / #7 / #8 bf16 on {len(rec_f.calls)} / "
                        f"{len(rec_b.calls)} / {len(rec_c.calls)} launches "
                        f"of a forward and a step: #6 / #7 bitwise the "
                        f"float32 instance on the widened operands, max abs "
                        f"err against plain "
                        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
            if parent is not None:
                rel_note += ("; #6 / #7 / #8 bf16 bitwise the earlier "
                             "checkout's on every launch" if not off_bits else
                             f"; NOT bitwise the earlier checkout's on "
                             f"{off_bits}")
            del rec_f, rec_b, rec_c
        if layer_path(model.cfg, True) == "mp" and low:
            # #10 bf16 launch by launch over a forward and a step
            rec = Recorder(segment.csr_segment_sum)
            model.load_state_dict(init)
            opt = build_optimizer(model.parameters(), LR, 5e-4)
            with swapped(segment, csr_segment_sum=rec):
                run.predict_all()
                train_step(model, opt, x, layouts, batches[0], y_node,
                           w_node)
            err, n_bf, off_bits = csr_bf16_launches(rec.calls, parent)
            worst["csr_segment_sum_bf16"] = max(
                worst["csr_segment_sum_bf16"], err)
            rel_note = (f"; #10 bf16 on {n_bf} of {len(rec.calls)} launches "
                        f"of a forward and a step: bitwise repeatable, max "
                        f"abs err against plain {err:.3e}")
            if parent is not None:
                rel_note += ("; bitwise the earlier checkout's on every "
                             "launch" if not off_bits else
                             f"; NOT bitwise the earlier checkout's on "
                             f"launches {off_bits}")
            del rec

        model.load_state_dict(init)
        opt = build_optimizer(model.parameters(), LR, 5e-4)
        fwd_ms = step_times(run.predict_all, n=6)
        cycle = itertools.cycle(batches)
        step = lambda: train_step(model, opt, x, layouts,  # noqa: E731
                                  next(cycle), y_node, w_node)
        step_ms = step_times(step, n=6)
        if rel:   # beside phase 6c's float32 run of the same aggregation
            busy_f = busy_s = float("nan")
            ref = F32_TIMES.get("GAT-min" if "min" in name else "GAT-max")
            busy = (f" (phase 6c float32 GAT {'min' if 'min' in name else 'max'}"
                    f": {ref[0]:.3f} / {ref[1]:.3f} ms)" if ref else "")
        else:
            busy_f = profile_device(run.predict_all, fwd_ms,
                                    f"{name} forward", reps=2)
            busy_s = profile_device(step, step_ms, f"{name} training step",
                                    reps=2)
            busy = (f"; busy forward {busy_f:.3f} (idle "
                    f"{1 - busy_f / fwd_ms:.1%}), step {busy_s:.3f} (idle "
                    f"{1 - busy_s / step_ms:.1%})")
        times[name] = (fwd_ms, step_ms, busy_f, busy_s)
        log(f"  phase 12 {name} [{card}]: bf16 launches per forward "
            f"{bf_fwd}, in KGWAS.train {bf_train}, in {CMP_STEPS} "
            f"train_steps {in_steps}{epoch_note}; predict_all vs plain ops "
            f"max abs err {pred_err:.3e}, bitwise repeatable; {CMP_STEPS} "
            f"steps, losses kernel {loss_k.tolist()} plain "
            f"{loss_p.tolist()}, parameters differ by {par_err:.3e}; forward "
            f"{fwd_ms:.3f} ms, train step {step_ms:.3f} ms{busy}{rel_note}; "
            f"{time.perf_counter() - t0:.1f} s")
        del run, model, opt, x, layouts, init, par_k
        torch.cuda.empty_cache()
    f32 = times["GAT-sum f32"]
    rows = {}
    for k in REL_BF16 + (REL_CSC,):
        if k in REL_BF16:
            r = rows[k] = dict(rel_rows["GAT-max compute"][k])
            r["floor_ms"] = floors16[k]
            r["max_abs_err"] = worst[k]
        for cfg_name in REL_TIMED:
            t = rel_rows[cfg_name][k]
            log(f"  phase 12 {k} [{card}] ({cfg_name}, "
                f"{t['launches_timed']} bf16 launches of a forward or a "
                f"step): "
                f"{t['ms']:.4f} ms [device {t['device_ms']:.4f}]"
                + (f", earlier checkout's {t['parent_ms']:.4f} [device "
                   f"{t['parent_device_ms']:.4f}]" if "parent_ms" in t
                   else "")
                + f", float32 "
                f"instance on the widened values {t['f32_ms']:.4f} "
                f"[{t['f32_device_ms']:.4f}]; bound {t['bound_ms']:.4f} "
                f"({t['bytes']:.4f} bytes, {t['operations']:.4f} "
                f"operations), bf16 gather floor {floors16[k]:.4f}, plain "
                f"{t['plain_ms']:.4f}")
    log(f"phase 12 ok [{card}]: {len(BF16_VARIANTS)} configurations in "
        f"{time.perf_counter() - t_phase:.1f} s; GAT-sum forward / step ms: "
        + "; ".join(f"{k} {v[0]:.3f} / {v[1]:.3f} ({v[0] / f32[0]:.3f}x / "
                    f"{v[1] / f32[1]:.3f}x f32)"
                    for k, v in times.items() if k.startswith("GAT-sum"))
        + f"; bf16 launches {launches}")
    return launches, worst, times, rows, epoch


# the quality gate (scripts/exp_stream_gate.py, scripts/exp_bf16_gate.py):
# their KG, model and training, KGWAS_P of each mode against f32
GATE_KG = dict(n_snp=4000, n_gene=400, n_go=80)
GATE_SEED = 7
GATE_MODES = {"f32": {}, "stream_dtype=bfloat16": dict(stream_dtype="bfloat16"),
              "compute_dtype=bfloat16": dict(compute_dtype="bfloat16"),
              "f32 with TF32 matmuls": {}}
GATE_TOP = 50


def phase_gate(kt, card, tmp):
    """Phase 13: the bf16 quality gate on the card. Each mode trains the
    gate scripts' model (hidden 64, 2 layers, batch 512, 30 epochs, lr
    3e-3) on their KG (4,000 SNPs, 400 genes, 80 GO terms, seed 7) and
    scores KGWAS_P's Spearman correlation and top-50 overlap against the
    f32 run; TF32 is switched on for its run only and restored. Fails on a
    crash or a non-finite KGWAS_P only: the scores are findings (the bar,
    Spearman > 0.95 and overlap >= 0.9, is printed beside them)."""
    from scipy.stats import spearmanr

    t_phase = time.perf_counter()
    res = {}
    for mode, kw in GATE_MODES.items():
        t0 = time.perf_counter()
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = mode.endswith("TF32 matmuls")
        try:
            data = kt.KGWAS_Data.from_synthetic(
                seed=GATE_SEED, data_path=str(
                    tmp / "gate" / mode.replace(" ", "_").replace("=", "_")),
                **GATE_KG)
            data.load_synthetic_gwas(seed=GATE_SEED)
            data.process_gwas_file()
            data.prepare_split()
            run = kt.KGWAS(data, exp_name="gate", seed=GATE_SEED)
            run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=64, **kw)
            table = run.train(batch_size=512, epoch=30, lr=3e-3)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        p = np.asarray(table["KGWAS_P"], dtype=np.float64)
        if not np.isfinite(p).all():
            raise AssertionError(f"gate {mode}: non-finite KGWAS_P")
        res[mode] = (np.asarray(table["ID"]), p)
        log(f"  phase 13 {mode}: trained in {time.perf_counter() - t0:.1f} "
            f"s, val pearson {run.train_history[-1]['val_pearsonr']:.4f}")
    ids, p32 = res["f32"]
    top32 = set(ids[np.argsort(p32, kind="stable")[:GATE_TOP]])
    for mode, (ids_m, p) in res.items():
        if mode == "f32":
            continue
        if not np.array_equal(ids_m, ids):
            raise AssertionError(f"gate {mode}: another SNP order")
        rho = float(spearmanr(p32, p).statistic)
        top = set(ids[np.argsort(p, kind="stable")[:GATE_TOP]])
        overlap = len(top & top32) / GATE_TOP
        verdict = "PASS" if rho > 0.95 and overlap >= 0.9 else "FAIL"
        log(f"phase 13 gate [{card}]: {mode} against f32: Spearman "
            f"{rho:.4f}, top-{GATE_TOP} overlap {overlap:.2f} (bar > 0.95 "
            f"and >= 0.9: {verdict})")
    log(f"phase 13 ok [{card}]: {len(GATE_MODES)} runs, "
        f"{time.perf_counter() - t_phase:.1f} s")


# ---------------------------------------------------------------------------
# phase 14: multi-device training (kgwas_tpu_torch/parallel), on one card
# ---------------------------------------------------------------------------

# rank counts whose per-rank layouts run through the kernels in one process
MESH_SHARDS = (2, 3, 4)
# (a) KGWAS.train(mesh=1) over NCCL: the merged GAT layer, the per-relation
# path (f32 and under stream_dtype) and the 'mp' path
MESH_VARIANTS = {
    "GAT-sum": {},
    "GAT-max": dict(gnn_aggr="max"),
    "SAGE-sum": dict(gnn_backbone="SAGE"),
    "GAT-max stream": dict(gnn_aggr="max", stream_dtype="bfloat16"),
}


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def grad_rule(what, got, unsharded, plain, exact):
    """The summed gradients of the ranks against float64: within the
    backward rule (GRAD_ERR_RATIO times the float32 plain version's error)
    or twice the unsharded kernels' own error, plus GRAD_FLOOR of the
    largest value. Returns the log text."""
    errs = []
    for name, a, u, p, x in zip(what[1], got, unsharded, plain, exact):
        e_s, e_u, e_p = (float((v.double() - x).abs().max())
                         for v in (a, u, p))
        limit = (max(GRAD_ERR_RATIO * e_p, 2 * e_u)
                 + GRAD_FLOOR * float(x.abs().max()))
        if e_s > limit:
            raise AssertionError(
                f"{what[0]} {name}: max abs err against float64 {e_s:.3e}, "
                f"the unsharded kernels' {e_u:.3e}, the plain version's "
                f"{e_p:.3e}")
        errs.append(f"{name} {e_s:.3e} (unsharded {e_u:.3e}, plain "
                    f"{e_p:.3e})")
    return ", ".join(errs)


def launched(before, kernels, n, what):
    """The kernels' launches since before (all_counts), each exactly n: one
    a rank with rows (at full width, every rank)."""
    after = all_counts()
    got = {k: after[k] - before[k] for k in kernels}
    if set(got.values()) != {n}:
        raise AssertionError(f"{what}: launched {got}, {n} each expected")


def mesh_relations(cg, host, device, card, gen):
    """Phase 14b, the per-relation path: each relation stream of the live
    groups (Gene and SNP) split into MESH_SHARDS ranks' blocks
    (relation_shard.relation_rank_stream, no process group), random xs and
    logits that bf16 holds exactly, each rank's #6, #7 and #8 on its rows,
    f32 and bf16, against the unsharded kernels on the whole stream (one
    plain and one float64 reference for both). Returns the checks made."""
    from kgwas_tpu_torch.models import device_layouts
    from kgwas_tpu_torch.ops import segment_softmax as ss
    from kgwas_tpu_torch.parallel.relation_shard import relation_rank_stream

    d, checked = HIDDEN, 0
    kernels = {torch.float32: ("segment_softmax_spmm_fwd",
                               "segment_softmax_spmm_bwd", "csc_segment_sum"),
               torch.bfloat16: ("segment_softmax_spmm_fwd_bf16",
                                "segment_softmax_spmm_bwd_bf16",
                                "csc_segment_sum_bf16")}
    for t in ("Gene", "SNP"):
        streams = device_layouts({t: host[t]}, device, cg,
                                 "relations")[t].relations
        for rk, RL in zip(host[t].rel_keys, streams):
            r = cg.relations[rk]
            n, n_src = RL.n_rows_per_rel, RL.src_base[-1]
            # values bf16 holds exactly: the f32 and the bf16 instances
            # share the plain and float64 references
            xw = (torch.randn(n_src, d, device=device, generator=gen)
                  * 0.5).bfloat16().float()
            lw = torch.randn(RL.src.shape[0], device=device,
                             generator=gen).bfloat16().float()
            g = torch.randn(n, d, device=device, generator=gen)
            trash = trash_mask(n, n, cg.num_nodes[r.dst_type])
            blocks = {k: [relation_rank_stream(r, cg, k, i, device)
                          for i in range(k)] for k in MESH_SHARDS}
            out_p, mp, sp = ss.segment_softmax_spmm_fwd_plain(
                xw, RL.src, lw, RL.row_offsets)
            plain = ss.segment_softmax_spmm_backward_plain(
                xw, lw, mp, sp, out_p, g, RL)
            o64, m64, s64 = ss.segment_softmax_spmm_fwd_plain(
                xw.double(), RL.src, lw.double(), RL.row_offsets)
            exact = ss.segment_softmax_spmm_backward_plain(
                xw.double(), lw.double(), m64, s64, o64, g.double(), RL)
            del out_p, mp, sp, o64, m64, s64
            for dt in (torch.float32, torch.bfloat16):
                xv, lv = xw.to(dt), lw.to(dt)
                out_u, mx, sm = ss.segment_softmax_spmm_fwd(
                    xv, RL.src, lv, RL.row_offsets, sched=RL.row_schedule)
                unsharded = ss.segment_softmax_spmm_backward(
                    xv, lv, mx, sm, out_u, g, RL)
                for k, ranks in blocks.items():
                    what = f"phase 14b {rk} {str(dt)[6:]} x{k}"
                    # the rank's forward and backward (#7, then #8 over
                    # its CSC); d_xs summed, d_logits in edge order
                    outs, d_xs, d_lg, before = [], 0.0, [], all_counts()
                    ranks = [rs for rs in ranks if not rs.empty]
                    for rs in ranks:
                        (r0, r1), (e0, e1) = rs.rows, rs.edges
                        lay, lr = rs.layout, lv[e0:e1].contiguous()
                        out, mx_r, sm_r = ss.segment_softmax_spmm_fwd(
                            xv, lay.src, lr, lay.row_offsets,
                            sched=lay.row_schedule)
                        dx, dl = ss.segment_softmax_spmm_backward(
                            xv, lr, mx_r, sm_r, out, g[r0:r1], lay)
                        outs.append(out)
                        d_xs = d_xs + dx
                        d_lg.append(dl)
                    launched(before, kernels[dt], len(ranks), what)
                    compare(torch.cat(outs), out_u, trash, what + " rows")
                    errs = grad_rule((what, ("d_xs", "d_logits")),
                                     (d_xs, torch.cat(d_lg)), unsharded,
                                     plain, exact)
                    if dt == torch.bfloat16:
                        # #6 and #7 bf16 on a rank's rows: the float32
                        # instance on the widened values, bit for bit
                        rs = ranks[-1]
                        (r0, r1), (e0, e1) = rs.rows, rs.edges
                        lay = rs.layout
                        fb = [ss.segment_softmax_spmm_fwd(
                            x_, lay.src, l_[e0:e1].contiguous(),
                            lay.row_offsets, sched=lay.row_schedule)
                            for x_, l_ in ((xv, lv), (xw, lw))]
                        bb = [ss.segment_softmax_spmm_bwd(
                            x_, lay.src, l_[e0:e1].contiguous(),
                            lay.row_offsets, *f_[1:], f_[0], g[r0:r1],
                            sched=lay.row_schedule)
                            for x_, l_, f_ in ((xv, lv, fb[0]),
                                               (xw, lw, fb[1]))]
                        if not all(torch.equal(a, b) for a, b in
                                   zip(fb[0] + bb[0], fb[1] + bb[1])):
                            raise AssertionError(
                                f"{what}: #6 / #7 bf16 on rank {k - 1}'s "
                                "rows differ from the float32 instance on "
                                "the widened values")
                    log(f"  {what} [{card}]: {k} ranks' rows ("
                        + ", ".join(str(rs.rows[1] - rs.rows[0])
                                    for rs in ranks)
                        + f") through #6, #7, #8, one launch each a rank; "
                        f"rows within RTOL; max abs err against float64: "
                        f"{errs}")
                    checked += 1
            del xw, lw, g, blocks, plain, exact
    return checked


def mesh_mp(cg, host, device, card, gen):
    """Phase 14b, the 'mp' path: the SNP and Gene merged layouts' R * N rows
    split into MESH_SHARDS ranks' blocks (relation_shard.mp_rank_stream),
    each rank's #10 (weighted by the symmetric norm) and #8 on its rows,
    against the unsharded kernels. Returns the streams checked."""
    from kgwas_tpu_torch.models import device_layouts
    from kgwas_tpu_torch.ops import segment
    from kgwas_tpu_torch.parallel.relation_shard import mp_rank_stream

    checked = 0
    for t in ("Gene", "SNP"):
        L = host[t]
        DL = device_layouts({t: L}, device, None, "mp")[t]
        xs = torch.randn(L.n_src_total, HIDDEN, device=device,
                         generator=gen)
        g = torch.randn(L.n_rows_total, HIDDEN, device=device, generator=gen)
        out_u = segment.CSRSegmentSum.apply(xs, DL.sym_e, DL)
        unsharded = segment.csc_segment_sum(g, DL.sym_e, None, xs, None, DL)
        plain = segment.csc_segment_sum_plain(g, DL.sym_e, None, xs, None,
                                              DL)
        exact = segment.csc_segment_sum_plain(
            g.double(), DL.sym_e.double(), None, xs.double(), None, DL)
        trash = trash_mask(L.n_rows_total, L.n_rows_per_rel,
                           cg.num_nodes[t])
        for k in MESH_SHARDS:
            what = f"phase 14b {t} 'mp' x{k}"
            ranks = [rs for rs in (mp_rank_stream(L, k, i, device)
                                   for i in range(k)) if not rs.empty]
            xl = xs.detach().clone().requires_grad_()
            outs, before = [], all_counts()
            for rs in ranks:
                r0, r1 = rs.rows
                out = segment.CSRSegmentSum.apply(xl, rs.layout.sym_e,
                                                  rs.layout)
                out.backward(g[r0:r1])
                outs.append(out.detach())
            launched(before, ("csr_segment_sum", "csc_segment_sum"),
                     len(ranks), what)
            compare(torch.cat(outs), out_u, trash, what + " rows")
            errs = grad_rule((what, ("d_xs",)), (xl.grad,), unsharded[:1],
                             plain[:1], exact[:1])
            log(f"  {what} [{card}]: {k} ranks' rows ("
                + ", ".join(str(rs.rows[1] - rs.rows[0]) for rs in ranks)
                + f") through #10, #8, one launch each a rank; rows within "
                f"RTOL; max abs err against float64: {errs}")
            checked += 1
        del xs, g, out_u, DL
    return checked


def mesh_merged(cg, host, device, card, gen):
    """Phase 14b, the merged GAT layer: each rank's layout of MESH_SHARDS
    ranks (build_device_layouts of the Gene and SNP groups, random tables)
    through #1, #2 and #8 in this process (no process group: each rank
    given the whole table, its d_xs summed), the ranks' rows assembled,
    against the unsharded layer (fold 0): rows at RTOL / TRASH_RTOL; d_xs,
    d_att and d_a_dst by grad_rule (d_att and d_a_dst are sums that
    cancel, and the ranks' schedules pack items otherwise). Returns the
    layouts checked."""
    from kgwas_tpu_torch.models import device_layouts
    from kgwas_tpu_torch.ops import gat_layer, segment
    from kgwas_tpu_torch.parallel import merged_shard

    checked = 0
    for t in ("Gene", "SNP"):
        L = host[t]
        R, n, d = len(L.rel_keys), L.n_rows_per_rel, HIDDEN
        DL = device_layouts({t: L}, device)[t]
        DL = dataclasses.replace(DL, **segment.csc_fields(
            L.dst, L.csc_perm, L.csc_offsets, n, L.src_base, 0, device))
        xs = torch.randn(L.n_src_total, d, device=device, generator=gen) * 0.1
        att = torch.randn(R, d, device=device, generator=gen) * 0.2
        ad = torch.randn(L.n_rows_total, device=device, generator=gen) * 0.5
        g = torch.randn(L.n_rows_total, d, device=device, generator=gen)
        fa = (DL.src, DL.row_offsets, att, ad, n, 0, "softmax", 0.2, 1.0)
        want, rmax, rsum = gat_layer.merged_gat_forward(xs, *fa)
        bw = (xs, att, ad, rmax, rsum, g, DL, 0, "softmax", 0.2, 1.0)
        want_b = gat_layer.merged_gat_backward(*bw)
        plain_b = gat_layer.merged_gat_backward_plain(*bw)
        exact_b = gat_layer.merged_gat_backward_plain(*as_double(bw[:6]),
                                                      *bw[6:])
        trash = trash_mask(L.n_rows_total, n, cg.num_nodes[t])
        for n_dev in MESH_SHARDS:
            what = f"phase 14b {t} merged x{n_dev}"
            dls = merged_shard.build_device_layouts(L, n_dev)
            outs, grads = [], [0.0, 0.0, 0.0]
            before = all_counts()
            for i in range(n_dev):
                shard = merged_shard.RankShard(L, dls, i, device)
                leaves = [v.detach().clone().requires_grad_()
                          for v in (xs, att, ad)]
                out = merged_shard.ShardedMergedGAT.apply(
                    *leaves, shard, None, "softmax", 0.2, 1.0)
                rows = slice(shard.row0, shard.row0 + shard.rows_per_dev)
                out.backward(g[rows])
                outs.append(out.detach())
                for k, v in enumerate(leaves):
                    grads[k] = grads[k] + v.grad
            launched(before, ("merged_gat_fwd", "merged_gat_bwd",
                              "csc_segment_sum"),
                     sum(b > a for a, b in zip(dls.row_bounds,
                                               dls.row_bounds[1:])), what)
            compare(torch.cat(outs), want, trash, what + " rows")
            errs = grad_rule((what, ("d_xs", "d_att", "d_a_dst")), grads,
                             want_b, plain_b, exact_b)
            log(f"  {what} [{card}]: {n_dev} ranks' rows ("
                + ", ".join(str(b - a) for a, b in zip(dls.row_bounds,
                                                        dls.row_bounds[1:]))
                + f", {dls.e_dev} padded edges) through #1, #2, #8 against "
                f"the unsharded layer; max abs err against float64: {errs}")
            checked += 1
        del xs, att, ad, g, want, want_b, plain_b, exact_b, DL
        torch.cuda.empty_cache()
    return checked


def phase_mesh(kt, data, cg, device, card):
    """Phase 14. The card's machine has one GPU, so no run of two ranks
    over NCCL is possible here. (a) KGWAS.train(mesh=1) at full width
    (MESH_VARIANTS, CMP_STEPS batches each) in a process group of one rank
    over NCCL (tcp://localhost): the sharded path of each (the merged GAT
    layer; the per-relation GAT layer, f32 and under stream_dtype; the
    'mp' SAGE layer), its halo all-gathers and reduce-scatters through
    NCCL; its launches counted from 0 just before (per step and forward,
    as path_launches; a bf16 instance counted in its family), its losses
    against the same train_steps on the device alone from the same
    weights (LOSS_RTOL);
    the all-gather and reduce-scatter ms at world size 1 on the SNP
    group's source table, the all-gather of the per-relation path's SNP
    rows, and a GAT-sum train step over the mesh beside one on the device
    alone (in turns, twice each).
    (b) Each rank's blocks for MESH_SHARDS ranks through the kernels in
    this process: the GAT-max relation streams (mesh_relations), the 'mp'
    streams (mesh_mp), the merged GAT layouts (mesh_merged). Returns
    ({f32 kernel: launches}, {bf16 kernel: launches}) of (a)."""
    import torch.distributed as dist
    from kgwas_tpu_torch.engine.loop import epoch_batches, train_step
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.graph import build_merged_layouts
    from kgwas_tpu_torch.kgwas import TILE_ROWS
    from kgwas_tpu_torch.parallel.mesh import (all_gather_rows, gather_rows,
                                               init_distributed, make_mesh,
                                               reduce_scatter_rows)
    from kgwas_tpu_torch.parallel.shard import sharded_train_step

    t0 = time.perf_counter()
    data_v = copy.copy(data)
    data_v.train_mask = np.asarray(data.train_mask)[:CMP_STEPS * BATCH]
    n_batches = len(epoch_batches(data_v.train_mask, BATCH, False, None))
    init_distributed("nccl", f"tcp://localhost:{free_port()}", 1, 0)
    total = dict.fromkeys(MODEL_KERNELS + BF16_KERNELS, 0)
    try:
        mesh = make_mesh(1)
        for name, kw in MESH_VARIANTS.items():
            tv = time.perf_counter()
            run = kt.KGWAS(data_v, exp_name="chip_smoke_mesh", seed=SEED)
            run.initialize_model(gnn_num_layers=LAYERS,
                                 gnn_hidden_dim=HIDDEN, no_relu=True, **kw)
            shared_state(run)
            init = copy.deepcopy(run.model.state_dict())
            all_counts(zero=True)
            run.train(batch_size=BATCH, epoch=1, lr=LR,
                      save_best_model=False, mesh=mesh, scan_steps=0)
            got = all_counts()
            counts = family_totals(got)
            bf = {k: got[k] for k in BF16_KERNELS if got[k]}
            _, _, layouts = run._device_state()
            f_train, b_train = path_launches(run.model, layouts, True)
            f_eval, _ = path_launches(run.model, layouts, False)
            want = add_counts((n_batches, f_train), (n_batches, b_train),
                              (2, f_eval))
            if counts != want or bool(bf) != ("stream_dtype" in kw):
                raise AssertionError(f"{name}: KGWAS.train(mesh=1) "
                                     f"launched {got}, expected the "
                                     f"families {want}")
            total = {k: total[k] + got[k] for k in total}
            lm = np.asarray(run.epoch_losses[0])
            # the same steps on the device alone, from the same weights
            run.model.load_state_dict(init)
            _, x, layouts = run._device_state()
            y_node, w_node = run._labels(cg)
            opt = build_optimizer(run.model.parameters(), LR, 5e-4)
            ls = torch.stack([train_step(run.model, opt, x, layouts,
                                         torch.from_numpy(b).to(device),
                                         y_node, w_node)
                              for b in epoch_batches(data_v.train_mask,
                                                     BATCH, False, None)])
            ls = ls.cpu().numpy()
            np.testing.assert_allclose(lm, ls, rtol=LOSS_RTOL)
            note = ""
            if name == "GAT-sum":
                # a train step over the mesh beside one on the single
                # device, in turns, from the trained state
                shard = run._sharded_run(mesh, cg, x)
                cyc = itertools.cycle([torch.from_numpy(b).to(device)
                                       for b in epoch_batches(
                                           data_v.train_mask, BATCH, False,
                                           None)])
                step_ms = {"mesh": [], "one": []}
                for _ in range(2):
                    step_ms["mesh"].append(step_times(
                        lambda: sharded_train_step(
                            run.model, opt, shard, layouts, next(cyc),
                            y_node, w_node), n=6))
                    step_ms["one"].append(step_times(lambda: train_step(
                        run.model, opt, x, layouts, next(cyc), y_node,
                        w_node), n=6))
                sn = run.layouts["SNP"]
                xs = torch.randn(sn.n_src_total, HIDDEN, device=device,
                                 generator=torch.Generator(
                                     device=device).manual_seed(SEED + 14))
                g_ms = cuda_ms(lambda: gather_rows(xs, mesh.data_group), 10)
                r_ms = cuda_ms(lambda: reduce_scatter_rows(
                    xs, mesh.data_group), 10)
                note = (f"; all-gather {g_ms:.4f} ms, reduce-scatter "
                        f"{r_ms:.4f} ms of the SNP group's "
                        f"[{sn.n_src_total}, {HIDDEN}] table at world size "
                        f"1; train step over the mesh {step_ms['mesh']} ms, "
                        f"on the device alone {step_ms['one']} ms (median "
                        f"of 6, in turns)")
                del xs, shard
            elif name == "GAT-max":
                # the per-relation path's gather of a destination type's
                # rows, once per type and layer
                rows = torch.randn(cg.padded_nodes["SNP"], HIDDEN,
                                   device=device, generator=torch.Generator(
                                       device=device).manual_seed(SEED + 14))
                a_ms = cuda_ms(lambda: all_gather_rows(
                    rows, mesh.data_group, [rows.shape[0]]), 10)
                note = (f"; all-gather of the SNP rows [{rows.shape[0]}, "
                        f"{HIDDEN}] at world size 1 {a_ms:.4f} ms")
                del rows
            log(f"  phase 14a {name} [{card}]: KGWAS.train(mesh=1) over "
                f"NCCL, {n_batches} steps, launches {got}; losses "
                f"{lm.tolist()} against the single-device steps' "
                f"{ls.tolist()}{note}; {time.perf_counter() - tv:.1f} s")
            del run, init, x, layouts, opt
            torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()

    host = build_merged_layouts(cg, tile_rows=TILE_ROWS)
    gen = torch.Generator(device=device).manual_seed(SEED + 14)
    tb = time.perf_counter()
    n_rel = mesh_relations(cg, host, device, card, gen)
    n_mp = mesh_mp(cg, host, device, card, gen)
    n_merged = mesh_merged(cg, host, device, card, gen)
    log(f"phase 14 ok [{card}]: mesh=1 over NCCL trained like one device "
        f"({', '.join(MESH_VARIANTS)}); {n_rel} relation-stream, {n_mp} "
        f"'mp' and {n_merged} merged splits over {MESH_SHARDS} ranks "
        f"matched the unsharded kernels "
        f"({time.perf_counter() - tb:.1f} s); {time.perf_counter() - t0:.1f}"
        f" s")
    return ({k: total[k] for k in MODEL_KERNELS},
            {k: total[k] for k in BF16_KERNELS})


# ---- phase 15: scanned dispatch, blocks of SCAN_S steps as CUDA graphs

# KGWAS.train's default scan_steps; (a) full blocks and a tail of a
# full-width epoch cut to SCAN_BLOCKS * SCAN_S + SCAN_TAIL batches
SCAN_S, SCAN_BLOCKS, SCAN_TAIL = 8, 3, 3
# (b) one captured block each, beside the same steps eager
SCAN_VARIANTS = {
    "GAT-max": dict(gnn_aggr="max"),
    "GCN": dict(gnn_backbone="GCN"),
    "compute bf16": dict(compute_dtype="bfloat16"),
    "param bf16": dict(param_dtype="bfloat16"),
    "remat": dict(remat=True),
}
# (d) the transient fault: this many steps into epoch 2 of the 20k-SNP KG
SCAN_FAULT = 10


def scan_counted_steps(steps, epochs=1, scan=SCAN_S):
    """The steps of KGWAS.train(scan_steps=scan) over epochs epochs of
    steps steps whose launches the wrappers count: the run's first block
    runs eagerly, the graph of the second is captured (its launches counted
    once, at capture), the later blocks replay it uncounted, each epoch's
    tail runs eagerly."""
    if scan <= 1:
        return steps * epochs
    blocks, tail = divmod(steps, scan)
    return min(blocks * epochs, 2) * scan + tail * epochs


def slope_ms(call, n1, n2, steps_per_call):
    """ms per step: n1, then n2 chained calls, each series ending in one
    synchronise, CUDA events; the difference cancels the fixed cost."""
    def series(n):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            call()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop)

    t1, t2 = series(n1), series(n2)
    return (t2 - t1) / ((n2 - n1) * steps_per_call)


def peak_mib(fn):
    """(fn's result, the device memory it allocated at its peak above what
    was allocated at its start, MiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    return out, (torch.cuda.max_memory_allocated() - base) / 2**20


def captured_scan(model, opt, x, layouts, y_node, w_node, bm):
    """A TrainScan of SCAN_S steps on layouts, its eager block run on the
    batches bm and a block captured: (the scan, the capture's launches, its
    peak MiB above its start, the graph pool's MiB)."""
    from kgwas_tpu_torch.engine.loop import TrainScan

    scan = TrainScan(model, opt, x, layouts, y_node, w_node, SCAN_S)
    scan(bm)   # the eager block a capture follows
    torch.cuda.synchronize()
    torch.cuda.empty_cache()   # as the capture does first
    reserved = torch.cuda.memory_reserved()
    model_counts(zero=True)
    _, capture_mb = peak_mib(lambda: scan.capture(BATCH))
    block = model_counts()
    pool_mb = (torch.cuda.memory_reserved() - reserved) / 2**20
    return scan, block, capture_mb, pool_mb


def phase_scan(kt, data, device, card, bench0, tmp):
    """Phase 15: KGWAS.train(scan_steps=SCAN_S), each full block one
    replay of a CUDA graph of SCAN_S captured steps (engine/loop.TrainScan).
    (a) Full-width GAT sum over SCAN_BLOCKS blocks and a SCAN_TAIL-step
    tail, scanned and with scan_steps=0 from one initial state: losses,
    parameters and Adam's state bitwise; the launches counted (the eager
    first block, the capture, the tail); one captured block's launches
    (SCAN_S eager steps'); the step's ms both ways (slope, CUDA events),
    each one's device idle share (torch.profiler), the eager step's peak
    memory and the graph's (its capture's peak and its pool). (b) One
    block of each SCAN_VARIANTS replayed against the same steps eager,
    bitwise, with step ms. (c) bench_lib with BENCH_SCAN=SCAN_S beside
    phase 8's BENCH_SCAN=0. (d) KGWAS.train(max_restarts=1, scan_steps=
    SCAN_S) on the 20k-SNP KG over 2 epochs, clean and with a transient
    fault SCAN_FAULT steps into epoch 2: bitwise the clean run. Returns the
    launches of the layer kernels."""
    import io

    from kgwas_tpu_torch import bench_lib
    from kgwas_tpu_torch.engine import resilience
    from kgwas_tpu_torch.engine.loop import (TrainScan, batch_loss,
                                             epoch_batches, train_step)
    from kgwas_tpu_torch.engine.optim import build_optimizer

    launches = dict.fromkeys(MODEL_KERNELS, 0)
    n_steps = SCAN_BLOCKS * SCAN_S + SCAN_TAIL
    data_v = copy.copy(data)
    data_v.train_mask = np.asarray(data.train_mask)[:n_steps * BATCH]

    # (a) full width, scanned and step by step
    runs, counts, init = {}, {}, None
    for scan in (SCAN_S, 0):
        run = kt.KGWAS(data_v, exp_name="chip_smoke_scan", seed=SEED)
        run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN,
                             no_relu=True)
        shared_state(run)
        if init is None:
            init = copy.deepcopy(run.model.state_dict())
        run.model.load_state_dict(init)
        model_counts(zero=True)
        t0 = time.perf_counter()
        run.train(batch_size=BATCH, epoch=1, lr=LR, save_best_model=False,
                  scan_steps=scan)
        run.wall = time.perf_counter() - t0
        counts[scan] = model_counts()
        runs[scan] = run
    scanned, stepped = runs[SCAN_S], runs[0]
    sc = scanned.train_scan
    if sc is None or (sc.captures, sc.replays) != (1, SCAN_BLOCKS - 1):
        raise AssertionError(f"(a) captures / replays "
                             f"{sc and (sc.captures, sc.replays)}")
    if scanned.epoch_losses != stepped.epoch_losses or len(
            scanned.epoch_losses[0]) != n_steps:
        raise AssertionError("(a) the scanned losses differ from the "
                             "step-by-step run's")
    same_state(scanned.params, stepped.params, "(a) parameters")
    same_state(scanned.optimizer.state_dict(), stepped.optimizer.state_dict(),
               "(a) Adam's state")
    f_eval, _ = path_launches(scanned.model, scanned._device_state()[2],
                              False)
    f_train, b_train = path_launches(scanned.model,
                                     scanned._device_state()[2], True)
    per_step = add_counts((1, f_train), (1, b_train))
    for scan, n in ((SCAN_S, scan_counted_steps(n_steps)), (0, n_steps)):
        want = add_counts((n, per_step), (2, f_eval))
        if counts[scan] != want:
            raise AssertionError(f"(a) scan_steps={scan}: launches "
                                 f"{counts[scan]}, expected {want}")
        for k, v in counts[scan].items():
            launches[k] += v

    # one captured block's launches, the timing, the memory
    model, opt = scanned.model, scanned.optimizer
    cg_, x, layouts = scanned._device_state()
    y_node, w_node = scanned._labels(cg_)
    bm = np.stack(epoch_batches(data_v.train_mask, BATCH, False,
                                None)[:SCAN_S])
    bidx = torch.from_numpy(bm[0]).to(device)
    scan, block, capture_mb, pool_mb = captured_scan(
        model, opt, x, layouts, y_node, w_node, bm)
    want = add_counts((SCAN_S, per_step))
    if block != want:
        raise AssertionError(f"(a) one captured block launched {block}, "
                             f"expected {want}")
    for k, v in block.items():
        launches[k] += v
    _, eager_mb = peak_mib(lambda: train_step(model, opt, x, layouts, bidx,
                                              y_node, w_node))
    graph_step = slope_ms(lambda: scan(bm), 2, 6, SCAN_S)
    eager_step = slope_ms(lambda: train_step(model, opt, x, layouts, bidx,
                                             y_node, w_node), 8, 24, 1)
    busy_graph = profile_device(lambda: scan(bm), graph_step * SCAN_S,
                                f"replayed block of {SCAN_S} steps")
    busy_eager = profile_device(lambda: train_step(
        model, opt, x, layouts, bidx, y_node, w_node), eager_step,
        "eager step")
    idle_graph = 1 - busy_graph / (graph_step * SCAN_S)
    idle_eager = 1 - busy_eager / eager_step
    log(f"  phase 15a [{card}]: full-width GAT sum, {SCAN_BLOCKS} blocks of "
        f"{SCAN_S} and a {SCAN_TAIL}-step tail: losses, parameters and "
        f"Adam's state bitwise scan_steps=0's; launches scanned "
        f"{counts[SCAN_S]}, step by step {counts[0]}; one captured block "
        f"{block}; train wall {scanned.wall:.2f} s scanned, "
        f"{stepped.wall:.2f} s step by step")
    log(f"  phase 15a [{card}]: step ms (slope): graph {graph_step:.4f} "
        f"(device idle {idle_graph:.1%}), eager {eager_step:.4f} (idle "
        f"{idle_eager:.1%}); peak above the start: eager step "
        f"{eager_mb:.1f} MiB, the capture {capture_mb:.1f} MiB, the graph's "
        f"pool {pool_mb:.1f} MiB reserved")
    del scan, runs, scanned, stepped, model, opt, x, layouts
    torch.cuda.empty_cache()

    # (b) one replayed block of each variant against the same steps eager
    batches = [torch.from_numpy(b).to(device) for b in
               epoch_batches(data_v.train_mask, BATCH, False, None)]
    notes = []
    for name, kw in SCAN_VARIANTS.items():
        run = kt.KGWAS(data_v, exp_name="chip_smoke_scan", seed=SEED)
        run.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN,
                             no_relu=True, **kw)
        shared_state(run)
        model = run.model
        cg_, x, layouts = run._device_state()
        y_node, w_node = run._labels(cg_)
        init = copy.deepcopy(model.state_dict())
        model_counts(zero=True)
        opt = build_optimizer(model.parameters(), LR, 5e-4)
        eager = torch.stack([train_step(model, opt, x, layouts, b, y_node,
                                        w_node)
                             for b in batches[:2 * SCAN_S]])
        want_state = to_host(model.state_dict())
        model.load_state_dict(init)
        opt = build_optimizer(model.parameters(), LR, 5e-4)
        scan = TrainScan(model, opt, x, layouts, y_node, w_node, SCAN_S)
        got = torch.cat([scan(bm), scan(np.stack(epoch_batches(
            data_v.train_mask, BATCH, False, None)[SCAN_S:2 * SCAN_S]))])
        if scan.replays != 1 or not torch.equal(got, eager):
            raise AssertionError(f"(b) {name}: the replayed block's losses "
                                 "differ from the eager steps'")
        same_state(to_host(model.state_dict()), want_state,
                   f"(b) {name} parameters")
        for k, v in model_counts().items():
            launches[k] += v
        g_ms = slope_ms(lambda: scan(bm), 1, 3, SCAN_S)
        e_ms = step_times(lambda: train_step(model, opt, x, layouts,
                                             batches[0], y_node, w_node),
                          n=5, warm=1)
        notes.append(f"{name} graph {g_ms:.3f} / eager {e_ms:.3f} ms")
        del scan, run, model, opt, x, layouts
        torch.cuda.empty_cache()
    log(f"  phase 15b [{card}]: one replayed block each bitwise the eager "
        f"steps; step ms " + "; ".join(notes))

    # (c) the bench, scanned, beside phase 8's
    out = io.StringIO()
    env = os.environ.get("BENCH_SCAN")
    os.environ["BENCH_SCAN"] = str(SCAN_S)
    try:
        with contextlib.redirect_stdout(out):
            bench_lib.main()
    finally:
        if env is None:
            os.environ.pop("BENCH_SCAN", None)
        else:
            os.environ["BENCH_SCAN"] = env
    line = out.getvalue().strip().split("\n")[-1]
    bench = json.loads(line)
    print(line, flush=True)
    if bench["config"]["scan"] != SCAN_S or not bench["value"] > 0:
        raise AssertionError(f"(c) bench {bench}")
    log(f"  phase 15c [{card}]: bench BENCH_SCAN={SCAN_S}: "
        f"{bench['value']:.6g} edge-traversals/s, step_ms "
        f"{bench['config']['step_ms']}; BENCH_SCAN=0 (phase 8): "
        f"{bench0['value']:.6g}, step_ms {bench0['config']['step_ms']}")

    # (d) a transient fault in a scanned run, 20k-SNP KG
    small = kt.KGWAS_Data.from_synthetic(seed=SEED, data_path=str(
        tmp / "scan_small"), **SMALL_KG)
    small.load_synthetic_gwas(seed=SEED)
    small.process_gwas_file()
    small.prepare_split()
    steps = len(small.train_mask) // BATCH
    fault = steps + SCAN_FAULT
    runs = {}
    sleep_backoff = resilience.sleep_backoff
    resilience.sleep_backoff = lambda *a, **k: None
    try:
        for tag in ("clean", "faulty"):
            run = kt.KGWAS(small, exp_name=f"chip_smoke_scan_{tag}",
                           seed=SEED)
            run.initialize_model(gnn_num_layers=LAYERS,
                                 gnn_hidden_dim=HIDDEN, no_relu=True)
            if tag == "faulty":
                fired = []

                def hook(global_step):
                    if global_step == fault and not fired:
                        fired.append(global_step)
                        raise RuntimeError(
                            "INTERNAL: injected transient backend failure")
                run._fault_hook = hook
            model_counts(zero=True)
            run.train(batch_size=BATCH, epoch=2, lr=LR,
                      save_best_model=False, max_restarts=1,
                      scan_steps=SCAN_S)
            for k, v in model_counts().items():
                launches[k] += v
            runs[tag] = run
    finally:
        resilience.sleep_backoff = sleep_backoff
    clean, faulty = runs["clean"], runs["faulty"]
    if (clean.restart_count, faulty.restart_count) != (0, 1):
        raise AssertionError(f"(d) restarts {clean.restart_count}, "
                             f"{faulty.restart_count}")
    if faulty.epoch_losses != clean.epoch_losses:
        raise AssertionError("(d) per-step losses differ")
    same_state(faulty.params, clean.params, "(d) final parameters")
    same_state(faulty.best_params, clean.best_params, "(d) best parameters")
    if faulty.train_scan.captures != 1 or faulty.train_scan is \
            clean.train_scan:
        raise AssertionError("(d) the restart did not capture anew")
    log(f"phase 15 ok [{card}]: (d) 20k-SNP KG, 2 epochs of {steps} steps "
        f"scanned ({SCAN_S} a block), a transient fault before global step "
        f"{fault}: one restart, a new graph captured, losses and final and "
        f"best parameters bitwise the clean run's; recovery "
        f"{faulty.recovery_seconds[0]:.3f} s")
    return launches


# ---------------------------------------------------------------- phase 16

# scripts/exp_fullkg.py's full knowledge graph, the reference's default
# training scale (kgwas/kgwas.py:85-113): 2,000,000 SNPs, a tenth as many
# genes, n_snp // 17 terms per GO type, degree 6; FULL_KG's other settings
FULLKG = dict(n_snp=2_000_000, n_gene=200_000, n_go=2_000_000 // 17,
              snp_dim=20, gene_dim=128, go_dim=128, avg_degree=6)
# the JAX package's round-5 caps: Gene in 2 dst-range sub-layouts, SNP in 4
FULLKG_SPLIT = "Gene:10000000,SNP:4000000"
SPLIT_ENV = "KGWAS_MERGED_MAX_EDGES"
# KGWAS.train's batches: the eager block, the captured block, a 3-step tail
FULLKG_BATCHES = 2 * SCAN_S + 3
FULLKG_FWD_REPS = 5


def fields_equal(a, b, what):
    """Raise unless two dataclasses (RelationShard, MergedDstLayout) hold
    the same fields, arrays bitwise and of one dtype."""
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        same = (x.dtype == y.dtype and np.array_equal(x, y)
                if isinstance(x, np.ndarray) else x == y)
        if not same:
            raise AssertionError(f"{what}.{f.name}: the native and numpy "
                                 "paths differ")


@contextlib.contextmanager
def per_layout_launches(layouts, counts):
    """The merged layer's three wrappers counting their calls by layout
    key in counts[kernel][key] (the key of the device layout whose row
    offsets a call is given), each call passed on unchanged."""
    from kgwas_tpu_torch.ops import gat_layer, segment

    key_of = {L.row_offsets.data_ptr(): t for t, L in layouts.items()}

    def counting(name, fn, rows_of):
        def wrapped(*args, **kwargs):
            per = counts.setdefault(name, {})
            k = key_of[rows_of(args).data_ptr()]
            per[k] = per.get(k, 0) + 1
            return fn(*args, **kwargs)
        return wrapped

    with swapped(gat_layer,
                 merged_gat_forward=counting(
                     "merged_gat_fwd", gat_layer.merged_gat_forward,
                     lambda a: a[2]),
                 merged_gat_bwd=counting(
                     "merged_gat_bwd", gat_layer.merged_gat_bwd,
                     lambda a: a[2])), \
            swapped(segment, csc_segment_sum=counting(
                "csc_segment_sum", segment.csc_segment_sum,
                lambda a: a[5].row_offsets)):
        yield


def phase_fullkg(kt, card, tmp):
    """Phase 16: the full knowledge graph (FULLKG: 2,000,000 SNPs), GAT sum
    at hidden 128, 2 layers, float32. (a) The host steps' seconds; compile
    and the merged layouts through the native ops and through their numpy
    versions (shardops.plain), the arrays bitwise equal; each native op
    against its numpy version on the largest relation. (b) Serving:
    predict_all with #1 counted from 0 (once per live group and layer),
    against the same forward through the plain ops (no_grad), forward ms
    (median of 5 after 1 warm-up) and edge-traversals/s. (c) Training:
    three train_steps from one initial state with exact launches and
    finite losses, against the same steps through the plain ops (losses
    LOSS_RTOL, parameters PARAM_ATOL); eager step ms by slope and its peak
    memory; a captured
    block of SCAN_S steps: the scanned step's ms by slope and the graph
    pool; then KGWAS.train(epoch=1) over FULLKG_BATCHES batches at its
    defaults (scan_steps=8) with its launches, KGWAS_P in [0, 1] and the
    pred.csv write's host seconds; the epoch these imply. (d) The split
    (FULLKG_SPLIT): predict_all against (b)'s, three train_steps against
    (c)'s, the launches per sub-layout, peak memory, forward and step ms,
    the split's host seconds. Returns the launches of the layer kernels."""
    from kgwas_tpu_torch import kgwas as engine
    from kgwas_tpu_torch.engine.loop import epoch_batches, train_step
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph
    from kgwas_tpu_torch.native import shardops

    device = torch.device(DEVICE)
    host = {}

    def timed(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        host[name] = time.perf_counter() - t0
        return out

    launches = dict.fromkeys(MODEL_KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # (a) the host steps
    os.environ.pop(SPLIT_ENV, None)
    data = timed("from_synthetic", kt.KGWAS_Data.from_synthetic, seed=SEED,
                 data_path=str(tmp / "fullkg"), **FULLKG)
    timed("load_synthetic_gwas", data.load_synthetic_gwas, seed=SEED)
    timed("process_gwas_file", data.process_gwas_file)
    timed("prepare_split", data.prepare_split)
    cg = timed("compile", data.compile)
    layouts = timed("merged layouts", engine.merged_layouts, cg)
    with shardops.plain():
        cg_np = timed("compile (numpy)", compile_graph, data.graph,
                      edge_pad_multiple=512, node_pad_multiple=512)
        layouts_np = timed("merged layouts (numpy)", build_merged_layouts,
                           cg_np, tile_rows=engine.TILE_ROWS)
    for k, r in cg.relations.items():
        fields_equal(r, cg_np.relations[k], k)
    if list(layouts) != list(layouts_np):
        raise AssertionError("(a) the native and numpy layouts differ")
    for t, L in layouts.items():
        fields_equal(L, layouts_np[t], t)
    del cg_np, layouts_np
    # each native op against its numpy version on the largest relation
    r = max(cg.relations.values(), key=lambda r: r.num_edges)
    src_k, dst_k = r.src[:r.num_edges], r.dst[:r.num_edges]
    n_dst = cg.padded_nodes[r.dst_type]
    op_s = {}
    for name, fn, args in (
            ("stable_order", shardops.stable_order,
             (src_k, cg.padded_nodes[r.src_type])),
            ("csr_offsets", shardops.csr_offsets, (dst_k, n_dst)),
            ("coalesce", shardops.coalesce, (src_k, dst_k, n_dst))):
        t0 = time.perf_counter()
        got = fn(*args)
        t1 = time.perf_counter()
        with shardops.plain():
            want = fn(*args)
        op_s[name] = (t1 - t0, time.perf_counter() - t1)
        pairs = zip(got, want) if name == "coalesce" else [(got, want)]
        if not all(np.array_equal(a, b) for a, b in pairs):
            raise AssertionError(f"(a) {name}: the native and numpy "
                                 "results differ")
    edges = cg.total_real_edges()
    n_snp = cg.num_nodes["SNP"]
    epoch_steps = len(data.train_mask) // BATCH
    groups = ", ".join(f"{t} {len(L.src):,} edges x {len(L.rel_keys)} "
                       f"slots" for t, L in layouts.items())
    log(f"  phase 16a: {n_snp:,} SNPs, {edges:,} real edges in "
        f"{len(cg.relations)} relations ({groups}); {epoch_steps} steps of "
        f"{BATCH} an epoch; the native ops' arrays bitwise the numpy "
        f"path's; on {r.key} ({r.num_edges:,} edges) native / numpy s: "
        + ", ".join(f"{k} {a:.4f} / {b:.4f}" for k, (a, b) in op_s.items()))

    # (b) serving
    run = kt.KGWAS(data, exp_name="chip_smoke_fullkg", seed=SEED)
    timed("initialize_model", run.initialize_model, gnn_num_layers=LAYERS,
          gnn_hidden_dim=HIDDEN, no_relu=True)
    model = run.model
    init = copy.deepcopy(model.state_dict())
    timed("device layouts", shared_state, run)
    _, x, dl = run._device_state()
    f_eval, _ = path_launches(model, dl, False)
    model_counts(zero=True)
    pred = run.predict_all()
    counts = model_counts()
    if counts != add_counts((1, f_eval)):
        raise AssertionError(f"(b) predict_all launched {counts}, expected "
                             f"{add_counts((1, f_eval))}")
    add(counts)
    if not np.isfinite(pred).all():
        raise AssertionError("(b) predict_all is not finite")
    with plain_ops(), torch.no_grad():
        plain = run._forward(cg, x, dl)[:n_snp].cpu().numpy()
    torch.cuda.empty_cache()
    pred_err = float(np.abs(pred - plain).max())
    np.testing.assert_allclose(pred, plain, rtol=PRED_RTOL, atol=PRED_ATOL,
                               err_msg="(b) predict_all vs the plain ops")
    del plain
    fwd_ms = step_times(lambda: run._forward(cg, x, dl), FULLKG_FWD_REPS, 1)
    log(f"  phase 16b [{card}]: predict_all launched "
        f"{counts['merged_gat_fwd']} x #1 (the live groups of 2 layers), within rtol {PRED_RTOL} / atol"
        f" {PRED_ATOL} of the plain ops (max abs err {pred_err:.3e}); "
        f"forward {fwd_ms:.3f} ms (median of {FULLKG_FWD_REPS}), "
        f"{edges * LAYERS / fwd_ms * 1e3:.4g} edge-traversals/s")

    # (c) training
    y_node, w_node = run._labels(cg)
    host_batches = epoch_batches(np.asarray(data.train_mask), BATCH, False,
                                 None)
    batches = [torch.from_numpy(b).to(device)
               for b in host_batches[:CMP_STEPS]]
    f_train, b_train = path_launches(model, dl, True)
    per_step = add_counts((1, f_train), (1, b_train))

    def three_steps(m, lay, counts_of=None):
        """CMP_STEPS train_steps of m on lay from init: (losses, the final
        state on the host, the optimizer)."""
        m.load_state_dict(init)
        opt = build_optimizer(m.parameters(), LR, 5e-4)
        model_counts(zero=True)
        losses = [float(train_step(m, opt, x, lay, b, y_node, w_node))
                  for b in batches]
        got = model_counts()
        want = add_counts((CMP_STEPS, per_step)) if counts_of is None else (
            counts_of)
        if got != want:
            raise AssertionError(f"train_steps launched {got}, expected "
                                 f"{want}")
        add(got)
        if not np.isfinite(losses).all():
            raise AssertionError(f"train_step losses {losses}")
        return losses, to_host(m.state_dict()), opt

    losses, params, opt = three_steps(model, dl)
    # the same steps through the plain layer ops, which form every [E, D]
    # row (the Gene group's backward holds about five of 9.1 GB at once)
    model.load_state_dict(init)
    popt = build_optimizer(model.parameters(), LR, 5e-4)
    with plain_ops():
        plosses, plain_mb = peak_mib(lambda: [float(train_step(
            model, popt, x, dl, b, y_node, w_node)) for b in batches])
    del popt
    torch.cuda.empty_cache()
    np.testing.assert_allclose(losses, plosses, rtol=LOSS_RTOL,
                               err_msg="(c) train_steps vs the plain ops")
    plain_par = max(float((v.float() - params[k].float()).abs().max())
                    for k, v in to_host(model.state_dict()).items())
    if plain_par > PARAM_ATOL:
        raise AssertionError(f"(c) parameters after {CMP_STEPS} steps "
                             f"{plain_par:.3e} from the plain ops', > "
                             f"{PARAM_ATOL}")
    b0 = batches[0]
    _, step_mb = peak_mib(lambda: train_step(model, opt, x, dl, b0, y_node,
                                             w_node))
    step_ms = slope_ms(lambda: train_step(model, opt, x, dl, b0, y_node,
                                          w_node), 2, 6, 1)
    step_busy = profile_device(lambda: train_step(
        model, opt, x, dl, b0, y_node, w_node), step_ms, "2M-SNP step", 2)
    bm = np.stack(host_batches[:SCAN_S])
    scan, block, _, pool_mb = captured_scan(model, opt, x, dl, y_node,
                                            w_node, bm)
    if block != add_counts((SCAN_S, per_step)):
        raise AssertionError(f"(c) a captured block launched {block}")
    add(block)
    scan_ms = slope_ms(lambda: scan(bm), 1, 3, SCAN_S)
    del scan, opt
    torch.cuda.empty_cache()
    log(f"  phase 16c [{card}]: {CMP_STEPS} train_steps launched "
        f"{add_counts((CMP_STEPS, per_step))}, losses "
        f"{[f'{v:.6g}' for v in losses]}, the plain ops' "
        f"{[f'{v:.6g}' for v in plosses]} (rtol {LOSS_RTOL}), parameters "
        f"{plain_par:.3e} apart (<= {PARAM_ATOL}; the plain steps' peak "
        f"{plain_mb:.1f} MiB); step {step_ms:.3f} ms eager "
        f"(slope), {scan_ms:.3f} ms scanned (slope, blocks of {SCAN_S}); "
        f"the step's peak {step_mb:.1f} MiB above its start, the graph's "
        f"pool {pool_mb:.1f} MiB")

    data_v = copy.copy(data)
    data_v.train_mask = np.asarray(data.train_mask)[:FULLKG_BATCHES * BATCH]
    trainer = kt.KGWAS(data_v, exp_name="chip_smoke_fullkg", seed=SEED)
    trainer.initialize_model(gnn_num_layers=LAYERS, gnn_hidden_dim=HIDDEN,
                             no_relu=True)
    shared_state(trainer)
    trainer.model.load_state_dict(init)
    model_counts(zero=True)
    t0 = time.perf_counter()
    table = trainer.train(batch_size=BATCH, epoch=1, lr=LR)
    train_wall = time.perf_counter() - t0
    counts = model_counts()
    want = add_counts((scan_counted_steps(FULLKG_BATCHES), per_step),
                      (2, f_eval))
    if counts != want:
        raise AssertionError(f"(c) KGWAS.train launched {counts}, expected "
                             f"{want}")
    add(counts)
    sc = trainer.train_scan
    if sc is None or (sc.captures, sc.replays) != (1, 1):
        raise AssertionError(f"(c) captures / replays "
                             f"{sc and (sc.captures, sc.replays)}")
    p = np.asarray(table["KGWAS_P"])
    if len(p) != n_snp or not (np.isfinite(p).all() and p.min() >= 0
                               and p.max() <= 1):
        raise AssertionError("(c) KGWAS_P is not finite in [0, 1]")
    log(f"  phase 16c [{card}]: KGWAS.train over {FULLKG_BATCHES} batches "
        f"(scan_steps={SCAN_S}: eager block, capture, "
        f"{FULLKG_BATCHES - 2 * SCAN_S}-step tail) launched {counts}; {train_wall:.1f} s wall, of which "
        f"{trainer.pred_csv_seconds:.2f} s the pred.csv (formatted once, "
        f"copied); KGWAS_P over {len(p):,} SNPs in [{p.min():.3g}, "
        f"{p.max():.3g}]; an epoch of {epoch_steps} steps implies "
        f"{epoch_steps * step_ms / 1e3:.1f} s eager, "
        f"{epoch_steps * scan_ms / 1e3:.1f} s scanned")
    del trainer, table, data_v
    torch.cuda.empty_cache()

    # (d) the split
    os.environ[SPLIT_ENV] = FULLKG_SPLIT
    try:
        split_layouts = timed("split layouts", engine.merged_layouts, cg)
        split_run = kt.KGWAS(data, exp_name="chip_smoke_fullkg_split",
                             seed=SEED)
        split_run.initialize_model(gnn_num_layers=LAYERS,
                                   gnn_hidden_dim=HIDDEN, no_relu=True)
    finally:
        del os.environ[SPLIT_ENV]
    if split_run.layouts is not split_layouts:
        raise AssertionError("(d) the run did not take the split layouts")
    subs = sorted(t for t in split_layouts if "@" in t)
    timed("split device layouts", shared_state, split_run)
    sdl = split_run._device_state()[2]
    smodel = split_run.model
    smodel.load_state_dict(init)
    sf_eval, _ = path_launches(smodel, sdl, False)
    per_sub = {}
    model_counts(zero=True)
    with per_layout_launches(sdl, per_sub):
        spred = split_run.predict_all()
    counts = model_counts()
    if counts != add_counts((1, sf_eval)):
        raise AssertionError(f"(d) predict_all launched {counts}")
    add(counts)
    split_err = float(np.abs(spred - pred).max())
    np.testing.assert_allclose(spred, pred, rtol=RTOL, atol=ATOL,
                               err_msg="(d) split predict_all")
    sf_train, sb_train = path_launches(smodel, sdl, True)
    with per_layout_launches(sdl, per_sub):
        slosses, sparams, sopt = three_steps(smodel, sdl, add_counts(
            (CMP_STEPS, sf_train), (CMP_STEPS, sb_train)))
    np.testing.assert_allclose(slosses, losses, rtol=LOSS_RTOL,
                               err_msg="(d) split losses")
    worst = max(float((sparams[k].float() - params[k].float()).abs().max())
                for k in params)
    if worst > PARAM_ATOL:
        raise AssertionError(f"(d) split parameters {worst:.3e} from the "
                             f"unsplit run's, > {PARAM_ATOL}")
    _, split_mb = peak_mib(lambda: train_step(smodel, sopt, x, sdl, b0,
                                              y_node, w_node))
    split_step = slope_ms(lambda: train_step(smodel, sopt, x, sdl, b0,
                                             y_node, w_node), 2, 6, 1)
    split_busy = profile_device(lambda: train_step(
        smodel, sopt, x, sdl, b0, y_node, w_node), split_step,
        "2M-SNP split step", 2)
    split_fwd = step_times(lambda: split_run._forward(cg, x, sdl),
                           FULLKG_FWD_REPS, 1)
    del sopt
    same = "bitwise" if np.array_equal(spred, pred) else "not bitwise"
    log(f"  phase 16d [{card}]: {SPLIT_ENV}={FULLKG_SPLIT}: {subs}; "
        f"predict_all {same} the unsplit one (max abs diff {split_err:.3e}, rtol {RTOL} / atol "
        f"{ATOL}); 3 steps' losses within rtol {LOSS_RTOL}, parameters "
        f"{worst:.3e} apart (<= {PARAM_ATOL}); launches by layout "
        f"(predict_all and 3 steps): {per_sub}")
    log(f"  phase 16d [{card}]: split / unsplit: step peak {split_mb:.1f} / "
        f"{step_mb:.1f} MiB, forward {split_fwd:.3f} / {fwd_ms:.3f} ms, step "
        f"{split_step:.3f} / {step_ms:.3f} ms (slope); split host "
        f"{host['split layouts']:.2f} s layouts + "
        f"{host['split device layouts']:.2f} s device layouts; device busy "
        f"a step {split_busy:.3f} / {step_busy:.3f} ms")
    log("  phase 16 host seconds: " + ", ".join(
        f"{k} {v:.2f}" for k, v in host.items()))
    SHARED_STATE.clear()
    del run, split_run, model, smodel, x, dl, sdl
    torch.cuda.empty_cache()
    return launches


# phase 17: the calibration protocol's settings
# (scripts/run_calibration.py:80-85), its seeds cut to 2 null and 1 causal
CALIB = dict(n_snp=50_000, hidden=128, batch_size=512, epochs=10)
CALIB_NULL_SEEDS, CALIB_CAUSAL_SEEDS = 2, 1
CALIB_KEYS = {"arm", "seed", "gwas_hits", "kgwas_hits", "gwas_loci",
              "kgwas_loci", "scale_factor", "wall_s"}
CAUSAL_KEYS = CALIB_KEYS | {"gwas_true_pos", "gwas_false_pos",
                            "kgwas_true_pos", "kgwas_false_pos", "n_causal"}
# trait 1 at two sample sizes, seed 1, 2 epochs of run_sweep's 10
SWEEP = dict(n_snp=50_000, sizes=(12_500, 50_000), epochs=2)
SWEEP_KEYS = {"job", "gwas_hits_5e8", "kgwas_hits_5e8", "test_metrics",
              "scale_factor", "gwas_loci", "kgwas_loci", "n_causal",
              "gwas_causal_recovered", "kgwas_causal_recovered"}
T_P = 5e-8   # the scripts' threshold (kgwas_tpu_torch/scripts/loci.py)


def recount_leads(chrom, pos, p):
    """The independent loci below T_P counted apart from stats/clumps.py:
    with singleton clumps, a chromosome's hits sorted by cM (POS / 1e6)
    start a new locus where the gap to the previous is 0.1 cM or more;
    a locus's lead is its smallest cM. Sorted (chrom, cM) pairs."""
    hit = p < T_P
    leads = []
    for c in np.unique(chrom[hit]):
        cm = np.sort(pos[hit & (chrom == c)] / 1e6)
        new = np.concatenate([[True], np.diff(cm) >= 0.1])
        leads += [(int(c), float(v)) for v in cm[new]]
    return sorted(leads)


def calib_against_plain(kt, data, seed, card):
    """The calibration path's kernels held against their plain versions at
    the shapes it gives them: null seed seed's draw prepared as run_seed
    prepares it on the 50,000-SNP KG, its model at the protocol's widths
    (no_relu, as phases 6 and 16, so that a head dead at its start leaves
    no layer gradient at 0); predict_all (#1) against the same forward
    through the plain ops (PRED_RTOL / PRED_ATOL), then CMP_STEPS
    train_steps (#1, #2, #8) at the protocol's batch, learning rate and
    weight decay from one initial state through the kernels and through
    the plain ops (losses LOSS_RTOL, parameters PARAM_ATOL), each with
    exact launches. These launches are a comparison's: not added to the
    kernel line's."""
    from kgwas_tpu_torch.engine.loop import epoch_batches, train_step
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.scripts import run_calibration

    run_calibration.prepare_seed(data, CALIB["n_snp"], 0, seed)
    run = kt.KGWAS(data, exp_name=f"calib_null_{seed}_plain", seed=seed,
                   device=DEVICE)
    run.initialize_model(gnn_num_layers=2, gnn_hidden_dim=CALIB["hidden"],
                         no_relu=True)
    model = run.model
    init = copy.deepcopy(model.state_dict())
    cg, x, dl = run._device_state()
    n_snp = cg.num_nodes["SNP"]
    f_eval, _ = path_launches(model, dl, False)
    model_counts(zero=True)
    pred = run.predict_all()
    counts = model_counts()
    if counts != add_counts((1, f_eval)):
        raise AssertionError(f"(a) predict_all launched {counts}, expected "
                             f"{add_counts((1, f_eval))}")
    with plain_ops(), torch.no_grad():
        plain = run._forward(cg, x, dl)[:n_snp].cpu().numpy()
    if not np.isfinite(pred).all() or not np.abs(plain).max() > 0:
        raise AssertionError("(a) predict_all not finite, or the plain "
                             "forward 0 everywhere")
    pred_err = float(np.abs(pred - plain).max())
    np.testing.assert_allclose(pred, plain, rtol=PRED_RTOL, atol=PRED_ATOL,
                               err_msg="(a) predict_all vs the plain ops")

    y_node, w_node = run._labels(cg)
    batches = [torch.from_numpy(b).to(DEVICE) for b in epoch_batches(
        np.asarray(data.train_mask), CALIB["batch_size"], False,
        None)[:CMP_STEPS]]
    f_train, b_train = path_launches(model, dl, True)
    want = add_counts((CMP_STEPS, f_train), (CMP_STEPS, b_train))

    def steps(ctx):
        model.load_state_dict(init)
        opt = build_optimizer(model.parameters(), LR, 5e-4)
        model_counts(zero=True)
        with ctx:
            losses = [float(train_step(model, opt, x, dl, b, y_node,
                                       w_node)) for b in batches]
        return losses, to_host(model.state_dict()), model_counts()

    losses, params, counts = steps(contextlib.nullcontext())
    if counts != want:
        raise AssertionError(f"(a) train_steps launched {counts}, expected "
                             f"{want}")
    plosses, pparams, _ = steps(plain_ops())
    if not np.isfinite(losses).all():
        raise AssertionError(f"(a) train_step losses {losses}")
    np.testing.assert_allclose(losses, plosses, rtol=LOSS_RTOL,
                               err_msg="(a) train_steps vs the plain ops")
    par_err = max(float((params[k].float() - v.float()).abs().max())
                  for k, v in pparams.items())
    moved = max(float((params[k].float() - v.float().cpu()).abs().max())
                for k, v in init.items())
    if par_err > PARAM_ATOL or moved == 0:
        raise AssertionError(f"(a) parameters after {CMP_STEPS} steps "
                             f"{par_err:.3e} from the plain ops' (> "
                             f"{PARAM_ATOL}), or moved {moved:.3e}")
    log(f"  phase 17a [{card}]: null seed {seed}'s path against the plain "
        f"ops: predict_all ({add_counts((1, f_eval))['merged_gat_fwd']} x "
        f"#1) max abs err {pred_err:.3e} (rtol {PRED_RTOL} / atol "
        f"{PRED_ATOL}); {CMP_STEPS} train_steps of {CALIB['batch_size']} "
        f"launched {({k: counts[k] for k in LONG_KERNELS})}, losses "
        f"{[f'{v:.6g}' for v in losses]}, the "
        f"plain ops' {[f'{v:.6g}' for v in plosses]} (rtol {LOSS_RTOL}), "
        f"parameters {par_err:.3e} apart (<= {PARAM_ATOL}), moved "
        f"{moved:.3e} from the start")
    del run, model
    torch.cuda.empty_cache()


def phase_experiments(kt, card, tmp):
    """Phase 17: the calibration runner, the sweep and its summary, and
    the kgwas_101 demo on the card (module docstring, item 17). Returns
    the launches of #1, #2 and #8 it counted."""
    import shutil

    from kgwas_tpu_torch.demo import kgwas_101
    from kgwas_tpu_torch.graph.synthetic import (
        make_synthetic_subsample_sumstats, make_synthetic_sumstats)
    from kgwas_tpu_torch.scripts import (run_calibration, run_sweep,
                                         summarize_calibration,
                                         summarize_subsample)
    from kgwas_tpu_torch.utils import read_table

    cpu = DEVICE == "cpu"
    root = tmp / "experiments"
    shutil.rmtree(root, ignore_errors=True)
    launches = dict.fromkeys(LONG_KERNELS, 0)

    def add(counts):
        for k, v in counts.items():
            launches[k] += v

    # (a) the calibration protocol, one directory of JSONs
    out_dir = root / "calib"
    out_dir.mkdir(parents=True)
    args = SimpleNamespace(cpu=cpu, **CALIB)
    t0 = time.perf_counter()
    data = run_calibration.calibration_kg(CALIB["n_snp"], str(out_dir))
    cg = data.compile()
    kg_s = time.perf_counter() - t0
    log(f"  phase 17a [{card}]: the calibration KG ({CALIB['n_snp']:,} "
        f"SNPs, {len(data.idx2id['Gene']):,} genes, "
        f"{len(data.idx2id['BiologicalProcess']):,} terms per GO type): "
        f"{cg.total_real_edges():,} real edges in {len(cg.relations)} "
        f"relations, built and compiled in {kg_s:.2f} s")
    jobs = run_calibration.seed_jobs(CALIB_NULL_SEEDS, CALIB_CAUSAL_SEEDS)
    seeds = []
    for arm, seed in jobs:
        long_counts(zero=True)
        (done,) = run_calibration.run_seeds(data, [(arm, seed)], args,
                                            str(out_dir))
        counts = long_counts()
        steps = len(data.train_mask) // CALIB["batch_size"]
        expect_launches(counts, 3,
                        scan_counted_steps(steps, CALIB["epochs"]),
                        CALIB["epochs"] + 1, f"(a) {arm} seed {seed}")
        add(counts)
        out, split = done[2], done[3]
        want = CAUSAL_KEYS if arm == "causal" else CALIB_KEYS
        if set(out) != want:
            raise AssertionError(f"(a) {arm} seed {seed}: keys "
                                 f"{sorted(out)}, expected {sorted(want)}")
        n_causal = 0 if arm == "null" else CALIB["n_snp"] // 20
        ss, causal = make_synthetic_sumstats(
            CALIB["n_snp"], n_causal=n_causal, seed=seed + 10_000,
            return_causal=True)
        p = np.asarray(ss["P"])
        hits = set(np.asarray(ss["SNP"])[p < T_P].tolist())
        recount = {"gwas_hits": int((p < T_P).sum()),
                   "gwas_loci": len(recount_leads(
                       np.asarray(ss["CHR"]), np.asarray(ss["POS"]), p))}
        if arm == "causal":
            causal_ids = {f"rs{i}" for i in causal}
            recount.update(gwas_true_pos=len(hits & causal_ids),
                           gwas_false_pos=len(hits - causal_ids),
                           n_causal=n_causal)
        got = {k: out[k] for k in recount}
        if got != recount:
            raise AssertionError(f"(a) {arm} seed {seed}: GWAS side {got}, "
                                 f"the draw's recount {recount}")
        kp = np.asarray(read_table(
            str(out_dir / "kg" / "model_pred" / "new_experiments"
                / f"calib_{arm}_{seed}_pred.csv"), sep=None)["KGWAS_P"],
            dtype=np.float64)
        if len(kp) != CALIB["n_snp"] or not (
                np.isfinite(kp).all() and kp.min() >= 0 and kp.max() <= 1):
            raise AssertionError(f"(a) {arm} seed {seed}: pred.csv's KGWAS_P "
                                 "not finite in [0, 1] on every SNP")
        seeds.append((arm, seed, out, split, steps))
        log(f"  phase 17a [{card}]: {arm} seed {seed}: {out['wall_s']} s "
            f"wall; host split {run_calibration.split_text(split)}; "
            f"{steps} steps an epoch, launches {counts}; GWAS hits / loci "
            f"{out['gwas_hits']} / {out['gwas_loci']}, KGWAS "
            f"{out['kgwas_hits']} / {out['kgwas_loci']}")
    files = {f.name: f.stat().st_mtime_ns for f in out_dir.glob("*.json")}
    long_counts(zero=True)
    again = run_calibration.run_seeds(data, jobs, args, str(out_dir))
    if again or any(long_counts().values()) or files != {
            f.name: f.stat().st_mtime_ns for f in out_dir.glob("*.json")}:
        raise AssertionError("(a) the resumed call trained or wrote")
    log(f"  phase 17a: the resumed call on the directory ran no seed and "
        f"launched nothing; summarize_calibration:\n"
        + summarize_calibration.summary(str(out_dir)).rstrip())
    calib_against_plain(kt, data, jobs[0][1], card)
    walls = [out["wall_s"] for _, _, out, _, _ in seeds]
    mean, later = statistics.mean(walls), statistics.mean(walls[1:])
    parts = {k: statistics.mean(sp[k] for _, _, _, sp, _ in seeds[1:])
             for k in seeds[0][3]}
    log(f"  phase 17a [{card}]: calibration seed {mean:.2f} s wall (mean "
        f"of {len(walls)}: {walls}), {3600 / mean:.1f} seeds per hour; "
        f"after the first seed (its one-time set-up) {later:.2f} s, "
        f"{3600 / later:.1f} seeds per hour, mean "
        "split " + ", ".join(f"{k} {v:.3f} s" for k, v in parts.items()))
    log(f"  phase 17a finding [{card}]: the null seeds' KGWAS loci / GWAS "
        "loci: " + ", ".join(f"seed {seed} {out['kgwas_loci']} / "
                             f"{out['gwas_loci']}" for arm, seed, out, _, _
                             in seeds if arm == "null"))
    del data, cg

    # (b) the sweep, 2 epochs of the default 10, and its summary
    sweep_dir = root / "sweep"
    job_s = []
    real_run_job = run_sweep.run_job

    def timed_job(job, a):
        t = time.perf_counter()
        out = real_run_job(job, a)
        job_s.append(time.perf_counter() - t)
        return out

    argv = ["--mode", "subsample", "--synthetic-n-snp", str(SWEEP["n_snp"]),
            "--phenos", "1", "--sample-sizes", *map(str, SWEEP["sizes"]),
            "--seed-start", "1", "--seed-end", "2",
            "--epochs", str(SWEEP["epochs"])]
    long_counts(zero=True)
    with swapped(run_sweep, run_job=timed_job):
        run_sweep.main(argv + ["--data-path", str(root / "sweep_kg"),
                               "--out-dir", str(sweep_dir)]
                       + (["--cpu"] if cpu else []))
    counts = long_counts()
    add(counts)
    files = sorted(sweep_dir.glob("*.json"),
                   key=lambda f: int(f.name.split("_")[2]))
    if [f.name for f in files] != [f"subsample_1_{n}_1.json"
                                   for n in SWEEP["sizes"]]:
        raise AssertionError(f"(b) JSONs {[f.name for f in files]}")
    for f, n in zip(files, SWEEP["sizes"]):
        out = json.loads(f.read_text())
        if set(out) != SWEEP_KEYS:
            raise AssertionError(f"(b) {f.name}: keys {sorted(out)}")
        ss, causal = make_synthetic_subsample_sumstats(
            SWEEP["n_snp"], 1, n, 1, return_causal=True)
        p = np.asarray(ss["P"])
        recount = {"gwas_hits_5e8": int((p < T_P).sum()),
                   "gwas_loci": recount_leads(np.asarray(ss["CHR"]),
                                              np.asarray(ss["POS"]), p),
                   "n_causal": len(causal),
                   "gwas_causal_recovered": int((p[causal] < T_P).sum())}
        got = {k: out[k] for k in recount}
        got["gwas_loci"] = [tuple(x) for x in got["gwas_loci"]]
        if got != recount:
            raise AssertionError(f"(b) {f.name}: GWAS side differs from "
                                 "the draw's recount")
    log(f"  phase 17b [{card}]: run_sweep {' '.join(argv)}: jobs "
        f"{[f'{s:.2f}' for s in job_s]} s, launches {counts}; "
        "summarize_subsample:\n" + summarize_subsample.summary(
            str(sweep_dir), 50_000).rstrip())

    # (c) the first demo, to its checkpoint reload
    long_counts(zero=True)
    t0 = time.perf_counter()
    run, run2 = kgwas_101.main(["--synthetic", "--data-path",
                                str(root / "demo") + "/"]
                               + (["--cpu"] if cpu else []))
    demo_s = time.perf_counter() - t0
    if not np.array_equal(run2.predict_all(), run.predict_all()):
        raise AssertionError("(c) the reloaded checkpoint serves other "
                             "predictions")
    counts = long_counts()
    add(counts)
    if not all(counts.values()):
        raise AssertionError(f"(c) kgwas_101 launched {counts}")
    log(f"  phase 17c [{card}]: demo.kgwas_101 --synthetic in {demo_s:.2f} "
        f"s to its reload, launches {counts} (both predict_all included)")
    log(f"phase 17 ok [{card}]: launches {launches}")
    del run, run2
    torch.cuda.empty_cache()
    return launches


PHASE_SECONDS = {}


def timed_phase(name, fn, *args):
    """fn(*args), its seconds kept in PHASE_SECONDS and logged."""
    t0 = time.perf_counter()
    try:
        return fn(*args)
    finally:
        PHASE_SECONDS[name] = time.perf_counter() - t0
        log(f"phase {name}: {PHASE_SECONDS[name]:.1f} s")


def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (HERE / "kgwas_tpu_torch" / "__init__.py").exists():
        print("chip_smoke: kgwas_tpu_torch is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(HERE))
    import kgwas_tpu_torch as kt
    from kgwas_tpu_torch.ops import build, gat_layer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device(DEVICE)
    tmp = HERE / "build" / "chip_smoke"
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- phase 1: card and kernel build
    log(f"phase 1: card {card} | torch {kind} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    built = build.build_all()
    parent = parent_kernels(build)
    logs = dict(build.build_log, **(parent.build_logs() if parent else {}))
    for name, info in logs.items():
        log(f"  built {name} in {info['seconds']:.1f} s")
        report_ptxas(build, name, info["ptxas"], KERNEL_LAUNCH)
    log(f"phase 1 ok: kernels built in {time.perf_counter() - t0:.1f} s "
        f"({sorted(built) or 'cached'})"
        + (f"; earlier kernels from {parent.csrc}" if parent else ""))
    PHASE_SECONDS["1"] = time.perf_counter() - t0

    # ---- phase 1b: the gather ceiling on the full-width data's streams
    t0 = time.perf_counter()
    data = kt.KGWAS_Data.from_synthetic(seed=SEED, data_path=str(tmp / "full"),
                                        **FULL_KG)
    data.load_synthetic_gwas(seed=SEED)
    data.process_gwas_file()
    cg = data.compile()
    log(f"phase 3: data built in {time.perf_counter() - t0:.1f} s: "
        f"{cg.total_real_edges()} real edges in {len(cg.relations)} "
        f"relations")
    from kgwas_tpu_torch.graph import build_merged_layouts
    from kgwas_tpu_torch.kgwas import TILE_ROWS

    layouts = build_merged_layouts(cg, tile_rows=TILE_ROWS)
    rates = phase_probe(build, layouts, cg, device, card)
    floors = gather_floors(cg, layouts, rates)
    rates16 = phase_probe(build, layouts, cg, device, card, bf16=True)
    floors16 = gather_floors_bf16(cg, layouts, rates16, rates)
    del layouts
    PHASE_SECONDS["1b (and the data)"] = time.perf_counter() - t0

    # ---- phase 2: kernel vs plain on the card, small KG
    worst_small, worst_small_bwd = timed_phase(
        "2", phase_kernel_vs_plain, device, gat_layer, kt, tmp)

    # ---- phases 3 and 4: the serving slice at full width, its timing
    tot, worst_full = timed_phase("3-4", phase_serve, kt, data, cg, device,
                                  card, parent, tmp)

    # ---- phase 5: the training slice at full width
    train_rows, train_counts, trainer, step_5d = timed_phase(
        "5", phase_train, kt, data, cg, device, card, parent)

    # ---- phase 6: the model variants
    worst_variants = timed_phase("6a", phase_variant_kernels, kt, device, tmp)
    # from here to phase 11e, KGWAS.train writes pred.csv's header alone
    header_only = contextlib.ExitStack()
    header_only.enter_context(pred_csv_header_only())
    variant_rows = timed_phase("6b-c", phase_variants, kt, data, cg, device,
                               card, worst_variants, parent)

    # ---- phase 7: interpretation on phase 5's model, and on GAT-max
    timed_phase("7", phase_interpret, kt, trainer, cg, card, tmp)
    del trainer
    torch.cuda.empty_cache()

    # ---- phase 8: the bench entry, and a traced, logged epoch
    bench0 = timed_phase("8", phase_bench, kt, data, card, step_5d[0], tmp)

    # ---- phase 10: the other model options (heads, dropout, ...), full width
    model_launches, model_worst, _ = timed_phase(
        "10", phase_models, kt, data, cg, device, card, floors)

    # ---- phases 12 and 13: the bf16 dtypes at full width (the per-relation
    # softmax GAT's #6 / #7 among them), the quality gate
    bf16_rows = timed_phase("12a", phase_bf16_kernels, kt, cg, device, card,
                            floors16, parent)
    bf16_launches, bf16_worst, _, rel_rows, bf16_epoch = timed_phase(
        "12b-d", phase_bf16_models, kt, data, cg, device, card, floors16,
        parent)
    bf16_rows.update(rel_rows)
    timed_phase("13", phase_gate, kt, card, tmp)

    # ---- phase 14: multi-device training (mesh=1 over NCCL on every layer
    # path, the blocks of 2, 3 and 4 ranks through the kernels)
    mesh_launches, mesh_bf16 = timed_phase("14", phase_mesh, kt, data, cg,
                                           device, card)
    bf16_launches = {k: v + mesh_bf16[k] for k, v in bf16_launches.items()}

    # ---- phase 15: scanned dispatch (CUDA graphs of blocks of steps)
    scan_launches = timed_phase("15", phase_scan, kt, data, device, card,
                                bench0, tmp)

    # ---- phase 11 (a), (b), (e): long runs and streamed features, full width
    long_launches = add_counts(
        (1, timed_phase("11a", phase_restart, kt, data, card)),
        (1, timed_phase("11b", phase_checkpoint, kt, data, card)),
        (1, timed_phase("11e", phase_streamed, kt, data, cg, device, card)),
        (1, mesh_launches), (1, scan_launches))
    header_only.close()
    del data, cg
    torch.cuda.empty_cache()

    # ---- phase 9: the real-data path through the CLI, full width
    timed_phase("9", phase_real, kt, card, step_5d, tmp)

    # ---- phase 11 (c), (d), (f): a sticky CUDA error, the watchdog, the
    # cohort builder
    timed_phase("11c", phase_sticky, card)
    long_launches = add_counts((1, long_launches),
                               (1, timed_phase("11d", phase_watchdog, card,
                                               tmp)))
    timed_phase("11f", phase_cohort, kt, card, tmp)

    # ---- phase 16: the full knowledge graph (2M SNPs), split and unsplit
    SHARED_STATE.clear()
    torch.cuda.empty_cache()
    long_launches = add_counts((1, long_launches), (1, timed_phase(
        "16", phase_fullkg, kt, card, tmp)))
    SHARED_STATE.clear()
    torch.cuda.empty_cache()

    # ---- phase 17: the experiment scripts (calibration, sweep, demo)
    long_launches = add_counts((1, long_launches), (1, timed_phase(
        "17", phase_experiments, kt, card, tmp)))
    log("phase seconds: " + ", ".join(f"{k} {v:.1f}"
                                      for k, v in PHASE_SECONDS.items())
        + f"; total {sum(PHASE_SECONDS.values()):.1f} s; wall "
        f"{time.perf_counter() - t_start:.1f} s")

    train_rows[0]["max_abs_err"] = max(train_rows[0]["max_abs_err"],
                                       worst_small_bwd)
    kernels = [{
        "name": "merged_gat_fwd",
        "route": "cuda",
        "source": "kgwas_tpu_torch/ops/csrc/merged_gat_fwd.cu",
        "replaces": "kgwas_tpu/ops/pallas_gat_layer.py:210",
        "launches": train_counts["merged_gat_fwd"],
        "max_abs_err": max(worst_small, worst_full),
        "ms": tot["ms"],
        "device_ms": tot["device_ms"],
        "plain_ms": tot["plain_ms"],
        "bound_ms": tot["bound_ms"],
        "bound_by": ("bytes" if tot["bytes"] >= tot["operations"]
                     else "operations"),
        "library_ms": None,
    }] + train_rows + variant_rows
    for row in kernels:   # phases 10 and 11's launches, 10's errors
        row["launches"] += (model_launches.get(row["name"], 0)
                            + long_launches.get(row["name"], 0))
        row["max_abs_err"] = max(row["max_abs_err"],
                                 model_worst.get(row["name"], 0.0))
    for name in BF16_KERNELS:   # phase 12's
        r = bf16_rows[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": BF16_SOURCE[name],
            "replaces": BF16_REPLACES[name],
            "launches": bf16_launches[name],
            "max_abs_err": max(r["max_abs_err"], bf16_worst[name]),
            "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"],
            "bound_by": ("bytes" if r["bytes"] >= r["operations"]
                         else "operations"),
            "library_ms": r.get("library_ms"),
            "gather_floor_ms": r["floor_ms"],
            "f32_ms": r["f32_ms"],
            "f32_device_ms": r["f32_device_ms"],
            # counted over a full-width epoch of train_steps, by variant
            # (phase 12's EPOCH_VARIANTS; kernels they launch)
            **({"epoch_launches": ep} if (ep := {
                v: c[name] for v, c in bf16_epoch.items() if c.get(name)})
               else {}),
            **{k: r[k] for k in ("parent_ms", "parent_device_ms") if k in r},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
