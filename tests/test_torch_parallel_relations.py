"""The per-relation and 'mp' layers, and layouts that do not divide evenly,
over the mesh's 'data' axis (``kgwas_tpu_torch/parallel/relation_shard.py``
and the uneven ``merged_shard.py``), against the single-process port and
the JAX package's GSPMD path.

* (a) Each rank's block of every relation stream, every merged layout's
  'mp' stream and every merged layout's ``build_device_layouts`` for 2, 3
  and 4 ranks on a KG whose row tiles do not divide by 3 or 4: the ranks'
  rows contiguous whole tiles, their edges in order the stream's, each
  rank's CSC complete (every edge once, at the source row the stream's
  CSC gives it), the pad edges on the rank that owns the trash row, the
  degree norms the stream's slices; contents compared.
* (b) In one process without a process group (each rank given the whole
  table, its gradients summed, as ``chip_smoke.py`` phase 14b does), every
  rank's plain #6 / #7 / #8 (GAT max, GAT min, with a dropout multiplier,
  with ``edge_dim``), #10 / #8 (sigmoid GAT max, SAGE max, GCN sum and SGC
  mean on the 'mp' stream) and #1 / #2 / #8 (merged GAT sum and sigmoid
  GAT sum) on its rows, for 2, 3 and 4 ranks: the assembled rows and the
  summed gradients against the unsharded plain layer at rtol 1e-5, each
  kernel called once per stream and head on a rank with rows, with the
  rank's row count.
* (c) Two gloo ranks, each running GAT max, SAGE sum, GCN max, sigmoid GAT
  sum and GAT sum with dropout 0.1 in turn (one start of the processes),
  against the single-process port (predictions rtol 1e-5, atol 1e-5;
  step-1 loss rtol 1e-5, the parameters' gradients at test_torch_train's
  bounds; 3 Adam steps' losses rtol 1e-5: test_torch_parallel's bounds for
  the merged path) and against the JAX package's ``make_sharded_train_step`` on its
  2-device CPU mesh (its GSPMD XLA path: ``_gspmd_cfg`` turns ``use_pallas``
  off outside the merged gate), 3 losses at rtol 1e-4. Three gloo ranks on
  the same KG (3 SNP row tiles, 2 Gene row tiles: a rank with no Gene
  rows; source rows that do not divide by 3), GAT max, SAGE sum, GAT sum
  and GAT max with remat (the collectives again in each recompute),
  against the single-process port only: the JAX package needs arrays that
  divide by its mesh (``shard_graph_arrays``).
* (d) ``torchrun --nproc-per-node 2 -m kgwas_tpu_torch.cli train --mesh 2
  --device cpu --backbone SAGE --aggr max`` writes the single-process
  CLI's KGWAS_P (rtol 1e-4, atol 1e-6).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kgwas_tpu_torch.config import ModelConfig
from kgwas_tpu_torch.engine.loop import batch_loss, fill_dead_grads, train_step
from kgwas_tpu_torch.engine.optim import build_optimizer
from kgwas_tpu_torch.graph import (build_merged_layouts, compile_graph,
                                   make_synthetic_kg)
from kgwas_tpu_torch.models import HeteroGNN, device_layouts, layer_paths
from kgwas_tpu_torch.ops import gat_layer, segment, segment_softmax
from kgwas_tpu_torch.ops.gat_layer import MergedGATLayer
from kgwas_tpu_torch.ops.segment import CSRSegmentSum
from kgwas_tpu_torch.parallel import merged_shard
from kgwas_tpu_torch.parallel.mesh import Mesh
from kgwas_tpu_torch.parallel.relation_shard import (make_relation_fns,
                                                     mp_rank_stream,
                                                     relation_rank_stream)
from torch_threads import few_torch_threads  # noqa: F401,E402

# SNP 1,536 padded rows (3 tiles), Gene 1,024 (2): neither divides by 4,
# Gene not by 3
KG = dict(n_snp=1100, n_gene=600, n_go=40, snp_dim=20, gene_dim=32,
          go_dim=16, seed=11)
HIDDEN = 16
HERE = Path(__file__).resolve().parent
LR, WD = 1e-3, 5e-4
TILE = merged_shard.TILE


def _compile(jax=False):
    if jax:
        from kgwas_tpu.graph import compile_graph as jcompile
        from kgwas_tpu.graph import make_synthetic_kg as jkg

        return jcompile(jkg(**KG), edge_pad_multiple=512,
                        node_pad_multiple=512)
    return compile_graph(make_synthetic_kg(**KG), edge_pad_multiple=512,
                         node_pad_multiple=512)


@pytest.fixture(scope="module")
def world():
    cg = _compile()
    return cg, build_merged_layouts(cg, tile_rows=TILE)


def _edge_sources(csc_perm, csc_ids):
    key = np.empty(len(csc_perm), np.int64)
    key[np.asarray(csc_perm, np.int64)] = csc_ids
    return key


# --------------------------------------------------------- (a) the layouts

def _check_blocks(ranks, src, dst, row_offsets, csc_perm, csc_ids, n_src,
                  num_real, trash, inv_deg, sym_e, what):
    """The ranks' RankStreams partition the stream (host arrays)."""
    n_rows = len(row_offsets) - 1
    key = _edge_sources(csc_perm, csc_ids)
    assert ranks[0].rows[0] == 0 and ranks[-1].rows[1] == n_rows, what
    counts = np.zeros(n_src, np.int64)
    got_src = []
    for i, r in enumerate(ranks):
        r0, r1 = r.rows
        if i + 1 < len(ranks):
            assert r1 == ranks[i + 1].rows[0], what
        assert r0 % TILE == 0 and (r1 % TILE == 0 or r1 == n_rows), what
        assert r.row_sizes[i] == r1 - r0, what
        e0, e1 = r.edges
        assert (e0, e1) == (row_offsets[r0], row_offsets[r1]), what
        if r.empty:
            assert r0 == r1 and e0 == e1, what
            continue
        L = r.layout
        assert L.n_rows_per_rel == r1 - r0 and L.src_base == (0, n_src)
        s = L.src.numpy()
        got_src.append(s)
        np.testing.assert_array_equal(
            L.row_offsets.numpy(), np.asarray(row_offsets[r0:r1 + 1]) - e0)
        np.testing.assert_array_equal(L.dst.numpy() + r0, dst[e0:e1])
        # the CSC: every edge once, at its source row in the stream's CSC,
        # in the stream's order within a row
        perm = L.csc_perm.numpy()
        assert np.array_equal(np.sort(perm), np.arange(e1 - e0)), what
        off = L.csc_offsets.numpy()
        ids = np.repeat(np.arange(n_src), np.diff(off))
        np.testing.assert_array_equal(ids, key[e0:e1][perm])
        assert np.all((np.diff(ids) > 0) | (np.diff(perm) > 0)), what
        counts += np.diff(off)
        np.testing.assert_array_equal(L.csc_rows.numpy(),
                                      L.dst.numpy()[perm])
        if num_real is not None:
            # a relation's real edges first; the pad edges on the rank that
            # owns the trash row
            real = int(np.clip(num_real - e0, 0, e1 - e0))
            assert L.rel_num_edges == (real,), what
            if e1 > num_real:
                assert r0 <= trash < r1, what
        np.testing.assert_array_equal(L.inv_deg.numpy(), inv_deg[r0:r1])
        np.testing.assert_array_equal(L.sym_e.numpy(), sym_e[e0:e1])
    np.testing.assert_array_equal(np.concatenate(got_src), src)
    np.testing.assert_array_equal(counts, np.bincount(key, minlength=n_src))


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_rank_blocks_partition_every_stream(world, n_dev):
    from kgwas_tpu_torch.models.hetero_gnn import (merged_mp_norms,
                                                   relation_norms)

    cg, host = world
    for rk, r in cg.relations.items():
        n_src = int(cg.padded_nodes[r.src_type])
        ranks = [relation_rank_stream(r, cg, n_dev, i, "cpu")
                 for i in range(n_dev)]
        _check_blocks(ranks, r.src, r.dst, r.row_offsets, r.csc_perm,
                      r.csc_src_sorted, n_src, r.num_edges,
                      cg.num_nodes[r.dst_type],
                      *relation_norms(r, n_src, cg.padded_nodes[r.dst_type]),
                      rk)
        # the source rows split over the ranks
        assert sum(ranks[0].x_sizes) == n_src
        assert [(s.x_lo, s.x_hi) for s in ranks] == [
            (i * n_src // n_dev, (i + 1) * n_src // n_dev)
            for i in range(n_dev)]
    for t, L in host.items():
        ranks = [mp_rank_stream(L, n_dev, i, "cpu") for i in range(n_dev)]
        _check_blocks(ranks, L.src, L.dst, L.row_offsets, L.csc_perm,
                      L.csc_ids, L.n_src_total, None, None,
                      *merged_mp_norms(L), t)
        # the merged GAT layer's blocks: the same rows, the same edges
        DL = merged_shard.build_device_layouts(L, n_dev)
        assert DL.row_bounds == tuple(r.rows[0] for r in ranks) + (
            L.n_rows_total,)
        edges = []
        for i in range(n_dev):
            e = int(DL.tile_starts[i, -1])
            assert e == ranks[i].edges[1] - ranks[i].edges[0]
            edges.append(DL.src[i, :e])
            np.testing.assert_array_equal(
                DL.dst_local[i, :e] + DL.row_bounds[i],
                L.dst[ranks[i].edges[0]:ranks[i].edges[1]])
            assert np.all(DL.src[i, e:] == 0)
            shard = merged_shard.RankShard(L, DL, i, "cpu")
            assert shard.rows_per_dev == ranks[i].rows[1] - ranks[i].rows[0]
            if not shard.empty:
                assert shard.csc.csc_offsets[-1] == e
        np.testing.assert_array_equal(np.concatenate(edges), L.src)


# ------------------------------------- (b) the ranks' kernels, one process

REL_CASES = {
    "GAT-max": dict(gnn_aggr="max"),
    "GAT-min": dict(gnn_aggr="min"),
    "GAT-max dropout": dict(gnn_aggr="max", dropout=0.3),
    "GAT-sum edge_dim": dict(edge_dim=3),
    "sigmoid GAT-max": dict(gnn_aggr="max", sigmoid_gat=True),
    "SAGE-max": dict(gnn_backbone="SAGE", gnn_aggr="max"),
}
MP_CASES = {"GCN-sum": dict(gnn_backbone="GCN"),
            "SGC-mean": dict(gnn_backbone="SGC", gnn_aggr="mean")}
MERGED_CASES = {"GAT-sum": "softmax", "sigmoid GAT-sum": "sigmoid"}
ALL_CASES = list(REL_CASES) + list(MP_CASES) + list(MERGED_CASES)


class _Calls:
    """Records each call of the kernel wrappers: (name, rows)."""

    def __init__(self, monkeypatch):
        self.calls = []
        for mod, name, rows in (
                (segment_softmax, "segment_softmax_spmm_fwd",
                 lambda a: a[3].shape[0] - 1),
                (segment_softmax, "segment_softmax_spmm_bwd",
                 lambda a: a[3].shape[0] - 1),
                (segment, "csr_segment_sum", lambda a: a[2].shape[0] - 1),
                (segment, "csc_segment_sum",
                 lambda a: a[5].n_rows_per_rel),
                (gat_layer, "merged_gat_forward",
                 lambda a: a[2].shape[0] - 1),
                (gat_layer, "merged_gat_bwd", lambda a: a[2].shape[0] - 1)):
            monkeypatch.setattr(mod, name, self._wrap(
                getattr(mod, name), name, rows))

    def _wrap(self, fn, name, rows):
        def call(*a, **kw):
            self.calls.append((name, int(rows(a))))
            return fn(*a, **kw)
        return call

    def take(self):
        out, self.calls = self.calls, []
        return out


def _model(cg, **kw):
    cfg = ModelConfig(gnn_hidden_dim=HIDDEN, no_relu=True, **kw)
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    return HeteroGNN(cfg, rel_types, KG["snp_dim"], KG["gene_dim"],
                     KG["go_dim"], seed=4)


def _leaves(vals):
    return {k: v.detach().clone().requires_grad_() for k, v in vals.items()}


def _grads(model, leaves):
    out = {f"h:{k}": v.grad for k, v in leaves.items()
           if v.grad is not None}
    out.update({k: p.grad for k, p in model.named_parameters()
                if p.grad is not None})
    return out


def _add(total, grads):
    """The sum of two ranks' gradients (a rank without rows of a stream
    gives its relation's parameters none)."""
    total = dict(total or {})
    for k, v in grads.items():
        if v is not None:
            total[k] = v if k not in total else total[k] + v
    return total


def _close(got, want, what):
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5,
                               atol=1e-5 * float(want.detach().abs().max()),
                               err_msg=what)


def _relation_case(world, name, n_dev, calls):
    cg, host = world
    model = _model(cg, **REL_CASES[name])
    layer = model.convs[0]
    layouts = device_layouts(host, "cpu", cg, "relations")
    gen = torch.Generator().manual_seed(9)
    h = {t: torch.randn(cg.padded_nodes[t], HIDDEN, generator=gen)
         for t in cg.padded_nodes}
    g = {t: torch.randn(cg.padded_nodes[t], HIDDEN, generator=gen)
         for t in layouts}
    keep = (model.draw_keep(layouts, torch.Generator().manual_seed(3))
            if model.cfg.dropout else None)
    edge_attr = ({rk: torch.randn(r.src.shape[0], 3, generator=gen)
                  for L in layouts.values()
                  for rk, r in zip(L.rel_keys, L.relations)}
                 if model.cfg.edge_dim else None)
    hl = _leaves(h)
    want = model.relation_layer(layer, hl, layouts, keep, edge_attr)
    sum(((want[t] * g[t]).sum() for t in want), torch.tensor(0.0)).backward()
    want_g = {k: v.clone() for k, v in _grads(model, hl).items()}
    model.zero_grad(set_to_none=True)
    calls.take()
    heads = model.cfg.gat_num_head if model.cfg.gnn_backbone == "GAT" else 1
    rows = {t: [] for t in layouts}
    total = None
    for i in range(n_dev):
        fns = make_relation_fns(host, cg, Mesh(data=n_dev, rank=i), "cpu")
        hl = _leaves(h)
        out = model.relation_layer(layer, hl, layouts, keep, edge_attr,
                                   rank_fns=fns)
        loss = torch.tensor(0.0)
        for t, v in out.items():
            r0, r1 = fns[t].rows
            assert v.shape[0] == r1 - r0
            rows[t].append(v.detach())
            loss = loss + (v * g[t][r0:r1]).sum()
        loss.backward()
        gi = _grads(model, hl)
        total = _add(total, gi)
        model.zero_grad(set_to_none=True)
        # once per stream and head on the rank's rows, on a rank with rows
        want_calls = []
        for t in layouts:
            for s in fns[t].streams:
                if s.empty:
                    continue
                n = s.rows[1] - s.rows[0]
                want_calls += [("segment_softmax_spmm_fwd", n),
                               ("segment_softmax_spmm_bwd", n),
                               ("csc_segment_sum", n)] * heads \
                    if name.startswith("GAT") else [
                        ("csr_segment_sum", n), ("csc_segment_sum", n)] * heads
        assert sorted(calls.take()) == sorted(want_calls), (name, i)
    for t in layouts:
        _close(torch.cat(rows[t]), want[t], f"{name} x{n_dev} {t} rows")
    for k, v in want_g.items():
        _close(total[k], v, f"{name} x{n_dev} {k}")


def _mp_case(world, name, n_dev, calls):
    cg, host = world
    model = _model(cg, **MP_CASES[name])
    layer = model.convs[0]
    layouts = device_layouts(host, "cpu", cg, "mp")
    gen = torch.Generator().manual_seed(10)
    h = {t: torch.randn(cg.padded_nodes[t], HIDDEN, generator=gen)
         for t in cg.padded_nodes}
    gcn = model.cfg.gnn_backbone == "GCN"
    for t, L in layouts.items():
        convs = [layer.convs[rk] for rk in L.rel_keys]
        weight = (lambda c: c.lin.weight) if gcn else (lambda c: None)
        hl = _leaves(h)
        xs = model.source_rows(hl, L, convs, weight, torch.float32)
        want = CSRSegmentSum.apply(xs, L.sym_e, L)
        g = torch.randn(want.shape, generator=gen)
        (want * g).sum().backward()
        want_g = {k: v.clone() for k, v in _grads(model, hl).items()}
        model.zero_grad(set_to_none=True)
        calls.take()
        outs, total = [], None
        for i in range(n_dev):
            rank = mp_rank_stream(host[t], n_dev, i, "cpu")
            hl = _leaves(h)
            xs = rank.source(lambda lo, hi: model.source_rows(
                hl, L, convs, weight, torch.float32, lo, hi))
            if rank.empty:
                continue
            out = CSRSegmentSum.apply(xs, rank.layout.sym_e, rank.layout)
            r0, r1 = rank.rows
            (out * g[r0:r1]).sum().backward()
            outs.append(out.detach())
            gi = _grads(model, hl)
            total = _add(total, gi)
            model.zero_grad(set_to_none=True)
            assert calls.take() == [("csr_segment_sum", r1 - r0),
                                    ("csc_segment_sum", r1 - r0)]
        _close(torch.cat(outs), want, f"{name} x{n_dev} {t} rows")
        for k, v in want_g.items():
            if v is not None:
                _close(total[k], v, f"{name} x{n_dev} {t} {k}")


def _merged_case(world, name, n_dev, calls):
    cg, host = world
    mode = MERGED_CASES[name]
    gen = torch.Generator().manual_seed(12)
    for t in ("Gene", "SNP"):
        L = host[t]
        R, n = len(L.rel_keys), L.n_rows_per_rel
        DL = device_layouts({t: L}, "cpu")[t]
        DL.__dict__.update(segment.csc_fields(
            L.dst, L.csc_perm, L.csc_offsets, n, L.src_base, 0, "cpu"))
        vals = {"xs": torch.randn(L.n_src_total, HIDDEN, generator=gen) * .1,
                "att": torch.randn(R, HIDDEN, generator=gen) * .2,
                "ad": torch.randn(L.n_rows_total, generator=gen) * .5}
        g = torch.randn(L.n_rows_total, HIDDEN, generator=gen)
        lv = _leaves(vals)
        want = MergedGATLayer.apply(lv["xs"], lv["att"], lv["ad"], DL, 0,
                                    mode, 0.2, 1.0)
        (want * g).sum().backward()
        want_g = {k: v.grad for k, v in lv.items()}
        calls.take()
        dls = merged_shard.build_device_layouts(L, n_dev)
        outs, total = [], {k: 0.0 for k in vals}
        for i in range(n_dev):
            shard = merged_shard.RankShard(L, dls, i, "cpu")
            lv = _leaves(vals)
            out = merged_shard.ShardedMergedGAT.apply(
                lv["xs"], lv["att"], lv["ad"], shard, None, mode, 0.2, 1.0)
            out.backward(g[shard.row0:shard.row0 + shard.rows_per_dev])
            outs.append(out.detach())
            total = {k: total[k] + (0.0 if v.grad is None else v.grad)
                     for k, v in lv.items()}
            got = calls.take()
            if shard.empty:
                assert got == []
                continue
            rows = shard.row_offsets.shape[0] - 1
            assert got == [("merged_gat_forward", rows),
                           ("merged_gat_bwd", rows),
                           ("csc_segment_sum", n)]
        _close(torch.cat(outs), want, f"{name} x{n_dev} {t} rows")
        for k, v in want_g.items():
            _close(total[k], v, f"{name} x{n_dev} {t} d_{k}")


@pytest.mark.parametrize("n_dev", [2, 3, 4])
@pytest.mark.parametrize("name", ALL_CASES)
def test_rank_kernels_assemble_the_unsharded_layer(world, monkeypatch, name,
                                                   n_dev):
    calls = _Calls(monkeypatch)
    if name in REL_CASES:
        _relation_case(world, name, n_dev, calls)
    elif name in MP_CASES:
        _mp_case(world, name, n_dev, calls)
    else:
        _merged_case(world, name, n_dev, calls)


# ------------------------------------------------ (c) gloo ranks, the JAX GSPMD

# the 2-rank configurations, each against the JAX package's GSPMD path
GLOO_2 = {"GAT-max": dict(gnn_aggr="max"),
          "SAGE-sum": dict(gnn_backbone="SAGE"),
          "GCN-max": dict(gnn_backbone="GCN", gnn_aggr="max"),
          "sigmoid GAT-sum": dict(sigmoid_gat=True),
          "GAT-sum dropout": dict(dropout=0.1)}
# the 3-rank configurations (blocks that do not divide), against the port;
# remat runs each layer's collectives again in its recompute
GLOO_3 = {"GAT-max": dict(gnn_aggr="max"),
          "SAGE-sum": dict(gnn_backbone="SAGE"), "GAT-sum": {},
          "GAT-max remat": dict(gnn_aggr="max", remat=True)}


def _world_for(cfg_kw, state):
    cg = _compile()
    model = _model(cg, **cfg_kw)
    model.load_state_dict(state)
    host = build_merged_layouts(cg, tile_rows=TILE)
    layouts = device_layouts(host, "cpu", cg, layer_paths(model.cfg))
    x = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
    return cg, host, model, layouts, x


def _rank_main(rank, world, work, threads):
    """One rank: for each configuration under work/cases (its spec.npz,
    state.pt and cfg.npy), the sharded forward, step 1's loss and summed
    gradients, and 3 Adam steps' losses, written to
    work/cases/<name>/rank{rank}.npz."""
    import torch.distributed as dist
    from kgwas_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from kgwas_tpu_torch.parallel.shard import (ShardedRun, sharded_forward,
                                                sharded_train_step, sum_grads)

    torch.set_num_threads(threads)
    work = Path(work)
    init_distributed("gloo", f"file://{work / 'store'}", world, rank)
    mesh = make_mesh(data=world)
    for case in sorted((work / "cases").iterdir()):
        kw = np.load(case / "cfg.npy", allow_pickle=True).item()
        spec = np.load(case / "spec.npz")
        state = torch.load(case / "state.pt")
        cg, host, model, layouts, x = _world_for(kw, state)
        run = ShardedRun(host, x, mesh, "cpu", cg.padded_nodes, cg=cg)
        y, w = torch.from_numpy(spec["y"]), torch.from_numpy(spec["w"])
        out = {"pred": sharded_forward(model, run, layouts).numpy()}
        loss = batch_loss(run.forward(model, layouts, training=True),
                          torch.from_numpy(spec["batches"][0]), y, w)
        (loss / mesh.size).backward()
        fill_dead_grads(model)
        sum_grads(model, mesh)
        out["loss"] = loss.item()
        out.update({f"grad:{k}": p.grad.numpy().copy()
                    for k, p in model.named_parameters()})
        model.load_state_dict(state)
        opt = build_optimizer(model.parameters(), LR, WD)
        out["losses"] = np.array([
            sharded_train_step(model, opt, run, layouts, torch.from_numpy(b),
                               y, w).item() for b in spec["batches"]])
        np.savez(case / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def _spawn(work, world):
    threads = max(1, (os.cpu_count() or 2) // (2 * world))
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import test_torch_parallel_relations as T; "
            "T._rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], "
            "int(sys.argv[6]))")
    return [subprocess.Popen(
        [sys.executable, "-c", code, str(HERE), str(HERE.parent), str(r),
         str(world), str(work), str(threads)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs, timeout=300):
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]


def _setup(case, kw, state):
    cg = _compile()
    n, n_pad = cg.num_nodes["SNP"], cg.padded_nodes["SNP"]
    rng = np.random.default_rng(5)
    y = np.zeros(n_pad, np.float32)
    w = np.zeros(n_pad, np.float32)
    y[:n] = rng.standard_normal(n) ** 2
    w[:n] = rng.random(n) + 0.5
    batches = np.stack([rng.choice(n, 64, replace=False) for _ in range(3)])
    case.mkdir(parents=True)
    np.savez(case / "spec.npz", y=y, w=w, batches=batches)
    np.save(case / "cfg.npy", np.array(kw, dtype=object))
    torch.save(state, case / "state.pt")


def _single(case):
    """The single-process port: predictions, step 1's loss and gradients,
    3 Adam steps' losses."""
    kw = np.load(case / "cfg.npy", allow_pickle=True).item()
    spec = np.load(case / "spec.npz")
    state = torch.load(case / "state.pt")
    _, _, model, layouts, x = _world_for(kw, state)
    y, w = torch.from_numpy(spec["y"]), torch.from_numpy(spec["w"])
    with torch.inference_mode():
        pred = model(x, layouts)[:, 0].numpy()
    loss = batch_loss(model(x, layouts, training=True),
                      torch.from_numpy(spec["batches"][0]), y, w)
    loss.backward()
    fill_dead_grads(model)
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    model.load_state_dict(state)
    opt = build_optimizer(model.parameters(), LR, WD)
    losses = np.array([train_step(model, opt, x, layouts, torch.from_numpy(b),
                                  y, w).item() for b in spec["batches"]])
    return pred, loss.item(), grads, losses


def _assert_like_single(case, world):
    from test_torch_train import _assert_grad

    ranks = [dict(np.load(case / f"rank{r}.npz")) for r in range(world)]
    for r in ranks[1:]:
        for k in ranks[0]:
            assert np.array_equal(ranks[0][k], r[k]), (case.name, k)
    got = ranks[0]
    pred, loss, grads, losses = _single(case)
    np.testing.assert_allclose(got["pred"], pred, rtol=1e-5, atol=1e-5)
    assert float(got["loss"]) == pytest.approx(loss, rel=1e-5)
    top = max(np.abs(v).max() for v in grads.values())
    for k, v in grads.items():
        _assert_grad(got[f"grad:{k}"], v, f"{case.name} {k}",
                     floor=1e-8 * top)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)
    return got


@pytest.fixture(scope="module")
def gloo_worlds(tmp_path_factory):
    """Two ranks over GLOO_2 and three over GLOO_3 (started together), and
    the JAX package's 3 steps of each GLOO_2 configuration on its 2-device
    CPU mesh from the same initial parameters, run here meanwhile."""
    import jax
    import jax.numpy as jnp
    from kgwas_tpu.config import ModelConfig as JaxModelConfig
    from kgwas_tpu.engine.loop import build_optimizer as jbuild_optimizer
    from kgwas_tpu.models.hetero_gnn import init_hetero_gnn
    from kgwas_tpu.parallel.mesh import make_mesh as jmake_mesh
    from kgwas_tpu.parallel.shard import (_select_kernel_path,
                                          make_sharded_train_step,
                                          node_vector_sharding, replicated,
                                          shard_graph_arrays)
    from kgwas_tpu_torch.engine.checkpoint import params_from_jax

    cg_j = _compile(jax=True)
    meta = cg_j.meta()
    cg = _compile()
    w2, w3 = (tmp_path_factory.mktemp(f"gloo{n}") for n in (2, 3))
    jcfgs, params = {}, {}
    for name, kw in GLOO_2.items():
        jcfgs[name] = JaxModelConfig(gnn_hidden_dim=HIDDEN, no_relu=True,
                                     use_pallas=True, **kw)
        params[name] = jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
            jax.random.PRNGKey(0), jcfgs[name], meta, KG["snp_dim"],
            KG["gene_dim"], KG["go_dim"]))
        _setup(w2 / "cases" / name, kw, params_from_jax(params[name]))
    for name, kw in GLOO_3.items():
        _setup(w3 / "cases" / name, kw, _model(cg, **kw).state_dict())
    procs = _spawn(w2, 2) + _spawn(w3, 3)
    jax_losses = {}
    try:
        mesh = jmake_mesh(data=2, model=1)
        arrays = shard_graph_arrays(mesh, cg_j.arrays())
        for name, jcfg in jcfgs.items():
            # outside the merged gate: the GSPMD-partitioned XLA ops
            assert _select_kernel_path(jcfg, meta, mesh,
                                       training=True)[1] is None
            spec = np.load(w2 / "cases" / name / "spec.npz")
            step = make_sharded_train_step(jcfg, meta,
                                           jbuild_optimizer(LR, WD), mesh,
                                           cg_j.arrays())
            p = params[name]
            s = jbuild_optimizer(LR, WD).init(p)
            losses = []
            for b in spec["batches"]:
                p, s, l_ = step(
                    p, s, arrays,
                    jax.device_put(jnp.asarray(b, jnp.int32),
                                   replicated(mesh)),
                    jax.device_put(jnp.asarray(spec["y"]),
                                   node_vector_sharding(mesh)),
                    jax.device_put(jnp.asarray(spec["w"]),
                                   node_vector_sharding(mesh)))
                losses.append(float(l_))
            jax_losses[name] = np.array(losses)
    finally:
        _join(procs)
    return w2, w3, jax_losses


@pytest.mark.parametrize("name", list(GLOO_2))
def test_two_gloo_ranks_match_single_and_jax_gspmd(gloo_worlds, name):
    w2, _, jax_losses = gloo_worlds
    got = _assert_like_single(w2 / "cases" / name, 2)
    np.testing.assert_allclose(got["losses"], jax_losses[name], rtol=1e-4)


@pytest.mark.parametrize("name", list(GLOO_3))
def test_three_gloo_ranks_uneven_blocks_match_single(gloo_worlds, name):
    _, w3, _ = gloo_worlds
    _assert_like_single(w3 / "cases" / name, 3)


# ------------------------------------------------------------- (d) the CLI

def test_cli_mesh_sage_max_under_torchrun(tmp_path):
    """train --mesh 2 --backbone SAGE --aggr max under torchrun (two gloo
    ranks): pred.csv's KGWAS_P is the single-process CLI run's."""
    from kgwas_tpu_torch.cli import main
    from kgwas_tpu_torch.utils import read_table

    argv = ["train", "--synthetic", "--device", "cpu", "--seed", "3",
            "--hidden", "16", "--epochs", "1", "--batch-size", "256",
            "--backbone", "SAGE", "--aggr", "max"]
    single = main(argv + ["--data-path", str(tmp_path / "one")])
    env = dict(os.environ, PYTHONPATH=str(HERE.parent))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--rdzv-endpoint", "localhost:0", "--rdzv-backend",
         "c10d", "-m", "kgwas_tpu_torch.cli", *argv, "--mesh", "2",
         "--data-path", str(tmp_path / "two")],
        capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    got = read_table(str(tmp_path / "two" / "model" / "KGWAS" / "pred.csv"),
                     sep=None)
    np.testing.assert_allclose(np.asarray(got["KGWAS_P"], float),
                               np.asarray(single.kgwas_res["KGWAS_P"], float),
                               rtol=1e-4, atol=1e-6)
