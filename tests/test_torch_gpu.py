"""The CUDA kernels of the port against their plain PyTorch versions, on the
card. Marked gpu: without a card each test skips.

This file imports torch and the port only (no jax), so it also runs on a
card's machine that has no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

The interpretation forward (``HeteroGNN.collect_attention``: the merged
GAT forward in its raw mode, fold R for GAT sum and fold 0 for GAT max,
on the 20k-SNP synthetic KG at hidden 128) through the kernel against the
same forward with the plain version swapped in: layer 1's weights bitwise
(the same tensor code on the same inputs), layer 2's at rtol 1e-5, atol
1e-5.

Tolerance rtol 1e-5, atol 1e-5 (float32, another summation order); each
relation's trash row, which sums up to 511 pad edges, at rtol 1e-4. The
backward kernels' gradients at rtol 1e-4 with an absolute floor of 1e-5 of
each array's largest entry: random cotangents make every row, trash rows
included, a sum of up to 511 terms, and the softmax mode's (m_e - dot_row)
cancels.

The model-variant kernels (segment_softmax_spmm_fwd / _bwd on one
relation's stream, csr_segment_sum and the CSC sum without logit term on a
merged group's) are held the same way, and two launches give the same
bits; the backward on every relation stream and the CSR sum on every
merged group, on their row schedules and with max_edges 8, by
chip_smoke.py's float64 rule (max abs error against the float64 plain
version at most 8 times the float32 plain version's plus 1e-6 of the
largest value). The merged GAT kernels run on their static schedule with the default
max_edges and with max_edges = 8, where real rows are cut into chunks too,
and on a stream with a hub node of several thousand edges across its slots.
The segment softmax forward and backward, the CSR sum and the CSC sum run
on their schedules too, on a stream with long rows, a hub row, empty rows
and a trash row of identical pad edges, at the default max_edges and at 8, and the CSC sum in each of
its four call forms (the merged GAT layer's, the per-relation GAT's, and
the message-passing backward with and without weights). With
KGWAS_PARENT_CSRC set to an earlier checkout's ``kgwas_tpu_torch/ops/csrc``,
the segment kernels are also held against that checkout's through its own
wrappers (its package imported as parent_kgwas_tpu_torch): the CSC sum
(with logit term) and the CSR sum bitwise on every row their schedules do
not cut into chunks (the chunked rows and d_att by the float64 rule, or
as trash rows), the segment softmax forward and backward within the
tolerances above; and the merged GAT kernels, built from that source with
this checkout's C interface, within the same tolerances.

The segment kernels' optional operand and output: #6 and #7 with a
per-edge multiplier (dropout) on the long-row stream and on relation
streams, a multiplier of ones giving the bits of the launch without one,
#8's per-edge d_w in three call forms and through CSRSegmentSum's
backward; with KGWAS_PARENT_CSRC, #6, #7 and #8 without them bitwise as
the earlier checkout's. The model: a per-relation GAT step's gradients
bitwise the same in two runs, and with remat bitwise those without, the
dropout masks drawn from one CUDA generator seed.

The bf16 instances of #6, #7, #8 and #10 on item streams of every shape
(long hub rows, chunked trash rows and empty rows; fewer items than a
block's warps; more items than the card holds warps; a schedule whose
largest item, 13 edges, is no multiple of 8; #7 and #10 also at D =
256, 384 and 512), #7 with float32 and bf16 logits, with and without the
multiplier, #8 in its four call forms, #10 unweighted and with float32
and bf16 weights: against their plain
versions, #6 and #7 bitwise the f32 instances on the widened operands,
and with KGWAS_PARENT_CSRC all four bitwise the earlier checkout's.

Outside the kernels: the host-streamed products (ops/streaming.py: pinned
staging, a copy stream) against a float64 dense product, and the train
state's asynchronous host copy (engine/checkpoint.host_train_state)
against an in-place update issued after it.

Dst-range sub-layouts (KGWAS_MERGED_MAX_EDGES, on the 20k-SNP KG with
Gene in 2 and SNP in 4): #1 (fold R and 0), #2, #8 and #10 on every
sub-layout's stream against their plain versions, two runs the same bits;
GAT, SAGE and GCN forwards and one step's gradients on the sub-layouts
against the unsplit layouts, one launch per live sub-layout and layer,
two split runs bitwise.

Scanned dispatch (engine/loop.TrainScan): a replayed CUDA graph of S
steps bitwise the same S steps eager (losses, parameters, Adam's state)
for GAT sum, GAT max and GCN on the 20k-SNP KG; the graph captured again
after load_state_dict (the resume path) replays the restored state; a
step that synchronises with the host cannot be captured and raises (in a
child process); the capturable Bf16Adam bitwise the host-stepped one it
replaced. TrainScan's spans (the eager block, the capture, each replay)
under torch.profiler on the card: as often in the trace as in the span
table, and none inside the capture.
"""
import dataclasses
import importlib
import importlib.util
import os
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.config import ModelConfig
from kgwas_tpu_torch.models.hetero_gnn import (HeteroGNN, device_layouts,
                                               layer_path, layer_paths)
from kgwas_tpu_torch.ops import (build, gat_layer, schedule, segment,
                                 segment_softmax)

pytestmark = pytest.mark.gpu

D = 128


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def group():
    g = make_synthetic_kg(n_snp=3000, n_gene=300, n_go=100, seed=3)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    L = build_merged_layouts(cg, tile_rows=512)["Gene"]
    return L, cg.num_nodes["Gene"]


def _close(got, want, n_per_rel, trash):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    mask = np.zeros(len(got), dtype=bool)
    mask[trash::n_per_rel] = True
    np.testing.assert_allclose(got[~mask], want[~mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-4, atol=1e-5)


def _sched(L, fold, max_edges, device, chunk_edges=gat_layer.CHUNK_EDGES):
    """None (the wrapper builds the default schedule) or the schedule of
    max_edges."""
    if max_edges is None:
        return None
    return gat_layer.schedule(L.row_offsets, L.n_rows_per_rel, fold,
                              max_edges, chunk_edges).to(device)


@pytest.mark.parametrize("max_edges", [None, 8])
@pytest.mark.parametrize("d", [D, 48])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_kernel_matches_plain(mode, fold, d, max_edges, cuda_device, group):
    L, trash = group
    rng = np.random.default_rng(2)
    R = len(L.rel_keys)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    args = (t((rng.standard_normal((L.n_src_total, d)) * 0.1).astype(np.float32)),
            t(L.src), t(L.row_offsets),
            t((rng.standard_normal((R, d)) * 0.2).astype(np.float32)),
            t((rng.standard_normal(L.n_rows_total) * 0.5).astype(np.float32)),
            L.n_rows_per_rel, R if fold else 0, mode, 0.2, 0.7)
    sched = _sched(L, args[6], max_edges, cuda_device)
    before = gat_layer.launches
    got = gat_layer.merged_gat_forward(*args, sched=sched)
    again = gat_layer.merged_gat_forward(*args, sched=sched)
    torch.cuda.synchronize()
    assert gat_layer.launches == before + 2
    want = gat_layer.merged_gat_forward_plain(*args)
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)   # no atomics, a fixed order: the same bits
        _close(g_, w_, L.n_rows_per_rel, trash)


def test_kernel_rejects_bad_inputs(cuda_device, group):
    L, _ = group
    R = len(L.rel_keys)
    xs = torch.zeros(L.n_src_total, D, device=cuda_device)
    att = torch.zeros(R, D, device=cuda_device)
    a_dst = torch.zeros(L.n_rows_total, device=cuda_device)
    src = torch.from_numpy(L.src).to(cuda_device)
    ro = torch.from_numpy(L.row_offsets).to(cuda_device)
    with pytest.raises(TypeError):
        gat_layer.merged_gat_forward(xs.double(), src, ro, att, a_dst,
                                     L.n_rows_per_rel)
    with pytest.raises(ValueError):
        gat_layer.merged_gat_forward(xs, src, ro.cpu(), att, a_dst,
                                     L.n_rows_per_rel)
    with pytest.raises(ValueError):
        gat_layer.merged_gat_forward(xs[:, ::2], src, ro, att[:, ::2], a_dst,
                                     L.n_rows_per_rel)


def _close_grad(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())


def _merged_layout(L, fold, device):
    """The group's DeviceLayout with the CSC sum's fields for this fold
    (device_layouts builds them for the model's fold, R)."""
    DL = device_layouts({"Gene": L}, device)["Gene"]
    if fold:
        return DL
    return dataclasses.replace(DL, **segment.csc_fields(
        L.dst, L.csc_perm, L.csc_offsets, L.n_rows_per_rel, L.src_base, 0,
        device))


def _bwd_inputs(L, fold, d, device, seed=4):
    rng = np.random.default_rng(seed)
    R = len(L.rel_keys)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    xs = t((rng.standard_normal((L.n_src_total, d)) * 0.1).astype(np.float32))
    att = t((rng.standard_normal((R, d)) * 0.2).astype(np.float32))
    a_dst = t((rng.standard_normal(L.n_rows_total) * 0.5).astype(np.float32))
    n_out = L.n_rows_per_rel if fold else L.n_rows_total
    g = t(rng.standard_normal((n_out, d)).astype(np.float32))
    return xs, att, a_dst, g


@pytest.mark.parametrize("max_edges", [None, 8])
@pytest.mark.parametrize("d", [D, 48])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_backward_kernels_match_plain(mode, fold, d, max_edges, cuda_device,
                                      group):
    L, _ = group
    fold = len(L.rel_keys) if fold else 0
    DL = _merged_layout(L, fold, cuda_device)
    sched = _sched(L, fold, max_edges, cuda_device)
    # the backward's: max_edges = 8 cuts real rows mid-row too
    bsched = _sched(L, fold, max_edges, cuda_device, max_edges)
    xs, att, a_dst, g = _bwd_inputs(L, fold, d, cuda_device)
    _, row_max, row_sum = gat_layer.merged_gat_forward(
        xs, DL.src, DL.row_offsets, att, a_dst, DL.n_rows_per_rel, fold, mode,
        0.2, 0.7, sched=sched)
    args = (xs, DL.src, DL.row_offsets, att, a_dst, row_max, row_sum, g,
            DL.n_rows_per_rel, fold, mode, 0.2, 0.7)
    before = (gat_layer.bwd_launches, segment.launches)
    edge = gat_layer.merged_gat_bwd(*args, sched=bsched)
    again = gat_layer.merged_gat_bwd(*args, sched=bsched)
    sums = segment.csc_segment_sum(g, edge[0], edge[1], xs, att, DL, fold)
    sums2 = segment.csc_segment_sum(g, edge[0], edge[1], xs, att, DL, fold)
    torch.cuda.synchronize()
    assert (gat_layer.bwd_launches, segment.launches) == (before[0] + 2,
                                                          before[1] + 2)
    for got, rep, want in zip(edge + sums, again + sums2,
                              gat_layer.merged_gat_bwd_plain(*args)
                              + segment.csc_segment_sum_plain(
                                  g, edge[0], edge[1], xs, att, DL, fold)):
        assert torch.equal(got, rep)   # no atomics: the same bits
        _close_grad(got, want)
    full = gat_layer.merged_gat_backward(xs, att, a_dst, row_max, row_sum, g,
                                         DL, fold, mode, 0.2, 0.7)
    plain = gat_layer.merged_gat_backward_plain(xs, att, a_dst, row_max,
                                                row_sum, g, DL, fold, mode,
                                                0.2, 0.7)
    for got, want in zip(full, plain):
        _close_grad(got, want)


def _hub_stream(seed=6, n=2048, n_rel=3, n_src=4096, hub=100,
                hub_edges=(3001, 2503, 1709)):
    """A merged stream whose node `hub` has thousands of edges in each slot
    (row lengths that no chunk size divides), the other rows ~6."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(6, n_rel * n)
    for r, e in enumerate(hub_edges):
        deg[r * n + hub] = e
    ro = np.zeros(n_rel * n + 1, dtype=np.int64)
    np.cumsum(deg, out=ro[1:])
    src = rng.integers(0, n_src, ro[-1])
    return src.astype(np.int32), ro.astype(np.int32), n, hub, rng


@pytest.mark.parametrize("max_edges", [None, 64])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_hub_node_split_across_slots(mode, fold, max_edges, cuda_device):
    src, ro, n, hub, rng = _hub_stream()
    n_rel = (len(ro) - 1) // n
    fold = n_rel if fold else 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    xs = t((rng.standard_normal((4096, D)) * 0.1).astype(np.float32))
    att = t((rng.standard_normal((n_rel, D)) * 0.2).astype(np.float32))
    a_dst = t((rng.standard_normal(n_rel * n) * 0.5).astype(np.float32))
    sched = gat_layer.schedule(ro, n, fold, max_edges or gat_layer.MAX_EDGES)
    assert hub in sched.split_units.tolist()
    sched = sched.to(cuda_device)
    args = (xs, t(src), t(ro), att, a_dst, n, fold, mode, 0.2, 0.7)
    got = gat_layer.merged_gat_forward(*args, sched=sched)
    again = gat_layer.merged_gat_forward(*args, sched=sched)
    want = gat_layer.merged_gat_forward_plain(*args)
    torch.cuda.synchronize()
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)
        # the hub's rows sum thousands of terms: held as trash rows are
        _close(g_, w_, n, hub)
    g = t(rng.standard_normal((n if fold else n_rel * n, D)).astype(
        np.float32))
    bargs = (xs, t(src), t(ro), att, a_dst, got[1], got[2], g, n, fold, mode,
             0.2, 0.7)
    bsched = gat_layer.schedule(ro, n, fold, max_edges or gat_layer.MAX_EDGES,
                                gat_layer.BWD_CHUNK_EDGES).to(cuda_device)
    edge = gat_layer.merged_gat_bwd(*bargs, sched=bsched)
    again = gat_layer.merged_gat_bwd(*bargs, sched=bsched)
    torch.cuda.synchronize()
    for got_, rep, want_ in zip(edge, again,
                                gat_layer.merged_gat_bwd_plain(*bargs)):
        assert torch.equal(got_, rep)
        _close_grad(got_, want_)


def test_csc_segment_sum_rejects_bad_inputs(cuda_device, group):
    L, _ = group
    DL = device_layouts({"Gene": L}, cuda_device)["Gene"]
    R = len(L.rel_keys)
    xs, att, _, g = _bwd_inputs(L, R, D, cuda_device)
    e = DL.csc_perm.shape[0]
    w = torch.zeros(e, device=cuda_device)
    with pytest.raises(ValueError):
        segment.csc_segment_sum(g, w[:-1], w, xs, att, DL, R)
    with pytest.raises(TypeError):
        segment.csc_segment_sum(g, w.double(), w, xs, att, DL, R)
    with pytest.raises(ValueError):
        segment.csc_segment_sum(g[:-1], w, w, xs, att, DL, R)
    # the layout's CSC fields are built for one fold, and never on the fly
    with pytest.raises(ValueError):
        segment.csc_segment_sum(g, w, w, xs, att,
                                dataclasses.replace(DL, csc_schedule=None), R)
    g_rows = torch.zeros(R * DL.n_rows_per_rel, D, device=cuda_device)
    with pytest.raises(ValueError):
        segment.csc_segment_sum(g_rows, w, w, xs, att, DL, 0)


# ------------------------------------------------ the model-variant kernels


@pytest.fixture(scope="module")
def variant_world(cuda_device):
    g = make_synthetic_kg(n_snp=3000, n_gene=300, n_go=100, seed=3)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    layouts = build_merged_layouts(cg, tile_rows=512)
    rel = device_layouts(layouts, cuda_device, cg, "relations")
    mp = device_layouts(layouts, cuda_device, path="mp")
    return cg, rel, mp


def _repeat_equal(fn, *args):
    """fn twice on the same inputs: the same bits."""
    got, again = fn(*args), fn(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, again):
        assert a is None or torch.equal(a, b)
    return got


@pytest.mark.parametrize("d", [D, 48])
@pytest.mark.parametrize("rk", ["Gene__Gene-PPI-Gene__Gene",
                                "Gene__rev_TSS__SNP"])
def test_segment_softmax_kernels_match_plain(rk, d, cuda_device,
                                             variant_world):
    cg, rel, _ = variant_world
    r = cg.relations[rk]
    L = rel[r.dst_type]
    RL = L.relations[L.rel_keys.index(rk)]
    rng = np.random.default_rng(8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(cuda_device)  # noqa: E731
    xs = t(rng.standard_normal((RL.src_base[-1], d)) * 0.1)
    logits = t(rng.standard_normal(RL.src.shape[0]) * 1.5)
    g = t(rng.standard_normal((RL.n_rows_per_rel, d)))
    before = (segment_softmax.launches, segment_softmax.bwd_launches)
    fwd_args = (xs, RL.src, logits, RL.row_offsets)
    got = _repeat_equal(segment_softmax.segment_softmax_spmm_fwd, *fwd_args)
    want = segment_softmax.segment_softmax_spmm_fwd_plain(*fwd_args)
    for g_, w_ in zip(got, want):
        _close(g_, w_, RL.n_rows_per_rel, cg.num_nodes[r.dst_type])
    out, row_max, row_sum = got
    bwd_args = fwd_args + (row_max, row_sum, out, g)
    edge = _repeat_equal(segment_softmax.segment_softmax_spmm_bwd, *bwd_args)
    for got_, want_ in zip(edge, segment_softmax.segment_softmax_spmm_bwd_plain(
            *bwd_args)):
        _close_grad(got_, want_)
    assert (segment_softmax.launches, segment_softmax.bwd_launches) == (
        before[0] + 2, before[1] + 2)
    full = segment_softmax.segment_softmax_spmm_backward(
        xs, logits, row_max, row_sum, out, g, RL)
    plain = segment_softmax.segment_softmax_spmm_backward_plain(
        xs, logits, row_max, row_sum, out, g, RL)
    for got_, want_ in zip(full, plain):
        _close_grad(got_, want_)


@pytest.mark.parametrize("d", [D, 48])
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_and_csc_sums_without_logits_match_plain(weighted, d,
                                                     cuda_device,
                                                     variant_world):
    cg, _, mp = variant_world
    DL = mp["Gene"]
    rng = np.random.default_rng(9)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(cuda_device)  # noqa: E731
    x = t(rng.standard_normal((DL.src_base[-1], d)) * 0.1)
    g = t(rng.standard_normal((DL.row_offsets.shape[0] - 1, d)))
    w = DL.sym_e if weighted else None
    before = (segment.csr_launches, segment.launches)
    (out,) = _repeat_equal(lambda *a: (segment.csr_segment_sum(*a),),
                           x, DL.src, DL.row_offsets, w)
    _close(out, segment.csr_segment_sum_plain(x, DL.src, DL.row_offsets, w),
           DL.n_rows_per_rel, cg.num_nodes["Gene"])
    d_x, d_att = _repeat_equal(segment.csc_segment_sum, g, w, None, x, None,
                               DL)
    assert d_att is None
    _close_grad(d_x, segment.csc_segment_sum_plain(g, w, None, x, None,
                                                   DL)[0])
    assert (segment.csr_launches, segment.launches) == (before[0] + 2,
                                                        before[1] + 2)


def _relation_bwd_args(RL, d, device, seed):
    """segment_softmax_spmm_bwd's arguments on one relation's stream: random
    xs, logits and g, and the forward kernel's out, row_max and row_sum."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)  # noqa: E731
    xs = t(rng.standard_normal((RL.src_base[-1], d)) * 0.1)
    logits = t(rng.standard_normal(RL.src.shape[0]) * 1.5)
    g = t(rng.standard_normal((RL.row_offsets.shape[0] - 1, d)))
    out, row_max, row_sum = segment_softmax.segment_softmax_spmm_fwd(
        xs, RL.src, logits, RL.row_offsets, sched=RL.row_schedule)
    return xs, RL.src, logits, RL.row_offsets, row_max, row_sum, out, g


def _as_double(args):
    return tuple(a.double() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


@pytest.mark.parametrize("d", [D, 48])
@pytest.mark.parametrize("max_edges", [None, 8])
def test_segment_softmax_bwd_on_every_relation_stream(max_edges, d,
                                                      cuda_device,
                                                      variant_world):
    """The backward kernel on every relation's stream, on the layout's row
    schedule and with max_edges 8 (real rows cut into chunks too, whose
    dot_r comes from out): two runs the same bits, and within the float64
    rule of the plain version."""
    cg, rel, _ = variant_world
    n = 0
    for L in rel.values():
        for rk, RL in zip(L.rel_keys, L.relations):
            args = _relation_bwd_args(RL, d, cuda_device, seed=17 + n)
            sched = RL.row_schedule
            if max_edges:
                sched = schedule.row_schedule(cg.relations[rk].row_offsets,
                                              max_edges, max_edges)
                assert sched.n_parts > len(sched.split_units)
                sched = sched.to(cuda_device)
            before = segment_softmax.bwd_launches
            got = _repeat_equal(
                lambda *a: segment_softmax.segment_softmax_spmm_bwd(
                    *a, sched=sched), *args)
            assert segment_softmax.bwd_launches == before + 2
            plain = segment_softmax.segment_softmax_spmm_bwd_plain(*args)
            exact = segment_softmax.segment_softmax_spmm_bwd_plain(
                *_as_double(args))
            for a, p, x in zip(got, plain, exact):
                _grad_rule(a, p, x)
            n += 1
    assert n == len(cg.relations)


@pytest.mark.parametrize("max_edges", [None, 8])
@pytest.mark.parametrize("weighted", [False, True])
def test_csr_segment_sum_on_every_merged_group(weighted, max_edges,
                                               cuda_device, variant_world):
    """The CSR sum on every merged group's stream, on the layout's row
    schedule and with max_edges 8: two runs the same bits, and within the
    float64 rule of the plain version."""
    cg, _, mp = variant_world
    rng = np.random.default_rng(18)
    for dst_t, DL in mp.items():
        x = torch.from_numpy((rng.standard_normal((DL.src_base[-1], D)) * 0.1
                              ).astype(np.float32)).to(cuda_device)
        sched = DL.row_schedule
        if max_edges:
            sched = schedule.row_schedule(DL.row_offsets.cpu().numpy(),
                                          max_edges, max_edges)
            sched = sched.to(cuda_device)
        assert sched.n_parts > 0
        args = (x, DL.src, DL.row_offsets, DL.sym_e if weighted else None)
        before = segment.csr_launches
        (got,) = _repeat_equal(lambda *a: (segment.csr_segment_sum(
            *a, sched=sched),), *args)
        assert segment.csr_launches == before + 2
        _grad_rule(got, segment.csr_segment_sum_plain(*args),
                   segment.csr_segment_sum_plain(*_as_double(args)))


# ------------------------------- the segment softmax and CSC schedules


def _long_row_stream(seed=10, n_rows=1024, n_src=2048, d=D):
    """One relation's stream: rows of ~4 edges, long rows (129, 300), a hub
    row (3001 edges), empty rows, and a trash row of 511 pad edges that all
    read source row 0 with one logit. Returns (src, row_offsets, logits,
    xs, long rows)."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, n_rows)
    deg[rng.choice(n_rows, 60, replace=False)] = 0
    long_rows = {7: 129, 300: 300, 555: 3001, 900: 511}
    for r, e in long_rows.items():
        deg[r] = e
    ro = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(deg, out=ro[1:])
    src = rng.integers(0, n_src, ro[-1])
    logits = (rng.standard_normal(ro[-1]) * 1.5).astype(np.float32)
    src[ro[900]:ro[901]] = 0
    logits[ro[900]:ro[901]] = 0.3
    xs = (rng.standard_normal((n_src, d)) * 0.1).astype(np.float32)
    return (src.astype(np.int32), ro.astype(np.int32), logits, xs,
            sorted(long_rows))


def _close_rows(got, want, rows):
    """_close with the given rows (a hub, the trash row) at rtol 1e-4."""
    got, want = got.cpu().numpy(), want.cpu().numpy()
    mask = np.zeros(len(got), dtype=bool)
    mask[rows] = True
    np.testing.assert_allclose(got[~mask], want[~mask], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got[mask], want[mask], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("max_edges", [None, 8])
@pytest.mark.parametrize("d", [D, 48])
def test_segment_softmax_fwd_long_hub_and_empty_rows(d, max_edges,
                                                     cuda_device):
    src, ro, logits, xs, long_rows = _long_row_stream(d=d)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    args = (t(xs), t(src), t(logits), t(ro))
    sched = None
    if max_edges:   # real rows cut into chunks of 8 too
        sched = schedule.row_schedule(ro, max_edges, max_edges)
        assert sched.n_parts > 100
        sched = sched.to(cuda_device)
    else:
        split = schedule.row_schedule(ro).split_units.tolist()
        assert split == long_rows
    before = segment_softmax.launches
    got = segment_softmax.segment_softmax_spmm_fwd(*args, sched=sched)
    again = segment_softmax.segment_softmax_spmm_fwd(*args, sched=sched)
    torch.cuda.synchronize()
    assert segment_softmax.launches == before + 2
    want = segment_softmax.segment_softmax_spmm_fwd_plain(*args)
    empty = np.flatnonzero(np.diff(ro) == 0)
    assert (got[0][t(empty).long()] == 0).all()
    assert (got[1][t(empty).long()] == segment_softmax.NEG_BIG).all()
    assert (got[2][t(empty).long()] == 0).all()
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)
        _close_rows(g_, w_, long_rows)


@pytest.mark.parametrize("max_edges", [None, 8])
@pytest.mark.parametrize("d", [D, 48])
def test_segment_bwd_and_csr_long_hub_and_empty_rows(d, max_edges,
                                                     cuda_device):
    """The backward kernel and the CSR sum on the stream with long rows, a
    hub, empty rows and a trash row of identical pad edges, at the default
    item sizes and at max_edges 8: two runs the same bits; the backward by
    the float64 rule, the CSR sum as trash rows are on its long rows."""
    src, ro, logits, xs, long_rows = _long_row_stream(d=d)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    fargs = (t(xs), t(src), t(logits), t(ro))
    out, row_max, row_sum = segment_softmax.segment_softmax_spmm_fwd(*fargs)
    rng = np.random.default_rng(19)
    g = t(rng.standard_normal((len(ro) - 1, d)).astype(np.float32))
    bsched = schedule.row_schedule(ro, max_edges or schedule.ROW_MAX_EDGES,
                                   max_edges or schedule.ROW_CHUNK_EDGES)
    csched = schedule.row_schedule(ro, max_edges or schedule.CSR_MAX_EDGES,
                                   max_edges or schedule.CSR_CHUNK_EDGES)
    assert set(long_rows) <= set(bsched.split_units.tolist())
    assert set(long_rows) <= set(csched.split_units.tolist())
    bsched, csched = bsched.to(cuda_device), csched.to(cuda_device)
    bargs = fargs + (row_max, row_sum, out, g)
    got = _repeat_equal(lambda *a: segment_softmax.segment_softmax_spmm_bwd(
        *a, sched=bsched), *bargs)
    for a, p, x in zip(got, segment_softmax.segment_softmax_spmm_bwd_plain(
            *bargs), segment_softmax.segment_softmax_spmm_bwd_plain(
            *_as_double(bargs))):
        _grad_rule(a, p, x)
    w = t(rng.random(len(src)).astype(np.float32))
    empty = t(np.flatnonzero(np.diff(ro) == 0)).long()
    for wt in (None, w):
        args = (fargs[0], fargs[1], fargs[3], wt)
        (got,) = _repeat_equal(lambda *a: (segment.csr_segment_sum(
            *a, sched=csched),), *args)
        assert (got[empty] == 0).all()
        _close_rows(got, segment.csr_segment_sum_plain(*args), long_rows)


def _hub_csc_layout(device, seed=11, n=512, n_rel=2, hub=70):
    """A two-slot merged stream whose slot-0 source row `hub` holds 2500
    CSC entries (a hub source row, cut into chunks), with empty source rows
    and ~4 entries on the others."""
    rng = np.random.default_rng(seed)
    n_src = 1024 * n_rel
    deg = rng.poisson(4, n_rel * n)
    ro = np.zeros(n_rel * n + 1, dtype=np.int64)
    np.cumsum(deg, out=ro[1:])
    dst = np.repeat(np.arange(n_rel * n), deg)
    slot = dst // n
    src = slot * 1024 + rng.integers(0, 700, len(dst))
    src[rng.random(len(dst)) < 0.45] = hub
    src[(slot == 1) & (src == hub)] = 1024 + hub
    perm = np.argsort(src, kind="stable")
    off = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n_src), out=off[1:])
    assert np.diff(off)[hub] > 4 * segment.CSC_MAX_EDGES
    assert (np.diff(off) == 0).any()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)  # noqa: E731
    return SimpleNamespace(src=t(src), row_offsets=t(ro), dst=t(dst),
                           csc_perm=t(perm), csc_offsets=t(off),
                           src_base=(0, 1024, 2048), n_rows_per_rel=n,
                           **segment.csc_fields(dst, perm, off, n,
                                                (0, 1024, 2048), n_rel,
                                                device)), hub


@pytest.mark.parametrize("d", [D, 48])
@pytest.mark.parametrize("form", ["merged", "relation", "mp-weighted",
                                  "mp-unweighted", "hub"])
def test_csc_segment_sum_call_forms(form, d, cuda_device, group,
                                    variant_world):
    """Each caller's form: the merged GAT layer's (w, dz, att, the fold),
    the per-relation GAT's (w), the message-passing backward's (w or
    none), and a hub source row of thousands of entries with the logit
    term; the CSC entries' rows and the schedule from the layout where it
    has them."""
    cg, rel, mp = variant_world
    rng = np.random.default_rng(13)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(cuda_device)  # noqa: E731
    if form == "merged":
        L, _ = group
        DL = device_layouts({"Gene": L}, cuda_device)["Gene"]
        fold = len(L.rel_keys)
    elif form == "relation":
        DL, fold = rel["SNP"].relations[0], 0
    elif form == "hub":
        DL, _ = _hub_csc_layout(cuda_device)
        fold = 2
    else:
        DL, fold = mp["Gene"], 0
    n_rel = len(DL.src_base) - 1
    e = DL.csc_perm.shape[0]
    logits = form in ("merged", "hub")
    xs = t(rng.standard_normal((DL.src_base[-1], d)) * 0.1)
    g = t(rng.standard_normal(((DL.n_rows_per_rel if fold
                                else DL.row_offsets.shape[0] - 1), d)))
    w = t(rng.random(e)) if form != "mp-unweighted" else None
    dz = t(rng.standard_normal(e)) if logits else None
    att = t(rng.standard_normal((n_rel, d))) if logits else None
    args = (g, w, dz, xs, att, DL, fold)
    before = segment.launches
    got = _repeat_equal(segment.csc_segment_sum, *args)
    assert segment.launches == before + 2
    assert (got[1] is None) != logits
    for got_, want_ in zip(got, segment.csc_segment_sum_plain(*args)):
        if got_ is not None:
            _close_grad(got_, want_)


@pytest.fixture
def parent_csrc():
    d = os.environ.get("KGWAS_PARENT_CSRC")
    if not d:
        pytest.skip("set KGWAS_PARENT_CSRC to an earlier checkout's "
                    "kgwas_tpu_torch/ops/csrc")
    return Path(d)


@pytest.fixture
def parent_ops(parent_csrc):
    """The earlier checkout's segment and merged GAT wrappers: its package
    imported as parent_kgwas_tpu_torch (its kernels built by its own
    ops/build.py)."""
    name = "parent_kgwas_tpu_torch"
    if name not in sys.modules:
        pkg = parent_csrc.resolve().parents[1]
        spec = importlib.util.spec_from_file_location(
            name, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return SimpleNamespace(
        segment=importlib.import_module(f"{name}.ops.segment"),
        segment_softmax=importlib.import_module(
            f"{name}.ops.segment_softmax"),
        gat_layer=importlib.import_module(f"{name}.ops.gat_layer"))


def _grad_rule(got, plain, exact):
    """chip_smoke.py's backward rule: got's max abs error against the
    float64 plain version at most 8 times the float32 plain version's plus
    1e-6 of the largest value."""
    k_err = float((got.double() - exact).abs().max())
    p_err = float((plain.double() - exact).abs().max())
    assert k_err <= 8 * p_err + 1e-6 * float(exact.abs().max())


@pytest.mark.parametrize("fold", [False, True])
def test_csc_segment_sum_logit_path_bitwise_as_parent(fold, parent_ops,
                                                      cuda_device, group):
    """The merged GAT layer's call (w, dz, att) gives the same bits as the
    earlier checkout's kernel through its own wrapper on every source row
    that the schedule does not cut into chunks; the chunked rows (each
    slot's trash source row) and d_att are held to the float64 plain
    version by the backward rule."""
    L, _ = group
    R = len(L.rel_keys)
    fold = R if fold else 0
    DL = _merged_layout(L, fold, cuda_device)
    xs, att, _, g = _bwd_inputs(L, fold, D, cuda_device)
    rng = np.random.default_rng(12)
    e = DL.src.shape[0]
    w = torch.from_numpy(rng.random(e, dtype=np.float32)).to(cuda_device)
    dz = torch.from_numpy(rng.standard_normal(e).astype(np.float32)).to(
        cuda_device)
    args = (g, w, dz, xs, att, DL, fold)
    new = segment.csc_segment_sum(*args)
    old = parent_ops.segment.csc_segment_sum(*args)
    torch.cuda.synchronize()
    chunked = DL.csc_schedule.split_units.long()
    assert chunked.numel() > 0
    whole = torch.ones(xs.shape[0], dtype=torch.bool, device=cuda_device)
    whole[chunked] = False
    assert torch.equal(new[0][whole], old[0][whole])
    plain = segment.csc_segment_sum_plain(*args)
    exact = segment.csc_segment_sum_plain(
        g.double(), w.double(), dz.double(), xs.double(), att.double(), DL,
        fold)
    _grad_rule(new[0][chunked], plain[0][chunked], exact[0][chunked])
    _grad_rule(new[1], plain[1], exact[1])


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_merged_gat_kernels_match_parent(mode, fold, parent_csrc,
                                         cuda_device, group, monkeypatch):
    """The merged GAT kernels against the earlier source's on the same
    inputs and schedules (its C interface is this checkout's), within the
    kernel-vs-plain tolerances."""
    L, trash = group
    R = len(L.rel_keys)
    fold = R if fold else 0
    n = L.n_rows_per_rel
    xs, att, a_dst, g = _bwd_inputs(L, fold, D, cuda_device)
    src = torch.from_numpy(L.src).to(cuda_device)
    ro = torch.from_numpy(L.row_offsets).to(cuda_device)
    new = gat_layer.merged_gat_forward(xs, src, ro, att, a_dst, n, fold, mode,
                                       0.2, 0.7)
    bargs = (xs, src, ro, att, a_dst, new[1], new[2], g, n, fold, mode, 0.2,
             0.7)
    new_b = gat_layer.merged_gat_bwd(*bargs)
    for name in ("merged_gat_fwd", "merged_gat_bwd"):
        source, entry, argtypes = build.KERNELS[name]
        monkeypatch.setitem(build._loaded, name, build.build_source(
            parent_csrc / source, f"parent_{name}", entry, argtypes))
    old = gat_layer.merged_gat_forward(xs, src, ro, att, a_dst, n, fold, mode,
                                       0.2, 0.7)
    old_b = gat_layer.merged_gat_bwd(*bargs)
    torch.cuda.synchronize()
    for a, b in zip(new, old):
        _close(a, b, n, trash)
    for a, b in zip(new_b, old_b):
        _close_grad(a, b)


@pytest.mark.parametrize("rk", ["Gene__Gene-PPI-Gene__Gene",
                                "Gene__rev_TSS__SNP"])
def test_segment_softmax_fwd_matches_parent(rk, parent_ops, cuda_device,
                                            variant_world):
    """The scheduled forward against the earlier checkout's kernel through
    its own wrapper on one relation's stream, within the kernel-vs-plain
    tolerances."""
    cg, rel, _ = variant_world
    r = cg.relations[rk]
    L = rel[r.dst_type]
    RL = L.relations[L.rel_keys.index(rk)]
    rng = np.random.default_rng(14)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(cuda_device)  # noqa: E731
    xs = t(rng.standard_normal((RL.src_base[-1], D)) * 0.1)
    logits = t(rng.standard_normal(RL.src.shape[0]) * 1.5)
    args = (xs, RL.src, logits, RL.row_offsets)
    new = segment_softmax.segment_softmax_spmm_fwd(*args,
                                                   sched=RL.row_schedule)
    old = parent_ops.segment_softmax.segment_softmax_spmm_fwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(new, old):
        _close(a, b, RL.n_rows_per_rel, cg.num_nodes[r.dst_type])


@pytest.mark.parametrize("rk", ["Gene__Gene-PPI-Gene__Gene",
                                "Gene__rev_TSS__SNP",
                                "SNP__Enhancer-eQTL-Gene__Gene"])
def test_segment_softmax_bwd_matches_parent(rk, parent_ops, cuda_device,
                                            variant_world):
    """The scheduled backward against the earlier checkout's kernel through
    its own wrapper on one relation's stream, within the backward
    kernels' tolerances (dot_r comes from the edges here, from out
    there)."""
    cg, rel, _ = variant_world
    r = cg.relations[rk]
    L = rel[r.dst_type]
    RL = L.relations[L.rel_keys.index(rk)]
    args = _relation_bwd_args(RL, D, cuda_device, seed=15)
    new = segment_softmax.segment_softmax_spmm_bwd(*args,
                                                   sched=RL.row_schedule)
    old = parent_ops.segment_softmax.segment_softmax_spmm_bwd(*args)
    torch.cuda.synchronize()
    for a, b in zip(new, old):
        _close_grad(a, b)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dst_t", ["Gene", "SNP"])
def test_csr_segment_sum_bitwise_as_parent(dst_t, weighted, parent_ops,
                                           cuda_device, variant_world):
    """The scheduled CSR sum gives the same bits as the earlier checkout's
    kernel (through its own wrapper) on every row its schedule does not cut
    into chunks: each row's edges in stream order; the chunked rows within
    the trash rows' tolerance."""
    cg, _, mp = variant_world
    DL = mp[dst_t]
    rng = np.random.default_rng(16)
    x = torch.from_numpy((rng.standard_normal((DL.src_base[-1], D)) * 0.1
                          ).astype(np.float32)).to(cuda_device)
    args = (x, DL.src, DL.row_offsets, DL.sym_e if weighted else None)
    new = segment.csr_segment_sum(*args, sched=DL.row_schedule)
    old = parent_ops.segment.csr_segment_sum(*args)
    torch.cuda.synchronize()
    chunked = DL.row_schedule.split_units.long()
    assert chunked.numel() > 0
    whole = torch.ones(new.shape[0], dtype=torch.bool, device=cuda_device)
    whole[chunked] = False
    assert torch.equal(new[whole], old[whole])
    np.testing.assert_allclose(new[chunked].cpu().numpy(),
                               old[chunked].cpu().numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("aggr", ["sum", "max"])
def test_collect_attention_kernel_matches_plain(aggr, cuda_device,
                                                monkeypatch):
    g = make_synthetic_kg(n_snp=20_000, n_gene=2_000, n_go=1_200,
                          snp_dim=20, gene_dim=128, go_dim=128,
                          avg_degree=6, seed=1)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    cfg = ModelConfig(gnn_hidden_dim=D, gnn_num_layers=2, gnn_aggr=aggr)
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    model = HeteroGNN(cfg, rel_types, 20, 128, 128, seed=0).to(cuda_device)
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512),
                             cuda_device, cg, layer_path(cfg))
    x = {t: torch.from_numpy(v).to(cuda_device)
         for t, v in cg.node_x.items()}
    before = gat_layer.launches
    got = model.collect_attention(x, layouts)
    torch.cuda.synchronize()
    # every group of both layers, one launch each
    assert gat_layer.launches == before + 2 * len(layouts)
    if aggr == "max":   # fold 0 on the schedules built once
        assert all(L.gat_fold0_schedule is not None
                   for L in layouts.values())
    monkeypatch.setattr(gat_layer, "merged_gat_forward",
                        lambda *a, sched=None, a_src=None:
                        gat_layer.merged_gat_forward_plain(*a))
    want = model.collect_attention(x, layouts)
    assert [list(a) for a in got] == [list(b) for b in want]
    for rk, alpha in got[0].items():
        assert torch.equal(alpha, want[0][rk]), rk
    for rk, alpha in got[1].items():
        assert torch.isfinite(alpha).all(), rk
        np.testing.assert_allclose(alpha.cpu().numpy(),
                                   want[1][rk].cpu().numpy(), rtol=1e-5,
                                   atol=1e-5, err_msg=rk)



# --------------------------- the multiplier of #6 / #7 and the d_w of #8


def _mult(rng, e, p=0.3):
    """A dropout multiplier [E]: keep ~ bernoulli(1 - p), times 1/(1 - p)."""
    return ((rng.random(e) >= p) / (1.0 - p)).astype(np.float32)


@pytest.mark.parametrize("max_edges", [None, 8])
@pytest.mark.parametrize("d", [D, 48])
def test_segment_softmax_kernels_with_mult_match_plain(d, max_edges,
                                                       cuda_device):
    """#6 and #7 with the per-edge multiplier on the stream with long rows,
    a hub, empty rows and a trash row (chunked rows: #7's dot_r from the
    saved out, which holds the multiplier), at the default item sizes and
    at max_edges 8: two runs the same bits; the forward within the
    kernel-vs-plain tolerances, the backward by the float64 rule."""
    src, ro, logits, xs, long_rows = _long_row_stream(d=d)
    rng = np.random.default_rng(21)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    mult = t(_mult(rng, len(src)))
    fargs = (t(xs), t(src), t(logits), t(ro))
    sched = schedule.row_schedule(ro, max_edges or schedule.ROW_MAX_EDGES,
                                  max_edges or schedule.ROW_CHUNK_EDGES)
    assert set(long_rows) <= set(sched.split_units.tolist())
    sched = sched.to(cuda_device)
    before = (segment_softmax.launches, segment_softmax.bwd_launches)
    got = _repeat_equal(lambda *a: segment_softmax.segment_softmax_spmm_fwd(
        *a, sched=sched, mult=mult), *fargs)
    want = segment_softmax.segment_softmax_spmm_fwd_plain(*fargs, mult=mult)
    for g_, w_ in zip(got, want):
        _close_rows(g_, w_, long_rows)
    out, row_max, row_sum = got
    g = t(rng.standard_normal((len(ro) - 1, d)).astype(np.float32))
    bargs = fargs + (row_max, row_sum, out, g)
    edge = _repeat_equal(lambda *a: segment_softmax.segment_softmax_spmm_bwd(
        *a, sched=sched, mult=mult), *bargs)
    plain = segment_softmax.segment_softmax_spmm_bwd_plain(*bargs, mult=mult)
    exact = segment_softmax.segment_softmax_spmm_bwd_plain(
        *_as_double(bargs), mult=mult.double())
    for a, p, x in zip(edge, plain, exact):
        _grad_rule(a, p, x)
    assert (segment_softmax.launches, segment_softmax.bwd_launches) == (
        before[0] + 2, before[1] + 2)


@pytest.mark.parametrize("rk", ["Gene__Gene-PPI-Gene__Gene",
                                "Gene__rev_TSS__SNP"])
def test_segment_softmax_mult_on_relation_stream(rk, cuda_device,
                                                 variant_world):
    """The layer op with a multiplier (SegmentSoftmaxSpmm, its backward
    #7 and #8) on one relation's stream against the same op on the CPU
    (the plain versions) from the same inputs: forward within the
    kernel-vs-plain tolerances, the gradients of xs and logits within the
    backward kernels' tolerance."""
    cg, rel, _ = variant_world
    r = cg.relations[rk]
    L = rel[r.dst_type]
    RL = L.relations[L.rel_keys.index(rk)]
    cpu = device_layouts({r.dst_type: build_merged_layouts(
        cg, tile_rows=512)[r.dst_type]}, "cpu", cg, "relations")[r.dst_type]
    RC = cpu.relations[L.rel_keys.index(rk)]
    rng = np.random.default_rng(22)
    xs = (rng.standard_normal((RL.src_base[-1], D)) * 0.1).astype(np.float32)
    logits = (rng.standard_normal(RL.src.shape[0]) * 1.5).astype(np.float32)
    mult = _mult(rng, RL.src.shape[0])
    g = rng.standard_normal((RL.n_rows_per_rel, D)).astype(np.float32)
    res = []
    for dev, lay in ((cuda_device, RL), ("cpu", RC)):
        a, b = (torch.from_numpy(v).to(dev).requires_grad_()
                for v in (xs, logits))
        out = segment_softmax.SegmentSoftmaxSpmm.apply(
            a, b, lay, torch.from_numpy(mult).to(dev))
        out.backward(torch.from_numpy(g).to(dev))
        res.append((out.detach(), a.grad, b.grad))
    _close(res[0][0], res[1][0], RL.n_rows_per_rel, cg.num_nodes[r.dst_type])
    for a, b in zip(res[0][1:], res[1][1:]):
        _close_grad(a, b.to(cuda_device))


@pytest.mark.parametrize("max_edges", [None, 8])
def test_mult_of_ones_gives_the_bits_without(max_edges, cuda_device):
    """A multiplier of ones gives the bits of the launch without one (p * 1
    is p): the flag changes nothing else in #6 and #7."""
    src, ro, logits, xs, _ = _long_row_stream()
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    fargs = (t(xs), t(src), t(logits), t(ro))
    ones = torch.ones(len(src), device=cuda_device)
    sched = schedule.row_schedule(ro, max_edges or schedule.ROW_MAX_EDGES,
                                  max_edges or schedule.ROW_CHUNK_EDGES
                                  ).to(cuda_device)
    fwd = segment_softmax.segment_softmax_spmm_fwd
    got, base = (fwd(*fargs, sched=sched, mult=m) for m in (ones, None))
    for a, b in zip(got, base):
        assert torch.equal(a, b)
    g = t(np.random.default_rng(23).standard_normal(
        (len(ro) - 1, D)).astype(np.float32))
    bargs = fargs + (base[1], base[2], base[0], g)
    bwd = segment_softmax.segment_softmax_spmm_bwd
    got, base = (bwd(*bargs, sched=sched, mult=m) for m in (ones, None))
    for a, b in zip(got, base):
        assert torch.equal(a, b)


@pytest.mark.parametrize("d", [D, 48])
@pytest.mark.parametrize("form", ["relation", "mp-weighted", "hub"])
def test_csc_segment_sum_edge_grad_matches_plain(form, d, cuda_device,
                                                 variant_world):
    """#8 with d_w: on a relation stream (pad edges on the source trash
    row), a merged 'mp' group and a hub source row cut into chunks (each
    chunk writes its own edges' d_w): two runs the same bits, d_xs the bits
    of the launch without d_w, d_w by the float64 rule."""
    cg, rel, mp = variant_world
    rng = np.random.default_rng(24)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(cuda_device)  # noqa: E731
    if form == "relation":
        DL, fold = rel["SNP"].relations[0], 0
    elif form == "hub":
        DL, _ = _hub_csc_layout(cuda_device)
        fold = 2
        assert DL.csc_schedule.split_units.numel() > 0
    else:
        DL, fold = mp["Gene"], 0
    e = DL.csc_perm.shape[0]
    xs = t(rng.standard_normal((DL.src_base[-1], d)) * 0.1)
    g = t(rng.standard_normal(((DL.n_rows_per_rel if fold
                                else DL.row_offsets.shape[0] - 1), d)))
    w = t(rng.random(e))
    args = (g, w, None, xs, None, DL, fold)
    before = segment.launches
    got = _repeat_equal(lambda *a: segment.csc_segment_sum(
        *a, edge_grad=True), *args)
    assert segment.launches == before + 2
    assert got[1] is None and got[2].shape == (e,)
    assert torch.equal(got[0], segment.csc_segment_sum(*args)[0])
    plain = segment.csc_segment_sum_plain(*args, edge_grad=True)
    exact = segment.csc_segment_sum_plain(
        g.double(), w.double(), None, xs.double(), None, DL, fold,
        edge_grad=True)
    _grad_rule(got[0], plain[0], exact[0])
    _grad_rule(got[2], plain[2], exact[2])


def test_csr_segment_sum_weight_grad(cuda_device, variant_world):
    """CSRSegmentSum with weights that need a gradient (the sigmoid GAT
    layer's): the backward's one #8 launch gives d_x and d_w, against the
    same op on the CPU (the plain versions) on the relation's real edges."""
    cg, rel, _ = variant_world
    L = rel["Gene"]
    RL = L.relations[0]
    rk = L.rel_keys[0]
    cpu = device_layouts({"Gene": build_merged_layouts(
        cg, tile_rows=512)["Gene"]}, "cpu", cg, "relations")["Gene"]
    RC = cpu.relations[0]
    rng = np.random.default_rng(25)
    x = (rng.standard_normal((RL.src_base[-1], D)) * 0.1).astype(np.float32)
    w = rng.random(RL.src.shape[0]).astype(np.float32)
    g = rng.standard_normal((RL.n_rows_per_rel, D)).astype(np.float32)
    res = []
    for dev, lay in ((cuda_device, RL), ("cpu", RC)):
        a, b = (torch.from_numpy(v).to(dev).requires_grad_() for v in (x, w))
        before = segment.launches
        segment.CSRSegmentSum.apply(a, b, lay).backward(
            torch.from_numpy(g).to(dev))
        if dev != "cpu":
            assert segment.launches == before + 1
        res.append((a.grad.cpu(), b.grad.cpu()))
    e = cg.relations[rk].num_edges
    _close_grad(res[0][0], res[1][0])
    _close_grad(res[0][1][:e], res[1][1][:e])


@pytest.mark.parametrize("kernel", ["fwd", "bwd", "csc"])
def test_flags_off_bitwise_as_parent(kernel, parent_ops, cuda_device,
                                     variant_world):
    """Without the multiplier and d_w, #6, #7 and #8 give the bits of the
    earlier checkout's kernels through its own wrappers, on every row
    (the schedules are the same)."""
    cg, rel, _ = variant_world
    L = rel["SNP"]
    RL = L.relations[0]
    args = _relation_bwd_args(RL, D, cuda_device, seed=26)
    if kernel == "fwd":
        new = segment_softmax.segment_softmax_spmm_fwd(*args[:4])
        old = parent_ops.segment_softmax.segment_softmax_spmm_fwd(*args[:4])
    elif kernel == "bwd":
        new = segment_softmax.segment_softmax_spmm_bwd(*args)
        old = parent_ops.segment_softmax.segment_softmax_spmm_bwd(*args)
    else:
        w = args[2].sigmoid().contiguous()
        cargs = (args[7], w, None, args[0], None, RL)
        new = segment.csc_segment_sum(*cargs)
        old = parent_ops.segment.csc_segment_sum(*cargs)
    torch.cuda.synchronize()
    for a, b in zip(new, old):
        assert (a is None and b is None) or torch.equal(a, b)


def test_remat_gradients_bitwise_with_a_fixed_mask(cuda_device):
    """remat=True against remat=False on the card: GAT sum, two heads,
    dropout 0.1 in training (the per-relation path, #6 and #7 with the
    multiplier), the masks drawn from two CUDA generators of one seed:
    the same loss and bitwise the same gradients (the recompute relaunches
    the forward kernels: twice the forward launches)."""
    g = make_synthetic_kg(n_snp=3000, n_gene=300, n_go=100, seed=3)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    layouts = build_merged_layouts(cg, tile_rows=512)
    x = {t: torch.from_numpy(v).to(cuda_device)
         for t, v in cg.node_x.items()}
    dims = [cg.node_x[t].shape[1]
            for t in ("SNP", "Gene", "BiologicalProcess")]
    grads, fwd = [], []
    for remat in (False, True):
        cfg = ModelConfig(gnn_hidden_dim=D, gnn_num_layers=2, gat_num_head=2,
                          dropout=0.1, no_relu=True, remat=remat)
        model = HeteroGNN(cfg, rel_types, *dims, seed=0).to(cuda_device)
        dl = device_layouts(layouts, cuda_device, cg, layer_paths(cfg))
        gen = torch.Generator(device=cuda_device).manual_seed(7)
        before = segment_softmax.launches
        model(x, dl, training=True, dropout_gen=gen)[:, 0].square().sum(
            ).backward()
        torch.cuda.synchronize()
        fwd.append(segment_softmax.launches - before)
        grads.append({k: p.grad for k, p in model.named_parameters()
                      if p.grad is not None})
    assert fwd[1] == 2 * fwd[0] > 0
    assert sorted(grads[0]) == sorted(grads[1])
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


@pytest.mark.parametrize("kw", [dict(gnn_aggr="max"),
                                dict(gnn_aggr="min", sigmoid_gat=True,
                                     gat_num_head=2)],
                         ids=["GAT-max", "sigmoid-min-H2"])
def test_relation_step_grads_bitwise_repeatable(kw, cuda_device):
    """Two backward passes of the per-relation GAT layer give the same
    bits: the logits' gathers sum their cotangents in a fixed order
    (convs.EdgeLogits), where index_select's backward added with float
    atomics on CUDA (ROADMAP Queue 3)."""
    g = make_synthetic_kg(n_snp=3000, n_gene=300, n_go=100, seed=3)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    dims = [cg.node_x[t].shape[1]
            for t in ("SNP", "Gene", "BiologicalProcess")]
    cfg = ModelConfig(gnn_hidden_dim=D, gnn_num_layers=2, no_relu=True, **kw)
    model = HeteroGNN(cfg, rel_types, *dims, seed=0).to(cuda_device)
    dl = device_layouts(build_merged_layouts(cg, tile_rows=512), cuda_device,
                        cg, layer_paths(cfg))
    x = {t: torch.from_numpy(v).to(cuda_device)
         for t, v in cg.node_x.items()}
    grads = []
    for _ in range(2):
        model.zero_grad(set_to_none=True)
        model(x, dl, training=True)[:, 0].square().sum().backward()
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()
                      if p.grad is not None})
    assert grads[0] and sorted(grads[0]) == sorted(grads[1])
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_streamed_products_on_the_card(cuda_device):
    """ops/streaming.py on the card: column chunks through the pinned
    staging buffers and the copy stream (the copy of chunk k+1 under the
    product of chunk k), against one dense product; every byte of the
    table crosses once a pass; a second call reuses the staging and gives
    the same bits."""
    from kgwas_tpu_torch.ops import streaming

    rng = np.random.default_rng(0)
    x = rng.standard_normal((1000, 700)).astype(np.float32)
    w = torch.from_numpy(rng.standard_normal((700, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal(64).astype(np.float32))
    dh = torch.from_numpy(rng.standard_normal((1024, 64)).astype(np.float32))
    streaming.reset_stats()
    out = streaming.streamed_matmul(x, w.to(cuda_device), b.to(cuda_device),
                                    col_chunk=96, row_pad_to=1024)
    gw = streaming.streamed_grad_w(x, dh.to(cuda_device), col_chunk=96)
    assert streaming.stats["h2d_bytes"] == 2 * x.nbytes
    assert streaming.stats["chunks"] == 2 * 8
    want = torch.zeros(1024, 64, dtype=torch.float64)
    want[:1000] = torch.from_numpy(x).double() @ w.double()
    want += b.double()
    np.testing.assert_allclose(out.cpu().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_allclose(
        gw.cpu().numpy(), (torch.from_numpy(x).double().t()
                           @ dh[:1000].double()).numpy(), rtol=1e-5,
        atol=1e-4)
    again = streaming.streamed_matmul(x, w.to(cuda_device),
                                      b.to(cuda_device), col_chunk=96,
                                      row_pad_to=1024)
    assert torch.equal(out, again)


def test_train_state_copy_precedes_the_next_step(cuda_device):
    """engine/checkpoint.host_train_state packs a CUDA state on the device
    and copies it to the host later, from another thread: an in-place
    update issued after the packing does not reach the copy; host tensors
    and other values come through as they were."""
    import threading

    from kgwas_tpu_torch.engine.checkpoint import host_train_state

    p = torch.arange(1 << 20, dtype=torch.float32, device=cuda_device)
    q = torch.arange(12, dtype=torch.int64, device=cuda_device).view(3, 4)
    step = torch.tensor(7.0)
    want = p.cpu()
    copy = host_train_state({"p": p, "q": q}, {
        "state": {0: {"m": p * 2, "step": step}}, "param_groups": [
            {"lr": 1e-4, "params": [0]}]})
    p.add_(1.0)
    step += 1
    out = {}
    t = threading.Thread(target=lambda: out.update(copy.result()))
    t.start()
    t.join()
    assert torch.equal(out["model"]["p"], want)
    assert torch.equal(out["model"]["q"], q.cpu())
    assert out["model"]["q"].shape == (3, 4)
    assert torch.equal(out["optimizer"]["state"][0]["m"], want * 2)
    assert float(out["optimizer"]["state"][0]["step"]) == 7.0
    assert out["optimizer"]["param_groups"] == [{"lr": 1e-4, "params": [0]}]


# ---- the bf16 instances (the dtype options)
#
# Each bf16 kernel against its plain bf16 version on the same bf16 table:
# the same rounding points, float32 sums in another order. A value the
# two round to bf16 from float32 values a few ulps apart (a weight, a
# message cotangent, dz for d_att) can round to the neighbouring bf16
# value: so at most 1 row in 10^3 of a forward (1 element in 10^4 of
# d_xs) misses the f32 tolerances above, each within 1e-2 relative (a
# weight's bf16 ulp, 2^-8, of its share) or 2^-8 of its row's largest
# value; d_att at rtol 1e-4 with a floor of 1e-4 of its largest value (a
# dz_e rounded to its bf16 neighbour moves one term of a d_att sum by
# 2^-8: up to 2.3e-5 of the largest value seen). Two launches give the
# same bits.
#
# The bf16 instances read each edge's score from the per-source-row pass
# (merged_gat_a_src): the pass bitwise its own order emulated in float32
# tensor code; #1 and #2 bf16 on the default schedule (trash rows in
# chunks), at max_edges 8 and on a hub node split across its slots; with
# KGWAS_PARENT_CSRC, bitwise the earlier checkout's instances, which
# scored every edge in the kernels.

def _bf16_rows_close(got, want, n_per_rel, trash, fold):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    mask = np.zeros(len(got), dtype=bool)
    if fold:
        mask[trash] = True
    else:
        mask[trash::n_per_rel] = True
    ok = np.isclose(got, want, rtol=1e-5, atol=1e-5).all(axis=1)
    ok[mask] = np.isclose(got[mask], want[mask], rtol=1e-4,
                          atol=1e-5).all(axis=1)
    assert (~ok).sum() <= max(1, len(ok) // 1000), (~ok).sum()
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-4)


def _bf16_grad_close(got, want):
    got, want = got.cpu().numpy(), want.cpu().numpy()
    miss = ~np.isclose(got, want, rtol=1e-4,
                       atol=1e-5 * np.abs(want).max())
    assert miss.sum() <= max(1, want.size // 10 ** 4), miss.sum()
    # a row's largest |value|; of a 1-D array (per row or edge), its largest
    scale = (np.abs(want).max() if want.ndim == 1
             else np.abs(want).max(axis=-1, keepdims=True))
    assert np.all(np.abs(got - want) <= 2.0 ** -8 * scale + 1e-6)


@pytest.mark.parametrize("max_edges", [None, 8])
@pytest.mark.parametrize("d", [D, 256, 48])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_bf16_kernels_match_plain(mode, fold, d, max_edges, cuda_device,
                                  group):
    """merged_gat_fwd_bf16 (#1, its scores from the score pass), then
    merged_gat_bwd_bf16 (#2) and csc_segment_sum_bf16 (#8, the logit
    term) on its output's cotangent; the default schedule cuts the trash
    rows into chunks, max_edges 8 real rows too."""
    L, trash = group
    fold = len(L.rel_keys) if fold else 0
    DL = _merged_layout(L, fold, cuda_device)
    xs, att, a_dst, g = _bwd_inputs(L, fold, d, cuda_device)
    xs = xs.to(torch.bfloat16)
    n = L.n_rows_per_rel
    args = (xs, DL.src, DL.row_offsets, att, a_dst, n, fold, mode, 0.2, 0.7)
    sched = _sched(L, fold, max_edges, cuda_device)
    before = (gat_layer.launches, gat_layer.bf16_launches,
              gat_layer.a_src_launches)
    got = gat_layer.merged_gat_forward(
        *args, sched=sched,
        a_src=gat_layer.merged_gat_a_src(xs, att, L.src_base))
    again = gat_layer.merged_gat_forward(
        *args, sched=sched,
        a_src=gat_layer.merged_gat_a_src(xs, att, L.src_base))
    torch.cuda.synchronize()
    assert (gat_layer.launches, gat_layer.bf16_launches,
            gat_layer.a_src_launches) == (before[0], before[1] + 2,
                                          before[2] + 2)
    want = gat_layer.merged_gat_forward_plain(*args)
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)
        assert g_.dtype == torch.float32
    _bf16_rows_close(got[0], want[0], n, trash, fold)
    for g_, w_ in zip(got[1:], want[1:]):
        _bf16_rows_close(g_[:, None], w_[:, None], n, trash, False)
    bwd = (xs, att, a_dst, want[1], want[2], g, DL, fold, mode, 0.2, 0.7)
    a_src = gat_layer.merged_gat_a_src(xs, att, L.src_base)
    b0 = (gat_layer.bf16_bwd_launches, segment.bf16_launches)
    new = gat_layer.merged_gat_backward(*bwd, a_src=a_src)
    new2 = gat_layer.merged_gat_backward(*bwd, a_src=a_src)
    torch.cuda.synchronize()
    assert (gat_layer.bf16_bwd_launches, segment.bf16_launches) == (
        b0[0] + 2, b0[1] + 2)
    plain = gat_layer.merged_gat_backward_plain(*bwd)
    for a, b in zip(new, new2):
        assert torch.equal(a, b)
    _bf16_grad_close(new[0], plain[0])
    np.testing.assert_allclose(new[1].cpu().numpy(), plain[1].cpu().numpy(),
                               rtol=1e-4, atol=1e-4 * float(
                                   plain[1].abs().max()))
    _bf16_grad_close(new[2], plain[2])


def _a_src_lane_order(xs, att, src_base):
    """merged_gat_a_src in the kernel's order, on the kernel's device: lane
    l sums its columns from 0 one by one (4 (32 k + l) .. + 3 at D = 128 k,
    else l + 32 k up to 512, zero past D), then the lanes' sums xor 16, 8,
    4, 2, 1. A product of two bf16 values is exact in float32, so each
    fused multiply-add of the kernel is this one rounded add."""
    x = xs.to(torch.float32)
    a = gat_layer.round_bf16(att)
    s, d = x.shape
    prods = torch.zeros(s, d, device=x.device)
    for r, (b0, b1) in enumerate(zip(src_base, src_base[1:])):
        prods[b0:b1] = x[b0:b1] * a[r]
    if d % 128 == 0:
        lanes = prods.view(s, d // 128, 32, 4).permute(0, 2, 1, 3).reshape(
            s, 32, d // 32)
    else:
        pad = torch.zeros(s, 512, device=x.device)
        pad[:, :d] = prods
        lanes = pad.view(s, 16, 32).permute(0, 2, 1)
    q = torch.zeros(s, 32, device=x.device)
    for c in range(lanes.shape[2]):
        q = q + lanes[:, :, c]
    idx = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        q = q + q[:, idx ^ off]
    out = torch.zeros(s, device=x.device)
    out[src_base[0]:src_base[-1]] = q[src_base[0]:src_base[-1], 0]
    return out


@pytest.mark.parametrize("slots", ["all", "shard"])
@pytest.mark.parametrize("d", [D, 256, 384, 512, 48, 130])
def test_a_src_pass_bitwise(d, slots, cuda_device, group):
    """The score pass (kgwas_merged_gat_a_src_bf16) bitwise its order
    emulated in float32 tensor code, and against the plain version
    (merged_gat_a_src_plain, whose torch sum takes another order: up to 512
    terms) at rtol 1e-5, atol 1e-6; with a shard's slots (1..R) the rows
    of slot 0 stay 0."""
    L, _ = group
    xs, att, _, _ = _bwd_inputs(L, 0, d, cuda_device)
    xs = xs.to(torch.bfloat16)
    base = tuple(int(b) for b in L.src_base)
    if slots == "shard":
        base, att = base[1:], att[1:].contiguous()
    n0 = gat_layer.a_src_launches
    got = gat_layer.merged_gat_a_src(xs, att, base)
    again = gat_layer.merged_gat_a_src(xs, att, base)
    torch.cuda.synchronize()
    assert gat_layer.a_src_launches == n0 + 2
    assert torch.equal(got, again)
    assert torch.equal(got, _a_src_lane_order(xs, att, base))
    plain = gat_layer.merged_gat_a_src_plain(xs.cpu(), att.cpu(), base)
    np.testing.assert_allclose(got.cpu().numpy(), plain.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert not got[:base[0]].any()
    with pytest.raises(TypeError):
        gat_layer.merged_gat_a_src(xs.float(), att, base)
    with pytest.raises(ValueError):
        gat_layer.merged_gat_a_src(xs, att, base[:-1])


def test_bf16_wrappers_need_a_src(cuda_device, group):
    """A bf16 table on the card launches #1 and #2 bf16 only with the
    score pass's a_src (no pass inside the wrappers), of the table's
    rows and float32."""
    L, _ = group
    xs, att, a_dst, g = _bwd_inputs(L, 0, D, cuda_device)
    xs = xs.to(torch.bfloat16)
    n = L.n_rows_per_rel
    src = torch.from_numpy(L.src).to(cuda_device)
    ro = torch.from_numpy(L.row_offsets).to(cuda_device)
    args = (xs, src, ro, att, a_dst, n, 0, "softmax", 0.2, 1.0)
    sched = _sched(L, 0, gat_layer.MAX_EDGES, cuda_device)
    n0 = (gat_layer.bf16_launches, gat_layer.a_src_launches)
    with pytest.raises(ValueError, match="needs a_src"):
        gat_layer.merged_gat_forward(*args, sched=sched)
    with pytest.raises(ValueError, match="a_src must be"):
        gat_layer.merged_gat_forward(
            *args, sched=sched,
            a_src=torch.zeros(xs.shape[0] - 1, device=cuda_device))
    _, row_max, row_sum = gat_layer.merged_gat_forward_plain(*args)
    bargs = (xs, src, ro, att, a_dst, row_max, row_sum, g, n, 0, "softmax",
             0.2, 1.0)
    with pytest.raises(ValueError, match="needs a_src"):
        gat_layer.merged_gat_bwd(*bargs)
    assert (gat_layer.bf16_launches, gat_layer.a_src_launches) == n0


def _owned_hub_stream(seed=6):
    """_hub_stream with each slot's sources inside its own third of the
    table, as the bf16 instances' scores per source row need."""
    src, ro, n, hub, rng = _hub_stream(seed)
    n_rel = (len(ro) - 1) // n
    base = np.linspace(0, 4096, n_rel + 1).astype(np.int64)
    slot = np.repeat(np.arange(n_rel * n) // n, np.diff(ro))
    src = base[slot] + src % np.diff(base)[slot]
    return src.astype(np.int32), ro, n, hub, rng, tuple(base.tolist())


@pytest.mark.parametrize("max_edges", [None, 64])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_bf16_hub_node_split_across_slots(mode, fold, max_edges,
                                          cuda_device):
    """#1 bf16 and #2 bf16 on a hub node's thousands of edges in each slot,
    cut into chunks, against their plain versions (bf16 rule), and bitwise
    repeatable."""
    src, ro, n, hub, rng, base = _owned_hub_stream()
    n_rel = (len(ro) - 1) // n
    fold = n_rel if fold else 0
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    xs = t((rng.standard_normal((4096, D)) * 0.1).astype(np.float32)).to(
        torch.bfloat16)
    att = t((rng.standard_normal((n_rel, D)) * 0.2).astype(np.float32))
    a_dst = t((rng.standard_normal(n_rel * n) * 0.5).astype(np.float32))
    sched = gat_layer.schedule(ro, n, fold, max_edges or gat_layer.MAX_EDGES)
    assert hub in sched.split_units.tolist()
    sched = sched.to(cuda_device)
    args = (xs, t(src), t(ro), att, a_dst, n, fold, mode, 0.2, 0.7)
    got = gat_layer.merged_gat_forward(
        *args, sched=sched, a_src=gat_layer.merged_gat_a_src(xs, att, base))
    again = gat_layer.merged_gat_forward(
        *args, sched=sched, a_src=gat_layer.merged_gat_a_src(xs, att, base))
    want = gat_layer.merged_gat_forward_plain(*args)
    torch.cuda.synchronize()
    for g_, a_ in zip(got, again):
        assert torch.equal(g_, a_)
    _bf16_rows_close(got[0], want[0], n, hub, fold)
    for g_, w_ in zip(got[1:], want[1:]):
        _bf16_rows_close(g_[:, None], w_[:, None], n, hub, False)
    g = t(rng.standard_normal((n if fold else n_rel * n, D)).astype(
        np.float32))
    bargs = (xs, t(src), t(ro), att, a_dst, want[1], want[2], g, n, fold,
             mode, 0.2, 0.7)
    bsched = gat_layer.schedule(ro, n, fold, max_edges or gat_layer.MAX_EDGES,
                                gat_layer.BWD_CHUNK_EDGES).to(cuda_device)
    edge = gat_layer.merged_gat_bwd(
        *bargs, sched=bsched, a_src=gat_layer.merged_gat_a_src(xs, att, base))
    again = gat_layer.merged_gat_bwd(
        *bargs, sched=bsched, a_src=gat_layer.merged_gat_a_src(xs, att, base))
    torch.cuda.synchronize()
    for got_, rep, want_ in zip(edge, again,
                                gat_layer.merged_gat_bwd_plain(*bargs)):
        assert torch.equal(got_, rep)
        _bf16_grad_close(got_, want_)


@pytest.mark.parametrize("max_edges", [None, 8])
@pytest.mark.parametrize("d", [D, 256, 48])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_merged_gat_bf16_bitwise_as_parent(mode, fold, d, max_edges,
                                           parent_ops, cuda_device, group):
    """#1 bf16 and #2 bf16 give the earlier checkout's bits (its kernels
    through its own wrappers, on its own score pass's a_src) on the same
    inputs and schedules."""
    L, _ = group
    fold = len(L.rel_keys) if fold else 0
    n = L.n_rows_per_rel
    xs, att, a_dst, g = _bwd_inputs(L, fold, d, cuda_device)
    xs = xs.to(torch.bfloat16)
    src = torch.from_numpy(L.src).to(cuda_device)
    ro = torch.from_numpy(L.row_offsets).to(cuda_device)
    sched = _sched(L, fold, max_edges or gat_layer.MAX_EDGES, cuda_device)
    bsched = _sched(L, fold, max_edges or gat_layer.MAX_EDGES, cuda_device,
                    gat_layer.BWD_CHUNK_EDGES if max_edges is None
                    else max_edges)
    args = (xs, src, ro, att, a_dst, n, fold, mode, 0.2, 0.7)
    a_src = gat_layer.merged_gat_a_src(xs, att, L.src_base)
    new = gat_layer.merged_gat_forward(*args, sched=sched, a_src=a_src)
    pg = parent_ops.gat_layer
    # the earlier checkout's wrappers get the scores from its own pass
    old_a_src = pg.merged_gat_a_src(xs, att, L.src_base)
    old = pg.merged_gat_forward(*args, sched=sched, a_src=old_a_src)
    bargs = (xs, src, ro, att, a_dst, new[1], new[2], g, n, fold, mode, 0.2,
             0.7)
    new_b = gat_layer.merged_gat_bwd(*bargs, sched=bsched, a_src=a_src)
    old_b = pg.merged_gat_bwd(*bargs, sched=bsched, a_src=old_a_src)
    torch.cuda.synchronize()
    for a, b in zip(new + new_b, old + old_b):
        assert torch.equal(a, b)


@pytest.mark.parametrize("kind", ["none", "f32", "bf16"])
@pytest.mark.parametrize("d", [D, 48])
def test_bf16_segment_sums_match_plain(kind, d, cuda_device, group):
    """csr_segment_sum_bf16 (#10: unweighted, f32 weights, bf16 weights
    with bf16 products) and csc_segment_sum_bf16 without the logit term
    (its weighted products rounded to bf16; with the weights' gradient)
    over a merged group's stream and its CSC."""
    L, trash = group
    DL = _merged_layout(L, 0, cuda_device)
    DL = dataclasses.replace(DL, row_schedule=schedule.row_schedule(
        L.row_offsets, schedule.CSR_MAX_EDGES,
        schedule.CSR_CHUNK_EDGES).to(cuda_device))
    xs, _, _, g = _bwd_inputs(L, 0, d, cuda_device)
    xs = xs.to(torch.bfloat16)
    rng = np.random.default_rng(21)
    e = DL.src.shape[0]
    w = (None if kind == "none" else torch.from_numpy(
        rng.random(e, dtype=np.float32)).to(cuda_device))
    if kind == "bf16":
        w = w.to(torch.bfloat16)
    c0 = segment.csr_bf16_launches
    got = segment.csr_segment_sum(xs, DL.src, DL.row_offsets, w,
                                  sched=DL.row_schedule)
    again = segment.csr_segment_sum(xs, DL.src, DL.row_offsets, w,
                                    sched=DL.row_schedule)
    want = segment.csr_segment_sum_plain(xs, DL.src, DL.row_offsets, w)
    torch.cuda.synchronize()
    assert segment.csr_bf16_launches == c0 + 2
    assert torch.equal(got, again)
    _close(got, want, L.n_rows_per_rel, trash)
    wf = None if w is None else w.to(torch.float32)
    new = segment.csc_segment_sum(g, wf, None, xs, None, DL,
                                  edge_grad=w is not None)
    plain = segment.csc_segment_sum_plain(g, wf, None, xs, None, DL,
                                          edge_grad=w is not None)
    torch.cuda.synchronize()
    _bf16_grad_close(new[0], plain[0])
    if w is not None:
        _close_grad(new[2], plain[2])


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_merged_gat_f32_instances_bitwise_as_parent(mode, fold, parent_csrc,
                                                    cuda_device, group,
                                                    monkeypatch):
    """The f32 instances of the merged GAT kernels, whose sources gained
    the bf16 instances beside them, give the earlier source's bits on the
    same inputs and schedules."""
    L, _ = group
    fold = len(L.rel_keys) if fold else 0
    n = L.n_rows_per_rel
    xs, att, a_dst, g = _bwd_inputs(L, fold, D, cuda_device)
    src = torch.from_numpy(L.src).to(cuda_device)
    ro = torch.from_numpy(L.row_offsets).to(cuda_device)
    new = gat_layer.merged_gat_forward(xs, src, ro, att, a_dst, n, fold, mode,
                                       0.2, 0.7)
    bargs = (xs, src, ro, att, a_dst, new[1], new[2], g, n, fold, mode, 0.2,
             0.7)
    new_b = gat_layer.merged_gat_bwd(*bargs)
    for name in ("merged_gat_fwd", "merged_gat_bwd"):
        source, entry, argtypes = build.KERNELS[name]
        monkeypatch.setitem(build._loaded, name, build.build_source(
            parent_csrc / source, f"parent_{name}", entry, argtypes))
    old = gat_layer.merged_gat_forward(xs, src, ro, att, a_dst, n, fold, mode,
                                       0.2, 0.7)
    old_b = gat_layer.merged_gat_bwd(*bargs)
    torch.cuda.synchronize()
    for a, b in zip(new + new_b, old + old_b):
        assert torch.equal(a, b)


# ---- the bf16 instances of the segment softmax kernels (#6, #7)
#
# They compute the float32 instances' arithmetic on operands widened to
# float32 (exact), so each is bitwise equal to the float32 instance on the
# widened operands under the same schedule, and held against the plain
# version (which widens the same way) at the float32 tolerances.

def _bf16_softmax_case(d, max_edges, logits_bf16, device, mult=False):
    """The long-row stream with a bf16 table (and bf16 logits when asked),
    its schedule, an optional multiplier and a cotangent g."""
    src, ro, logits, xs, long_rows = _long_row_stream(d=d)
    rng = np.random.default_rng(31)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    xs_b = t(xs).to(torch.bfloat16)
    lg = t(logits)
    if logits_bf16:
        lg = lg.to(torch.bfloat16)
    sched = schedule.row_schedule(ro, max_edges or schedule.ROW_MAX_EDGES,
                                  max_edges or schedule.ROW_CHUNK_EDGES)
    g = t(rng.standard_normal((len(ro) - 1, d)).astype(np.float32))
    mu = t(_mult(rng, len(src))) if mult else None
    return (xs_b, t(src), lg, t(ro)), sched.to(device), g, mu, long_rows


@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("logits", ["f32", "bf16"])
@pytest.mark.parametrize("max_edges", [None, 8])
@pytest.mark.parametrize("d", [D, 48])
def test_bf16_segment_softmax_kernels_match_plain_and_f32(
        d, max_edges, logits, mult, cuda_device):
    """segment_softmax_spmm_fwd_bf16 (#6) and _bwd_bf16 (#7) on bf16 rows
    (logits float32 as under stream_dtype, bf16 as under compute_dtype),
    on the long-row stream (chunks, a hub, empty rows, a trash row) at the
    default item sizes and at max_edges 8: two runs the same bits, float32
    outputs, within the float32 kernel-vs-plain tolerances of the plain
    version, and bitwise the float32 instances on the widened operands."""
    fargs, sched, g, mu, long_rows = _bf16_softmax_case(
        d, max_edges, logits == "bf16", cuda_device, mult)
    before = (segment_softmax.launches, segment_softmax.bwd_launches,
              segment_softmax.bf16_launches,
              segment_softmax.bf16_bwd_launches)
    got = _repeat_equal(lambda *a: segment_softmax.segment_softmax_spmm_fwd(
        *a, sched=sched, mult=mu), *fargs)
    assert all(v.dtype == torch.float32 for v in got)
    want = segment_softmax.segment_softmax_spmm_fwd_plain(*fargs, mult=mu)
    for g_, w_ in zip(got, want):
        _close_rows(g_, w_, long_rows)
    wide = (fargs[0].float(), fargs[1], fargs[2].float(), fargs[3])
    f32 = segment_softmax.segment_softmax_spmm_fwd(*wide, sched=sched,
                                                   mult=mu)
    for a, b in zip(got, f32):
        assert torch.equal(a, b)
    out, row_max, row_sum = got
    bargs = fargs + (row_max, row_sum, out, g)
    edge = _repeat_equal(lambda *a: segment_softmax.segment_softmax_spmm_bwd(
        *a, sched=sched, mult=mu), *bargs)
    assert all(v.dtype == torch.float32 for v in edge)
    plain = segment_softmax.segment_softmax_spmm_bwd_plain(*bargs, mult=mu)
    exact = segment_softmax.segment_softmax_spmm_bwd_plain(
        *_as_double(bargs), mult=None if mu is None else mu.double())
    for a, p, x in zip(edge, plain, exact):
        _grad_rule(a, p, x)
    f32_b = segment_softmax.segment_softmax_spmm_bwd(*_as_float(bargs),
                                                     sched=sched, mult=mu)
    for a, b in zip(edge, f32_b):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert (segment_softmax.launches, segment_softmax.bwd_launches,
            segment_softmax.bf16_launches,
            segment_softmax.bf16_bwd_launches) == (
        before[0] + 1, before[1] + 1, before[2] + 2, before[3] + 2)


def _as_float(args):
    return tuple(a.float() if torch.is_tensor(a) and a.is_floating_point()
                 else a for a in args)


@pytest.mark.parametrize("rk", ["Gene__Gene-PPI-Gene__Gene",
                                "Gene__rev_TSS__SNP"])
def test_bf16_segment_softmax_op_on_relation_stream(rk, cuda_device,
                                                    variant_world):
    """SegmentSoftmaxSpmm on bf16 xs and bf16 logits over one relation's
    stream and its row schedule (the compute dtype's op): float32 output,
    the gradients in the operands' dtypes, against the same op on the CPU
    (the plain versions) from the same bf16 values: the forward within
    the kernel-vs-plain tolerances, d_logits by the backward tolerance and
    d_xs (#8's bf16 instance, products rounded to bf16) by the bf16 rule."""
    cg, rel, _ = variant_world
    r = cg.relations[rk]
    L = rel[r.dst_type]
    RL = L.relations[L.rel_keys.index(rk)]
    cpu = device_layouts({r.dst_type: build_merged_layouts(
        cg, tile_rows=512)[r.dst_type]}, "cpu", cg, "relations")[r.dst_type]
    RC = cpu.relations[L.rel_keys.index(rk)]
    rng = np.random.default_rng(32)
    xs = torch.from_numpy((rng.standard_normal((RL.src_base[-1], D))
                           * 0.1).astype(np.float32)).to(torch.bfloat16)
    logits = torch.from_numpy((rng.standard_normal(RL.src.shape[0])
                               * 1.5).astype(np.float32)).to(torch.bfloat16)
    g = rng.standard_normal((RL.n_rows_per_rel, D)).astype(np.float32)
    res = []
    before = (segment_softmax.bf16_launches,
              segment_softmax.bf16_bwd_launches, segment.bf16_launches)
    for dev, lay in ((cuda_device, RL), ("cpu", RC)):
        a, b = (v.to(dev).requires_grad_() for v in (xs, logits))
        out = segment_softmax.SegmentSoftmaxSpmm.apply(a, b, lay)
        assert out.dtype == torch.float32
        out.backward(torch.from_numpy(g).to(dev))
        assert a.grad.dtype == b.grad.dtype == torch.bfloat16
        res.append((out.detach().cpu(), a.grad.float().cpu(),
                    b.grad.float().cpu()))
    assert (segment_softmax.bf16_launches, segment_softmax.bf16_bwd_launches,
            segment.bf16_launches) == (before[0] + 1, before[1] + 1,
                                       before[2] + 1)
    (o, dx, dl), (o_p, dx_p, dl_p) = res
    _close(o, o_p, RL.n_rows_per_rel, cg.num_nodes[r.dst_type])
    _bf16_grad_close(dx, dx_p)
    _bf16_grad_close(dl, dl_p)


@pytest.mark.parametrize("mult", [False, True])
def test_segment_softmax_f32_instances_bitwise_as_parent(
        mult, parent_csrc, cuda_device, monkeypatch):
    """The f32 instances of #6 and #7, whose sources gained the bf16
    instances beside them, give the earlier source's bits on the same
    inputs and schedules (the C interface of the f32 entry points is
    unchanged)."""
    src, ro, logits, xs, _ = _long_row_stream()
    rng = np.random.default_rng(33)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    mu = t(_mult(rng, len(src))) if mult else None
    sched = schedule.row_schedule(ro).to(cuda_device)
    fargs = (t(xs), t(src), t(logits), t(ro))
    g = t(rng.standard_normal((len(ro) - 1, D)).astype(np.float32))

    def run():
        f = segment_softmax.segment_softmax_spmm_fwd(*fargs, sched=sched,
                                                     mult=mu)
        b = segment_softmax.segment_softmax_spmm_bwd(
            *fargs, f[1], f[2], f[0], g, sched=sched, mult=mu)
        return f + b

    new = run()
    for name in ("segment_softmax_spmm_fwd", "segment_softmax_spmm_bwd"):
        source, entry, argtypes = build.KERNELS[name]
        monkeypatch.setitem(build._loaded, name, build.build_source(
            parent_csrc / source, f"parent_{name}", entry, argtypes))
    old = run()
    torch.cuda.synchronize()
    for a, b in zip(new, old):
        assert torch.equal(a, b)


# ---- the bf16 kernels #6 and #8 on item streams of every shape
#
# #6 bf16 gathers its rows through a cp.async ring and #8 bf16 takes its
# rows' c in transposing butterflies; every row keeps its order of
# additions, so #6 bf16 stays bitwise the float32 instance on the widened
# operands, and both stay bitwise the earlier checkout's kernels: on a
# stream with long hub rows, chunked trash rows and empty rows, one with
# fewer items than a block's warps, and one with many items (more than the
# card holds warps at once).

def _short_row_stream(n_rows, n_src, seed, d=D):
    """A relation stream of n_rows rows of 0-3 edges into n_src source
    rows (packed items of 32 rows), in _long_row_stream's form."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, 4, n_rows)
    ro = np.zeros(n_rows + 1, dtype=np.int64)
    np.cumsum(deg, out=ro[1:])
    src = rng.integers(0, n_src, ro[-1])
    logits = (rng.standard_normal(ro[-1]) * 1.5).astype(np.float32)
    xs = (rng.standard_normal((n_src, d)) * 0.1).astype(np.float32)
    return src.astype(np.int32), ro.astype(np.int32), logits, xs, []


ITEM_STREAMS = {
    "long": lambda: _long_row_stream(),
    "few": lambda: _short_row_stream(40, 64, 41),
    "many": lambda: _short_row_stream(400_000, 400_000, 42),
    "odd": lambda: _long_row_stream(seed=12),
}
# the streams scheduled at other item sizes (max_edges = chunk_edges): a
# largest item of 13 edges, no multiple of 8 (a warp's arrays then end
# off a ring group, and the next warp's ring must stay 16-byte aligned)
STREAM_EDGES = {"odd": 13}
# #7 and #10 bf16 also on the long-row stream at the wider 16-byte widths:
# a lane's ring copies are then NV 16-byte copies of a row, and at D = 384
# and 512 a block's shared memory passes 48 KB
WIDE_STREAMS = {f"long{d}": (lambda d=d: _long_row_stream(d=d))
                for d in (256, 384, 512)}
BF16_STREAMS = {**ITEM_STREAMS, **WIDE_STREAMS}


def _stream_schedule(stream, ro, max_edges, chunk_edges, device):
    k = STREAM_EDGES.get(stream)
    return schedule.row_schedule(ro, k or max_edges, k or chunk_edges).to(
        device)


def _csc_of(src, ro, n_src, device):
    """The one-slot CSC layout of a relation stream (src, row_offsets),
    with its CSC sum's fields."""
    deg = np.diff(ro)
    dst = np.repeat(np.arange(len(deg)), deg)
    perm = np.argsort(src, kind="stable")
    off = np.zeros(n_src + 1, dtype=np.int64)
    np.cumsum(np.bincount(src, minlength=n_src), out=off[1:])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(device)  # noqa: E731
    return SimpleNamespace(src=t(src), row_offsets=t(ro), dst=t(dst),
                           csc_perm=t(perm), csc_offsets=t(off),
                           src_base=(0, n_src), n_rows_per_rel=len(deg),
                           **segment.csc_fields(dst, perm, off, len(deg),
                                                (0, n_src), 0, device))


def _stream_fwd_case(stream, logits, mult, device):
    src, ro, lg, xs, long_rows = BF16_STREAMS[stream]()
    rng = np.random.default_rng(44)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    lg_t = t(lg)
    if logits == "bf16":
        lg_t = lg_t.to(torch.bfloat16)
    args = (t(xs).to(torch.bfloat16), t(src), lg_t, t(ro))
    mu = t(_mult(rng, len(src))) if mult else None
    return args, _stream_schedule(stream, ro, schedule.ROW_MAX_EDGES,
                                  schedule.ROW_CHUNK_EDGES, device), mu, \
        long_rows


@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("logits", ["f32", "bf16"])
@pytest.mark.parametrize("stream", sorted(ITEM_STREAMS))
def test_bf16_segment_softmax_item_streams(stream, logits, mult,
                                           cuda_device):
    """#6 bf16 on the item streams: two runs the same bits, bitwise the
    float32 instance on the widened operands, and within the
    kernel-vs-plain tolerances of the plain version."""
    args, sched, mu, long_rows = _stream_fwd_case(stream, logits, mult,
                                                cuda_device)
    assert sched.items.shape[0] > 0
    got = _repeat_equal(lambda *a: segment_softmax.segment_softmax_spmm_fwd(
        *a, sched=sched, mult=mu), *args)
    wide = segment_softmax.segment_softmax_spmm_fwd(
        args[0].float(), args[1], args[2].float(), args[3], sched=sched,
        mult=mu)
    want = segment_softmax.segment_softmax_spmm_fwd_plain(*args, mult=mu)
    for a, b, c in zip(got, wide, want):
        assert torch.equal(a, b)
        _close_rows(a, c, long_rows)


@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("logits", ["f32", "bf16"])
@pytest.mark.parametrize("stream", sorted(ITEM_STREAMS))
def test_bf16_segment_softmax_streams_bitwise_as_parent(stream, logits, mult,
                                                     parent_ops,
                                                     cuda_device):
    """#6 bf16 gives the earlier checkout's bits on the item streams."""
    args, sched, mu, _ = _stream_fwd_case(stream, logits, mult, cuda_device)
    new = segment_softmax.segment_softmax_spmm_fwd(*args, sched=sched,
                                                   mult=mu)
    old = parent_ops.segment_softmax.segment_softmax_spmm_fwd(
        *args, sched=sched, mult=mu)
    torch.cuda.synchronize()
    for a, b in zip(new, old):
        assert torch.equal(a, b)


def _stream_csc_case(stream, form, device):
    """#8 bf16's call on the CSC of an item stream: (args, edge_grad)."""
    src, ro, _, xs, _ = ITEM_STREAMS[stream]()
    lay = _csc_of(src, ro, xs.shape[0], device)
    rng = np.random.default_rng(45)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(device)  # noqa: E731
    e, n = len(src), len(ro) - 1
    g = t(rng.standard_normal((n, D)))
    w = None if form == "unweighted" else t(rng.random(e))
    logits = form == "logits"
    dz = t(rng.standard_normal(e) * 0.3) if logits else None
    att = t(rng.standard_normal((1, D)) * 0.2) if logits else None
    return (g, w, dz, t(xs).to(torch.bfloat16), att, lay), form == "d_w"


CSC_FORMS = ["logits", "weighted", "unweighted", "d_w"]


@pytest.mark.parametrize("form", CSC_FORMS)
@pytest.mark.parametrize("stream", sorted(ITEM_STREAMS))
def test_bf16_csc_segment_sum_item_streams(stream, form, cuda_device):
    """#8 bf16 on the CSC of the item streams, in its four call forms
    (the logit term with fold 0, weighted, unweighted, with d_w): two
    runs the same bits, within the bf16 rule of the plain version (d_w
    within the float32 backward tolerance)."""
    args, eg = _stream_csc_case(stream, form, cuda_device)
    before = segment.bf16_launches
    got = _repeat_equal(lambda *a: segment.csc_segment_sum(
        *a, edge_grad=eg), *args)
    want = segment.csc_segment_sum_plain(*args, edge_grad=eg)
    assert segment.bf16_launches == before + 2
    _bf16_grad_close(got[0], want[0])
    if form == "logits":
        _bf16_grad_close(got[1], want[1])
    if eg:
        _close_grad(got[2], want[2])


@pytest.mark.parametrize("form", CSC_FORMS)
@pytest.mark.parametrize("stream", sorted(ITEM_STREAMS))
def test_bf16_csc_segment_sum_streams_bitwise_as_parent(stream, form,
                                                     parent_ops,
                                                     cuda_device):
    """#8 bf16 gives the earlier checkout's bits on every output, with
    and without the logit term, weighted and unweighted."""
    args, eg = _stream_csc_case(stream, form, cuda_device)
    new = segment.csc_segment_sum(*args, edge_grad=eg)
    old = parent_ops.segment.csc_segment_sum(*args, edge_grad=eg)
    torch.cuda.synchronize()
    for a, b in zip(new, old):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("fold", [False, True])
def test_bf16_csc_segment_sum_logit_path_bitwise_as_parent(
        fold, parent_ops, cuda_device, group):
    """#8 bf16 on the merged GAT layer's call (w, dz, att, with and
    without the fold) gives the earlier checkout's bits on every source
    row and on d_att."""
    L, _ = group
    R = len(L.rel_keys)
    fold = R if fold else 0
    DL = _merged_layout(L, fold, cuda_device)
    xs, att, _, g = _bwd_inputs(L, fold, D, cuda_device)
    rng = np.random.default_rng(46)
    e = DL.src.shape[0]
    w = torch.from_numpy(rng.random(e, dtype=np.float32)).to(cuda_device)
    dz = torch.from_numpy(rng.standard_normal(e).astype(np.float32)).to(
        cuda_device)
    args = (g, w, dz, xs.to(torch.bfloat16), att, DL, fold)
    new = segment.csc_segment_sum(*args)
    old = parent_ops.segment.csc_segment_sum(*args)
    torch.cuda.synchronize()
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])


# ---- the bf16 kernels #7 and #10 on the item streams
#
# Both gather their bf16 rows through a cp.async ring fed by edge. #7
# bf16 keeps each m_e's lane dot and butterfly, so it stays bitwise the
# float32 instance on the widened operands; #10 bf16 keeps each column's
# chain in stream order. Both stay bitwise the earlier checkout's.

def _stream_bwd_case(stream, logits, mult, device):
    """#7 bf16's call on an item stream: the forward's outputs (#6 bf16)
    and a cotangent g, (args, sched, mult, long rows)."""
    args, sched, mu, long_rows = _stream_fwd_case(stream, logits, mult,
                                                  device)
    out, row_max, row_sum = segment_softmax.segment_softmax_spmm_fwd(
        *args, sched=sched, mult=mu)
    rng = np.random.default_rng(47)
    g = torch.from_numpy(rng.standard_normal(out.shape).astype(
        np.float32)).to(device)
    return args + (row_max, row_sum, out, g), sched, mu, long_rows


@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("logits", ["f32", "bf16"])
@pytest.mark.parametrize("stream", sorted(BF16_STREAMS))
def test_bf16_segment_softmax_bwd_item_streams(stream, logits, mult,
                                               cuda_device):
    """#7 bf16 on the item streams: two runs the same bits, bitwise the
    float32 instance on the widened operands, and within the backward
    kernels' tolerance (the float64 rule) of the plain version."""
    bargs, sched, mu, _ = _stream_bwd_case(stream, logits, mult,
                                           cuda_device)
    before = segment_softmax.bf16_bwd_launches
    got = _repeat_equal(lambda *a: segment_softmax.segment_softmax_spmm_bwd(
        *a, sched=sched, mult=mu), *bargs)
    assert segment_softmax.bf16_bwd_launches == before + 2
    wide = segment_softmax.segment_softmax_spmm_bwd(*_as_float(bargs),
                                                    sched=sched, mult=mu)
    plain = segment_softmax.segment_softmax_spmm_bwd_plain(*bargs, mult=mu)
    exact = segment_softmax.segment_softmax_spmm_bwd_plain(
        *_as_double(bargs), mult=None if mu is None else mu.double())
    for a, b, p, x in zip(got, wide, plain, exact):
        assert a.dtype == torch.float32
        assert torch.equal(a, b)
        _grad_rule(a, p, x)


@pytest.mark.parametrize("mult", [False, True])
@pytest.mark.parametrize("logits", ["f32", "bf16"])
@pytest.mark.parametrize("stream", sorted(BF16_STREAMS))
def test_bf16_segment_softmax_bwd_streams_bitwise_as_parent(
        stream, logits, mult, parent_ops, cuda_device):
    """#7 bf16 gives the earlier checkout's bits on the item streams. At
    D = 256-512 the earlier bf16 instance took the generic column layout,
    off its float32 instance's bits; there the new one gives the earlier
    checkout's float32 instance's bits on the widened operands."""
    bargs, sched, mu, _ = _stream_bwd_case(stream, logits, mult,
                                           cuda_device)
    new = segment_softmax.segment_softmax_spmm_bwd(*bargs, sched=sched,
                                                   mult=mu)
    old = parent_ops.segment_softmax.segment_softmax_spmm_bwd(
        *(_as_float(bargs) if stream in WIDE_STREAMS else bargs),
        sched=sched, mult=mu)
    torch.cuda.synchronize()
    for a, b in zip(new, old):
        assert torch.equal(a, b)


CSR_FORMS = ["unweighted", "f32", "bf16"]


def _stream_csr_case(stream, form, device):
    """#10 bf16's call on an item stream: (args, sched, long rows); the
    weights float32, or bf16 (each product rounded to bf16)."""
    src, ro, _, xs, long_rows = BF16_STREAMS[stream]()
    rng = np.random.default_rng(48)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    w = None
    if form != "unweighted":
        w = t(rng.random(len(src)).astype(np.float32))
        if form == "bf16":
            w = w.to(torch.bfloat16)
    args = (t(xs).to(torch.bfloat16), t(src), t(ro), w)
    return args, _stream_schedule(stream, ro, schedule.CSR_MAX_EDGES,
                                  schedule.CSR_CHUNK_EDGES, device), \
        long_rows


@pytest.mark.parametrize("form", CSR_FORMS)
@pytest.mark.parametrize("stream", sorted(BF16_STREAMS))
def test_bf16_csr_segment_sum_item_streams(stream, form, cuda_device):
    """#10 bf16 on the item streams, unweighted, with float32 weights and
    with bf16 weights: two runs the same bits, rows without edges 0, and
    within the float32 tolerances of the plain version (its long rows as
    trash rows: sums of hundreds of terms in another order)."""
    args, sched, long_rows = _stream_csr_case(stream, form, cuda_device)
    before = segment.csr_bf16_launches
    (got,) = _repeat_equal(lambda *a: (segment.csr_segment_sum(
        *a, sched=sched),), *args)
    assert segment.csr_bf16_launches == before + 2
    empty = torch.diff(args[2]) == 0
    assert (got[empty] == 0).all()
    _close_rows(got, segment.csr_segment_sum_plain(*args), long_rows)


@pytest.mark.parametrize("form", CSR_FORMS)
@pytest.mark.parametrize("stream", sorted(BF16_STREAMS))
def test_bf16_csr_segment_sum_streams_bitwise_as_parent(stream, form,
                                                        parent_ops,
                                                        cuda_device):
    """#10 bf16 gives the earlier checkout's bits on the item streams, in
    its three forms, chunked rows included."""
    args, sched, _ = _stream_csr_case(stream, form, cuda_device)
    new = segment.csr_segment_sum(*args, sched=sched)
    old = parent_ops.segment.csr_segment_sum(*args, sched=sched)
    torch.cuda.synchronize()
    assert torch.equal(new, old)


# ------------------------------------------------------ scanned dispatch

SCAN_S, SCAN_LR = 4, 1e-3


@pytest.fixture(scope="module")
def scan_world(cuda_device):
    g = make_synthetic_kg(n_snp=20_000, n_gene=2_000, n_go=1_200, seed=0)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    dims = [cg.node_x[t].shape[1]
            for t in ("SNP", "Gene", "BiologicalProcess")]
    n, n_pad = cg.num_nodes["SNP"], cg.padded_nodes["SNP"]
    rng = np.random.default_rng(2)
    y = np.zeros(n_pad, np.float32)
    w = np.zeros(n_pad, np.float32)
    y[:n] = rng.standard_normal(n) ** 2
    w[:n] = rng.random(n) + 0.5
    batches = rng.integers(0, n, (4 * SCAN_S, 512))
    x = {t: torch.from_numpy(v).to(cuda_device)
         for t, v in cg.node_x.items()}
    return SimpleNamespace(
        cg=cg, rel_types=rel_types, dims=dims, x=x,
        layouts=build_merged_layouts(cg, tile_rows=512), batches=batches,
        y=torch.from_numpy(y).to(cuda_device),
        w=torch.from_numpy(w).to(cuda_device))


def _scan_model(world, device, **kw):
    cfg = ModelConfig(gnn_hidden_dim=D, gnn_num_layers=2, no_relu=True, **kw)
    model = HeteroGNN(cfg, world.rel_types, *world.dims, seed=0).to(device)
    return model, device_layouts(world.layouts, device, world.cg,
                                 layer_paths(cfg))


def _state_equal(a, b):
    if isinstance(b, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(b, dict):
        return sorted(map(str, a)) == sorted(map(str, b)) and all(
            _state_equal(a[k], b[k]) for k in b)
    if isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(map(_state_equal, a, b))
    return a == b


def _eager_steps(model, opt, world, layouts, batches):
    from kgwas_tpu_torch.engine.loop import train_step

    dev = world.y.device
    return torch.stack([train_step(model, opt, world.x, layouts,
                                   torch.from_numpy(b).to(dev), world.y,
                                   world.w) for b in batches])


@pytest.mark.parametrize("kw", [{}, dict(gnn_aggr="max"),
                                dict(gnn_backbone="GCN")],
                         ids=["GAT-sum", "GAT-max", "GCN"])
def test_captured_block_bitwise_eager_steps(kw, cuda_device, scan_world):
    """Three blocks through TrainScan (the first eager, the graph
    captured at the second, replayed at the third) against the same
    3 S steps eager, from the same state: losses, parameters and Adam's
    state bitwise; the capture counts one block's launches."""
    from kgwas_tpu_torch.engine.loop import TrainScan
    from kgwas_tpu_torch.engine.optim import build_optimizer

    world = scan_world
    model, layouts = _scan_model(world, cuda_device, **kw)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    bm = world.batches[:3 * SCAN_S]
    opt = build_optimizer(model.parameters(), SCAN_LR, 5e-4)
    want = _eager_steps(model, opt, world, layouts, bm)
    want_state = ({k: v.clone() for k, v in model.state_dict().items()},
                  opt.state_dict())
    model.load_state_dict(init)
    opt = build_optimizer(model.parameters(), SCAN_LR, 5e-4)
    scan = TrainScan(model, opt, world.x, layouts, world.y, world.w, SCAN_S)
    got = [scan(bm[:SCAN_S])]
    before = (gat_layer.launches, segment_softmax.launches,
              segment.csr_launches, segment.launches)
    got += [scan(bm[SCAN_S:2 * SCAN_S])]
    per_block = [a - b for a, b in zip((
        gat_layer.launches, segment_softmax.launches, segment.csr_launches,
        segment.launches), before)]
    got += [scan(bm[2 * SCAN_S:])]
    torch.cuda.synchronize()
    assert (scan.captures, scan.replays) == (1, 2)
    assert sum(per_block) > 0 and all(v % SCAN_S == 0 for v in per_block)
    assert torch.equal(torch.cat(got), want)
    assert _state_equal(model.state_dict(), want_state[0])
    assert _state_equal(opt.state_dict(), want_state[1])


def test_capture_again_after_load_state_dict(cuda_device, scan_world):
    """The resume path: after load_state_dict of the model and the
    optimizer (new state tensors), reset() and the next block captures
    again and replays the restored state: the block's losses and the
    parameters after it are those the first time it ran from that state."""
    from kgwas_tpu_torch.engine.loop import TrainScan
    from kgwas_tpu_torch.engine.optim import build_optimizer

    world = scan_world
    model, layouts = _scan_model(world, cuda_device)
    opt = build_optimizer(model.parameters(), SCAN_LR, 5e-4)
    scan = TrainScan(model, opt, world.x, layouts, world.y, world.w, SCAN_S)
    b = world.batches
    scan(b[:SCAN_S])
    scan(b[SCAN_S:2 * SCAN_S])
    saved = ({k: v.clone() for k, v in model.state_dict().items()},
             copy_state(opt.state_dict()))
    first = scan(b[2 * SCAN_S:3 * SCAN_S])
    after = {k: v.clone() for k, v in model.state_dict().items()}
    scan(b[3 * SCAN_S:])
    model.load_state_dict(saved[0])
    opt.load_state_dict(saved[1])
    scan.reset()
    again = scan(b[2 * SCAN_S:3 * SCAN_S])
    torch.cuda.synchronize()
    assert scan.captures == 2
    assert torch.equal(again, first)
    assert _state_equal(model.state_dict(), after)


def copy_state(obj):
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    if isinstance(obj, dict):
        return {k: copy_state(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [copy_state(v) for v in obj]
    return obj


def test_scan_spans_on_the_card(cuda_device, scan_world):
    """TrainScan's spans (engine/profiling.span) under torch.profiler on
    the card: the eager block, the capture and each replay once a call,
    as often in the trace as in the span table, each annotation holding
    the table's seconds; no span opens inside the capture; with no
    profiler the replays still count."""
    from torch.profiler import ProfilerActivity, profile

    from kgwas_tpu_torch.engine.loop import TrainScan
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.engine.profiling import reset_spans, span_totals

    world = scan_world
    model, layouts = _scan_model(world, cuda_device)
    opt = build_optimizer(model.parameters(), SCAN_LR, 5e-4)
    scan = TrainScan(model, opt, world.x, layouts, world.y, world.w, SCAN_S)
    b = world.batches
    reset_spans()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for k in range(4):
            scan(b[k * SCAN_S:(k + 1) * SCAN_S])
        torch.cuda.synchronize()
    totals = span_totals()
    names = ("kgwas.scan.eager", "kgwas.scan.capture", "kgwas.scan.replay")
    assert [totals[n].count for n in names] == [1, 1, 3]
    ann = {}
    for e in prof.profiler.kineto_results.events():
        if (e.name().startswith("kgwas.")
                and e.device_type() == torch.autograd.DeviceType.CPU):
            ann.setdefault(e.name(), []).append(
                (e.start_ns(), e.start_ns() + e.duration_ns()))
    assert sorted(ann) == sorted(names)
    for n in names:
        assert len(ann[n]) == totals[n].count
        annotated = sum(e - s for s, e in ann[n]) / 1e9
        assert 0 <= annotated - totals[n].total_s < 2e-3 * totals[n].count
    (c0, c1), = ann["kgwas.scan.capture"]
    assert all(e <= c0 or s >= c1 for n in names if n != "kgwas.scan.capture"
               for s, e in ann[n])
    scan(b[:SCAN_S])
    torch.cuda.synchronize()
    assert span_totals()["kgwas.scan.replay"].count == 4
    reset_spans()


HOST_SYNC_CAPTURE = """
import sys
sys.path.insert(0, {root!r})
import torch
from kgwas_tpu_torch.engine import loop
from kgwas_tpu_torch.engine.loop import TrainScan
dev = torch.device("cuda")
lin = torch.nn.Linear(8, 1).to(dev)
opt = torch.optim.Adam(lin.parameters(), lr=1e-3, capturable=True)
x = torch.randn(64, 8, device=dev)
y = torch.randn(64, device=dev)
w = torch.ones(64, device=dev)


class Model(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = lin

    def forward(self, x, layouts, training=False, dropout_gen=None):
        out = self.lin(x)
        if float(out.sum()) > 1e30:   # a host sync inside the step
            out = out * 2
        return out


scan = TrainScan(Model(), opt, x, None, y, w, 2)
b = torch.arange(32).reshape(2, 16)
scan(b)   # eager: runs
try:
    scan(b)
except RuntimeError as e:
    print("RAISED", type(e).__name__, str(e)[:200])
    sys.exit(0)
print("NO RAISE", scan.captures, scan.replays)
sys.exit(1)
"""


def test_capture_with_a_host_sync_raises(cuda_device, tmp_path):
    """A step that reads a value on the host cannot be captured: the
    scanned call raises (no fallback to eager steps). In a child process,
    so that a broken capture cannot touch this one's CUDA context."""
    import subprocess

    script = tmp_path / "sync_capture.py"
    script.write_text(HOST_SYNC_CAPTURE.format(
        root=str(Path(__file__).resolve().parents[1])))
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "RAISED" in proc.stdout


class PlainBf16Adam(torch.optim.Optimizer):
    """The Bf16Adam that the capturable one replaced (engine/optim.py
    before scanned dispatch): the step read on the host and the bias
    corrections built there every step. The plain version of both
    Bf16Adam tests (tests/test_torch_scan.py imports it: this module
    imports no jax)."""

    def __init__(self, params, lr, weight_decay=0.0, betas=(0.9, 0.999),
                 eps=1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      betas=betas, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            dt = next((p.dtype for p in group["params"]), torch.float32)

            def c(v):
                return torch.tensor(v, dtype=torch.float32).to(dt)

            c_wd, c_lr, c_eps = c(wd), c(-lr), c(eps)
            c1, c2, c3, c4 = c(1 - b1), c(b1), c(1 - b2), c(b2)
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = int(st["step"])
                g = p.grad.to(p.dtype)
                if wd:
                    g = g + c_wd * p
                mu = c1 * g + c2 * st["exp_avg"]
                nu = c3 * (g * g) + c4 * st["exp_avg_sq"]
                st["exp_avg"], st["exp_avg_sq"] = mu, nu
                bc1 = c(float(np.float32(1) - np.float32(b1) ** np.float32(t)))
                bc2 = c(float(np.float32(1) - np.float32(b2) ** np.float32(t)))
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + c_eps)
                p.copy_(p + c_lr * u)


def test_bf16_adam_on_the_card_bitwise_the_host_stepped_one(cuda_device):
    """The capturable Bf16Adam (device step, bias tables; on the card a
    product with the bias correction's float32 reciprocal, as CUDA divides
    by a CPU scalar) against the Bf16Adam it replaced, 300 steps."""
    from kgwas_tpu_torch.engine.optim import Bf16Adam

    gen = torch.Generator(device=cuda_device).manual_seed(3)
    shapes = [(256, 128), (128,), (7, 3)]
    a = [(torch.randn(s, generator=gen, device=cuda_device) * 0.3).to(
        torch.bfloat16) for s in shapes]
    b = [p.clone() for p in a]
    plain, opt = PlainBf16Adam(a, 1e-2, 5e-4), Bf16Adam(b, 1e-2, 5e-4)
    for _ in range(300):
        for pa, pb in zip(a, b):
            g = (torch.randn(pa.shape, generator=gen, device=cuda_device)
                 * 0.1).to(torch.bfloat16)
            pa.grad, pb.grad = g, g.clone()
        plain.step()
        opt.step()
    for pa, pb in zip(a, b):
        assert torch.equal(pa.view(torch.int16), pb.view(torch.int16))


# ------------------------------------ the mesh's rank blocks (relation_shard)

def _single_stream(src, row_offsets, key, n_src, device, sched_args=()):
    """A stream of its own on the card, built from its host arrays as
    device_layouts builds a relation's: src, row_offsets, each edge's source
    row as the CSC gives it (key), the rows' schedule and the CSC fields."""
    put = lambda a: torch.from_numpy(np.ascontiguousarray(  # noqa: E731
        a, dtype=np.int32)).to(device)
    n_rows = len(row_offsets) - 1
    dst = np.repeat(np.arange(n_rows), np.diff(row_offsets))
    perm = np.argsort(key, kind="stable")
    off = np.zeros(n_src + 1, np.int64)
    np.cumsum(np.bincount(key, minlength=n_src), out=off[1:])
    return SimpleNamespace(
        src=put(src), row_offsets=put(row_offsets), dst=put(dst),
        csc_perm=put(perm), csc_offsets=put(off), n_rows_per_rel=n_rows,
        src_base=(0, n_src),
        row_schedule=schedule.row_schedule(
            np.asarray(row_offsets, np.int32), *sched_args).to(device),
        **segment.csc_fields(dst, perm, off, n_rows, (0, n_src), 0, device))


def _edge_keys(csc_perm, csc_ids):
    key = np.empty(len(csc_perm), np.int64)
    key[np.asarray(csc_perm, np.int64)] = csc_ids
    return key


def _equal(got, want):
    for a, b in zip(got, want):
        assert a is None and b is None or torch.equal(a, b)


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_rank_relation_blocks_bitwise_as_single_streams(n_dev, cuda_device,
                                                        variant_world):
    """#6, #7 and #8 on each rank's block of a relation stream
    (relation_shard.relation_rank_stream; the SNP rows, 6 tiles, in blocks
    that do not divide by 4) bitwise the same kernels on the block built as
    a stream of its own; the ranks' rows against the unsharded kernel on
    the whole stream within the tolerances above."""
    from kgwas_tpu_torch.parallel.relation_shard import relation_rank_stream

    cg, rel, _ = variant_world
    rk = "Gene__rev_TSS__SNP"
    r = cg.relations[rk]
    L = rel[r.dst_type]
    RL = L.relations[L.rel_keys.index(rk)]
    gen = torch.Generator(device=cuda_device).manual_seed(21)
    xs = torch.randn(RL.src_base[-1], D, device=cuda_device, generator=gen)
    lg = torch.randn(RL.src.shape[0], device=cuda_device, generator=gen)
    g = torch.randn(RL.n_rows_per_rel, D, device=cuda_device, generator=gen)
    want = segment_softmax.segment_softmax_spmm_fwd(
        xs, RL.src, lg, RL.row_offsets, sched=RL.row_schedule)[0]
    key = _edge_keys(r.csc_perm, r.csc_src_sorted)
    ss, outs = segment_softmax, []
    for i in range(n_dev):
        rs = relation_rank_stream(r, cg, n_dev, i, cuda_device)
        assert not rs.empty
        (r0, r1), (e0, e1) = rs.rows, rs.edges
        one = _single_stream(r.src[e0:e1], r.row_offsets[r0:r1 + 1] - e0,
                             key[e0:e1], RL.src_base[-1], cuda_device)
        lr = lg[e0:e1].contiguous()
        before = (ss.launches, ss.bwd_launches, segment.launches)
        got = [], []
        for k, lay in enumerate((rs.layout, one)):
            f = ss.segment_softmax_spmm_fwd(xs, lay.src, lr, lay.row_offsets,
                                            sched=lay.row_schedule)
            b = ss.segment_softmax_spmm_bwd(
                xs, lay.src, lr, lay.row_offsets, f[1], f[2], f[0],
                g[r0:r1], sched=lay.row_schedule)
            c = segment.csc_segment_sum(g[r0:r1], b[0], None, xs, None, lay)
            got[k].extend(f + b + c)
        assert (ss.launches, ss.bwd_launches, segment.launches) == (
            before[0] + 2, before[1] + 2, before[2] + 2)
        _equal(got[0], got[1])
        assert got[0][0].shape[0] == r1 - r0
        outs.append(got[0][0])
    _close(torch.cat(outs), want, RL.n_rows_per_rel, cg.num_nodes["SNP"])


@pytest.mark.parametrize("n_dev", [2, 3, 4])
def test_rank_mp_blocks_bitwise_as_single_streams(n_dev, cuda_device,
                                                  variant_world):
    """#10 (weighted by the symmetric norm) and #8 on each rank's block of
    the SNP group's merged 'mp' stream (relation_shard.mp_rank_stream)
    bitwise the same kernels on the block built as a stream of its own
    (CSR_MAX_EDGES schedule); the ranks' rows against the unsharded #10
    within the tolerances above."""
    from kgwas_tpu_torch.graph import build_merged_layouts as bml
    from kgwas_tpu_torch.parallel.relation_shard import mp_rank_stream

    cg, _, mp = variant_world
    L = bml(cg, tile_rows=512)["SNP"]
    DL = mp["SNP"]
    gen = torch.Generator(device=cuda_device).manual_seed(22)
    xs = torch.randn(L.n_src_total, D, device=cuda_device, generator=gen)
    g = torch.randn(L.n_rows_total, D, device=cuda_device, generator=gen)
    want = segment.csr_segment_sum(xs, DL.src, DL.row_offsets, DL.sym_e,
                                   sched=DL.row_schedule)
    key = _edge_keys(L.csc_perm, L.csc_ids)
    outs = []
    for i in range(n_dev):
        rs = mp_rank_stream(L, n_dev, i, cuda_device)
        (r0, r1), (e0, e1) = rs.rows, rs.edges
        one = _single_stream(L.src[e0:e1], L.row_offsets[r0:r1 + 1] - e0,
                             key[e0:e1], L.n_src_total, cuda_device,
                             (schedule.CSR_MAX_EDGES,
                              schedule.CSR_CHUNK_EDGES))
        w = rs.layout.sym_e
        before = (segment.csr_launches, segment.launches)
        got = [], []
        for k, lay in enumerate((rs.layout, one)):
            got[k].append(segment.csr_segment_sum(
                xs, lay.src, lay.row_offsets, w, sched=lay.row_schedule))
            got[k].extend(segment.csc_segment_sum(g[r0:r1], w, None, xs,
                                                  None, lay))
        assert (segment.csr_launches, segment.launches) == (
            before[0] + 2, before[1] + 2)
        _equal(got[0], got[1])
        outs.append(got[0][0])
    _close(torch.cat(outs), want, L.n_rows_per_rel, cg.num_nodes["SNP"])


@pytest.mark.parametrize("mode", ["softmax", "sigmoid"])
def test_sharded_merged_gat_uneven_blocks_match_unsharded(mode, cuda_device,
                                                          variant_world):
    """The merged GAT layer over the SNP group's row tiles in blocks that
    differ (4 ranks, or 5 where 4 divide them; merged_shard.
    ShardedMergedGAT, no process
    group, each rank given the whole table): #1, #2 and #8 once a rank, the
    ranks' rows against the unsharded layer (fold 0) within the tolerances
    above, the summed d_xs at the backward kernels' bounds."""
    from kgwas_tpu_torch.graph import build_merged_layouts as bml
    from kgwas_tpu_torch.parallel import merged_shard

    cg = variant_world[0]
    L = bml(cg, tile_rows=512)["SNP"]
    n_dev = 4 if (L.n_rows_total // 512) % 4 else 5
    R, n = len(L.rel_keys), L.n_rows_per_rel
    DL = _merged_layout(L, False, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(23)
    xs = torch.randn(L.n_src_total, D, device=cuda_device, generator=gen) * .1
    att = torch.randn(R, D, device=cuda_device, generator=gen) * .2
    ad = torch.randn(L.n_rows_total, device=cuda_device, generator=gen) * .5
    g = torch.randn(L.n_rows_total, D, device=cuda_device, generator=gen)
    leaf = xs.clone().requires_grad_()
    want = gat_layer.MergedGATLayer.apply(leaf, att, ad, DL, 0, mode, 0.2,
                                          1.0)
    want.backward(g)
    dls = merged_shard.build_device_layouts(L, n_dev)
    assert len(set(np.diff(dls.row_bounds))) > 1
    outs, d_xs = [], 0.0
    before = (gat_layer.launches, gat_layer.bwd_launches, segment.launches)
    for i in range(n_dev):
        shard = merged_shard.RankShard(L, dls, i, cuda_device)
        x = xs.clone().requires_grad_()
        out = merged_shard.ShardedMergedGAT.apply(x, att, ad, shard, None,
                                                  mode, 0.2, 1.0)
        out.backward(g[shard.row0:shard.row0 + shard.rows_per_dev])
        outs.append(out.detach())
        d_xs = d_xs + x.grad
    assert (gat_layer.launches, gat_layer.bwd_launches,
            segment.launches) == tuple(b + n_dev for b in before)
    _close(torch.cat(outs), want.detach(), n, cg.num_nodes["SNP"])
    _close_grad(d_xs, leaf.grad)


# ------------------- dst-range sub-layouts (KGWAS_MERGED_MAX_EDGES)

# Gene in 2 sub-layouts, SNP in 4, on the 20k-SNP KG
SPLIT_CAP = "Gene:100000,SNP:30000"


@pytest.fixture(scope="module")
def split_world(cuda_device):
    g = make_synthetic_kg(n_snp=20_000, n_gene=2_000, n_go=1_200, seed=0)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    whole = build_merged_layouts(cg, tile_rows=512)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("KGWAS_MERGED_MAX_EDGES", SPLIT_CAP)
        split = build_merged_layouts(cg, tile_rows=512)
    subs = {t: L for t, L in split.items() if L.base_type is not None}
    assert sorted(subs) == ["Gene@0", "Gene@1", "SNP@0", "SNP@1", "SNP@2",
                            "SNP@3"]
    return cg, whole, split, subs


def _sub_trash_mask(L, n_real, n_out):
    """The rows of a sub-layout's output of n_out rows (N, or R * N: one
    block of N a slot) that are its group's trash row, where the
    sub-layout holds it."""
    mask = np.zeros(n_out, dtype=bool)
    local = n_real - L.node_base
    if 0 <= local < L.n_rows_per_rel:
        mask[local::L.n_rows_per_rel] = True
    return mask


def test_layer_kernels_on_every_sub_layout_match_plain(cuda_device,
                                                       split_world):
    """#1 (fold R and 0), #2 and #8 (the merged layer's backward) and #10
    (the 'mp' forward, with and without weights) on each sub-layout's
    stream, which reads the whole group's source table: two runs the same
    bits, against the plain versions (forward rtol 1e-5, atol 1e-5, the
    trash row rtol 1e-4; gradients as above; #10 by the float64 rule)."""
    cg, _, split, subs = split_world
    dls = device_layouts(split, cuda_device, cg, ("merged", "mp"))
    rng = np.random.default_rng(31)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    for key, L in subs.items():
        DL, R = dls[key], len(L.rel_keys)
        n_real = cg.num_nodes[L.base_type]
        xs = t((rng.standard_normal((L.n_src_total, D)) * 0.1
                ).astype(np.float32))
        att = t((rng.standard_normal((R, D)) * 0.2).astype(np.float32))
        a_dst = t((rng.standard_normal(L.n_rows_total) * 0.5
                   ).astype(np.float32))
        for fold in (R, 0):
            args = (xs, DL.src, DL.row_offsets, att, a_dst,
                    L.n_rows_per_rel, fold, "softmax", 0.2, 1.0)
            sched = gat_layer.layout_schedule(DL, fold)
            before = gat_layer.launches
            got = _repeat_equal(lambda *a: gat_layer.merged_gat_forward(
                *a, sched=sched), *args)
            assert gat_layer.launches == before + 2
            want = gat_layer.merged_gat_forward_plain(*args)
            for g_, w_ in zip(got, want):
                g_, w_ = g_.cpu().numpy(), w_.cpu().numpy()
                mask = _sub_trash_mask(L, n_real, len(g_))
                np.testing.assert_allclose(g_[~mask], w_[~mask], rtol=1e-5,
                                           atol=1e-5, err_msg=key)
                np.testing.assert_allclose(g_[mask], w_[mask], rtol=1e-4,
                                           atol=1e-5, err_msg=key)
        _, row_max, row_sum = gat_layer.merged_gat_forward(
            xs, DL.src, DL.row_offsets, att, a_dst, L.n_rows_per_rel, R,
            "softmax", 0.2, 1.0, sched=DL.gat_schedule)
        g = t(rng.standard_normal((L.n_rows_per_rel, D)).astype(np.float32))
        bargs = (xs, DL.src, DL.row_offsets, att, a_dst, row_max, row_sum, g,
                 L.n_rows_per_rel, R, "softmax", 0.2, 1.0)
        before = (gat_layer.bwd_launches, segment.launches)
        edge = _repeat_equal(lambda *a: gat_layer.merged_gat_bwd(
            *a, sched=DL.gat_bwd_schedule), *bargs)
        sums = _repeat_equal(lambda: segment.csc_segment_sum(
            g, edge[0], edge[1], xs, att, DL, R))
        assert (gat_layer.bwd_launches, segment.launches) == (
            before[0] + 2, before[1] + 2)
        for got_, want_ in zip(edge + sums,
                               gat_layer.merged_gat_bwd_plain(*bargs)
                               + segment.csc_segment_sum_plain(
                                   g, edge[0], edge[1], xs, att, DL, R)):
            _close_grad(got_, want_)
        for weighted in (False, True):
            cargs = (xs, DL.src, DL.row_offsets,
                     DL.sym_e if weighted else None)
            before = segment.csr_launches
            (got_,) = _repeat_equal(lambda *a: (segment.csr_segment_sum(
                *a, sched=DL.row_schedule),), *cargs)
            assert segment.csr_launches == before + 2
            _grad_rule(got_, segment.csr_segment_sum_plain(*cargs),
                       segment.csr_segment_sum_plain(*_as_double(cargs)))


@pytest.mark.parametrize("backbone", ["GAT", "SAGE", "GCN"])
def test_split_forward_and_step_match_unsplit(backbone, cuda_device,
                                              split_world):
    """The model's forward and one step's gradients on the sub-layouts
    against the unsplit layouts (forward rtol 1e-5, atol 1e-5; gradients
    at rtol 1e-4 with a floor of 1e-5 of each array's largest entry and
    1e-8 of the largest gradient: att_dst's cancels to noise), #1 / #10
    launched once per live sub-layout and layer; two split runs bitwise."""
    cg, whole, split, _ = split_world
    cfg = ModelConfig(gnn_hidden_dim=D, gnn_num_layers=2, no_relu=True,
                      gnn_backbone=backbone)
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    dims = [cg.node_x[t].shape[1] for t in ("SNP", "Gene",
                                              "BiologicalProcess")]
    x = {t: torch.from_numpy(v).to(cuda_device) for t, v in cg.node_x.items()}
    n = cg.num_nodes["SNP"]
    batch = torch.arange(0, n, 37, device=cuda_device)[:512]
    y = torch.rand(cg.padded_nodes["SNP"], device=cuda_device)

    def run(layouts):
        model = HeteroGNN(cfg, rel_types, *dims, seed=0).to(cuda_device)
        dl = device_layouts(layouts, cuda_device, cg, layer_paths(cfg))
        counts = (gat_layer.launches, segment.csr_launches)
        pred = model(x, dl, training=True)
        launched = (gat_layer.launches - counts[0],
                    segment.csr_launches - counts[1])
        ((pred[batch, 0] - y[batch]) ** 2).mean().backward()
        torch.cuda.synchronize()
        grads = {k: p.grad for k, p in model.named_parameters()
                 if p.grad is not None}
        live = model.live_groups(dl)[0]
        return pred.detach(), grads, launched, sum(len(g) for g in live)

    want, wgrads, _, _ = run(whole)
    got, grads, launched, n_live = run(split)
    again, grads2, _, _ = run(split)
    assert n_live == (10 if backbone != "GCN" else 6)   # 6 + 4; GCN: 2 + 4
    assert launched == ((n_live, 0) if backbone == "GAT" else (0, n_live))
    assert torch.equal(got, again)
    assert all(torch.equal(grads[k], grads2[k]) for k in grads)
    np.testing.assert_allclose(got[:n].cpu().numpy(), want[:n].cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert sorted(grads) == sorted(wgrads)
    top = max(float(v.abs().max()) for v in wgrads.values())
    for k, v in wgrads.items():
        w_ = v.cpu().numpy()
        np.testing.assert_allclose(
            grads[k].cpu().numpy(), w_, rtol=1e-4,
            atol=1e-5 * np.abs(w_).max() + 1e-8 * top, err_msg=k)


# ------------------------------------------------- the calibration protocol

def test_calibration_seed_launches(cuda_device, tmp_path):
    """One causal seed of the calibration protocol
    (scripts/run_calibration.run_seed) at 2,000 SNPs, GAT sum at hidden
    128, batch 64, 2 epochs, through the kernels: #1, #2 and #8 launched
    as the epochs and forwards imply with KGWAS.train's scan_steps=8 (the
    run's first block eager, the second captured and counted once, the
    later blocks replayed uncounted, each epoch's tail eager), 3 a
    forward or step (the live groups), and the JAX runner's keys."""
    from kgwas_tpu_torch.scripts import run_calibration

    args = SimpleNamespace(n_snp=2000, hidden=D, batch_size=64, epochs=2,
                           cpu=False)
    data = run_calibration.calibration_kg(2000, str(tmp_path))
    gat_layer.launches = gat_layer.bwd_launches = segment.launches = 0
    out = run_calibration.run_seed(data, {}, "causal", 1, args)
    counts = (gat_layer.launches, gat_layer.bwd_launches, segment.launches)
    steps = len(data.train_mask) // args.batch_size
    assert steps > 8 and steps % 8
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    counted = chip_smoke.scan_counted_steps(steps, args.epochs)
    # a step's forward and backward, each epoch's forward, the test's
    assert counts == (3 * (counted + args.epochs + 1), 3 * counted,
                      3 * counted)
    assert set(out) == {"arm", "seed", "gwas_hits", "kgwas_hits",
                        "gwas_loci", "kgwas_loci", "scale_factor",
                        "gwas_true_pos", "gwas_false_pos", "kgwas_true_pos",
                        "kgwas_false_pos", "n_causal", "wall_s"}
    assert 0 <= out["kgwas_hits"] <= 2000 and out["n_causal"] == 100
