"""The CUDA kernels of the port against their plain PyTorch versions, on the
card. Marked gpu: without a card each test skips.

This file imports torch and the port only (no jax), so it also runs on a
card's machine that has no JAX installed:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Tolerance rtol 1e-5, atol 1e-5 (float32, another summation order); each
relation's trash row, which sums up to 511 pad edges, at rtol 1e-4. The
backward kernels' gradients at rtol 1e-4 with an absolute floor of 1e-5 of
each array's largest entry: random cotangents make every row, trash rows
included, a sum of up to 511 terms, and the softmax mode's (m_e - dot_row)
cancels.

The model-variant kernels (segment_softmax_spmm_fwd / _bwd on one
relation's stream, csr_segment_sum and the CSC sum without logit term on a
merged group's) are held the same way, and two launches give the same
bits. The merged GAT kernels run on their static schedule with the default
max_edges and with max_edges = 8, where real rows are cut into chunks too,
and on a stream with a hub node of several thousand edges across its slots.
The segment softmax forward and the CSC sum run on their schedules too, on
a stream with long rows, a hub row, empty rows and a trash row of identical
pad edges, at the default max_edges and at 8, and the CSC sum in each of
its four call forms (the merged GAT layer's, the per-relation GAT's, and
the message-passing backward with and without weights). With
KGWAS_PARENT_CSRC set to an earlier checkout's ``kgwas_tpu_torch/ops/csrc``,
the CSC sum (with logit term) is also held bitwise against that source's
kernel on every source row it does not cut into chunks (the chunked rows
and d_att, whose partials now follow the items, by the float64 rule of
chip_smoke.py), and the merged GAT and segment softmax forward kernels
within the tolerances above.
"""
import ctypes
import dataclasses
import os
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.models.hetero_gnn import device_layouts
from kgwas_tpu_torch.ops import build, gat_layer, segment, segment_softmax

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
        sched = segment_softmax.row_schedule(ro, max_edges, max_edges)
        assert sched.n_parts > 100
        sched = sched.to(cuda_device)
    else:
        split = segment_softmax.row_schedule(ro).split_units.tolist()
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


# the earlier checkout's one-warp-per-row segment kernels: their C entry
# points (the merged GAT kernels have this checkout's)
_PARENT_CSC_ARGS = ([ctypes.c_void_p] * 8
                    + [ctypes.POINTER(ctypes.c_longlong)]
                    + [ctypes.c_void_p] * 3
                    + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p])
_PARENT_SEG_FWD_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_void_p]


def _grad_rule(got, plain, exact):
    """chip_smoke.py's backward rule: got's max abs error against the
    float64 plain version at most 8 times the float32 plain version's plus
    1e-6 of the largest value."""
    k_err = float((got.double() - exact).abs().max())
    p_err = float((plain.double() - exact).abs().max())
    assert k_err <= 8 * p_err + 1e-6 * float(exact.abs().max())


@pytest.mark.parametrize("fold", [False, True])
def test_csc_segment_sum_logit_path_bitwise_as_parent(fold, parent_csrc,
                                                      cuda_device, group):
    """The merged GAT layer's call (w, dz, att) gives the same bits as the
    kernel built from the earlier source on every source row that the
    schedule does not cut into chunks; the chunked rows (each slot's trash
    source row) and d_att, whose partials now follow the items, are held
    to the float64 plain version by the backward rule."""
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
    new = segment.csc_segment_sum(g, w, dz, xs, att, DL, fold)
    fn = build.build_source(parent_csrc / "csc_segment_sum.cu",
                            "parent_csc_segment_sum", "kgwas_csc_segment_sum",
                            _PARENT_CSC_ARGS)
    old = torch.empty_like(xs)
    old_att = torch.empty_like(att)
    partial = torch.empty(DL.src_base[-1] // 64, D, device=cuda_device)
    bases = (ctypes.c_longlong * (R + 1))(*DL.src_base)
    assert fn(g.data_ptr(), w.data_ptr(), dz.data_ptr(), xs.data_ptr(),
              att.data_ptr(), DL.dst.data_ptr(), DL.csc_perm.data_ptr(),
              DL.csc_offsets.data_ptr(), bases, old.data_ptr(),
              old_att.data_ptr(), partial.data_ptr(), R, DL.n_rows_per_rel,
              int(bool(fold)), D, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    chunked = DL.csc_schedule.split_units.long()
    assert chunked.numel() > 0
    whole = torch.ones(xs.shape[0], dtype=torch.bool, device=cuda_device)
    whole[chunked] = False
    assert torch.equal(new[0][whole], old[whole])
    args = (g, w, dz, xs, att, DL, fold)
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
def test_segment_softmax_fwd_matches_parent(rk, parent_csrc, cuda_device,
                                            variant_world):
    """The scheduled forward against the earlier one-warp-per-row kernel on
    one relation's stream, within the kernel-vs-plain tolerances."""
    cg, rel, _ = variant_world
    r = cg.relations[rk]
    L = rel[r.dst_type]
    RL = L.relations[L.rel_keys.index(rk)]
    rng = np.random.default_rng(14)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(cuda_device)  # noqa: E731
    xs = t(rng.standard_normal((RL.src_base[-1], D)) * 0.1)
    logits = t(rng.standard_normal(RL.src.shape[0]) * 1.5)
    new = segment_softmax.segment_softmax_spmm_fwd(
        xs, RL.src, logits, RL.row_offsets, sched=RL.row_schedule)
    fn = build.build_source(parent_csrc / "segment_softmax_spmm_fwd.cu",
                            "parent_segment_softmax_spmm_fwd",
                            "kgwas_segment_softmax_spmm_fwd",
                            _PARENT_SEG_FWD_ARGS)
    n_rows = RL.row_offsets.shape[0] - 1
    old = (torch.empty(n_rows, D, device=cuda_device),
           torch.empty(n_rows, device=cuda_device),
           torch.empty(n_rows, device=cuda_device))
    assert fn(xs.data_ptr(), RL.src.data_ptr(), logits.data_ptr(),
              RL.row_offsets.data_ptr(), *(o.data_ptr() for o in old),
              n_rows, D, torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    for a, b in zip(new, old):
        _close(a, b, RL.n_rows_per_rel, cg.num_nodes[r.dst_type])
