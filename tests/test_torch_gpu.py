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
With KGWAS_PARENT_CSRC set to an earlier checkout's
``kgwas_tpu_torch/ops/csrc``, the merged GAT layer's CSC sum (with logit
term) is also held bitwise against that source's kernel, and the merged GAT
forward and backward within the tolerances above (the redesigned kernels
sum in another order).
"""
import ctypes
import os
from pathlib import Path

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
    DL = device_layouts({"Gene": L}, cuda_device)["Gene"]
    fold = len(L.rel_keys) if fold else 0
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


@pytest.fixture
def parent_csrc():
    d = os.environ.get("KGWAS_PARENT_CSRC")
    if not d:
        pytest.skip("set KGWAS_PARENT_CSRC to an earlier checkout's "
                    "kgwas_tpu_torch/ops/csrc")
    return Path(d)


@pytest.mark.parametrize("fold", [False, True])
def test_csc_segment_sum_logit_path_bitwise_as_parent(fold, parent_csrc,
                                                      cuda_device, group,
                                                      monkeypatch):
    """The merged GAT layer's call (w, dz, att) gives the same bits as the
    kernel built from the earlier source."""
    L, _ = group
    DL = device_layouts({"Gene": L}, cuda_device)["Gene"]
    R = len(L.rel_keys)
    fold = R if fold else 0
    xs, att, _, g = _bwd_inputs(L, fold, D, cuda_device)
    rng = np.random.default_rng(12)
    e = DL.src.shape[0]
    w = torch.from_numpy(rng.random(e, dtype=np.float32)).to(cuda_device)
    dz = torch.from_numpy(rng.standard_normal(e).astype(np.float32)).to(
        cuda_device)
    new = segment.csc_segment_sum(g, w, dz, xs, att, DL, fold)
    fn = build.build_source(parent_csrc / "csc_segment_sum.cu",
                            "parent_csc_segment_sum", "kgwas_csc_segment_sum",
                            build.KERNELS["csc_segment_sum"][2])
    monkeypatch.setitem(build._loaded, "csc_segment_sum", fn)
    old = segment.csc_segment_sum(g, w, dz, xs, att, DL, fold)
    torch.cuda.synchronize()
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])


# the merged GAT kernels of an earlier checkout: its C entry points (one
# warp per output row, no schedule)
_PARENT_FWD_ARGS = ([ctypes.c_void_p] * 8 + [ctypes.c_longlong] * 2
                    + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                    + [ctypes.c_void_p])
_PARENT_BWD_ARGS = ([ctypes.c_void_p] * 11 + [ctypes.c_longlong] * 2
                    + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                    + [ctypes.c_void_p])


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_merged_gat_kernels_match_parent(mode, fold, parent_csrc,
                                         cuda_device, group):
    """The redesigned kernels against the earlier source's on the same
    inputs, within the kernel-vs-plain tolerances: the sums run in another
    order, so not bitwise."""
    L, trash = group
    R = len(L.rel_keys)
    fold = R if fold else 0
    n = L.n_rows_per_rel
    xs, att, a_dst, g = _bwd_inputs(L, fold, D, cuda_device)
    src = torch.from_numpy(L.src).to(cuda_device)
    ro = torch.from_numpy(L.row_offsets).to(cuda_device)
    fwd = build.build_source(parent_csrc / "merged_gat_fwd.cu",
                             "parent_merged_gat_fwd", "kgwas_merged_gat_fwd",
                             _PARENT_FWD_ARGS)
    bwd = build.build_source(parent_csrc / "merged_gat_bwd.cu",
                             "parent_merged_gat_bwd", "kgwas_merged_gat_bwd",
                             _PARENT_BWD_ARGS)
    n_out = n if fold else L.n_rows_total
    mode_i = gat_layer.MODES.index(mode)
    f = R if fold else 1
    stream = torch.cuda.current_stream().cuda_stream
    new = gat_layer.merged_gat_forward(xs, src, ro, att, a_dst, n, fold, mode,
                                       0.2, 0.7)
    old = (torch.empty(n_out, D, device=cuda_device),
           torch.empty(L.n_rows_total, device=cuda_device),
           torch.empty(L.n_rows_total, device=cuda_device))
    assert fwd(xs.data_ptr(), src.data_ptr(), ro.data_ptr(), att.data_ptr(),
               a_dst.data_ptr(), *(o.data_ptr() for o in old), n_out, n, f,
               D, mode_i, 0.2, 0.7, stream) == 0
    for a, b in zip(new, old):
        _close(a, b, n, trash)
    e = src.shape[0]
    bargs = (xs, src, ro, att, a_dst, new[1], new[2], g)
    new_b = gat_layer.merged_gat_bwd(*bargs, n, fold, mode, 0.2, 0.7)
    old_b = (torch.empty(e, device=cuda_device),
             torch.empty(e, device=cuda_device),
             torch.empty(L.n_rows_total, device=cuda_device))
    assert bwd(*(a.data_ptr() for a in bargs), *(o.data_ptr() for o in old_b),
               n_out, n, f, D, mode_i, 0.2, 0.7, stream) == 0
    torch.cuda.synchronize()
    for a, b in zip(new_b, old_b):
        _close_grad(a, b)
