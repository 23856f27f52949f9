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
bits. With KGWAS_PARENT_CSRC set to an earlier checkout's
``kgwas_tpu_torch/ops/csrc``, the merged GAT layer's CSC sum (with logit
term) is also held bitwise against that source's kernel.
"""
import ctypes
import os
import subprocess
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


@pytest.mark.parametrize("d", [D, 48])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_kernel_matches_plain(mode, fold, d, cuda_device, group):
    L, trash = group
    rng = np.random.default_rng(2)
    R = len(L.rel_keys)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)  # noqa: E731
    args = (t((rng.standard_normal((L.n_src_total, d)) * 0.1).astype(np.float32)),
            t(L.src), t(L.row_offsets),
            t((rng.standard_normal((R, d)) * 0.2).astype(np.float32)),
            t((rng.standard_normal(L.n_rows_total) * 0.5).astype(np.float32)),
            L.n_rows_per_rel, R if fold else 0, mode, 0.2, 0.7)
    before = gat_layer.launches
    got = gat_layer.merged_gat_forward(*args)
    again = gat_layer.merged_gat_forward(*args)
    torch.cuda.synchronize()
    assert gat_layer.launches == before + 2
    want = gat_layer.merged_gat_forward_plain(*args)
    for g_, a_, w_ in zip(got, again, want):
        assert torch.equal(g_, a_)   # one warp per row: the same bits
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


@pytest.mark.parametrize("d", [D, 48])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_backward_kernels_match_plain(mode, fold, d, cuda_device, group):
    L, _ = group
    DL = device_layouts({"Gene": L}, cuda_device)["Gene"]
    fold = len(L.rel_keys) if fold else 0
    xs, att, a_dst, g = _bwd_inputs(L, fold, d, cuda_device)
    _, row_max, row_sum = gat_layer.merged_gat_forward(
        xs, DL.src, DL.row_offsets, att, a_dst, DL.n_rows_per_rel, fold, mode,
        0.2, 0.7)
    args = (xs, DL.src, DL.row_offsets, att, a_dst, row_max, row_sum, g,
            DL.n_rows_per_rel, fold, mode, 0.2, 0.7)
    before = (gat_layer.bwd_launches, segment.launches)
    edge = gat_layer.merged_gat_bwd(*args)
    again = gat_layer.merged_gat_bwd(*args)
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
                                                      tmp_path, monkeypatch):
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
    lib = tmp_path / "libparent_csc_segment_sum.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(parent_csrc / "csc_segment_sum.cu")], check=True,
                   capture_output=True)
    fn = ctypes.CDLL(str(lib)).kgwas_csc_segment_sum
    fn.argtypes = build.KERNELS["csc_segment_sum"][2]
    fn.restype = ctypes.c_int
    monkeypatch.setitem(build._loaded, "csc_segment_sum", fn)
    old = segment.csc_segment_sum(g, w, dz, xs, att, DL, fold)
    torch.cuda.synchronize()
    assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])
