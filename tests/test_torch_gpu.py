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
"""
import numpy as np
import pytest
import torch

from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.models.hetero_gnn import device_layouts
from kgwas_tpu_torch.ops import gat_layer, segment

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
