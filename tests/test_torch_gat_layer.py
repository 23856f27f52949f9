"""The port's merged GAT layer op against the JAX package's fused Pallas op.

One tiny merged layout (the Gene group of a small synthetic KG, six
relations, D = 128) and seeded numpy inputs go through
``kgwas_tpu.ops.pallas_gat_layer`` (Pallas interpret mode on the CPU) and
``kgwas_tpu_torch.ops.gat_layer.merged_gat_forward_plain``, for the
softmax, sigmoid and raw modes with the cross-relation fold on and off.
Tolerance rtol 1e-5, atol 1e-6: float32 on both sides, different summation
orders. The trash rows are held at rtol 1e-4: each sums every pad edge of
its relation (up to 511 terms), and float32 rounding grows with the number
of terms summed in another order. The CUDA kernel is held against the
plain version on the card in tests/test_torch_gpu.py.
"""
import numpy as np
import pytest
import torch

from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg
from kgwas_tpu.graph.merged_layout import build_merged_layouts as jax_build
from kgwas_tpu.ops import pallas_gat_layer as P

from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.ops import gat_layer
from torch_threads import few_torch_threads  # noqa: F401,E402

D = 128
SLOPE = 0.2
TEMP = 0.7
RTOL, ATOL = 1e-5, 1e-6
TRASH_RTOL = 1e-4


def _layout(dst_type="Gene", seed=3):
    g = make_synthetic_kg(n_snp=300, n_gene=70, n_go=40, seed=seed)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    L = build_merged_layouts(cg, tile_rows=512)[dst_type]
    L.trash = cg.num_nodes[dst_type]
    return L


def _assert_rows(got, want, L, rtol=RTOL, atol=ATOL):
    """Real rows at rtol/atol, each relation's trash row at TRASH_RTOL."""
    got, want = np.asarray(got), np.asarray(want)
    n = L.n_rows_per_rel
    trash = np.zeros(len(got), dtype=bool)
    trash[L.trash::n] = True
    np.testing.assert_allclose(got[~trash], want[~trash], rtol=rtol, atol=atol)
    np.testing.assert_allclose(got[trash], want[trash], rtol=TRASH_RTOL,
                               atol=atol)


def _inputs(L, seed=0):
    rng = np.random.default_rng(seed)
    R = len(L.rel_keys)
    xs_all = (rng.standard_normal((L.n_src_total, D)) * 0.1).astype(np.float32)
    att = (rng.standard_normal((R, D)) * 0.2).astype(np.float32)
    a_dst = (rng.standard_normal(L.n_rows_total) * 0.5).astype(np.float32)
    return xs_all, att, a_dst


def _plain(L, xs_all, att, a_dst, fold, mode, device="cpu"):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return gat_layer.merged_gat_forward_plain(
        t(xs_all), t(L.src), t(L.row_offsets), t(att), t(a_dst),
        L.n_rows_per_rel, fold=fold, mode=mode, negative_slope=SLOPE,
        temperature=TEMP)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_plain_matches_fused_pallas_op(mode, fold):
    L = _layout()
    xs_all, att, a_dst = _inputs(L)
    R = len(L.rel_keys)
    msgs = xs_all[L.src]
    if mode == "softmax":
        ref = P.fused_gat_layer(msgs, att, a_dst, L.dst, L.row_offsets,
                                L.tile2rel, L.n_rows_total, SLOPE, TEMP,
                                True, R if fold else 0)
    else:
        ref = P.fused_gat_layer_unnorm(msgs, att, a_dst, L.dst, L.row_offsets,
                                       L.tile2rel, L.n_rows_total, SLOPE,
                                       TEMP, mode, True, R if fold else 0)
    out, _, _ = _plain(L, xs_all, att, a_dst, R if fold else 0, mode)
    assert out.shape == ((L.n_rows_per_rel if fold else L.n_rows_total), D)
    _assert_rows(out.numpy(), ref, L)


@pytest.mark.parametrize("mode", ["softmax", "sigmoid"])
def test_row_stats_match_merged_forward(mode):
    L = _layout()
    xs_all, att, a_dst = _inputs(L, seed=1)
    ts = P._tile_starts_np(L.row_offsets)
    _, row_max, row_sum = P._merged_forward(
        xs_all[L.src], P._prep_att8(att),
        P._prep_adst_tiles(a_dst, L.n_rows_total), L.dst, ts, L.tile2rel,
        L.n_rows_total, SLOPE, TEMP, interpret=True, mode=mode)
    _, m, s = _plain(L, xs_all, att, a_dst, 0, mode)
    _assert_rows(m.numpy(), np.asarray(row_max)[::8].reshape(-1), L)
    _assert_rows(s.numpy(), np.asarray(row_sum)[::8].reshape(-1), L)
    # empty rows: NEG_BIG and 0, as the TPU kernel leaves them
    empty = np.diff(L.row_offsets) == 0
    assert empty.any()
    assert np.all(m.numpy()[empty] == gat_layer.NEG_BIG)
    assert np.all(s.numpy()[empty] == 0)


def test_port_layout_equals_jax_layout():
    """The layout both sides read is the same one."""
    g = jax_make_kg(n_snp=300, n_gene=70, n_go=40, seed=3)
    jl = jax_build(jax_compile_graph(g, edge_pad_multiple=512,
                                     node_pad_multiple=512), tile_rows=512)
    L = _layout()
    for k in ("src", "dst", "row_offsets", "tile2rel"):
        assert np.array_equal(getattr(L, k), getattr(jl["Gene"], k)), k
