"""The plain versions of the model-variant kernels against the JAX package.

Same seeded numpy inputs on both sides; the JAX side runs its Pallas ops in
interpret mode on the CPU. The CUDA kernels are held against these plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py phase 6).

  (i)   ops/segment_ref.py against kgwas_tpu/ops/segment.py
  (ii)  TPU kernels #6 and #7: segment_softmax.SegmentSoftmaxSpmm (plain
        forward, plain backward and the CSC segment sum without logit term)
        against fused_segment_softmax_spmm composed with gather_rows_csc and
        its jax.vjp, on one relation's stream: forward rtol 1e-4, atol
        1e-5; gradients rtol 1e-3, atol 1e-4, as tests/test_pallas_kernels.py
        holds the fused op. The cotangent is random on every row, trash rows
        included, so the pad edges' route (their source row 0 in the
        gather, the source trash row in the CSC) is held too.
  (iii) TPU kernel #10: segment.CSRSegmentSum (plain) against
        segment_sum_edges composed with gather_rows_csc, with and without a
        per-edge weight, forward and jax.vjp (same tolerances)
  (iv)  the generalised CSC segment sum: with dz=None it is the logit term
        dropped, and with logits it gives what it gave before
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg
from kgwas_tpu.ops import segment as jseg
from kgwas_tpu.ops.pallas_segment import (fused_segment_softmax_spmm,
                                          gather_rows_csc, segment_sum_edges)

from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.models import device_layouts
from kgwas_tpu_torch.ops import segment, segment_ref, segment_softmax
from torch_threads import few_torch_threads  # noqa: F401,E402

D = 128
KG = dict(n_snp=300, n_gene=70, n_go=40, seed=3)
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def world():
    cg_j = jax_compile_graph(jax_make_kg(**KG), edge_pad_multiple=512,
                             node_pad_multiple=512)
    cg = compile_graph(make_synthetic_kg(**KG), edge_pad_multiple=512,
                       node_pad_multiple=512)
    layouts = build_merged_layouts(cg, tile_rows=512)
    return cg_j, cg, layouts, device_layouts(layouts, "cpu", cg, "relations")


# ------------------------------------------------------ (i) segment_ref


@pytest.mark.parametrize("op", ["gather_rows", "segment_sum", "segment_max",
                                "segment_mean", "segment_softmax",
                                "leaky_relu"])
def test_segment_ref_matches_jax_segment(op):
    rng = np.random.default_rng(1)
    n_seg, e, n_real = 40, 300, 260
    ids = np.sort(rng.integers(0, n_seg - 3, e)).astype(np.int32)
    ids[n_real:] = n_seg - 1     # pad edges on the trash row
    data = rng.standard_normal((e, 5)).astype(np.float32)
    logits = (rng.standard_normal(e) * 3).astype(np.float32)
    valid = np.arange(e) < n_real
    if op == "gather_rows":
        x = rng.standard_normal((n_seg, 5)).astype(np.float32)
        got = segment_ref.gather_rows(_t(x), _t(ids))
        want = jseg.gather_rows(x, ids)
    elif op == "segment_mean":
        got = segment_ref.segment_mean(_t(data), _t(ids).long(), n_seg,
                                       _t(valid))
        want = jseg.segment_mean(data, ids, n_seg, valid)
    elif op == "segment_softmax":
        got = segment_ref.segment_softmax(_t(logits), _t(ids).long(), n_seg,
                                          _t(valid))
        want = jseg.segment_softmax(logits, ids, n_seg, valid)
    elif op == "leaky_relu":
        got = segment_ref.leaky_relu(_t(logits), 0.2)
        want = jseg.leaky_relu(logits, 0.2)
    else:
        got = getattr(segment_ref, op)(_t(data), _t(ids).long(), n_seg)
        want = getattr(jseg, op)(data, ids, n_seg)
        if op == "segment_max":   # JAX fills empty segments with -inf
            want = np.maximum(np.asarray(want), segment_ref.NEG_BIG)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-7)


# ------------------------------------------------- (ii) kernels #6 and #7

# a homogeneous relation, one into SNP (the trash row holds 320 pad edges)
# and one whose source type is far larger than its destination type
RELATIONS = ["Gene__Gene-PPI-Gene__Gene", "Gene__rev_TSS__SNP",
             "SNP__Enhancer-eQTL-Gene__Gene"]


def _relation_inputs(cg, rk, seed):
    r = cg.relations[rk]
    rng = np.random.default_rng(seed)
    xs = (rng.standard_normal((cg.padded_nodes[r.src_type], D)) * 0.1
          ).astype(np.float32)
    logits = (rng.standard_normal(len(r.src)) * 1.5).astype(np.float32)
    g = rng.standard_normal((cg.padded_nodes[r.dst_type], D)
                            ).astype(np.float32)
    return r, xs, logits, g


def _relation_layout(world, rk):
    _, cg, _, dl = world
    dst_t = cg.relations[rk].dst_type
    return dl[dst_t].relations[dl[dst_t].rel_keys.index(rk)]


@pytest.mark.parametrize("rk", RELATIONS)
def test_segment_softmax_spmm_matches_pallas(world, rk):
    cg_j, cg, _, _ = world
    r, xs, logits, g = _relation_inputs(cg, rk, seed=RELATIONS.index(rk))
    rj = cg_j.relations[rk]
    n_rows = cg.padded_nodes[r.dst_type]

    def f(xs, logits):
        msgs = gather_rows_csc(xs, jnp.asarray(rj.src), rj.csc_perm,
                               rj.csc_src_sorted, rj.csc_offsets,
                               cg_j.padded_nodes[r.src_type], True)
        return fused_segment_softmax_spmm(msgs, logits, jnp.asarray(rj.dst),
                                          rj.row_offsets, n_rows, True)

    want, vjp = jax.vjp(f, xs, logits)
    want_dxs, want_dl = vjp(jnp.asarray(g))

    RL = _relation_layout(world, rk)
    leaves = [_t(xs).requires_grad_(), _t(logits).requires_grad_()]
    out = segment_softmax.SegmentSoftmaxSpmm.apply(*leaves, RL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    got_dxs, got_dl = torch.autograd.grad(out, leaves, _t(g))
    np.testing.assert_allclose(got_dxs.numpy(), np.asarray(want_dxs),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(got_dl.numpy(), np.asarray(want_dl),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    # the saved row statistics: NEG_BIG and 0 on empty rows
    _, row_max, row_sum = segment_softmax.segment_softmax_spmm_fwd_plain(
        _t(xs), RL.src, _t(logits), RL.row_offsets)
    empty = np.diff(r.row_offsets) == 0
    assert empty.any()
    assert (row_max.numpy()[empty] == segment_ref.NEG_BIG).all()
    assert (row_sum.numpy()[empty] == 0).all()
    assert (out.detach().numpy()[empty] == 0).all()


def test_segment_softmax_backward_matches_autograd_of_plain_forward(world):
    """The plain backward (edge half, then the CSC sum without logit term)
    against torch autograd of the plain forward. The CSC sends the pad
    edges' cotangents to the source trash row where autograd's gather sends
    them to row 0, so d_xs is compared with those moved."""
    rk = RELATIONS[1]
    _, cg, _, _ = world
    r, xs, logits, g = _relation_inputs(cg, rk, seed=7)
    RL = _relation_layout(world, rk)
    leaves = [_t(xs).requires_grad_(), _t(logits).requires_grad_()]
    out, row_max, row_sum = segment_softmax.segment_softmax_spmm_fwd_plain(
        leaves[0], RL.src, leaves[1], RL.row_offsets)
    want_dxs, want_dl = torch.autograd.grad(out, leaves, _t(g))
    got_dxs, got_dl = segment_softmax.segment_softmax_spmm_backward_plain(
        _t(xs), _t(logits), row_max.detach(), row_sum.detach(),
        out.detach(), _t(g), RL)
    # move the pad edges' share from source row 0 to the trash row
    w, _ = segment_softmax.segment_softmax_spmm_bwd_plain(
        _t(xs), RL.src, _t(logits), RL.row_offsets, row_max.detach(),
        row_sum.detach(), out.detach(), _t(g))
    pad = slice(r.num_edges, None)
    share = (w[pad, None] * _t(g)[RL.dst[pad].long()]).sum(0)
    want_dxs = want_dxs.clone()
    want_dxs[0] -= share
    want_dxs[cg.num_nodes[r.src_type]] += share
    np.testing.assert_allclose(got_dxs.numpy(), want_dxs.numpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(got_dl.numpy(), want_dl.numpy(),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ------------------------------------------------------------ (iii) #10


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dst_t", ["Gene", "SNP"])
def test_csr_segment_sum_matches_segment_sum_edges(world, dst_t, weighted):
    _, cg, layouts, _ = world
    L = layouts[dst_t]
    DL = device_layouts({dst_t: L}, "cpu", path="mp")[dst_t]
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((L.n_src_total, D)) * 0.1).astype(np.float32)
    g = rng.standard_normal((L.n_rows_total, D)).astype(np.float32)
    w = DL.sym_e.numpy() if weighted else None

    def f(x):
        msgs = gather_rows_csc(x, jnp.asarray(L.src), L.csc_perm, L.csc_ids,
                               L.csc_offsets, L.n_src_total, True)
        if weighted:
            msgs = msgs * jnp.asarray(w)[:, None]
        return segment_sum_edges(msgs, jnp.asarray(L.dst),
                                 jnp.asarray(L.row_offsets), L.n_rows_total,
                                 True)

    want, vjp = jax.vjp(f, x)
    (want_dx,) = vjp(jnp.asarray(g))
    leaf = _t(x).requires_grad_()
    out = segment.CSRSegmentSum.apply(leaf, None if w is None else _t(w), DL)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    (got_dx,) = torch.autograd.grad(out, [leaf], _t(g))
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(want_dx),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


# ------------------------------------------------------------ (iv) #8


@pytest.mark.parametrize("weighted", [False, True])
def test_csc_segment_sum_without_logits(world, weighted):
    """dz=None drops the logit term and d_att; w=None weighs every edge 1."""
    _, cg, layouts, dl = world
    DL = dl["Gene"]
    R = len(DL.rel_keys)
    rng = np.random.default_rng(5)
    e = DL.src.shape[0]
    xs = _t((rng.standard_normal((DL.src_base[-1], D)) * 0.1
             ).astype(np.float32))
    g = _t(rng.standard_normal((R * DL.n_rows_per_rel, D)).astype(np.float32))
    w = _t(rng.random(e).astype(np.float32)) if weighted else None
    d_xs, d_att = segment.csc_segment_sum(g, w, None, xs, None, DL)
    assert d_att is None
    ones = torch.ones(e)
    want, _ = segment.csc_segment_sum_plain(
        g, ones if w is None else w, torch.zeros(e), xs,
        torch.zeros(R, D), DL)
    assert torch.equal(d_xs, want)


def test_csc_segment_sum_with_logits_is_unchanged(world):
    """The merged GAT backward's call: the plain version routes each edge by
    the CSC, which for a merged layout is its src, so it equals the
    index_add_ over src the plain version ran before."""
    _, _, _, dl = world
    DL = dl["Gene"]
    R = len(DL.rel_keys)
    rng = np.random.default_rng(6)
    e = DL.src.shape[0]
    xs = _t((rng.standard_normal((DL.src_base[-1], D)) * 0.1
             ).astype(np.float32))
    att = _t(rng.standard_normal((R, D)).astype(np.float32))
    g = _t(rng.standard_normal((DL.n_rows_per_rel, D)).astype(np.float32))
    w = _t(rng.random(e).astype(np.float32))
    dz = _t(rng.standard_normal(e).astype(np.float32))
    d_xs, d_att = segment.csc_segment_sum(g, w, dz, xs, att, DL, R)
    assert torch.equal(segment.csc_sources(DL), DL.src.long())
    dst = DL.dst.long()
    n = DL.n_rows_per_rel
    d_msgs = w[:, None] * g[dst % n] + dz[:, None] * att[dst // n]
    assert torch.equal(d_xs, torch.zeros_like(xs).index_add_(
        0, DL.src.long(), d_msgs))
    assert d_att.shape == (R, D) and d_att.abs().sum() > 0
