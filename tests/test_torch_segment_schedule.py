"""The segment kernels' static schedules, and their split-and-combine
arithmetic against the JAX package's Pallas ops.

``schedule.row_schedule`` packs a stream's short rows into items and cuts
long ones (each relation's trash row, with up to 511 pad edges; hubs) into
chunks: one relation's rows for #6 and #7, a merged layout's R*N rows for
#10 (``CSR_MAX_EDGES``); ``segment.csc_schedule`` does the same over a
layout's CSC source rows and never lets an item hold rows of two slots.
The CUDA kernels (segment_softmax_spmm_fwd.cu, segment_softmax_spmm_bwd.cu,
csc_segment_sum.cu, csr_segment_sum.cu) run only on the card
(tests/test_torch_gpu.py), so this file holds (i) the schedules' properties
and what ``device_layouts`` keeps of them, and (ii) PyTorch emulations of
the kernels' arithmetic: the forward's chunk partials and their
log-sum-exp combine in part order against ``fused_segment_softmax_spmm``
(Pallas interpret mode on the CPU); the backward's items (packed rows with
dot_r from their own edges, chunks that each recompute the log-sum-exp and
dot_r = out_r . g_r) against that op's VJP; the CSR sum's packed rows and
chunks added in part order against ``segment_sum_edges`` (interpret mode);
and the CSC sum over each entry's row in CSC order (``csc_rows``), its
chunks added in part order and d_att from per-item partials, against
``csc_segment_sum_plain`` and ``gather_rows_csc``'s backward (interpret
mode). max_edges = chunk_edges = 8 cuts real rows into chunks too.

Tolerances: the forward's real rows rtol 1e-5, atol 1e-6, trash rows rtol
1e-4 (float32 sums of up to 511 terms in another order; atol the Pallas
op's own error against float64 there); the CSR sum's real rows rtol 1e-5,
atol 1e-5 and trash rows rtol 1e-4 against the Pallas op; the backward, the
CSR sum and the CSC sum by chip_smoke.py's backward rule (max abs error
against the float64 plain version at most 8 times the float32 plain
version's plus 1e-6 of the largest value); the CSC sum rtol 1e-5, atol
1e-5 against the Pallas op, and the backward rtol 1e-3, atol 1e-4, as
tests/test_torch_variant_ops.py holds the plain backward against it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg
from kgwas_tpu.ops.pallas_segment import (fused_segment_softmax_spmm,
                                          gather_rows_csc, segment_sum_edges)

from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.models import device_layouts
from kgwas_tpu_torch.ops import schedule as S
from kgwas_tpu_torch.ops import segment, segment_softmax
from kgwas_tpu_torch.ops.segment_ref import EPS, NEG_BIG, csr_rows
from torch_threads import few_torch_threads  # noqa: F401,E402

D = 128
KG = dict(n_snp=300, n_gene=70, n_go=40, seed=3)
RTOL, ATOL, TRASH_RTOL = 1e-5, 1e-6, 1e-4
RELATIONS = ["Gene__Gene-PPI-Gene__Gene", "Gene__rev_TSS__SNP",
             "SNP__Enhancer-eQTL-Gene__Gene"]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def world():
    cg_j = jax_compile_graph(jax_make_kg(**KG), edge_pad_multiple=512,
                             node_pad_multiple=512)
    cg = compile_graph(make_synthetic_kg(**KG), edge_pad_multiple=512,
                       node_pad_multiple=512)
    return cg_j, cg, build_merged_layouts(cg, tile_rows=512)


def _check_cover(sched, offsets, max_edges, chunk_edges, breaks=()):
    """Every entry once, rows in order, packed items within max_edges and
    ITEM_MAX_ROWS rows and between two breaks, chunks only of longer rows,
    at most chunk_edges each, parts in item order and per row in entry
    order; item_breaks the first item at each break."""
    ro = np.asarray(offsets, dtype=np.int64)
    n_rows = len(ro) - 1
    deg = np.diff(ro)
    assert sched.fold_slots == 1 and sched.n_rows == n_rows
    hits = np.zeros(ro[-1], dtype=np.int64)
    seen = np.zeros(n_rows, dtype=np.int64)
    last, part, first_unit = -1, 0, []
    for a, b, c, d in sched.items.numpy():
        if c < 0:                                   # packed rows a..b-1
            assert a == last + 1 and b > a
            assert b - a <= S.ITEM_MAX_ROWS
            assert deg[a:b].sum() <= max_edges
            assert not any(a < k < b for k in breaks)
            hits[ro[a]:ro[b]] += 1
            seen[a:b] += 1
            last = b - 1
        else:                                       # chunk c..d-1 of row a
            assert deg[a] > max_edges and 0 < d - c <= chunk_edges
            assert ro[a] <= c < d <= ro[a + 1] and b == part
            if a != last:
                assert a == last + 1 and c == ro[a]
                seen[a] += 1
            part += 1
            hits[c:d] += 1
            last = a
        first_unit.append(a)
    assert np.all(hits == 1) and np.all(seen == 1)
    assert part == sched.n_parts
    assert np.array_equal(sched.split_units.numpy(),
                          np.flatnonzero(deg > max_edges))
    offs = sched.part_offsets.numpy()
    for j, row in enumerate(sched.split_units.tolist()):
        assert offs[j + 1] - offs[j] == -(-deg[row] // chunk_edges)
    want = np.searchsorted(first_unit, [0, *breaks, n_rows])
    assert sched.item_breaks == tuple(int(i) for i in want)


# ------------------------------------------------ (i) the schedules


@pytest.mark.parametrize("max_edges, chunk_edges", [(8, 8), (128, 512)])
@pytest.mark.parametrize("rk", RELATIONS)
def test_row_schedule_covers_every_edge_once_in_row_order(world, rk,
                                                          max_edges,
                                                          chunk_edges):
    _, cg, _ = world
    r = cg.relations[rk]
    sched = S.row_schedule(r.row_offsets, max_edges, chunk_edges)
    _check_cover(sched, r.row_offsets, max_edges, chunk_edges)
    # the trash row (all of the relation's pad edges) is cut
    trash = cg.num_nodes[r.dst_type]
    if np.diff(r.row_offsets)[trash] > max_edges:
        assert trash in sched.split_units.tolist()


@pytest.mark.parametrize("max_edges", [8, segment.CSC_MAX_EDGES,
                                       segment.CSC_LOGIT_MAX_EDGES])
@pytest.mark.parametrize("dst_t", ["Gene", "SNP", "BiologicalProcess"])
def test_csc_schedule_keeps_items_inside_a_slot(world, dst_t, max_edges):
    _, _, layouts = world
    L = layouts[dst_t]
    sched = segment.csc_schedule(L.csc_offsets, L.src_base, max_edges,
                                 max_edges)
    breaks = [int(b) for b in L.src_base[1:-1]]
    _check_cover(sched, L.csc_offsets, max_edges, max_edges, breaks)
    assert len(sched.item_breaks) == len(L.src_base)
    # each slot's items hold its rows only
    items = sched.items.numpy()
    for r in range(len(L.src_base) - 1):
        lo, hi = sched.item_breaks[r], sched.item_breaks[r + 1]
        for a, b, c, _ in items[lo:hi]:
            last = a if c >= 0 else b - 1
            assert L.src_base[r] <= a and last < L.src_base[r + 1]


def test_schedule_rejects_breaks_outside_the_rows():
    ro = np.array([0, 2, 3, 3], dtype=np.int32)
    with pytest.raises(ValueError):
        S.schedule(ro, 3, 0, 8, 8, breaks=[4])


@pytest.mark.parametrize("path", ["merged", "relations", "mp"])
def test_device_layouts_carry_the_segment_schedules(world, path):
    _, cg, layouts = world
    dl = device_layouts(layouts, "cpu", cg, path)
    for t, DL in dl.items():
        L = layouts[t]
        streams = []
        if path == "relations":   # the CSC sums run per relation there
            assert DL.csc_schedule is None and DL.csc_rows is None
        else:
            streams.append((DL, L.dst, L.csc_perm, L.csc_offsets,
                            L.n_rows_per_rel, L.src_base,
                            len(L.rel_keys) if path == "merged" else 0))
        for rk, RL in zip(DL.rel_keys, DL.relations or ()):
            r = cg.relations[rk]
            streams.append((RL, r.dst, r.csc_perm, r.csc_offsets,
                            RL.n_rows_per_rel, RL.src_base, 0))
            want = S.row_schedule(r.row_offsets)
            assert torch.equal(RL.row_schedule.items, want.items)
            assert RL.row_schedule.n_parts == want.n_parts
        if path == "mp":   # the CSR sum's, over the merged layout's rows
            want = S.row_schedule(L.row_offsets, S.CSR_MAX_EDGES,
                                  S.CSR_CHUNK_EDGES)
            got = DL.row_schedule
            assert torch.equal(got.items, want.items)
            assert torch.equal(got.part_offsets, want.part_offsets)
            _check_cover(got, L.row_offsets, S.CSR_MAX_EDGES,
                         S.CSR_CHUNK_EDGES)
            trash = cg.num_nodes[t]   # each slot's trash row is cut
            for r0 in range(0, len(L.row_offsets) - 1, L.n_rows_per_rel):
                row = r0 + trash
                if np.diff(L.row_offsets)[row] > S.CSR_MAX_EDGES:
                    assert row in got.split_units.tolist()
        elif path != "relations":
            assert DL.row_schedule is None
        for lay, dst, perm, off, n, base, fold in streams:
            rows = dst[perm] % n if fold else dst[perm]
            assert lay.csc_fold == bool(fold)
            assert np.array_equal(lay.csc_rows.numpy(), rows)
            want = segment.csc_schedule(
                off, base, segment.CSC_LOGIT_MAX_EDGES if fold
                else segment.CSC_MAX_EDGES)
            got = lay.csc_schedule
            assert got.max_edges == want.max_edges
            assert torch.equal(got.items, want.items)
            assert got.item_breaks == want.item_breaks
            assert torch.equal(got.part_offsets, want.part_offsets)
            again = segment.csc_fields(dst, perm, off, n, base, fold, "cpu")
            assert again["csc_fold"] == lay.csc_fold
            assert torch.equal(again["csc_rows"], lay.csc_rows)
            assert torch.equal(again["csc_schedule"].items, got.items)


def test_schedule_scratch_is_not_carried_to_a_copy():
    """A wrapper's scratch lives on the schedule it was made for: to() and
    a copy start with none."""
    ro = np.array([0, 2, 3, 3, 700], dtype=np.int32)
    sched = S.row_schedule(ro)
    sched.cache["k"] = torch.zeros(3)
    assert sched.to("cpu").cache == {}
    assert dataclasses.replace(sched, max_edges=64).cache == {}
    assert sched.cache["k"].shape == (3,)


# ---------------------------- (ii) split-and-combine arithmetic, emulated


def _chunk_segments(n_rows, ro, sched):
    """Per entry: its segment, a row of a packed item or a chunk (n_rows +
    part); and each part's row."""
    seg = csr_rows(_t(ro))
    part_row = torch.zeros(sched.n_parts, dtype=torch.int64)
    for row, p, e0, e1 in sched.items.numpy():
        if e0 >= 0:
            seg[e0:e1] = n_rows + p
            part_row[p] = row
    return seg, part_row


def _emulate_segment_softmax(xs, src, logits, ro, sched):
    """segment_softmax_spmm_fwd.cu's arithmetic: per packed row and per
    chunk its max, weights exp(min(l - m, 60)), sum and weighted sum; each
    chunked row's parts merged by log-sum-exp in part order; the
    division."""
    n_rows = len(ro) - 1
    seg, part_row = _chunk_segments(n_rows, ro, sched)
    n_seg = n_rows + sched.n_parts
    x = xs[_t(src[:len(seg)]).long()]
    l = logits[:len(seg)]
    m = torch.full((n_seg,), NEG_BIG).scatter_reduce(0, seg, l, "amax",
                                                     include_self=True)
    p = torch.exp(torch.clamp(l - m[seg], max=segment_softmax.EXP_CLAMP))
    s = torch.zeros(n_seg).index_add_(0, seg, p)
    acc = torch.zeros(n_seg, x.shape[1]).index_add_(0, seg, p[:, None] * x)
    row_max, row_sum, row_acc = m[:n_rows], s[:n_rows], acc[:n_rows]
    for row in sched.split_units.tolist():
        parts = torch.nonzero(part_row == row)[:, 0]   # in part order
        big = m[n_rows + parts].max()
        sc = torch.exp(m[n_rows + parts] - big)
        row_max[row] = big
        row_sum[row] = (s[n_rows + parts] * sc).sum()
        row_acc[row] = (acc[n_rows + parts] * sc[:, None]).sum(0)
    return row_acc / (row_sum + EPS)[:, None], row_max, row_sum


def _assert_rows(got, want, trash, exact):
    """Real rows at RTOL/ATOL; the trash row at TRASH_RTOL, with atol the
    reference's own error against exact (float64) there, and got at least
    as close to exact."""
    got, want, exact = (np.asarray(a) for a in (got, want, exact))
    real = np.ones(len(got), dtype=bool)
    real[trash] = False
    np.testing.assert_allclose(got[real], want[real], rtol=RTOL, atol=ATOL)
    ref_err = float(np.abs(want[trash] - exact[trash]).max())
    assert float(np.abs(got[trash] - exact[trash]).max()) <= max(ref_err,
                                                                  ATOL)
    np.testing.assert_allclose(got[trash], want[trash], rtol=TRASH_RTOL,
                               atol=max(ATOL, ref_err))


@pytest.mark.parametrize("max_edges", [8, S.ROW_MAX_EDGES])
@pytest.mark.parametrize("rk", RELATIONS)
def test_segment_softmax_split_and_combine_matches_pallas(world, rk,
                                                          max_edges):
    cg_j, cg, _ = world
    r, rj = cg.relations[rk], cg_j.relations[rk]
    rng = np.random.default_rng(RELATIONS.index(rk))
    xs = (rng.standard_normal((cg.padded_nodes[r.src_type], D)) * 0.1
          ).astype(np.float32)
    logits = (rng.standard_normal(len(r.src)) * 1.5).astype(np.float32)
    n_rows = cg.padded_nodes[r.dst_type]
    chunk = max_edges if max_edges == 8 else S.ROW_CHUNK_EDGES
    sched = S.row_schedule(r.row_offsets, max_edges, chunk)
    trash = cg.num_nodes[r.dst_type]
    assert trash in sched.split_units.tolist()
    out, row_max, row_sum = _emulate_segment_softmax(
        _t(xs), r.src, _t(logits), r.row_offsets, sched)
    want = fused_segment_softmax_spmm(
        jnp.asarray(xs)[jnp.asarray(rj.src)], jnp.asarray(logits),
        jnp.asarray(rj.dst), rj.row_offsets, n_rows, True)
    # float64 of the same function, by the plain version
    exact = segment_softmax.segment_softmax_spmm_fwd_plain(
        _t(xs).double(), _t(r.src), _t(logits).double(), _t(r.row_offsets))
    _assert_rows(out.numpy(), np.asarray(want), trash, exact[0].numpy())
    plain = segment_softmax.segment_softmax_spmm_fwd_plain(
        _t(xs), _t(r.src), _t(logits), _t(r.row_offsets))
    for got, p, e in zip((row_max, row_sum), plain[1:], exact[1:]):
        _assert_rows(got.numpy(), p.numpy(), trash, e.numpy())


def _emulate_csc(g, w, dz, xs, att, lay, fold, sched):
    """csc_segment_sum.cu's arithmetic: each CSC entry's row from csc_rows,
    w and dz through csc_perm; per packed row and per chunk the sum of w
    g[row] and of dz; each chunked row's parts added in part order; c att
    per row; d_att as the sum, in item order, of each item's partial (c xs
    over its rows, or its chunk's c xs[row]), in groups of 64 items."""
    off = lay.csc_offsets.numpy()
    n_src = len(off) - 1
    seg, part_row = _chunk_segments(n_src, off, sched)
    n_seg = n_src + sched.n_parts
    perm = lay.csc_perm.long()
    rows = g[lay.csc_rows.long()]
    wv = torch.ones(len(perm), dtype=g.dtype) if w is None else w[perm]
    acc = torch.zeros(n_seg, g.shape[1], dtype=g.dtype).index_add_(
        0, seg, wv[:, None] * rows)
    d_xs = acc[:n_src].clone()
    c = None
    if dz is not None:
        c = torch.zeros(n_seg, dtype=g.dtype).index_add_(0, seg, dz[perm])
    for row in sched.split_units.tolist():
        parts = n_src + torch.nonzero(part_row == row)[:, 0]
        d_xs[row] = acc[parts].sum(0)
        if c is not None:
            c[row] = c[parts].sum()
    if c is None:
        return d_xs, None
    base = torch.tensor(lay.src_base)
    slot = torch.repeat_interleave(torch.arange(len(base) - 1), base.diff())
    d_xs += c[:n_src, None] * att[slot]
    partial = []
    for row, b, e0, _ in sched.items.numpy():
        if e0 >= 0:
            part = int(b)
            partial.append(c[n_src + part] * xs[row])
        else:
            partial.append((c[row:b, None] * xs[row:b]).sum(0))
    partial = torch.stack(partial)
    # each slot's partials in groups of 64 items (kGroupItems), then the
    # groups
    d_att = torch.stack([
        torch.stack([partial[i:min(i + 64, b)].sum(0) for i in
                     range(a, b, 64)]).sum(0) if b > a
        else torch.zeros(xs.shape[1], dtype=xs.dtype)
        for a, b in zip(sched.item_breaks, sched.item_breaks[1:])])
    return d_xs, d_att


def _grad_rule(got, plain, exact):
    k_err = float((got.double() - exact).abs().max())
    p_err = float((plain.double() - exact).abs().max())
    assert k_err <= 8 * p_err + 1e-6 * float(exact.abs().max())


@pytest.mark.parametrize("max_edges", [8, segment.CSC_MAX_EDGES])
@pytest.mark.parametrize("form", ["merged", "relation", "mp"])
def test_csc_split_and_combine_matches_plain(world, form, max_edges):
    """The CSC-ordered rows, chunks and item partials reproduce
    csc_segment_sum_plain, in each call form."""
    _, cg, layouts = world
    rng = np.random.default_rng(7)
    path = {"merged": "merged", "relation": "relations", "mp": "mp"}[form]
    DL = device_layouts(layouts, "cpu", cg, path)["Gene"]
    fold = len(DL.rel_keys) if form == "merged" else 0
    if form == "relation":
        DL = DL.relations[1]
    n_rel = len(DL.src_base) - 1
    e = DL.csc_perm.shape[0]
    xs = _t((rng.standard_normal((DL.src_base[-1], D)) * 0.1
             ).astype(np.float32))
    g = _t(rng.standard_normal(((DL.n_rows_per_rel if fold else
                                 DL.row_offsets.shape[0] - 1), D)
                               ).astype(np.float32))
    w = _t(rng.random(e).astype(np.float32))
    dz = att = None
    if form == "merged":
        dz = _t(rng.standard_normal(e).astype(np.float32))
        att = _t(rng.standard_normal((n_rel, D)).astype(np.float32))
    sched = segment.csc_schedule(DL.csc_offsets, DL.src_base, max_edges,
                                 max_edges)
    assert sched.n_parts > 0
    got = _emulate_csc(g, w, dz, xs, att, DL, fold, sched)
    args = (g, w, dz, xs, att, DL, fold)
    plain = segment.csc_segment_sum_plain(*args)
    exact = segment.csc_segment_sum_plain(
        *(a.double() if torch.is_tensor(a) else a for a in args))
    for a, p, x in zip(got, plain, exact):
        if p is None:
            assert a is None
        else:
            _grad_rule(a, p, x)


@pytest.mark.parametrize("rk", RELATIONS[:2])
def test_csc_split_and_combine_matches_gather_rows_csc_backward(world, rk):
    """The per-relation GAT backward's CSC sum (w, no logit term), emulated
    on the relation's CSC-ordered rows and schedule with real rows cut,
    against jax.vjp of gather_rows_csc (pallas_segment_sum in interpret
    mode) of the message cotangent w_e g[dst_e]."""
    cg_j, cg, layouts = world
    r, rj = cg.relations[rk], cg_j.relations[rk]
    dl = device_layouts(layouts, "cpu", cg, "relations")[r.dst_type]
    RL = dl.relations[dl.rel_keys.index(rk)]
    rng = np.random.default_rng(9)
    n_src = cg.padded_nodes[r.src_type]
    xs = (rng.standard_normal((n_src, D)) * 0.1).astype(np.float32)
    g = rng.standard_normal((RL.n_rows_per_rel, D)).astype(np.float32)
    w = rng.random(len(r.src)).astype(np.float32)
    sched = segment.csc_schedule(RL.csc_offsets, RL.src_base, 8, 8)
    assert sched.n_parts > len(sched.split_units)
    got, _ = _emulate_csc(_t(g), _t(w), None, _t(xs), None, RL, 0, sched)

    def f(x):
        return gather_rows_csc(x, jnp.asarray(rj.src), rj.csc_perm,
                               rj.csc_src_sorted, rj.csc_offsets, n_src,
                               True)

    _, vjp = jax.vjp(f, jnp.asarray(xs))
    (want,) = vjp(jnp.asarray(w[:, None] * g[r.dst]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _emulate_segment_softmax_bwd(xs, src, logits, ro, row_max, row_sum, out,
                                 g, sched):
    """segment_softmax_spmm_bwd.cu's item arithmetic: per edge p_e from its
    row's log-sum-exp and m_e = xs[src_e] . g_r; in a packed item dot_r =
    sum_e p_e m_e over the row's own edges, in a chunk dot_r = out_r . g_r,
    recomputed by each chunk (its segment n_rows + part); w_e = p_e,
    d_logit_e = p_e (m_e - dot)."""
    n_rows = len(ro) - 1
    seg, part_row = _chunk_segments(n_rows, ro, sched)
    row = csr_rows(_t(ro))
    e = len(row)
    lse = row_max + torch.log(row_sum + EPS)
    p = torch.exp(torch.clamp(logits[:e] - lse[row],
                              max=segment_softmax.EXP_CLAMP))
    m = (xs[_t(src[:e]).long()] * g[row]).sum(-1)
    dot = torch.zeros(n_rows + sched.n_parts, dtype=xs.dtype).index_add_(
        0, seg, p * m)
    dot[n_rows:] = (out[part_row] * g[part_row]).sum(-1)
    return p, p * (m - dot[seg])


@pytest.mark.parametrize("max_edges", [8, S.ROW_MAX_EDGES])
@pytest.mark.parametrize("rk", RELATIONS)
def test_segment_softmax_bwd_items_match_pallas_vjp(world, rk, max_edges):
    """The backward's item walk over the relation's row schedule (real rows
    cut into chunks too at max_edges 8) against jax.vjp of
    fused_segment_softmax_spmm (Pallas interpret mode): d_logits, and d_xs
    as the CSC sum of its weights against the op's d_msgs summed per
    source row as the CSC routes each edge; and against the plain version
    by the float64 rule."""
    cg_j, cg, layouts = world
    r, rj = cg.relations[rk], cg_j.relations[rk]
    dl = device_layouts(layouts, "cpu", cg, "relations")[r.dst_type]
    RL = dl.relations[dl.rel_keys.index(rk)]
    rng = np.random.default_rng(20 + RELATIONS.index(rk))
    xs = (rng.standard_normal((cg.padded_nodes[r.src_type], D)) * 0.1
          ).astype(np.float32)
    logits = (rng.standard_normal(len(r.src)) * 1.5).astype(np.float32)
    n_rows = cg.padded_nodes[r.dst_type]
    g = rng.standard_normal((n_rows, D)).astype(np.float32)
    sched = S.row_schedule(r.row_offsets, max_edges,
                           8 if max_edges == 8 else S.ROW_CHUNK_EDGES)
    assert cg.num_nodes[r.dst_type] in sched.split_units.tolist()
    out, row_max, row_sum = segment_softmax.segment_softmax_spmm_fwd_plain(
        _t(xs), _t(r.src), _t(logits), _t(r.row_offsets))
    args = (_t(xs), _t(r.src), _t(logits), _t(r.row_offsets), row_max,
            row_sum, out, _t(g))
    w, d_logits = _emulate_segment_softmax_bwd(*args[:3], r.row_offsets,
                                               *args[4:], sched)
    plain = segment_softmax.segment_softmax_spmm_bwd_plain(*args)
    exact = segment_softmax.segment_softmax_spmm_bwd_plain(
        *(a.double() if a.is_floating_point() else a for a in args))
    for a, p, x in zip((w, d_logits), plain, exact):
        _grad_rule(a, p, x)

    def f(msgs, lg):
        return fused_segment_softmax_spmm(msgs, lg, jnp.asarray(rj.dst),
                                          rj.row_offsets, n_rows, True)

    _, vjp = jax.vjp(f, jnp.asarray(xs)[jnp.asarray(rj.src)],
                     jnp.asarray(logits))
    d_msgs, want_dl = vjp(jnp.asarray(g))
    np.testing.assert_allclose(d_logits.numpy(), np.asarray(want_dl),
                               rtol=1e-3, atol=1e-4)
    want_dxs = torch.zeros(len(xs), D).index_add_(
        0, segment.csc_sources(RL), _t(np.array(d_msgs)))
    got_dxs, _ = segment.csc_segment_sum_plain(_t(g), w, None, _t(xs), None,
                                               RL)
    np.testing.assert_allclose(got_dxs.numpy(), want_dxs.numpy(), rtol=1e-3,
                               atol=1e-4)


def _emulate_csr(x, src, ro, w, sched):
    """csr_segment_sum.cu's arithmetic: per packed row and per chunk the sum
    of w_e x[src_e]; each chunked row's parts added in part order."""
    n_rows = len(ro) - 1
    seg, part_row = _chunk_segments(n_rows, ro, sched)
    msgs = x[_t(src[:len(seg)]).long()]
    if w is not None:
        msgs = w[:len(seg), None] * msgs
    acc = torch.zeros(n_rows + sched.n_parts, x.shape[1],
                      dtype=x.dtype).index_add_(0, seg, msgs)
    out = acc[:n_rows].clone()
    for row in sched.split_units.tolist():
        parts = n_rows + torch.nonzero(part_row == row)[:, 0]
        out[row] = acc[parts[0]]
        for q in parts[1:]:
            out[row] = out[row] + acc[q]
    return out


@pytest.mark.parametrize("max_edges", [8, S.CSR_MAX_EDGES])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("dst_t", ["Gene", "SNP", "BiologicalProcess",
                                   "CellularComponent",
                                   "MolecularFunction"])
def test_csr_split_and_combine_matches_segment_sum_edges(world, dst_t,
                                                         weighted,
                                                         max_edges):
    """The CSR sum's packed rows and chunks over a merged group's rows,
    with and without the symmetric norm, against segment_sum_edges
    (Pallas interpret mode) and the plain version by the float64 rule."""
    _, cg, layouts = world
    L = layouts[dst_t]
    DL = device_layouts({dst_t: L}, "cpu", path="mp")[dst_t]
    rng = np.random.default_rng(30)
    x = (rng.standard_normal((L.n_src_total, D)) * 0.1).astype(np.float32)
    w = DL.sym_e if weighted else None
    sched = (DL.row_schedule if max_edges == S.CSR_MAX_EDGES
             else S.row_schedule(L.row_offsets, 8, 8))
    assert sched.n_parts > 0
    got = _emulate_csr(_t(x), L.src, L.row_offsets, w, sched)
    args = (_t(x), DL.src, DL.row_offsets, w)
    _grad_rule(got, segment.csr_segment_sum_plain(*args),
               segment.csr_segment_sum_plain(
                   _t(x).double(), DL.src, DL.row_offsets,
                   None if w is None else w.double()))
    msgs = jnp.asarray(x)[jnp.asarray(L.src)]
    if weighted:
        msgs = msgs * jnp.asarray(w.numpy())[:, None]
    want = np.asarray(segment_sum_edges(msgs, jnp.asarray(L.dst),
                                        jnp.asarray(L.row_offsets),
                                        L.n_rows_total, True))
    trash = np.zeros(L.n_rows_total, dtype=bool)
    trash[cg.num_nodes[dst_t]::L.n_rows_per_rel] = True
    np.testing.assert_allclose(got.numpy()[~trash], want[~trash], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy()[trash], want[trash], rtol=1e-4,
                               atol=1e-5)
