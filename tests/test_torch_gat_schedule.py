"""The merged GAT kernels' static schedule, and its split-and-combine
arithmetic against the JAX package's Pallas ops.

``gat_layer.schedule`` packs short units (output rows) into items and cuts
long ones into chunks of one slot row; the CUDA kernels compute each chunk's
partial and combine a unit's partials in part order. The kernels run only on
the card (tests/test_torch_gpu.py), so this file holds (i) the schedule's
properties and (ii) a PyTorch emulation of the chunk partials and their
fixed-order combine (the forward's log-sum-exp merge, the backward's
dot_row sum) against ``P.fused_gat_layer`` / ``P.fused_gat_layer_unnorm``,
``P._merged_forward`` (Pallas interpret mode on the CPU) and
``merged_gat_bwd_plain``. max_edges = chunk_edges = 8 cuts real rows into
chunks too, not only each relation's trash row (up to 511 pad edges). Tolerances: real rows rtol 1e-5,
atol 1e-6; trash rows rtol 1e-4 (float32 sums of up to 511 terms in
another order).
"""
import numpy as np
import pytest
import torch

from kgwas_tpu.ops import pallas_gat_layer as P

from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.models.hetero_gnn import device_layouts
from kgwas_tpu_torch.ops import gat_layer

D = 128
SLOPE, TEMP = 0.2, 0.7
RTOL, ATOL, TRASH_RTOL = 1e-5, 1e-6, 1e-4


def _layout(dst_type="Gene", seed=3):
    g = make_synthetic_kg(n_snp=300, n_gene=70, n_go=40, seed=seed)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    L = build_merged_layouts(cg, tile_rows=512)[dst_type]
    L.trash = cg.num_nodes[dst_type]
    return L


def _inputs(L, seed=0):
    rng = np.random.default_rng(seed)
    R = len(L.rel_keys)
    xs_all = (rng.standard_normal((L.n_src_total, D)) * 0.1).astype(np.float32)
    att = (rng.standard_normal((R, D)) * 0.2).astype(np.float32)
    a_dst = (rng.standard_normal(L.n_rows_total) * 0.5).astype(np.float32)
    return xs_all, att, a_dst


def _assert_rows(got, want, L, exact=None):
    """Real rows at RTOL/ATOL, trash rows at TRASH_RTOL. With exact (the
    same function in float64), a trash row's atol is the reference's own
    max abs error there, and got must be at least as close to exact: the
    pad edges all read one source row, so a trash row sums up to 511 nearly
    equal terms, and a column that cancels across the fold's slots keeps
    only the float32 rounding of the reference's own order."""
    got, want = np.asarray(got), np.asarray(want)
    trash = np.zeros(len(got), dtype=bool)
    trash[L.trash::L.n_rows_per_rel] = True
    np.testing.assert_allclose(got[~trash], want[~trash], rtol=RTOL,
                               atol=ATOL)
    atol = ATOL
    if exact is not None:
        exact = np.asarray(exact)[trash]
        ref_err = float(np.abs(want[trash] - exact).max())
        assert float(np.abs(got[trash] - exact).max()) <= max(ref_err, ATOL)
        atol = max(ATOL, ref_err)
    np.testing.assert_allclose(got[trash], want[trash], rtol=TRASH_RTOL,
                               atol=atol)


def _exact_forward(L, xs_all, att, a_dst, fold, mode):
    """The layer in float64 (numpy): out and, per row, max and sum."""
    R = len(L.rel_keys)
    n = L.n_rows_per_rel
    ro = L.row_offsets.astype(np.int64)
    n_rows = len(ro) - 1
    dst = np.repeat(np.arange(n_rows), np.diff(ro))
    x = xs_all.astype(np.float64)[L.src[:len(dst)]]
    z = (x * att.astype(np.float64)[dst // n]).sum(-1) + a_dst[dst]
    l = np.where(z >= 0, z, SLOPE * z) / TEMP
    m = np.full(n_rows, gat_layer.NEG_BIG)
    np.maximum.at(m, dst, l)
    if mode == "softmax":
        w = np.exp(l - m[dst])
    else:
        w = 1 / (1 + np.exp(-l)) if mode == "sigmoid" else l * TEMP
    s = np.zeros(n_rows)
    np.add.at(s, dst, w)
    out = np.zeros((n_rows, x.shape[1]))
    np.add.at(out, dst, w[:, None] * x)
    if mode == "softmax":
        out /= (s + gat_layer.EPS)[:, None]
    return out.reshape(R, n, -1).sum(0) if fold else out, m, s


def _unit_rows(u, L, f, fold):
    n = L.n_rows_per_rel
    return [r * n + u for r in range(f)] if fold else [u]


# ------------------------------------------------ (i) the schedule itself


@pytest.mark.parametrize("max_edges, chunk_edges", [(8, 8), (64, None)])
@pytest.mark.parametrize("fold", [False, True])
def test_schedule_covers_every_edge_once_in_unit_order(fold, max_edges,
                                                       chunk_edges):
    L = _layout()
    R = len(L.rel_keys)
    f = R if fold else 1
    ro = L.row_offsets.astype(np.int64)
    chunk = chunk_edges or gat_layer.CHUNK_EDGES
    s = gat_layer.schedule(L.row_offsets, L.n_rows_per_rel, R if fold else 0,
                           max_edges, chunk)
    assert s.max_edges == max_edges and s.chunk_edges == chunk
    assert s.fold_slots == f and s.n_rows == L.n_rows_total
    items = s.items.numpy()
    n_units = L.n_rows_per_rel if fold else L.n_rows_total
    deg = np.diff(ro)
    unit_deg = deg.reshape(f, -1).sum(0) if fold else deg
    hits = np.zeros(ro[-1], dtype=np.int64)
    unit_seen = np.zeros(n_units, dtype=np.int64)
    last_unit, part = -1, 0
    for a, b, c, d in items:
        if c < 0:                               # packed units a..b-1
            edges = 0
            for u in range(a, b):
                unit_seen[u] += 1
                for row in _unit_rows(u, L, f, fold):
                    hits[ro[row]:ro[row + 1]] += 1
                    edges += ro[row + 1] - ro[row]
            assert edges <= max_edges
            assert b - a <= gat_layer.ITEM_MAX_UNITS
            assert (b - a) * f <= gat_layer.ITEM_MAX_ROWS
            assert a >= last_unit + 1
            last_unit = b - 1
        else:                                   # chunk c..d-1 of row a
            u = a % L.n_rows_per_rel if fold else a
            assert unit_deg[u] > max_edges      # only long units are cut
            assert 0 < d - c <= chunk           # a chunk of one slot row
            assert ro[a] <= c < d <= ro[a + 1]
            assert b == part                    # parts in item order
            part += 1
            hits[c:d] += 1
            assert u >= last_unit
            if u > last_unit:
                unit_seen[u] += 1
            last_unit = u
    assert np.all(hits == 1)                    # every edge exactly once
    assert np.all(unit_seen == 1)               # every unit, in order
    split = s.split_units.numpy()
    assert np.array_equal(split, np.flatnonzero(unit_deg > max_edges))
    offs = s.part_offsets.numpy()
    assert offs.shape == (len(split) * f + 1,) and offs[-1] == s.n_parts
    assert np.all(np.diff(offs) >= 0) and part == s.n_parts
    # each (unit, slot) lists the chunks of that row, in edge order
    chunk_rows = items[items[:, 2] >= 0][:, 0]
    for j, u in enumerate(split):
        for r, row in enumerate(_unit_rows(u, L, f, fold)):
            rows = chunk_rows[offs[j * f + r]:offs[j * f + r + 1]]
            assert np.all(rows == row)
            n_chunks = -(-(ro[row + 1] - ro[row]) // chunk)
            assert len(rows) == n_chunks


def test_schedule_rejects_bad_max_edges():
    L = _layout()
    for k in (0, gat_layer.ITEM_MAX_EDGES + 1):
        with pytest.raises(ValueError):
            gat_layer.schedule(L.row_offsets, L.n_rows_per_rel, 0, k)
        with pytest.raises(ValueError):
            gat_layer.schedule(L.row_offsets, L.n_rows_per_rel, 0, 8, k)


def test_merged_device_layout_carries_the_fold_schedule():
    L = _layout()
    DL = device_layouts({"Gene": L}, "cpu")["Gene"]
    R = len(L.rel_keys)
    for backward, chunk in ((False, gat_layer.CHUNK_EDGES),
                            (True, gat_layer.BWD_CHUNK_EDGES)):
        want = gat_layer.schedule(L.row_offsets, L.n_rows_per_rel, R,
                                  chunk_edges=chunk)
        got = DL.gat_bwd_schedule if backward else DL.gat_schedule
        assert got.fold_slots == R and got.max_edges == gat_layer.MAX_EDGES
        assert got.chunk_edges == chunk
        for k in ("items", "split_units", "part_offsets"):
            assert torch.equal(getattr(got, k), getattr(want, k)), k
        assert gat_layer.layout_schedule(DL, R, backward) is got
        assert gat_layer.layout_schedule(DL, 0, backward) is None


# ---------------------------- (ii) split-and-combine arithmetic, emulated


def _segments(L, sched, fold):
    """Per edge: its row, and its segment: a row of a packed item, or a
    chunk (n_rows + part). With each chunk's row."""
    ro = L.row_offsets.astype(np.int64)
    n_rows = len(ro) - 1
    dst = np.repeat(np.arange(n_rows), np.diff(ro))
    seg = dst.copy()
    part_row = np.zeros(sched.n_parts, dtype=np.int64)
    for row, p, e0, e1 in sched.items.numpy():
        if e0 >= 0:
            seg[e0:e1] = n_rows + p
            part_row[p] = row
    return torch.from_numpy(dst), torch.from_numpy(seg), torch.from_numpy(
        part_row)


def _emulate_forward(L, xs_all, att, a_dst, fold, mode, max_edges):
    """The kernels' arithmetic in PyTorch: (m, s, acc) per packed row and per
    chunk, then each chunked row's parts merged (log-sum-exp for softmax,
    a plain sum otherwise), the division, and the fold's slot sum."""
    R = len(L.rel_keys)
    n = L.n_rows_per_rel
    sched = gat_layer.schedule(L.row_offsets, n, R if fold else 0, max_edges,
                               max_edges)
    t = torch.from_numpy
    dst, seg, part_row = _segments(L, sched, fold)
    n_rows = L.n_rows_total
    n_seg = n_rows + sched.n_parts
    x = t(xs_all)[t(L.src[:len(dst)]).long()]
    z = (x * t(att)[dst // n]).sum(-1) + t(a_dst)[dst]
    l = torch.where(z >= 0, z, SLOPE * z) / TEMP
    m = torch.full((n_seg,), gat_layer.NEG_BIG).scatter_reduce(
        0, seg, l, "amax", include_self=True)
    if mode == "softmax":
        w = torch.exp(torch.clamp(l - m[seg], max=gat_layer.EXP_CLAMP))
    else:
        w = torch.sigmoid(l) if mode == "sigmoid" else l * TEMP
    s = torch.zeros(n_seg).index_add_(0, seg, w)
    acc = torch.zeros(n_seg, D).index_add_(0, seg, w[:, None] * x)
    row_max, row_sum = m[:n_rows].clone(), s[:n_rows].clone()
    row_acc = acc[:n_rows].clone()
    # the combine, over each chunked row's parts in part order
    if sched.n_parts:
        pm, ps, pacc = m[n_rows:], s[n_rows:], acc[n_rows:]
        big = torch.full((n_rows,), gat_layer.NEG_BIG).scatter_reduce(
            0, part_row, pm, "amax", include_self=True)
        cut = torch.zeros(n_rows, dtype=torch.bool)
        cut[part_row] = True
        sc = (torch.exp(pm - big[part_row]) if mode == "softmax"
              else torch.ones_like(pm))
        row_max[cut] = big[cut]
        row_sum[cut] = torch.zeros(n_rows).index_add_(
            0, part_row, ps * sc)[cut]
        row_acc[cut] = torch.zeros(n_rows, D).index_add_(
            0, part_row, pacc * sc[:, None])[cut]
    if mode == "softmax":
        out = row_acc / (row_sum + gat_layer.EPS)[:, None]
    else:
        out = row_acc
        row_max = torch.full((n_rows,), gat_layer.NEG_BIG)
        row_sum = torch.zeros(n_rows)
    if fold:
        out = out.reshape(R, n, D).sum(0)
    return out, row_max, row_sum, sched


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_split_and_combine_matches_fused_pallas_op(mode, fold):
    L = _layout()
    xs_all, att, a_dst = _inputs(L)
    R = len(L.rel_keys)
    out, _, _, sched = _emulate_forward(L, xs_all, att, a_dst, fold, mode, 8)
    # real rows are cut too, not only the trash rows
    real_cut = [u for u in sched.split_units.tolist()
                if u % L.n_rows_per_rel != L.trash]
    assert real_cut
    msgs = xs_all[L.src]
    if mode == "softmax":
        ref = P.fused_gat_layer(msgs, att, a_dst, L.dst, L.row_offsets,
                                L.tile2rel, L.n_rows_total, SLOPE, TEMP,
                                True, R if fold else 0)
    else:
        ref = P.fused_gat_layer_unnorm(msgs, att, a_dst, L.dst, L.row_offsets,
                                       L.tile2rel, L.n_rows_total, SLOPE,
                                       TEMP, mode, True, R if fold else 0)
    assert out.shape == ((L.n_rows_per_rel if fold else L.n_rows_total), D)
    exact, _, _ = _exact_forward(L, xs_all, att, a_dst, fold, mode)
    _assert_rows(out.numpy(), ref, L, exact)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid"])
def test_split_row_stats_match_merged_forward(mode, fold):
    L = _layout()
    xs_all, att, a_dst = _inputs(L, seed=1)
    ts = P._tile_starts_np(L.row_offsets)
    _, row_max, row_sum = P._merged_forward(
        xs_all[L.src], P._prep_att8(att),
        P._prep_adst_tiles(a_dst, L.n_rows_total), L.dst, ts, L.tile2rel,
        L.n_rows_total, SLOPE, TEMP, interpret=True, mode=mode)
    _, m, s, _ = _emulate_forward(L, xs_all, att, a_dst, fold, mode, 8)
    _, m64, s64 = _exact_forward(L, xs_all, att, a_dst, fold, mode)
    softmax = mode == "softmax"   # else NEG_BIG and 0 on both sides
    _assert_rows(m.numpy(), np.asarray(row_max)[::8].reshape(-1), L,
                 m64 if softmax else None)
    _assert_rows(s.numpy(), np.asarray(row_sum)[::8].reshape(-1), L,
                 s64 if softmax else None)


def _emulate_backward(L, sched, xs_all, att, a_dst, row_max, row_sum, g,
                      fold, mode):
    """The backward kernels' arithmetic: z_e and m_e per edge, dot_row as a
    partial per packed row or chunk, the chunked rows' partials summed in
    part order; then w_e, dz_e and d_a_dst. Returns (w, dz, d_a_dst, dot)
    in the inputs' float type."""
    n = L.n_rows_per_rel
    n_rows = L.n_rows_total
    dst, seg, part_row = _segments(L, sched, fold)
    x = xs_all[torch.from_numpy(L.src[:len(dst)]).long()]
    z = (x * att[dst // n]).sum(-1) + a_dst[dst]
    m = (g[dst % n if fold else dst] * x).sum(-1)
    l = torch.where(z >= 0, z, SLOPE * z) / TEMP
    leaky_d = torch.where(z >= 0, 1.0, SLOPE)
    dot = torch.zeros(n_rows, dtype=x.dtype)
    if mode == "softmax":
        lse = row_max + torch.log(row_sum + gat_layer.EPS)
        w = torch.exp(torch.clamp(l - lse[dst], max=gat_layer.EXP_CLAMP))
        seg_dot = torch.zeros(n_rows + sched.n_parts, dtype=x.dtype)
        seg_dot.index_add_(0, seg, w * m)
        dot = seg_dot[:n_rows].clone()
        dot[part_row] = 0.0
        for p, row in enumerate(part_row.tolist()):      # part order
            dot[row] += seg_dot[n_rows + p]
        dz = w * (m - dot[dst]) * leaky_d / TEMP
    elif mode == "sigmoid":
        w = torch.sigmoid(l)
        dz = m * w * (1.0 - w) * leaky_d / TEMP
    else:
        w = l * TEMP
        dz = m * leaky_d
    d_a_dst = torch.zeros(n_rows, dtype=x.dtype).index_add_(0, dst, dz)
    return w, dz, d_a_dst, dot


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_split_backward_dot_row_matches_plain(mode, fold):
    """dot_row from chunk partials against the plain sum (real rows rtol
    1e-5); then w, dz and d_a_dst against merged_gat_bwd_plain by the rule
    chip_smoke.py holds the backward kernel to: the max abs error against
    the plain version in float64 at most 8 times the float32 plain
    version's, plus 1e-6 of the largest value (d_a_dst of a softmax row is
    a difference of nearly equal terms)."""
    L = _layout()
    xs_all, att, a_dst = _inputs(L, seed=2)
    R = len(L.rel_keys)
    n = L.n_rows_per_rel
    fold_r = R if fold else 0
    rng = np.random.default_rng(5)
    g = rng.standard_normal(((n if fold else L.n_rows_total), D)).astype(
        np.float32)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    args32 = (t(xs_all), t(att), t(a_dst))
    _, row_max, row_sum = gat_layer.merged_gat_forward_plain(
        args32[0], t(L.src), t(L.row_offsets), args32[1], args32[2], n,
        fold_r, mode, SLOPE, TEMP)
    sched = gat_layer.schedule(L.row_offsets, n, fold_r, 8, 8)
    assert sched.n_parts > len(sched.split_units) * sched.fold_slots
    got = _emulate_backward(L, sched, *args32, row_max, row_sum, t(g), fold,
                            mode)
    if mode == "softmax":
        dst = torch.repeat_interleave(torch.arange(L.n_rows_total),
                                      t(np.diff(L.row_offsets)).long())
        x = args32[0][t(L.src[:len(dst)]).long()]
        w, m = got[0], (t(g)[dst % n if fold else dst] * x).sum(-1)
        want_dot = torch.zeros(L.n_rows_total).index_add_(0, dst, w * m)
        _assert_rows(got[3].numpy(), want_dot.numpy(), L)
    plain_args = (t(L.src), t(L.row_offsets))
    f64 = [a.double() for a in (*args32, row_max, row_sum, t(g))]
    plain = gat_layer.merged_gat_bwd_plain(
        args32[0], *plain_args, args32[1], args32[2], row_max, row_sum, t(g),
        n, fold_r, mode, SLOPE, TEMP)
    exact = gat_layer.merged_gat_bwd_plain(
        f64[0], *plain_args, *f64[1:], n, fold_r, mode, SLOPE, TEMP)
    for name, a, p, e in zip(("w", "dz", "d_a_dst"), got, plain, exact):
        k_err = float((a.double() - e).abs().max())
        p_err = float((p.double() - e).abs().max())
        assert k_err <= 8 * p_err + 1e-6 * float(e.abs().max()), name
