"""The merged GAT layer's per-source-row scores, which the bf16 instances of
kernels #1 and #2 read (``gat_layer.merged_gat_a_src``), on the CPU.

An edge's score ``att[slot] . xs_all[src_e]`` depends on its source row
alone, as long as every slot row r*N + n reads rows that slot r owns,
``src_base[r] <= src_e < src_base[r+1]``. Then one dot per source row,
``a_src[s]``, gathered by ``src`` gives every edge's score:

* ``merged_gat_a_src_plain`` gathered by ``src``, plus ``a_dst`` of the
  edge's row, is bitwise the ``z`` that ``gat_layer._edge_terms`` forms
  per edge (bf16 and float32 tables; the Gene and the SNP group of a small
  synthetic KG);
* the plain forward and backward with their per-edge score replaced by
  the gathered ``a_src`` give the same bits as the plain versions, in
  every mode, fold 0 and R, and (bf16 table) still match the JAX
  package's Pallas kernels #1 and #2 in interpret mode, with
  ``tests/test_torch_bf16_ops.py``'s tolerances and stated exceptions;
* ``a_src`` against the score of the TPU kernel's ``_logits_row`` (att
  cast to bf16, float32 accumulation) at rtol 1e-5: another summation
  order;
* every layout ``build_merged_layouts`` makes, and every rank's part of
  the sharded layouts (``merged_shard.RankShard`` over 2 and 4 ranks),
  keeps each slot's sources inside its rows (``check_src_owner``, which
  ``device_layouts`` and ``RankShard`` run once); an edge moved into
  another slot's rows is refused.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu.ops import pallas_gat_layer as P

from kgwas_tpu_torch.graph import (build_merged_layouts, compile_graph,
                                   make_synthetic_kg)
from kgwas_tpu_torch.models import device_layouts
from kgwas_tpu_torch.ops import gat_layer
from kgwas_tpu_torch.parallel import merged_shard
from test_torch_bf16_ops import (_assert_flips, _assert_rows, _jax_layer,
                                 _row_classes, _straddling_rows)
from test_torch_gat_layer import SLOPE, TEMP, _inputs, _layout
from torch_threads import few_torch_threads  # noqa: F401,E402

D = 128
GROUPS = ("Gene", "SNP")
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


@pytest.fixture(scope="module")
def layouts():
    return {t: _layout(t) for t in GROUPS}


def _case(L, dtype):
    xs, att, ad = _inputs(L)
    return (torch.from_numpy(xs).to(dtype), torch.from_numpy(att),
            torch.from_numpy(ad))


def _scored_edge_terms(real):
    """gat_layer._edge_terms with each edge's score read from the gathered
    per-source-row a_src of the layout whose src_base it is given."""
    def edge_terms(xs_all, src, row_offsets, att, a_dst_all, n_rows_per_rel,
                   negative_slope, temperature):
        dst, x, _, _ = real(xs_all, src, row_offsets, att, a_dst_all,
                            n_rows_per_rel, negative_slope, temperature)
        a_src = gat_layer.merged_gat_a_src_plain(xs_all, att,
                                                 edge_terms.src_base)
        z = a_src[src[:dst.shape[0]].long()] + a_dst_all[dst]
        l = torch.where(z >= 0, z, negative_slope * z) / temperature
        return dst, x, z, l
    return edge_terms


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("group", GROUPS)
def test_a_src_gathered_is_the_edge_score(group, dtype, layouts):
    L = layouts[group]
    xs, att, ad = _case(L, DTYPES[dtype])
    src = torch.from_numpy(L.src)
    ro = torch.from_numpy(L.row_offsets)
    a_src = gat_layer.merged_gat_a_src_plain(xs, att, L.src_base)
    assert a_src.dtype == torch.float32 and a_src.shape == (L.n_src_total,)
    # the wrapper runs the plain version on a CPU table
    assert torch.equal(gat_layer.merged_gat_a_src(xs, att, L.src_base), a_src)
    dst, _, z, _ = gat_layer._edge_terms(xs, src, ro, att, ad,
                                         L.n_rows_per_rel, SLOPE, TEMP)
    assert torch.equal(a_src[src[:dst.shape[0]].long()] + ad[dst], z)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", gat_layer.MODES)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("group", GROUPS)
def test_plain_versions_around_a_src_bitwise(group, dtype, mode, fold,
                                             layouts, monkeypatch):
    """The plain forward and backward, their scores taken from a_src, give
    the plain versions' bits."""
    L = layouts[group]
    fold = len(L.rel_keys) if fold else 0
    xs, att, ad = _case(L, DTYPES[dtype])
    src = torch.from_numpy(L.src)
    ro = torch.from_numpy(L.row_offsets)
    n = L.n_rows_per_rel
    g = torch.from_numpy((np.random.default_rng(5).standard_normal(
        (n if fold else L.n_rows_total, D)) * 0.1).astype(np.float32))
    args = (xs, src, ro, att, ad, n, fold, mode, SLOPE, TEMP)

    def run():
        out = gat_layer.merged_gat_forward_plain(*args)
        bwd = gat_layer.merged_gat_bwd_plain(*args[:5], out[1], out[2], g,
                                             *args[5:])
        return out + bwd

    want = run()
    scored = _scored_edge_terms(gat_layer._edge_terms)
    scored.src_base = L.src_base
    monkeypatch.setattr(gat_layer, "_edge_terms", scored)
    got = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def gene_bf16():
    """test_torch_bf16_ops.py's case: its Gene layout, the same bf16
    table on both sides."""
    L = _layout()
    DL = device_layouts({"Gene": L}, "cpu", path="merged")["Gene"]
    xs, att, ad = _inputs(L)
    xb = jnp.asarray(xs).astype(jnp.bfloat16)
    xt = torch.from_numpy(xs).to(torch.bfloat16)
    assert np.array_equal(np.asarray(xb.astype(jnp.float32)),
                          xt.to(torch.float32).numpy())
    return L, DL, xb, xt, att, ad


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", gat_layer.MODES)
def test_bf16_around_a_src_matches_pallas(gene_bf16, mode, fold,
                                          monkeypatch):
    """The plain bf16 forward and backward around a_src against the
    JAX package's Pallas #1 and its VJP (#2 + the gather's backward) in
    interpret mode."""
    L, DL, xb, xt, att, ad = gene_bf16
    R = len(L.rel_keys)
    fold = R if fold else 0
    n_out = L.n_rows_per_rel if fold else L.n_rows_total
    scored = _scored_edge_terms(gat_layer._edge_terms)
    scored.src_base = L.src_base
    monkeypatch.setattr(gat_layer, "_edge_terms", scored)
    g = (np.random.default_rng(5).standard_normal((n_out, D))
         * 0.1).astype(np.float32)
    layer = _jax_layer(L, mode, fold)
    want, vjp = jax.vjp(layer, xb, jnp.asarray(att), jnp.asarray(ad))
    jdx, _, jdad = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    out, row_max, row_sum = gat_layer.merged_gat_forward_plain(
        xt, DL.src, DL.row_offsets, torch.from_numpy(att),
        torch.from_numpy(ad), L.n_rows_per_rel, fold, mode, SLOPE, TEMP)
    dx, _, dad = gat_layer.merged_gat_backward_plain(
        xt, torch.from_numpy(att), torch.from_numpy(ad), row_max, row_sum,
        torch.from_numpy(g), DL, fold, mode, SLOPE, TEMP)
    straddle = (_straddling_rows(L, xt, att, ad) if mode == "softmax"
                else np.zeros(0, dtype=np.int64))
    _assert_rows(out.numpy(), np.asarray(want),
                 *_row_classes(L, n_out, fold, straddle))
    _assert_rows(dad.numpy(), jdad, *_row_classes(L, L.n_rows_total, 0,
                                                  straddle))
    _assert_flips(dx.numpy(), jdx)


@pytest.mark.parametrize("group", GROUPS)
def test_a_src_matches_the_pallas_score(group, layouts):
    """a_src of a bf16 table against the TPU kernel's score of the same
    rows (_logits_row: att cast to bf16, a float32 product), a_dst 0."""
    L = layouts[group]
    xs, att, _ = _case(L, torch.bfloat16)
    got = gat_layer.merged_gat_a_src_plain(xs, att, L.src_base).numpy()
    xj = jnp.asarray(xs.to(torch.float32).numpy()).astype(jnp.bfloat16)
    for r, (b0, b1) in enumerate(zip(L.src_base, L.src_base[1:])):
        if b1 == b0:
            continue
        z, _ = P._logits_row(xj[b0:b1], jnp.asarray(att.numpy()[r:r + 1]),
                             jnp.zeros((1, 1), jnp.float32),
                             jnp.zeros((1, b1 - b0), jnp.float32), SLOPE,
                             TEMP)
        np.testing.assert_allclose(got[b0:b1], np.asarray(z)[0], rtol=1e-5,
                                   atol=1e-6)


def _owned(src, row_offsets, n_rows_per_rel, src_base):
    ro = np.asarray(row_offsets, np.int64)
    slot = np.repeat(np.arange(len(ro) - 1) // n_rows_per_rel, np.diff(ro))
    s = np.asarray(src, np.int64)[:ro[-1]]
    base = np.asarray(src_base, np.int64)
    return bool(((s >= base[slot]) & (s < base[slot + 1])).all())


@pytest.mark.parametrize("kg,n_dev", [(dict(seed=3), None),
                                      (dict(n_go=600, seed=7), 2),
                                      (dict(n_go=1600, seed=7), 4)],
                         ids=["small", "go600-2", "go1600-4"])
def test_layouts_keep_sources_in_their_slots(kg, n_dev):
    cg = compile_graph(make_synthetic_kg(**dict(
        dict(n_snp=300, n_gene=60, n_go=30, snp_dim=20, gene_dim=32,
             go_dim=16), **kg)), edge_pad_multiple=512, node_pad_multiple=512)
    host = build_merged_layouts(cg, tile_rows=512)
    assert set(host) >= {"SNP", "Gene"}
    for t, L in host.items():
        assert _owned(L.src, L.row_offsets, L.n_rows_per_rel, L.src_base), t
        gat_layer.check_src_owner(L.src, L.row_offsets, L.n_rows_per_rel,
                                  L.src_base)
    dls = device_layouts(host, "cpu", path="merged")
    assert all(dls[t].src_base == tuple(host[t].src_base) for t in host)
    if n_dev is None:
        return
    split = 0
    for t, L in host.items():
        if (L.n_rows_total // merged_shard.TILE) % n_dev or \
                L.n_src_total % n_dev:
            continue
        DL = merged_shard.build_device_layouts(L, n_dev)
        for i in range(n_dev):
            s = merged_shard.RankShard(L, DL, i, "cpu")
            assert len(s.src_base) == s.s_hi - s.s_lo + 1
            assert _owned(s.src.numpy(), s.row_offsets.numpy(),
                          L.n_rows_per_rel, s.src_base), (t, i)
        split += 1
    assert split >= 3


def test_check_src_owner_refuses_an_edge_in_another_slot(layouts):
    L = layouts["Gene"]
    src = L.src.copy()
    e = int(L.row_offsets[L.n_rows_per_rel])   # slot 1's first edge
    src[e] = L.src_base[0]                     # a row of slot 0
    with pytest.raises(ValueError, match="outside the slot's rows"):
        gat_layer.check_src_owner(src, L.row_offsets, L.n_rows_per_rel,
                                  L.src_base)
    bad = copy.copy(L)
    bad.src = src
    with pytest.raises(ValueError, match="outside the slot's rows"):
        device_layouts({"Gene": bad}, "cpu", path="merged")
    with pytest.raises(ValueError, match="slots"):
        gat_layer.check_src_owner(L.src, L.row_offsets, L.n_rows_per_rel,
                                  L.src_base[:-1])
