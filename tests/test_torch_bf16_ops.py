"""The bf16 forms of the port's layer ops against the JAX package's Pallas
ops (interpret mode) on the same bf16 operands.

One small merged layout (the Gene group of a small synthetic KG, six
relations, D = 128, and its SNP group for the segment sums) and seeded
numpy inputs, rounded to bf16 the same way on both sides (round to
nearest even; checked bit for bit), go through:

* #1, the merged GAT forward: ``gat_layer.merged_gat_forward_plain`` on a
  bf16 table against ``fused_gat_layer`` / ``fused_gat_layer_unnorm`` on
  bf16 messages, softmax, sigmoid and raw, fold R and 0;
* #2 + #8, its VJP: ``gat_layer.merged_gat_backward_plain`` (the edge
  backward, then ``segment.csc_segment_sum_plain`` with the logit term)
  against ``jax.vjp`` of ``gather_rows_csc`` + the fused layer;
* #10, ``segment.csr_segment_sum_plain`` against ``segment_sum_edges`` on
  the messages as the JAX package forms them (bf16 rows, bf16 rows times
  an f32 norm, bf16 rows times bf16 weights);
* #8 alone, ``segment.csc_segment_sum_plain`` without the logit term (with
  the weights' gradient) against the VJP of ``gather_rows_csc`` +
  ``segment_sum_edges``. The JAX package cannot take that VJP with bf16
  weights (its multiply's transpose meets a float32 cotangent: a dtype
  error, checked); there its reference takes the same weights in float32,
  which is the port's backward.

Tolerance: float32 outputs at rtol 1e-5, atol 1e-6, as the f32 tests: the
operands are identical and every rounding to bf16 happens at the same
point, so only the float32 summation order differs; that is what catches
a missing rounding point (a weight not rounded moves a row by up to 2^-9
of its share). Stated exceptions:

* a softmax row whose edges span two of the TPU kernel's 512-edge windows
  with its max logit past the first: the TPU kernel rounds the first
  window's weights against the running max, exp(l - m_0), and rescales
  them by exp(m_0 - m) after rounding, where the port rounds exp(l - m)
  against the row's max; such a row (found from the kernel's tiling) is
  held at rtol 1e-2 (a weight's bf16 ulp), and so are its d_a_dst;
* trash rows (each relation's up to 511 pad edges, and the fold's sum of
  them across relations, which cancels) at rtol 1e-4 with an absolute
  floor of 1e-6 of the row's largest value, as float32 rounding grows with
  the number of terms summed in another order;
* values that the JAX side rounds to bf16 from a float32 value that
  differs in its last bits between the two sides (the message cotangent
  d_msgs, and dz before the d_att dot) may round to the neighbouring bf16
  value, one bf16 ulp (2^-8) apart: in d_xs at most 1 element in 10^4
  misses rtol 1e-5, each within 2^-8 of its row's largest |value|, and
  d_att is held at rtol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu.ops import pallas_gat_layer as P
from kgwas_tpu.ops.pallas_segment import (BE, BN, LANE, gather_rows_csc,
                                          segment_sum_edges)

from kgwas_tpu_torch.models import device_layouts
from kgwas_tpu_torch.models.hetero_gnn import merged_mp_norms
from kgwas_tpu_torch.ops import gat_layer, segment
from test_torch_gat_layer import SLOPE, TEMP, _inputs, _layout

D = 128
RTOL, ATOL = 1e-5, 1e-6
TRASH_RTOL = 1e-4
BF16_RTOL = 1e-2     # one bf16 ulp of a weight, with room for its share
ULP = 2.0 ** -8


@pytest.fixture(scope="module")
def gene():
    L = _layout()
    DL = device_layouts({"Gene": L}, "cpu", path="merged")["Gene"]
    xs, att, ad = _inputs(L)
    xb = jnp.asarray(xs).astype(jnp.bfloat16)
    xt = torch.from_numpy(xs).to(torch.bfloat16)
    # the same bf16 values on both sides
    assert np.array_equal(np.asarray(xb.astype(jnp.float32)),
                          xt.to(torch.float32).numpy())
    return L, DL, xb, xt, att, ad


def _straddling_rows(L, xt, att, ad):
    """Rows whose max logit lies past the first 512-edge window (BE) their
    edges touch in the TPU kernel's tiling (tiles of BN rows, windows from
    the tile's first edge rounded down to LANE): there the TPU kernel
    rounds weights against a running max."""
    x = xt.to(torch.float32).numpy()[L.src].astype(np.float64)
    att_b = torch.from_numpy(att).to(torch.bfloat16).to(torch.float32)
    ro = L.row_offsets.astype(np.int64)
    n_rows = len(ro) - 1
    dst = np.repeat(np.arange(n_rows), np.diff(ro))
    z = (x[:len(dst)] * att_b.numpy()[dst // L.n_rows_per_rel]).sum(-1) \
        + ad[dst]
    lg = np.where(z >= 0, z, SLOPE * z) / TEMP
    start = ro[(dst // BN) * BN]
    win = (np.arange(len(dst)) - (start - start % LANE)) // BE
    rows = []
    for r in np.nonzero(np.diff(ro) > 0)[0]:
        e0, e1 = ro[r], ro[r + 1]
        first = win[e0:e1] == win[e0]
        if lg[e0:e1][first].max() < lg[e0:e1].max():
            rows.append(r)
    return np.asarray(rows, dtype=np.int64)


def _row_classes(L, n_out, fold, straddle):
    """(trash, straddle) masks over the output rows."""
    n = L.n_rows_per_rel
    trash = np.zeros(n_out, dtype=bool)
    bad = np.zeros(n_out, dtype=bool)
    if fold:
        trash[L.trash] = True
        bad[straddle % n] = True
    else:
        trash[L.trash::n] = True
        bad[straddle] = True
    return trash, bad & ~trash


def _assert_rows(got, want, trash, straddle):
    got, want = np.asarray(got), np.asarray(want)
    real = ~trash & ~straddle
    np.testing.assert_allclose(got[real], want[real], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[straddle], want[straddle],
                               rtol=BF16_RTOL, atol=1e-4)
    for r in np.nonzero(trash)[0]:
        np.testing.assert_allclose(
            got[r], want[r], rtol=TRASH_RTOL,
            atol=max(ATOL, 1e-6 * float(np.abs(want[r]).max())))


def _jax_layer(L, mode, fold):
    def f(x, a, d):
        msgs = gather_rows_csc(x, jnp.asarray(L.src), L.csc_perm, L.csc_ids,
                               L.csc_offsets, L.n_src_total, True)
        if mode == "softmax":
            return P.fused_gat_layer(msgs, a, d, L.dst, L.row_offsets,
                                     L.tile2rel, L.n_rows_total, SLOPE, TEMP,
                                     True, fold)
        return P.fused_gat_layer_unnorm(msgs, a, d, L.dst, L.row_offsets,
                                        L.tile2rel, L.n_rows_total, SLOPE,
                                        TEMP, mode, True, fold)
    return f


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_bf16_forward_matches_pallas(gene, mode, fold):
    L, DL, xb, xt, att, ad = gene
    R = len(L.rel_keys)
    fold = R if fold else 0
    want = np.asarray(_jax_layer(L, mode, fold)(xb, jnp.asarray(att),
                                                 jnp.asarray(ad)))
    out, row_max, row_sum = gat_layer.merged_gat_forward_plain(
        xt, DL.src, DL.row_offsets, torch.from_numpy(att),
        torch.from_numpy(ad), L.n_rows_per_rel, fold, mode, SLOPE, TEMP)
    assert out.dtype == torch.float32 and out.shape == want.shape
    straddle = (_straddling_rows(L, xt, att, ad) if mode == "softmax"
                else np.zeros(0, dtype=np.int64))
    assert len(straddle) < 0.01 * L.n_rows_total
    _assert_rows(out.numpy(), want, *_row_classes(L, len(want), fold,
                                                  straddle))
    if mode == "softmax" and not fold:
        # the row statistics, as the TPU kernel writes them
        ts = P._tile_starts_np(L.row_offsets)
        _, jm, js = P._merged_forward(
            xb[jnp.asarray(L.src)], P._prep_att8(jnp.asarray(att)),
            P._prep_adst_tiles(jnp.asarray(ad), L.n_rows_total), L.dst, ts,
            L.tile2rel, L.n_rows_total, SLOPE, TEMP, interpret=True,
            mode=mode)
        trash, _ = _row_classes(L, L.n_rows_total, 0, straddle)
        for got, ref in ((row_max, jm), (row_sum, js)):
            ref = np.asarray(ref)[::8].reshape(-1)
            np.testing.assert_allclose(got.numpy()[~trash], ref[~trash],
                                       rtol=RTOL, atol=ATOL)


def _assert_flips(got, want):
    """d_xs: rtol 1e-5 / atol 1e-6 but for at most 1 element in 10^4, each
    within one bf16 ulp of its row's largest |value|."""
    got, want = np.asarray(got), np.asarray(want)
    miss = ~np.isclose(got, want, rtol=RTOL, atol=ATOL)
    assert miss.sum() <= max(1, want.size // 10 ** 4), miss.sum()
    scale = np.abs(want).max(axis=1, keepdims=True)
    assert np.all(np.abs(got - want) <= ULP * scale + ATOL)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_bf16_backward_matches_pallas(gene, mode, fold):
    L, DL, xb, xt, att, ad = gene
    R = len(L.rel_keys)
    fold = R if fold else 0
    n_out = L.n_rows_per_rel if fold else L.n_rows_total
    g = (np.random.default_rng(5).standard_normal((n_out, D))
         * 0.1).astype(np.float32)
    _, vjp = jax.vjp(_jax_layer(L, mode, fold), xb, jnp.asarray(att),
                     jnp.asarray(ad))
    jdx, jdatt, jdad = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    _, row_max, row_sum = gat_layer.merged_gat_forward_plain(
        xt, DL.src, DL.row_offsets, torch.from_numpy(att),
        torch.from_numpy(ad), L.n_rows_per_rel, fold, mode, SLOPE, TEMP)
    dx, datt, dad = gat_layer.merged_gat_backward_plain(
        xt, torch.from_numpy(att), torch.from_numpy(ad), row_max, row_sum,
        torch.from_numpy(g), DL, fold, mode, SLOPE, TEMP)
    assert dx.dtype == datt.dtype == dad.dtype == torch.float32
    straddle = (_straddling_rows(L, xt, att, ad) if mode == "softmax"
                else np.zeros(0, dtype=np.int64))
    _assert_rows(dad.numpy(), jdad, *_row_classes(L, L.n_rows_total, 0,
                                                  straddle))
    _assert_flips(dx.numpy(), jdx)
    np.testing.assert_allclose(datt.numpy(), jdatt, rtol=TRASH_RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def snp():
    L = _layout("SNP")
    DL = device_layouts({"SNP": L}, "cpu", path="mp")["SNP"]
    rng = np.random.default_rng(11)
    x = (rng.standard_normal((L.n_src_total, D)) * 0.1).astype(np.float32)
    _, sym_e = merged_mp_norms(L)
    return L, DL, jnp.asarray(x).astype(jnp.bfloat16), \
        torch.from_numpy(x).to(torch.bfloat16), sym_e


def _weights(kind, sym_e):
    """(port w, JAX multiplier) of a weight kind: none (SAGE), the f32
    norm (GCN, SGC: bf16 rows times f32 promote to f32), bf16 weights
    (the per-relation sigmoid GAT under compute_dtype: bf16 products)."""
    if kind == "none":
        return None, None
    if kind == "f32":
        return torch.from_numpy(sym_e), jnp.asarray(sym_e)
    wb = torch.from_numpy(sym_e).to(torch.bfloat16)
    return wb, jnp.asarray(sym_e).astype(jnp.bfloat16)


def _jax_mp(L, jw):
    def f(x, w=jw):
        msgs = gather_rows_csc(x, jnp.asarray(L.src), L.csc_perm, L.csc_ids,
                               L.csc_offsets, L.n_src_total, True)
        if w is not None:
            msgs = msgs * w[:, None]
        return segment_sum_edges(msgs, jnp.asarray(L.dst),
                                 jnp.asarray(L.row_offsets), L.n_rows_total,
                                 True)
    return f


@pytest.mark.parametrize("kind", ["none", "f32", "bf16"])
def test_bf16_csr_segment_sum_matches_pallas(snp, kind):
    L, DL, xb, xt, sym_e = snp
    w, jw = _weights(kind, sym_e)
    want = np.asarray(_jax_mp(L, jw)(xb))
    got = segment.csr_segment_sum_plain(xt, DL.src, DL.row_offsets, w)
    assert got.dtype == torch.float32
    trash, _ = _row_classes(L, L.n_rows_total, 0, np.zeros(0, np.int64))
    _assert_rows(got.numpy(), want, trash, np.zeros_like(trash))


@pytest.mark.parametrize("kind", ["none", "f32", "bf16"])
def test_bf16_csc_segment_sum_matches_pallas(snp, kind):
    """#8 without the logit term: the message-passing backward (the JAX
    package's cotangents there are float32: no rounding) and, for a
    weighted sum, the weights' gradient."""
    L, DL, xb, xt, sym_e = snp
    w, jw = _weights(kind, sym_e)
    g = (np.random.default_rng(6).standard_normal((L.n_rows_total, D))
         * 0.1).astype(np.float32)
    if kind == "bf16":
        _, vjp = jax.vjp(lambda x, v: _jax_mp(L, v)(x), xb, jw)
        with pytest.raises(TypeError, match="same dtypes"):
            vjp(jnp.asarray(g))
        jw = jw.astype(jnp.float32)
    if jw is None:
        _, vjp = jax.vjp(_jax_mp(L, None), xb)
        (jdx,) = vjp(jnp.asarray(g))
    else:
        _, vjp = jax.vjp(lambda x, v: _jax_mp(L, v)(x), xb, jw)
        jdx, jdw = vjp(jnp.asarray(g))
    wf = None if w is None else w.to(torch.float32)
    out = segment.csc_segment_sum_plain(torch.from_numpy(g), wf, None, xt,
                                        None, DL, 0, edge_grad=w is not None)
    assert out[0].dtype == torch.float32 and out[1] is None
    np.testing.assert_allclose(out[0].numpy(), np.asarray(jdx), rtol=RTOL,
                               atol=ATOL)
    if w is not None:
        e = L.rel_num_edges
        real = np.concatenate([np.arange(b, b + n) for b, n in
                               zip(L.edge_base, e)])
        np.testing.assert_allclose(out[2].numpy()[real],
                                   np.asarray(jdw)[real], rtol=RTOL,
                                   atol=ATOL)
