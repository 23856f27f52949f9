"""The per-relation model variants of the port against the JAX package:
sigmoid GAT and SAGE / GCN / SGC with max and min, dropout, edge_dim,
pheno_condition and remat; and the plain versions of the kernels' new
multiplier (#6, #7) and weight gradient (#8) against float64.

From the same weights, on the 90-SNP KG of tests/test_torch_model_heads.py
(jax matmul precision 'highest'), the port on the CPU (the plain versions
of its kernels) against the JAX package:

  * sigmoid GAT with max and min at hidden 128: the forward and jax.grad of
    apply_hetero_gnn(use_pallas=True), whose per-relation sigmoid layer
    runs segment_sum_edges (#10) with its gather's CSC backward (#8), both
    in interpret mode; the port's weights get their gradient through
    CSRSegmentSum's backward (#8 with d_w)
  * SAGE, GCN and SGC with max and min (apply_sage / apply_gcn / apply_sgc
    per relation, their norms over the real edges only)
  * one relation's GAT layer with dropout (softmax and sigmoid, H = 2):
    apply_gat with a dropout_rng, whose mask the test draws again as
    apply_gat draws it (jax.random.bernoulli on the [E_pad, H] alpha),
    against gat_relation with keep = mask / (1 - p)
  * the edge_dim term: one relation's layer (tests/test_model.py:92's
    setting: edge_dim 1 with [E] attributes, and edge_dim 3 at H = 2) and
    the model with edge_attr in every relation's edge arrays
    (tests/test_model.py:151's setting)
  * pheno_condition: its parameters are created and inert
  * remat: gradients bitwise equal to those without remat (with a fixed
    dropout mask from one generator seed), and within the tolerance of the
    JAX package's remat=True

Forward rtol 1e-4, atol 1e-5 on real rows; gradients rtol 1e-4 with an
absolute floor of 1e-6 of the largest gradient. The plain versions with the
multiplier and d_w against float64 references written independently of
them: rtol 1e-5 with a floor of 1e-6 of the largest value.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu.config import ModelConfig as JaxModelConfig
from kgwas_tpu.engine.checkpoint import flatten_params as jax_flatten
from kgwas_tpu.models import init_hetero_gnn
from kgwas_tpu.models.convs import apply_gat, init_gat
from kgwas_tpu.models.hetero_gnn import apply_hetero_gnn

from kgwas_tpu_torch.engine import flatten_params, params_from_jax, params_to_jax
from kgwas_tpu_torch.graph import build_merged_layouts
from kgwas_tpu_torch.models import GATConv, device_layouts, gat_relation
from kgwas_tpu_torch.ops import segment, segment_softmax
from kgwas_tpu_torch.ops.segment_ref import csr_rows

from test_torch_model_heads import (FWD_ATOL, FWD_RTOL, LOSS_RTOL,  # noqa: F401
                                    assert_grads_close, jax_loss_grads,
                                    port_loss_grads, port_model, world)
from test_torch_train_layouts import reached  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401,E402

REF_RTOL, REF_FLOOR = 1e-5, 1e-6


def _params(world, cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
        jax.random.PRNGKey(seed), cfg, world[0].meta(), 20, 32, 16))


def _assert_model_matches(world, cfg, **fwd):
    params = _params(world, cfg)
    want_pred, want_loss, want = jax_loss_grads(world, cfg, params)
    got_pred, got_loss, got = port_loss_grads(world, cfg, params, **fwd)
    n = len(world[2])
    assert np.abs(want_pred[:n]).max() > 0
    np.testing.assert_allclose(got_pred[:n], want_pred[:n], rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert_grads_close(got, want)


@pytest.mark.parametrize("aggr", ["max", "min"])
def test_sigmoid_gat_max_min_match_jax(world, reached, aggr):  # noqa: F811
    cfg = JaxModelConfig(gnn_hidden_dim=128, gnn_num_layers=2, no_relu=True,
                         use_pallas=True, sigmoid_gat=True, gnn_aggr=aggr)
    _assert_model_matches(world, cfg)
    # the JAX side ran #10 forward and #8 in its gather's backward
    assert set(reached) == {8, 10}


@pytest.mark.parametrize("backbone,aggr", [
    ("SAGE", "max"), ("SAGE", "min"), ("GCN", "min"), ("SGC", "max")])
def test_message_passing_max_min_match_jax(world, backbone, aggr):
    cfg = JaxModelConfig(gnn_hidden_dim=16, gnn_num_layers=2, no_relu=True,
                         gnn_backbone=backbone, gnn_aggr=aggr)
    _assert_model_matches(world, cfg)


# ---------------------------------------------------- one relation's layer

RK = "SNP__Enhancer-eQTL-Gene__Gene"   # bipartite: lin_src and lin_dst
C, DIN, TEMP, P_DROP = 8, 6, 0.7, 0.3


def _relation(world):
    """(JAX relation shard, the port's relation DeviceLayout, its source
    and destination row counts)."""
    cg_j, cg, _ = world
    r = cg.relations[RK]
    L = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu", cg,
                       "relations")[r.dst_type]
    RL = L.relations[L.rel_keys.index(RK)]
    return (cg_j.relations[RK], RL, cg.padded_nodes[r.src_type],
            cg.padded_nodes[r.dst_type], cg.num_nodes[r.dst_type])


def _conv_from_jax(p, heads, edge_dim=None):
    """The port's GATConv holding the JAX init_gat params p."""
    conv = GATConv(DIN, C, heads, False, torch.Generator().manual_seed(0),
                   edge_dim)
    sd = params_from_jax({"convs": [{RK: p}],
                          "lin": {"w": np.zeros((1, 1), np.float32),
                                  "b": np.zeros(1, np.float32)}})
    pre = f"convs.0.convs.{RK}."
    conv.load_state_dict({k[len(pre):]: v for k, v in sd.items()
                          if k.startswith(pre)})
    return conv


def _relation_grads(world, heads, mode, keep_rng=None, edge_dim=None,
                    ea_shape=None):
    """One relation's layer through apply_gat and through gat_relation from
    the same params and inputs: (port out, JAX out) on the real rows and
    the gradients of sum(out * G) with respect to the params and the
    inputs, both flattened."""
    rj, RL, n_src, n_dst, n_real = _relation(world)
    rng = np.random.default_rng(3)
    x_src = rng.standard_normal((n_src, DIN)).astype(np.float32)
    x_dst = rng.standard_normal((n_dst, DIN)).astype(np.float32)
    cot = rng.standard_normal((n_dst, heads * C)).astype(np.float32)
    cot[n_real:] = 0   # the real rows: the trash row is not the layer's
    ea = None
    if ea_shape is not None:
        ea = rng.standard_normal((len(rj.src),) + ea_shape).astype(np.float32)
    p = jax.tree_util.tree_map(np.asarray, init_gat(
        jax.random.PRNGKey(4), DIN, DIN, C, heads, edge_dim=edge_dim))

    def jax_fn(p, xs, xd):
        out, _ = apply_gat(
            p, xs, xd, jnp.asarray(rj.src), jnp.asarray(rj.dst),
            rj.num_edges, n_dst, heads=heads, out_channels=C,
            temperature=TEMP, sigmoid_gat=mode == "sigmoid",
            dropout_p=P_DROP if keep_rng is not None else 0.0,
            dropout_rng=keep_rng,
            edge_attr=None if ea is None else jnp.asarray(ea))
        return jnp.sum(out * cot), out

    (_, want), grads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2),
                                          has_aux=True)(p, x_src, x_dst)
    keep = None
    if keep_rng is not None:
        # apply_gat's draw on its [E_pad, H] alpha, then where(keep,
        # alpha / (1 - p), 0)
        mask = jax.random.bernoulli(keep_rng, 1.0 - P_DROP,
                                    (len(rj.src), heads))
        keep = torch.from_numpy(np.asarray(mask, dtype=np.float32)
                                / (1.0 - P_DROP))
        assert 0 < float((keep == 0).float().mean()) < 1
    conv = _conv_from_jax(p, heads, edge_dim)
    xs = torch.from_numpy(x_src).requires_grad_()
    xd = torch.from_numpy(x_dst).requires_grad_()
    got = gat_relation(conv, xs, xd, RL, 0.2, TEMP, mode, keep,
                       None if ea is None else torch.from_numpy(ea))
    (got * torch.from_numpy(cot)).sum().backward()
    g_port = {"x_src": xs.grad.numpy(), "x_dst": xd.grad.numpy()}
    g_port.update({k: v.grad.numpy() for k, v in conv.named_parameters()})
    sd = params_to_jax({f"convs.0.convs.{RK}.{k}": v.grad
                        for k, v in conv.named_parameters()})
    g_jax = {"x_src": np.asarray(grads[1]), "x_dst": np.asarray(grads[2])}
    g_port = {"x_src": g_port["x_src"], "x_dst": g_port["x_dst"],
              **flatten_params(sd["convs"][0][RK])}
    g_jax.update(flatten_params(jax.tree_util.tree_map(np.asarray,
                                                       grads[0])))
    return got.detach().numpy()[:n_real], np.asarray(want)[:n_real], \
        g_port, g_jax


@pytest.mark.parametrize("mode", ["softmax", "sigmoid"])
def test_gat_relation_keep_matches_apply_gat_dropout(world, mode):
    got, want, g_port, g_jax = _relation_grads(
        world, 2, mode, keep_rng=jax.random.PRNGKey(17))
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    assert_grads_close(g_port, g_jax)


@pytest.mark.parametrize("edge_dim,heads", [(1, 1), (3, 2)])
def test_gat_relation_edge_attr_matches_apply_gat(world, edge_dim, heads):
    got, want, g_port, g_jax = _relation_grads(
        world, heads, "softmax", edge_dim=edge_dim,
        ea_shape=() if edge_dim == 1 else (edge_dim,))
    assert "lin_edge/w" in g_jax and "att_edge" in g_jax
    np.testing.assert_allclose(got, want, rtol=FWD_RTOL, atol=FWD_ATOL)
    assert_grads_close(g_port, g_jax)


def test_model_edge_attr_matches_jax(world):
    """edge_dim=2 with edge_attr in every relation's edge arrays: the
    per-relation path with the edge term, forward and gradients."""
    cg_j, cg, y = world
    cfg = JaxModelConfig(gnn_hidden_dim=16, gnn_num_layers=2, no_relu=True,
                         edge_dim=2)
    params = _params(world, cfg, seed=6)
    rng = np.random.default_rng(4)
    ea = {rk: rng.standard_normal((len(r.src), 2)).astype(np.float32)
          for rk, r in cg.relations.items()}
    meta, arrays = cg_j.meta(), cg_j.arrays()
    for rk, ed in arrays["edges"].items():
        ed["edge_attr"] = jnp.asarray(ea[rk])
    n = len(y)

    def loss_fn(p):
        pred = apply_hetero_gnn(p, cfg, meta, arrays)
        return jnp.mean((pred[:n, 0] - jnp.asarray(y)) ** 2), pred

    (_, want_pred), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    want = jax_flatten(jax.tree_util.tree_map(np.asarray, grads))
    got_pred, _, got = port_loss_grads(
        world, cfg, params,
        edge_attr={k: torch.from_numpy(v) for k, v in ea.items()})
    np.testing.assert_allclose(got_pred[:n], np.asarray(want_pred)[:n],
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    # without edge_attr the term is absent: another forward
    plain_pred, _, _ = port_loss_grads(world, cfg, params)
    assert np.abs(plain_pred[:n] - got_pred[:n]).max() > 1e-6
    assert_grads_close(got, want)


def test_pheno_condition_params_created_and_inert(world):
    gen = torch.Generator().manual_seed(0)
    att = GATConv(DIN, C, 1, False, gen, pheno_condition="ATT")
    assert att.lin_edge_ is not None and att.att_edge is not None
    assert att.lin_edge is None and att.pheno_mlp is None
    msg = GATConv(DIN, C, 2, False, gen, edge_dim=4, pheno_condition="MSG")
    assert msg.pheno_mlp.weight.shape == (2 * C, 4)
    with pytest.raises(ValueError, match="MSG"):
        GATConv(DIN, C, 1, False, gen, pheno_condition="MSG")
    # inert: the forward is the same bits with the parameters scrambled,
    # and they get no gradient
    cfg = JaxModelConfig(gnn_hidden_dim=16, gnn_num_layers=2, no_relu=True,
                         pheno_condition="ATT")
    model, layouts, x = port_model(world[1], cfg, _params(world, cfg))
    before = model(x, layouts)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if "lin_edge_" in name or "att_edge" in name:
                p.add_(1.0)
    after = model(x, layouts)
    assert torch.equal(before, after)
    after.sum().backward()
    assert all(p.grad is None for name, p in model.named_parameters()
               if "lin_edge_" in name or "att_edge" in name)


# ------------------------------------------------------------------ remat

def test_remat_grads_bitwise_and_match_jax(world):
    _, cg, _ = world
    # with a fixed dropout mask (one generator seed): bitwise
    grads = []
    for remat in (False, True):
        cfg = JaxModelConfig(gnn_hidden_dim=16, gnn_num_layers=2,
                             gat_num_head=2, dropout=0.1, no_relu=True,
                             remat=remat)
        params = _params(world, cfg, seed=8)
        _, _, g = port_loss_grads(
            world, cfg, params, training=True,
            dropout_gen=torch.Generator().manual_seed(5))
        grads.append(g)
    assert sorted(grads[0]) == sorted(grads[1])
    for k in grads[0]:
        np.testing.assert_array_equal(grads[0][k], grads[1][k], err_msg=k)
    # against the JAX package's remat=True, GAT sum at two heads
    cfg = JaxModelConfig(gnn_hidden_dim=16, gnn_num_layers=2, gat_num_head=2,
                         no_relu=True, remat=True)
    _assert_model_matches(world, cfg)


# ----------------------------------- the plain multiplier and d_w, float64

def _stream(seed=5, n_rows=40, n_src=60, d=12):
    rng = np.random.default_rng(seed)
    deg = rng.poisson(3, n_rows)
    deg[::7] = 0
    ro = np.concatenate([[0], np.cumsum(deg)]).astype(np.int32)
    src = rng.integers(0, n_src, ro[-1]).astype(np.int32)
    return (torch.from_numpy(rng.standard_normal((n_src, d))),
            torch.from_numpy(src), torch.from_numpy(rng.standard_normal(
                ro[-1]) * 1.5), torch.from_numpy(ro),
            torch.from_numpy(((rng.random(ro[-1]) >= 0.3) / 0.7)),
            torch.from_numpy(rng.standard_normal((n_rows, d))))


def _close64(got, ref):
    ref = ref.detach()
    np.testing.assert_allclose(got.double().numpy(), ref.numpy(),
                               rtol=REF_RTOL,
                               atol=REF_FLOOR * float(ref.abs().max()))


def test_plain_mult_versions_match_float64():
    """segment_softmax_spmm_fwd_plain / _bwd_plain with a multiplier (in
    float32) against a float64 reference: a softmax per row and the
    multiplied sum, and autograd of it for the logits' cotangent."""
    xs, src, logits, ro, mult, g = _stream()
    rows = csr_rows(ro)
    l64 = logits.clone().requires_grad_()
    out64 = torch.zeros(ro.shape[0] - 1, xs.shape[1], dtype=torch.float64)
    alpha = torch.zeros_like(l64)
    for r in range(ro.shape[0] - 1):
        e0, e1 = int(ro[r]), int(ro[r + 1])
        if e1 > e0:
            a = torch.softmax(l64[e0:e1], 0)
            alpha = alpha.index_put((torch.arange(e0, e1),), a)
            out64[r] = (a * mult[e0:e1])[None] @ xs[src[e0:e1].long()]
    f32 = lambda t: t.float()  # noqa: E731
    out, row_max, row_sum = segment_softmax.segment_softmax_spmm_fwd_plain(
        f32(xs), src, f32(logits), ro, mult=f32(mult))
    _close64(out, out64)
    (out64 * g).sum().backward()
    w, d_logits = segment_softmax.segment_softmax_spmm_bwd_plain(
        f32(xs), src, f32(logits), ro, row_max, row_sum, out, f32(g),
        mult=f32(mult))
    _close64(w, alpha * mult)
    _close64(d_logits, l64.grad)
    # without a multiplier the plain versions are as they were: p and
    # p (m - dot)
    w1, _ = segment_softmax.segment_softmax_spmm_bwd_plain(
        f32(xs), src, f32(logits), ro, row_max, row_sum, out, f32(g))
    _close64(w1, alpha)
    assert rows.shape == w.shape


def test_plain_edge_grad_and_csr_weight_grad_match_float64(world):
    """csc_segment_sum_plain's d_w (float32) against g[dst] . x[src] in
    float64 on a relation stream's real edges, and CSRSegmentSum's weight
    gradient through autograd against float64 autograd of the weighted
    sum."""
    _, RL, n_src, n_dst, _ = _relation(world)
    e = RL.rel_num_edges[0]
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((n_src, 16)))
    g = torch.from_numpy(rng.standard_normal((n_dst, 16)))
    w = torch.from_numpy(rng.random(RL.src.shape[0]))
    w[e:] = 0   # pad edges: weight 0, as the layers give them
    d_x, d_att, d_w = segment.csc_segment_sum_plain(
        g.float(), w.float(), None, x.float(), None, RL, edge_grad=True)
    assert d_att is None
    ref = (x[RL.src.long()] * g[RL.dst.long()]).sum(-1)
    _close64(d_w[:e], ref[:e])
    xf = x.float().requires_grad_()
    wf = w.float().requires_grad_()
    segment.CSRSegmentSum.apply(xf, wf, RL).backward(g.float())
    x64 = x.clone().requires_grad_()
    w64 = w.clone().requires_grad_()
    rows = csr_rows(RL.row_offsets)
    out64 = torch.zeros(n_dst, 16, dtype=torch.float64).index_add(
        0, rows, w64[:, None] * x64[RL.src.long()])
    (out64 * g).sum().backward()
    _close64(wf.grad[:e], w64.grad[:e])
    _close64(xf.grad, x64.grad)
    _close64(d_x, x64.grad)
