"""The port's training slice against the JAX package's.

Same seeded numpy inputs on both sides; the JAX side runs its Pallas ops in
interpret mode on the CPU, the port its plain versions (the CUDA kernels
are held against these on the card in tests/test_torch_gpu.py).

  (i)   prepare_split and its scikit-learn split: the same ids
  (ii)  Adam: five steps against kgwas_tpu.engine.optim.torch_adam
  (iii) the layer's gradient against jax.vjp of the fused Pallas layer op
        composed with gather_rows_csc (TPU kernels #2 and #8)
  (iv)  the layer's gradient against torch autograd of the plain forward
  (v)   the plain CSC segment sum against pallas_segment_sum
  (vi)  one step's parameter gradients against jax.grad of the JAX loss
        (use_pallas=True), from the same weights: the helpers here, the
        tests in test_torch_train_layouts.py, one per JAX training layout
  (vii) the golden pipeline (250 SNPs, hidden 16, 2 epochs) trained in
        both packages from the same initial weights: per-step losses, pred
        and KGWAS_P; the port's checkpoint serves the same predictions in
        the JAX package

Every tolerance is stated where it is used, with its reason.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import train_test_split as sk_split

from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.config import ModelConfig as JaxModelConfig
from kgwas_tpu.engine.optim import torch_adam
from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg
from kgwas_tpu.models.hetero_gnn import apply_hetero_gnn, init_hetero_gnn
from kgwas_tpu.ops import pallas_gat_layer as P
from kgwas_tpu.ops.pallas_segment import (gather_rows_csc, pad_stream_ids_np,
                                          padded_stream_len,
                                          pallas_segment_sum)

from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.config import ModelConfig
from kgwas_tpu_torch.engine import (batch_loss, build_optimizer,
                                    flatten_params, params_from_jax,
                                    params_to_jax)
from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.kgwas_data import train_test_split
from kgwas_tpu_torch.models import HeteroGNN, device_layouts, layer_path
from kgwas_tpu_torch.ops import gat_layer, segment
from torch_threads import few_torch_threads  # noqa: F401,E402

D = 128
SLOPE = 0.2
TEMP = 0.7
# gradients of one layer, float32 on both sides with sums of up to 511
# terms taken in another order, and in the softmax mode a cancellation
# (m_e - dot_row): the error scales with the array's largest entry, so the
# absolute tolerance is a fraction of it
GRAD_RTOL, GRAD_SCALE_ATOL = 1e-4, 1e-5


def _assert_grad(got, want, what="", floor=0.0):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(
        got, want, rtol=GRAD_RTOL,
        atol=GRAD_SCALE_ATOL * np.abs(want).max() + floor, err_msg=what)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ (i) the split


@pytest.mark.parametrize("n,seed,test_size", [
    (20, 0, 0.05), (250, 123, 0.05), (1001, 7, 0.05), (333, 42, 0.2)])
def test_split_matches_sklearn(n, seed, test_size):
    ids = np.arange(n) * 3 + 1
    y = np.random.default_rng(seed).standard_normal(n)
    got = train_test_split(ids, y, test_size, seed)
    want = sk_split(ids, y, test_size=test_size, random_state=seed)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


@pytest.mark.parametrize("n_snp,seed", [(250, 123), (400, 1)])
def test_prepare_split_matches_jax(tmp_path, n_snp, seed):
    kw = dict(n_snp=n_snp, n_gene=40, n_go=15, seed=seed)
    sides = []
    for cls in (JaxData, KGWAS_Data):
        d = cls.from_synthetic(data_path=str(tmp_path / cls.__module__), **kw)
        d.load_synthetic_gwas(seed=seed)
        d.process_gwas_file()
        d.prepare_split()
        sides.append(d)
    jd, pd_ = sides
    for k in ("train_mask", "val_mask", "test_mask", "all_mask"):
        assert np.array_equal(getattr(pd_, k), np.asarray(getattr(jd, k))), k
    assert pd_.train_input_nodes[0] == "SNP"
    assert np.array_equal(pd_.graph.node_labels["SNP"],
                          jd.graph.node_labels["SNP"])
    assert (pd_.graph.node_labels["SNP"] == -1).sum() == 0


# --------------------------------------------------------------- (ii) Adam


def test_adam_matches_optax_torch_adam():
    rng = np.random.default_rng(0)
    shapes = {"w": (7, 5), "b": (5,), "att": (1, 1, 5)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * 10.0 ** rng.integers(-3, 2)
                  ).astype(np.float32) for k, s in shapes.items()}
             for _ in range(5)]
    lr, wd = 1e-3, 5e-4
    opt = torch_adam(lr, wd)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = opt.init(jp)
    tp = {k: torch.nn.Parameter(_t(v.copy())) for k, v in p0.items()}
    topt = build_optimizer(list(tp.values()), lr, wd)
    for g in grads:
        upd, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                state, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k, p in tp.items():
            p.grad = _t(g[k])
        topt.step()
        # float32 on both sides, the same formulas in another order: the
        # updates agree to a few float32 ulps of lr
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), rtol=1e-6,
                                       atol=1e-8, err_msg=k)


# ---------------------------------------------- (iii)-(v) the layer gradient


@pytest.fixture(scope="module")
def gene_group():
    g = make_synthetic_kg(n_snp=300, n_gene=70, n_go=40, seed=3)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    L = build_merged_layouts(cg, tile_rows=512)["Gene"]
    return L, device_layouts({"Gene": L}, "cpu")["Gene"]


def _layer_inputs(L, fold, seed):
    rng = np.random.default_rng(seed)
    R = len(L.rel_keys)
    xs = (rng.standard_normal((L.n_src_total, D)) * 0.1).astype(np.float32)
    att = (rng.standard_normal((R, D)) * 0.2).astype(np.float32)
    a_dst = (rng.standard_normal(L.n_rows_total) * 0.5).astype(np.float32)
    n_out = L.n_rows_per_rel if fold else L.n_rows_total
    g = rng.standard_normal((n_out, D)).astype(np.float32)
    return xs, att, a_dst, g


def _port_grads(DL, xs, att, a_dst, g, fold, mode):
    _, row_max, row_sum = gat_layer.merged_gat_forward_plain(
        _t(xs), DL.src, DL.row_offsets, _t(att), _t(a_dst),
        DL.n_rows_per_rel, fold, mode, SLOPE, TEMP)
    return gat_layer.merged_gat_backward_plain(
        _t(xs), _t(att), _t(a_dst), row_max, row_sum, _t(g), DL, fold, mode,
        SLOPE, TEMP)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_layer_grad_matches_pallas_vjp(gene_group, mode, fold):
    L, DL = gene_group
    fold = len(L.rel_keys) if fold else 0
    xs, att, a_dst, g = _layer_inputs(L, fold, seed=0)

    def f(xs, att, a_dst):
        msgs = gather_rows_csc(xs, jnp.asarray(L.src), L.csc_perm, L.csc_ids,
                               L.csc_offsets, L.n_src_total, True)
        if mode == "softmax":
            return P.fused_gat_layer(msgs, att, a_dst, L.dst, L.row_offsets,
                                     L.tile2rel, L.n_rows_total, SLOPE, TEMP,
                                     True, fold)
        return P.fused_gat_layer_unnorm(msgs, att, a_dst, L.dst,
                                        L.row_offsets, L.tile2rel,
                                        L.n_rows_total, SLOPE, TEMP, mode,
                                        True, fold)

    _, vjp = jax.vjp(f, xs, att, a_dst)
    want = vjp(jnp.asarray(g))
    got = _port_grads(DL, xs, att, a_dst, g, fold, mode)
    for name, a, b in zip(("d_xs_all", "d_att", "d_a_dst"), got, want):
        _assert_grad(a.numpy(), b, name)


@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("mode", ["softmax", "sigmoid", "raw"])
def test_layer_grad_matches_autograd_of_plain_forward(gene_group, mode, fold):
    L, DL = gene_group
    fold = len(L.rel_keys) if fold else 0
    xs, att, a_dst, g = _layer_inputs(L, fold, seed=1)
    leaves = [_t(a).requires_grad_() for a in (xs, att, a_dst)]
    out, _, _ = gat_layer.merged_gat_forward_plain(
        leaves[0], DL.src, DL.row_offsets, leaves[1], leaves[2],
        DL.n_rows_per_rel, fold, mode, SLOPE, TEMP)
    want = torch.autograd.grad(out, leaves, _t(g))
    got = _port_grads(DL, xs, att, a_dst, g, fold, mode)
    for name, a, b in zip(("d_xs_all", "d_att", "d_a_dst"), got, want):
        _assert_grad(a.numpy(), b.numpy(), name)
    # the autograd function gives the same gradients as its backward
    leaves2 = [_t(a).requires_grad_() for a in (xs, att, a_dst)]
    out2 = gat_layer.MergedGATLayer.apply(*leaves2, DL, fold, mode, SLOPE,
                                          TEMP)
    assert torch.equal(out2, out.detach())
    for a, b in zip(torch.autograd.grad(out2, leaves2, _t(g)), got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("fold", [False, True])
def test_csc_segment_sum_plain_matches_pallas_segment_sum(gene_group, fold):
    L, DL = gene_group
    R = len(L.rel_keys)
    fold = R if fold else 0
    xs, att, _, g = _layer_inputs(L, fold, seed=2)
    rng = np.random.default_rng(3)
    e = len(L.src)
    w = rng.random(e).astype(np.float32)
    dz = rng.standard_normal(e).astype(np.float32)
    d_xs, d_att = segment.csc_segment_sum_plain(
        _t(g), _t(w), _t(dz), _t(xs), _t(att), DL, fold)

    # the message cotangent the TPU backward kernel writes, permuted to
    # source order as gather_rows_csc's backward does, then TPU kernel #8
    rows = L.dst % L.n_rows_per_rel if fold else L.dst
    d_msgs = w[:, None] * g[rows] + dz[:, None] * att[L.dst // L.n_rows_per_rel]
    perm = np.zeros(padded_stream_len(e), np.int32)
    perm[:e] = L.csc_perm
    want = pallas_segment_sum(
        jnp.take(jnp.asarray(d_msgs), jnp.asarray(perm), axis=0),
        jnp.asarray(pad_stream_ids_np(L.csc_ids, L.n_src_total)),
        jnp.asarray(L.csc_offsets), L.n_src_total, True, pre_padded=True)
    _assert_grad(d_xs.numpy(), want, "d_xs_all")
    # d_att in float64: sum over each slot's edges of dz_e xs[src_e]
    slot = L.dst // L.n_rows_per_rel
    want_att = np.zeros((R, D))
    np.add.at(want_att, slot, dz[:, None].astype(np.float64) * xs[L.src])
    _assert_grad(d_att.numpy(), want_att, "d_att")


# ------------------------------------------- (vi) one step's parameter grads

KG = dict(n_snp=300, n_gene=60, n_go=30, snp_dim=20, gene_dim=32, go_dim=16,
          seed=7)


@pytest.fixture(scope="module")
def step_world():
    cg_j = jax_compile_graph(jax_make_kg(**KG), edge_pad_multiple=512,
                             node_pad_multiple=512)
    cg = compile_graph(make_synthetic_kg(**KG), edge_pad_multiple=512,
                       node_pad_multiple=512)
    n = cg.num_nodes["SNP"]
    n_pad = cg.padded_nodes["SNP"]
    rng = np.random.default_rng(5)
    y = np.zeros(n_pad, np.float32)
    w = np.zeros(n_pad, np.float32)
    y[:n] = rng.standard_normal(n) ** 2
    w[:n] = rng.random(n) + 0.5
    batch = rng.choice(n, 64, replace=False)
    return cg_j, cg, y, w, batch


def jax_step_grads(step_world, cfg, params):
    """jax.grad of the JAX engine's loss (engine/loop.py make_train_step)."""
    cg_j, _, y, w, batch = step_world
    meta, arrays = cg_j.meta(), cg_j.arrays()

    def loss_fn(p):
        pred = apply_hetero_gnn(p, cfg, meta, arrays, training=True)
        b = jnp.asarray(batch)
        return jnp.mean(jnp.take(jnp.asarray(w), b)
                        * (jnp.take(pred[:, 0], b) - jnp.take(jnp.asarray(y), b))
                        ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), flatten_params(jax.tree_util.tree_map(np.asarray,
                                                              grads))


def port_step_grads(step_world, cfg, params):
    _, cg, y, w, batch = step_world
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    port_cfg = ModelConfig.from_dict(cfg.to_dict())
    model = HeteroGNN(port_cfg, rel_types, 20, 32, 16, seed=1)
    model.load_state_dict(params_from_jax(params))
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu",
                             cg, layer_path(port_cfg))
    x = {t: _t(v) for t, v in cg.node_x.items()}
    loss = batch_loss(model(x, layouts), torch.from_numpy(batch), _t(y), _t(w))
    loss.backward()
    # a group the head does not read has no gradient; JAX's is 0
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in model.named_parameters()}
    return loss.item(), flatten_params(params_to_jax(grads))


def assert_step_grads_match(step_world, cfg_kw):
    """One step's loss and parameter gradients, port against JAX, from the
    same JAX-initialised weights. no_relu: a dead ReLU head would make every
    gradient zero."""
    cfg = JaxModelConfig(gnn_hidden_dim=D, gnn_num_layers=2, no_relu=True,
                         use_pallas=True, **cfg_kw)
    params = jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
        jax.random.PRNGKey(0), cfg, step_world[0].meta(), 20, 32, 16))
    jl, jg = jax_step_grads(step_world, cfg, params)
    pl_, pg = port_step_grads(step_world, cfg, params)
    # float32 through two layers and the head, sums in another order
    assert pl_ == pytest.approx(jl, rel=1e-5)
    assert sorted(pg) == sorted(jg)
    # a_dst is constant within each softmax row, so some gradients (the
    # att_dst of a group whose rows' logits share one sign) cancel to float
    # noise on both sides: an absolute floor of 1e-8 of the largest gradient
    top = max(np.abs(v).max() for v in jg.values())
    for k in jg:
        _assert_grad(pg[k], jg[k], k, floor=1e-8 * top)


# ------------------------------------------------- (vii) the golden pipeline

GOLDEN = dict(n_snp=250, n_gene=50, n_go=18, seed=123)


@pytest.mark.parametrize("no_relu", [False, True])
def test_golden_pipeline_trains_like_jax(tmp_path, no_relu):
    data = JaxData.from_synthetic(data_path=str(tmp_path / "jax"), **GOLDEN)
    data.load_synthetic_gwas(seed=123)
    data.process_gwas_file()
    data.prepare_split()
    run = JaxKGWAS(data, exp_name="golden", seed=123)
    run.initialize_model(gnn_hidden_dim=16, gnn_num_layers=2, no_relu=no_relu)
    init = jax.tree_util.tree_map(np.array, run.params)
    res = run.train(batch_size=64, epoch=2, lr=1e-3, save_best_model=False)

    pdata = KGWAS_Data.from_synthetic(data_path=str(tmp_path / "port"),
                                      **GOLDEN)
    pdata.load_synthetic_gwas(seed=123)
    pdata.process_gwas_file()
    pdata.prepare_split()
    port = KGWAS(pdata, device="cpu", exp_name="golden", seed=123)
    port.initialize_model(gnn_hidden_dim=16, gnn_num_layers=2,
                          no_relu=no_relu)
    port.model.load_state_dict(params_from_jax(init))
    table = port.train(batch_size=64, epoch=2, lr=1e-3)

    # per-step losses: float32, another summation order, and Adam, whose
    # update is about lr whatever the gradient's size, so differences in
    # the last bits of small gradients grow step by step
    assert [len(e) for e in port.epoch_losses] == [len(e) for e in
                                                   run.epoch_losses]
    np.testing.assert_allclose(np.concatenate(port.epoch_losses),
                               np.concatenate(run.epoch_losses), rtol=1e-4)
    assert port.best_epoch == run.best_epoch
    assert list(table) == list(res.columns)
    # pred after six such steps: rtol 1e-4 with an absolute floor at 1e-4
    # of the largest prediction; KGWAS_P is the golden test's tolerance
    # (equal bins give equal p-values)
    pred = res.pred.values
    np.testing.assert_allclose(table["pred"], pred, rtol=1e-4,
                               atol=1e-4 * max(np.abs(pred).max(), 1e-30))
    if no_relu:
        assert np.abs(table["pred"]).max() > 0
    np.testing.assert_allclose(table["KGWAS_P"],
                               res.KGWAS_P.values.astype(np.float64),
                               rtol=1e-5, atol=1e-8)
    assert port.scale_factor == pytest.approx(run.scale_factor)
    assert port.test_metrics["mse"] == pytest.approx(run.test_metrics["mse"],
                                                     rel=1e-4)

    # the port's checkpoint: the best state, served by the JAX package
    ckpt = os.path.join(str(tmp_path / "port"), "model", "golden")
    assert os.path.exists(os.path.join(ckpt, "pred.csv"))
    served = JaxKGWAS(data, exp_name="served", seed=1).load_pretrained(ckpt)
    assert served.config == port.config
    np.testing.assert_allclose(np.asarray(served.predict_all()),
                               port.predict_all(), rtol=1e-5, atol=1e-6)
