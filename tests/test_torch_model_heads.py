"""Multi-head GAT in the port against the JAX package, the checkpoint carry
of every variant's parameters, and the training entry point with heads and
dropout.

From the same JAX-initialised weights (``params_from_jax``), at a small
size (a 90-SNP synthetic KG, edges padded to 64, rows to 512 as the merged
layout's tile needs; jax matmul precision 'highest', the JAX ModelConfig
default), the port on the CPU (the plain versions of its kernels) against
``apply_hetero_gnn``:

  * the forward and ``jax.grad`` of a loss at H = 2: the merged path (GAT
    sum at hidden 128 with the JAX package's Pallas ops in interpret mode,
    as tests/test_merged_layer.py runs them; mean at hidden 16, where the
    JAX package takes its per-relation XLA path) and the per-relation path
    (GAT max, its plain branch). Forward rtol 1e-4, atol 1e-5; gradients
    rtol 1e-4 with an absolute floor of 1e-6 of the largest gradient
    (float32 sums in another order; a_dst's gradients cancel to float
    noise)
  * the interpretation at H = 2: each head's per-edge weight [E, H]
    (rtol 1e-5, atol 1e-6, as tests/test_torch_interpret.py) and the
    attention table, whose weight is the mean over heads
  * the checkpoint carry: params_from_jax / params_to_jax bitwise for
    H = 2 with edge_dim 2, and for pheno_condition 'ATT' and 'MSG';
    save_model, then load_pretrained in both packages: the same state and
    the same predictions (rtol 1e-5)
  * KGWAS.train at gat_num_head=2 and at dropout=0.1 (which drops nothing
    in KGWAS.train: the JAX engine passes no dropout_rng; the step takes
    the per-relation path, the evaluation the merged one) against the JAX
    package's, from the same initial weights: per-step losses rtol 1e-4
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.config import ModelConfig as JaxModelConfig
from kgwas_tpu.engine.checkpoint import flatten_params as jax_flatten
from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg
from kgwas_tpu.interpret import attention as jax_attention
from kgwas_tpu.models import apply_collect_attention, init_hetero_gnn
from kgwas_tpu.models.hetero_gnn import apply_hetero_gnn

from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.config import ModelConfig
from kgwas_tpu_torch.engine import (flatten_params, params_from_jax,
                                    params_to_jax, save_model)
from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.interpret import attention
from kgwas_tpu_torch.models import HeteroGNN, device_layouts, layer_paths
from kgwas_tpu_torch.ops import gat_layer, segment_softmax

from test_torch_interpret import (ALPHA_ATOL, ALPHA_RTOL, NETWORK_KEYS,
                                  _small_world, columns_of, compare_tables)

KG = dict(n_snp=90, n_gene=35, n_go=14, seed=43)
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_FLOOR = 1e-4, 1e-6
LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def world():
    cg_j = jax_compile_graph(jax_make_kg(**KG), edge_pad_multiple=64,
                             node_pad_multiple=512)
    cg = compile_graph(make_synthetic_kg(**KG), edge_pad_multiple=64,
                       node_pad_multiple=512)
    n = cg.num_nodes["SNP"]
    y = np.random.default_rng(1).standard_normal(n).astype(np.float32)
    return cg_j, cg, y


def port_model(cg, cfg, params):
    """The port's HeteroGNN of the JAX config cfg with the JAX params
    (loaded strictly), its layouts on the CPU and the node features."""
    port_cfg = ModelConfig.from_dict(cfg.to_dict())
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    model = HeteroGNN(port_cfg, rel_types, 20, 32, 16, seed=1)
    model.load_state_dict(params_from_jax(params))
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu",
                             cg, layer_paths(port_cfg))
    x = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
    return model, layouts, x


def assert_grads_close(got, want):
    assert sorted(got) == sorted(want)
    top = max(np.abs(v).max() for v in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=GRAD_RTOL,
                                   atol=GRAD_FLOOR * top, err_msg=k)


def jax_loss_grads(world, cfg, params):
    """(pred, loss, flattened grads) of mean((pred[:n] - y)^2) through
    apply_hetero_gnn."""
    cg_j, cg, y = world
    meta, arrays = cg_j.meta(), cg_j.arrays()
    n = len(y)

    def loss_fn(p):
        pred = apply_hetero_gnn(p, cfg, meta, arrays)
        return jnp.mean((pred[:n, 0] - jnp.asarray(y)) ** 2), pred

    (loss, pred), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        params)
    return (np.asarray(pred), float(loss),
            jax_flatten(jax.tree_util.tree_map(np.asarray, grads)))


def port_loss_grads(world, cfg, params, **fwd):
    _, cg, y = world
    model, layouts, x = port_model(cg, cfg, params)
    pred = model(x, layouts, **fwd)
    loss = torch.mean((pred[:len(y), 0] - torch.from_numpy(y)) ** 2)
    loss.backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in model.named_parameters()}
    return (pred.detach().numpy(), loss.item(),
            flatten_params(params_to_jax(grads)))


HEAD_CONFIGS = {
    # the merged path, the JAX package on its Pallas merged kernels
    "sum-pallas": dict(gnn_hidden_dim=128, use_pallas=True),
    "mean": dict(gnn_hidden_dim=16, gnn_aggr="mean"),
    # the per-relation path: #6 and #7 per head in the port
    "max": dict(gnn_hidden_dim=16, gnn_aggr="max"),
}


@pytest.mark.parametrize("name", list(HEAD_CONFIGS))
def test_two_heads_forward_and_grads_match_jax(world, name):
    cfg = JaxModelConfig(gnn_num_layers=2, gat_num_head=2, no_relu=True,
                         **HEAD_CONFIGS[name])
    params = jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
        jax.random.PRNGKey(6), cfg, world[0].meta(), 20, 32, 16))
    # the deeper layer and the head read H * hidden columns
    h = cfg.gnn_hidden_dim
    assert params["lin"]["w"].shape == (2 * h, 1)
    rk = next(iter(params["convs"][1]))
    assert params["convs"][1][rk]["lin_src"]["w"].shape == (2 * h, 2 * h)
    want_pred, want_loss, want = jax_loss_grads(world, cfg, params)
    before = (gat_layer.launches, segment_softmax.launches)
    got_pred, got_loss, got = port_loss_grads(world, cfg, params)
    assert (gat_layer.launches, segment_softmax.launches) == before
    n = len(world[2])
    assert np.abs(want_pred[:n]).max() > 0
    np.testing.assert_allclose(got_pred[:n], want_pred[:n], rtol=FWD_RTOL,
                               atol=FWD_ATOL)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    assert_grads_close(got, want)


@pytest.mark.parametrize("aggr", ["sum", "max"])
def test_two_heads_attention_matches_jax(aggr):
    """Each head's weight per edge against apply_collect_attention's [E, H]
    alpha, and the attention table (the mean over heads) against the JAX
    package's."""
    cfg, params, meta, cgj, model, layouts, x, cg = _small_world(
        2, gat_num_head=2, gnn_aggr=aggr)
    want = apply_collect_attention(params, cfg, meta, cgj.arrays(), raw=True)
    got = model.collect_attention(x, layouts)
    for li, (a, b) in enumerate(zip(got, want)):
        assert set(a) == set(b) == set(cg.relations), li
        for rk, alpha in a.items():
            e = cg.relations[rk].num_edges
            assert alpha.shape == (e, 2)
            np.testing.assert_allclose(alpha.numpy(), np.asarray(b[rk])[:e],
                                       rtol=ALPHA_RTOL, atol=ALPHA_ATOL,
                                       err_msg=f"l{li + 1} {rk}")
    want_t = jax_attention.attention_tables(params, cfg, meta, cgj.arrays(),
                                            dict(cgj.relations))
    got_t = attention.attention_tables(model, x, layouts, dict(cg.relations))
    assert len(got_t["h_idx"]) == len(want_t) > 0
    compare_tables(got_t, columns_of(want_t), NETWORK_KEYS, NETWORK_KEYS,
                   "weight", rtol=ALPHA_RTOL, atol=ALPHA_ATOL)


CKPT_CONFIGS = {
    "heads2-edge_dim2": dict(gat_num_head=2, edge_dim=2),
    "pheno-ATT": dict(pheno_condition="ATT"),
    "pheno-MSG": dict(pheno_condition="MSG", edge_dim=3),
}


@pytest.mark.parametrize("name", list(CKPT_CONFIGS))
def test_checkpoint_round_trip(tmp_path, name):
    kw = dict(gnn_hidden_dim=16, gnn_num_layers=2, **CKPT_CONFIGS[name])
    jdata = JaxData.from_synthetic(n_snp=60, n_gene=20, n_go=10, seed=3,
                                   data_path=str(tmp_path / "jax"))
    jrun = JaxKGWAS(jdata, seed=5)
    jrun.initialize_model(**kw)
    init = jax.tree_util.tree_map(np.array, jrun.params)
    sd = params_from_jax(init)
    for key in {"heads2-edge_dim2": ("lin_edge.weight", "att_edge"),
                "pheno-ATT": ("lin_edge_.weight", "att_edge"),
                "pheno-MSG": ("pheno_mlp.weight", "lin_edge.weight",
                              "att_edge")}[name]:
        assert any(k.endswith(key) for k in sd), key
    # the port's model holds the same parameters: a strict load, and back
    pdata = KGWAS_Data.from_synthetic(n_snp=60, n_gene=20, n_go=10, seed=3,
                                      data_path=str(tmp_path / "port"))
    run = KGWAS(pdata, device="cpu", seed=5).initialize_model(**kw)
    run.model.load_state_dict(sd)
    back = flatten_params(params_to_jax(run.model.state_dict()))
    want = jax_flatten(init)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)
    assert run.config == jrun.config
    # save_model -> load_pretrained in both packages
    ckpt = str(tmp_path / "ckpt")
    save_model(run.model.state_dict(), run.config, ckpt)
    again = KGWAS(pdata, device="cpu", seed=9).load_pretrained(ckpt)
    for k, v in run.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    served = JaxKGWAS(jdata, seed=1).load_pretrained(ckpt)
    np.testing.assert_allclose(np.asarray(served.predict_all()),
                               again.predict_all(), rtol=1e-5, atol=1e-6)


TRAIN_CONFIGS = {"heads2": dict(gat_num_head=2), "dropout": dict(dropout=0.1)}


@pytest.mark.parametrize("name", list(TRAIN_CONFIGS))
def test_train_matches_jax(tmp_path, name):
    kw = dict(gnn_hidden_dim=16, gnn_num_layers=2, no_relu=True,
              **TRAIN_CONFIGS[name])
    syn = dict(n_snp=150, n_gene=30, n_go=12, seed=11)
    data = JaxData.from_synthetic(data_path=str(tmp_path / "jax"), **syn)
    data.load_synthetic_gwas(seed=11)
    data.process_gwas_file()
    data.prepare_split()
    jrun = JaxKGWAS(data, exp_name="t", seed=11)
    jrun.initialize_model(**kw)
    init = jax.tree_util.tree_map(np.array, jrun.params)
    jrun.train(batch_size=32, epoch=1, lr=1e-3, save_best_model=False)

    pdata = KGWAS_Data.from_synthetic(data_path=str(tmp_path / "port"), **syn)
    pdata.load_synthetic_gwas(seed=11)
    pdata.process_gwas_file()
    pdata.prepare_split()
    run = KGWAS(pdata, device="cpu", exp_name="t", seed=11)
    run.initialize_model(**kw)
    run.model.load_state_dict(params_from_jax(init))
    run.train(batch_size=32, epoch=1, lr=1e-3, save_best_model=False)
    assert run.config == jrun.config
    assert [len(e) for e in run.epoch_losses] == [
        len(e) for e in jrun.epoch_losses] and len(run.epoch_losses[0]) >= 3
    np.testing.assert_allclose(np.concatenate(run.epoch_losses),
                               np.concatenate(jrun.epoch_losses),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(run.predict_all(),
                               np.asarray(jrun.predict_all()), rtol=1e-4,
                               atol=1e-5)
    assert not os.path.exists(os.path.join(str(tmp_path / "port"), "model",
                                           "t", "model.npz"))
