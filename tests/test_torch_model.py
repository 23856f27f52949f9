"""The port's model and weight carry against the JAX package.

* ``params_to_jax(params_from_jax(p)) == p`` exactly;
* ``kgwas_tpu.engine.checkpoint.import_torch_state_dict`` reads the port
  module's state_dict back into the same JAX tree, which proves the
  reference ``model.py`` key names;
* the port's full forward (CPU, plain layer op) from JAX-initialised
  weights against ``kgwas_tpu.models.hetero_gnn.apply_hetero_gnn``: at
  hidden 128 on the merged Pallas path (interpret mode) and at hidden 16 on
  the XLA per-relation path. rtol 1e-5, atol 1e-5 on the real SNP rows:
  float32 on both sides, different summation orders through two layers.
"""
import jax
import numpy as np
import pytest
import torch

from kgwas_tpu.config import ModelConfig as JaxModelConfig
from kgwas_tpu.engine.checkpoint import import_torch_state_dict
from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg
from kgwas_tpu.models.hetero_gnn import apply_hetero_gnn, init_hetero_gnn

from kgwas_tpu_torch.config import ModelConfig
from kgwas_tpu_torch.engine.checkpoint import (
    flatten_params,
    params_from_jax,
    params_to_jax,
)
from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.models import HeteroGNN, device_layouts, encoder_for

KG = dict(n_snp=300, n_gene=60, n_go=30, snp_dim=20, gene_dim=32, go_dim=16,
          seed=7)


def _jax_setup(hidden, layers=2, seed=0, **cfg_kw):
    cg = jax_compile_graph(jax_make_kg(**KG), edge_pad_multiple=512,
                           node_pad_multiple=512)
    cfg = JaxModelConfig(gnn_hidden_dim=hidden, gnn_num_layers=layers,
                         **cfg_kw)
    meta = cg.meta()
    params = init_hetero_gnn(jax.random.PRNGKey(seed), cfg, meta, 20, 32, 16)
    params = jax.tree_util.tree_map(np.asarray, params)
    return cg, cfg, meta, params


def _port_model(cfg, params):
    cg = compile_graph(make_synthetic_kg(**KG), edge_pad_multiple=512,
                       node_pad_multiple=512)
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    port_cfg = ModelConfig.from_dict(cfg.to_dict())
    model = HeteroGNN(port_cfg, rel_types, 20, 32, 16, seed=1)
    model.load_state_dict(params_from_jax(params))
    return cg, model


def _assert_tree_equal(a, b):
    fa, fb = flatten_params(a), flatten_params(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        assert fa[k].shape == fb[k].shape, k
        assert np.array_equal(fa[k], fb[k]), k


def test_params_round_trip_exact():
    _, _, _, params = _jax_setup(hidden=16)
    _assert_tree_equal(params_to_jax(params_from_jax(params)), params)
    # the /-flattened npz form carries the same way
    _assert_tree_equal(params_to_jax(params_from_jax(flatten_params(params))),
                       params)


def test_state_dict_uses_reference_key_names():
    cg, cfg, _, params = _jax_setup(hidden=16)
    _, model = _port_model(cfg, params)
    sd = model.state_dict()
    assert "snp_feat_mlp.FC_hidden.weight" in sd
    assert "convs.0.convs.Gene__Gene-PPI-Gene__Gene.lin_src.weight" in sd
    assert "convs.0.convs.Gene__Gene-PPI-Gene__Gene.lin_dst.weight" not in sd
    assert "convs.1.convs.SNP__TSS__Gene.lin_dst.weight" in sd
    assert sd["convs.1.convs.SNP__TSS__Gene.att_src"].shape == (1, 1, 16)
    imported = import_torch_state_dict(sd, cfg.gnn_num_layers)
    _assert_tree_equal(jax.tree_util.tree_map(np.asarray, imported), params)


@pytest.mark.parametrize("hidden,use_pallas,extra", [
    (128, True, {}),
    (128, True, {"sigmoid_gat": True}),
    (16, False, {}),
    (16, False, {"gnn_aggr": "mean", "no_relu": True}),
])
def test_forward_matches_jax(hidden, use_pallas, extra):
    cg_j, cfg, meta, params = _jax_setup(hidden, use_pallas=use_pallas,
                                         **extra)
    want = np.asarray(apply_hetero_gnn(params, cfg, meta, cg_j.arrays()))
    cg, model = _port_model(cfg, params)
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu")
    x = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
    with torch.inference_mode():
        got = model(x, layouts).numpy()
    n = cg.num_nodes["SNP"]
    assert got.shape == want.shape
    assert np.abs(want[:n]).max() > 0
    np.testing.assert_allclose(got[:n], want[:n], rtol=1e-5, atol=1e-5)


def test_forward_runs_only_the_groups_that_reach_the_head(monkeypatch):
    """The head reads the last layer's SNP rows only, so the forward runs
    the last layer's SNP group and, before it, the groups that group reads
    (as the JAX package's jit drops the rest as dead code). The
    predictions equal those of a forward over every group."""
    from kgwas_tpu_torch.ops import gat_layer

    _, cfg, _, params = _jax_setup(hidden=16)
    cg, model = _port_model(cfg, params)
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu")
    x = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
    live, encoded = model.live_groups(layouts)
    assert live == [["Gene", "SNP"], ["SNP"]]
    assert encoded == set(x)
    streams = []
    real = gat_layer.merged_gat_forward
    monkeypatch.setattr(gat_layer, "merged_gat_forward",
                        lambda *a, **k: streams.append(a[1]) or real(*a, **k))
    with torch.inference_mode():
        got = model(x, layouts)
        h = {t: getattr(model, encoder_for(t))(v) for t, v in x.items()}
        for layer in model.convs:
            h = {t: torch.relu(v)
                 for t, v in model.merged_layer(layer, h, layouts).items()}
        want = model.lin(h["SNP"])
    assert [s is layouts["SNP"].src for s in streams[:3]] == [False, True,
                                                             True]
    assert torch.equal(got, torch.relu(want))
