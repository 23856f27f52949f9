"""Dst-range sub-layouts (``KGWAS_MERGED_MAX_EDGES``) in the port against
the JAX package and against the unsplit port.

On a KG whose Gene (2 row tiles) and SNP (3 row tiles) groups split, with
the same seeded numpy inputs on both sides (the JAX side's Pallas ops in
interpret mode, the port's plain versions):

  * ``split_merged_layout`` equals the JAX package's array for array at
    the port's tile (512), under both forms of the setting; each slot's
    real edges are its parent's, in order
  * the forward and one step's gradients of GAT sum and mean (the merged
    layer) and SAGE, GCN and SGC (the 'mp' layer) under the split, against
    the unsplit port and ``apply_hetero_gnn`` on the JAX package's split
    layouts (the cases of ``tests/test_merged_layer.py``'s split tests):
    forward rtol 1e-5, atol 1e-5; gradients at ``test_torch_train``'s
    bounds (GAT) and ``test_torch_variants``' (SAGE, GCN, SGC)
  * ``get_disease_critical_network``'s three tables, with and without a
    split, from one model: equal

``KGWAS.train`` and two gloo ranks under the split: test_torch_split_train.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.config import ModelConfig as JaxModelConfig
from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg
from kgwas_tpu.models.hetero_gnn import apply_hetero_gnn, init_hetero_gnn

import kgwas_tpu_torch as kt
from kgwas_tpu_torch.config import ModelConfig
from kgwas_tpu_torch.engine import (batch_loss, flatten_params,
                                    params_from_jax, params_to_jax)
from kgwas_tpu_torch.graph import (build_merged_layouts, compile_graph,
                                   make_synthetic_kg)
from kgwas_tpu_torch.graph import merged_layout as port_ml
from kgwas_tpu_torch.models import HeteroGNN, device_layouts, layer_paths

from test_torch_train import GRAD_RTOL, GRAD_SCALE_ATOL
from test_torch_variants import GRAD_ATOL as MP_GRAD_ATOL
from test_torch_variants import GRAD_RTOL as MP_GRAD_RTOL
from torch_threads import few_torch_threads  # noqa: F401,E402

# Gene: 16,384 edges over 2 row tiles; SNP: 6,144 over 3
KG_S = dict(n_snp=1100, n_gene=600, n_go=60, snp_dim=20, gene_dim=32,
            go_dim=16, seed=7)
SPLIT = "Gene:10000,SNP:2500"      # Gene in 2 sub-layouts, SNP in 3
SPLIT_KEYS = {"Gene@0", "Gene@1", "SNP@0", "SNP@1", "SNP@2"}
ENV = "KGWAS_MERGED_MAX_EDGES"
FWD_RTOL, FWD_ATOL = 1e-5, 1e-5
D = 128
CONFIGS = {"GAT-sum": {}, "GAT-mean": dict(gnn_aggr="mean"),
           "SAGE": dict(gnn_backbone="SAGE"), "GCN": dict(gnn_backbone="GCN"),
           "SGC": dict(gnn_backbone="SGC")}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _compile_both(spec):
    """(JAX compiled graph with its layouts built, port compiled graph,
    port layouts) under the setting spec (None: unset)."""
    with pytest.MonkeyPatch.context() as mp:
        if spec is None:
            mp.delenv(ENV, raising=False)
        else:
            mp.setenv(ENV, spec)
        cg_j = jax_compile_graph(jax_make_kg(**KG_S), edge_pad_multiple=512,
                                 node_pad_multiple=512)
        cg_j.meta()   # builds (and keeps) its merged layouts now
        cg = compile_graph(make_synthetic_kg(**KG_S), edge_pad_multiple=512,
                           node_pad_multiple=512)
        return cg_j, cg, build_merged_layouts(cg, tile_rows=512)


@pytest.fixture(scope="module")
def world():
    cg_j, cg, split = _compile_both(SPLIT)
    unsplit = _compile_both(None)[2]
    n, n_pad = cg.num_nodes["SNP"], cg.padded_nodes["SNP"]
    rng = np.random.default_rng(5)
    y = np.zeros(n_pad, np.float32)
    w = np.zeros(n_pad, np.float32)
    y[:n] = rng.standard_normal(n) ** 2
    w[:n] = rng.random(n) + 0.5
    batch = rng.choice(n, 64, replace=False)
    return cg_j, cg, split, unsplit, y, w, batch


# ------------------------------------------------------------- the layouts


@pytest.mark.parametrize("spec", [SPLIT, "3000"])
def test_split_equals_jax_array_for_array(spec):
    cg_j, cg, layouts = _compile_both(spec)
    want = cg_j.meta()["merged"]
    assert set(layouts) == set(want) and SPLIT_KEYS <= set(layouts)
    for t, L in layouts.items():
        J = want[t]
        for f in ("src", "dst", "row_offsets", "tile2rel", "src_base",
                  "csc_perm", "csc_ids", "csc_offsets", "edge_base"):
            a, b = getattr(L, f), getattr(J, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (t, f)
        for f in ("dst_type", "rel_keys", "src_types", "n_rows_per_rel",
                  "n_rows_total", "num_edges", "n_src_total", "base_type",
                  "node_base"):
            assert getattr(L, f) == getattr(J, f), (t, f)
        if "@" in t:
            assert np.array_equal(L.parent_src_deg, J.parent_src_deg), t


def test_sub_layouts_hold_each_relation_in_order():
    """Each slot's first rel_num_edges edges of each sub-layout are real;
    joined in node order they are the parent's real edges of the slot, in
    its order; the pads land in the sub-layout that holds the trash row."""
    _, cg, split = _compile_both(SPLIT)
    whole = build_merged_layouts(cg, tile_rows=512)
    for base in ("Gene", "SNP"):
        P = whole[base]
        subs = sorted((L for L in split.values() if L.base_type == base),
                      key=lambda L: L.node_base)
        assert [L.node_base for L in subs] == list(np.cumsum(
            [0] + [L.n_rows_per_rel for L in subs[:-1]]))
        assert sum(L.n_rows_per_rel for L in subs) == P.n_rows_per_rel
        assert sum(len(L.src) for L in subs) == len(P.src)
        for r, rk in enumerate(P.rel_keys):
            e0 = P.edge_base[r]
            real = P.src[e0:e0 + P.rel_num_edges[r]]
            parts = [L.src[L.edge_base[r]:L.edge_base[r] + L.rel_num_edges[r]]
                     for L in subs]
            assert np.array_equal(np.concatenate(parts), real), (base, rk)
            trash = cg.num_nodes[base]
            for L in subs:
                pads = L.edge_base[r + 1] - L.edge_base[r] - L.rel_num_edges[r]
                holds = L.node_base <= trash < L.node_base + L.n_rows_per_rel
                assert pads == (P.edge_base[r + 1] - e0 - P.rel_num_edges[r]
                                if holds else 0), (base, rk)


def test_parse_and_cache():
    f = port_ml._parse_max_edges("Gene:5,default:7")
    assert (f("Gene"), f("SNP")) == (5, 7)
    assert port_ml._parse_max_edges("9")("SNP") == 9
    assert port_ml._parse_max_edges("Gene:5")("SNP") == 0
    # KGWAS's cache follows the setting: one build per setting and graph
    from kgwas_tpu_torch.kgwas import merged_layouts

    cg = compile_graph(make_synthetic_kg(**KG_S), 512, 512)
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv(ENV, raising=False)
        a = merged_layouts(cg)
        mp.setenv(ENV, SPLIT)
        b = merged_layouts(cg)
        assert merged_layouts(cg) is b
        mp.setenv(ENV, "0")
        assert merged_layouts(cg) is a
    assert "Gene" in a and SPLIT_KEYS <= set(b)


# ------------------------------------------- the forward and the gradients


def _jax_pred_and_grads(world, cfg, params):
    cg_j, y, w, batch = world[0], world[4], world[5], world[6]
    meta, arrays = cg_j.meta(), cg_j.arrays()

    def loss_fn(p):
        pred = apply_hetero_gnn(p, cfg, meta, arrays, training=True)
        b = jnp.asarray(batch)
        return jnp.mean(jnp.take(jnp.asarray(w), b) * (
            jnp.take(pred[:, 0], b) - jnp.take(jnp.asarray(y), b)) ** 2), pred

    (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return (np.asarray(pred), float(loss),
            flatten_params(jax.tree_util.tree_map(np.asarray, grads)))


def _port_pred_and_grads(world, cfg, params, layouts):
    cg, y, w, batch = world[1], world[4], world[5], world[6]
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    port_cfg = ModelConfig.from_dict(cfg.to_dict())
    model = HeteroGNN(port_cfg, rel_types, 20, 32, 16, seed=1)
    model.load_state_dict(params_from_jax(params))
    dl = device_layouts(layouts, "cpu", cg, layer_paths(port_cfg))
    x = {t: _t(v) for t, v in cg.node_x.items()}
    pred = model(x, dl, training=True)
    loss = batch_loss(pred, _t(batch), _t(y), _t(w))
    loss.backward()
    grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
             for k, p in model.named_parameters()}
    return (pred.detach().numpy(), loss.item(),
            flatten_params(params_to_jax(grads)))


def _assert_grads(got, want, name):
    assert sorted(got) == sorted(want)
    top = max(np.abs(v).max() for v in want.values())
    for k in want:
        if name.startswith("GAT"):
            # test_torch_train's rule; att_dst's gradient cancels to float
            # noise (a_dst is constant within a softmax row): a floor of
            # 1e-8 of the largest gradient
            np.testing.assert_allclose(
                got[k], want[k], rtol=GRAD_RTOL,
                atol=GRAD_SCALE_ATOL * np.abs(want[k]).max() + 1e-8 * top,
                err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=MP_GRAD_RTOL,
                                       atol=MP_GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_split_forward_and_grads_match_unsplit_and_jax(world, name):
    cfg = JaxModelConfig(gnn_hidden_dim=D, gnn_num_layers=2, no_relu=True,
                         use_pallas=True, pallas_mode="merged",
                         **CONFIGS[name])
    params = jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
        jax.random.PRNGKey(3), cfg, world[0].meta(), 20, 32, 16))
    jp, jl, jg = _jax_pred_and_grads(world, cfg, params)
    sp, sl, sg = _port_pred_and_grads(world, cfg, params, world[2])
    up, ul, ug = _port_pred_and_grads(world, cfg, params, world[3])
    n = world[1].num_nodes["SNP"]
    assert np.abs(jp[:n]).max() > 0
    for want, loss, grads in ((up, ul, ug), (jp, jl, jg)):
        np.testing.assert_allclose(sp[:n], want[:n], rtol=FWD_RTOL,
                                   atol=FWD_ATOL)
        assert sl == pytest.approx(loss, rel=1e-5)
        _assert_grads(sg, grads, name)


# ------------------------------------------ training and the interpretation


def _data(root, jax_side=False):
    cls = JaxData if jax_side else kt.KGWAS_Data
    data = cls.from_synthetic(data_path=str(root), n_snp=KG_S["n_snp"],
                              n_gene=KG_S["n_gene"], n_go=KG_S["n_go"],
                              seed=3)
    data.load_synthetic_gwas(seed=3)
    data.process_gwas_file()
    data.prepare_split()
    data.train_mask = np.asarray(data.train_mask)[:3 * 64]   # 3 steps
    return data


def test_interpretation_tables_equal_with_and_without_split(tmp_path,
                                                            monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    data = _data(tmp_path)
    run = kt.KGWAS(data, device="cpu", exp_name="whole", seed=3)
    run.initialize_model(gnn_hidden_dim=D, no_relu=True)
    table = run.train(batch_size=64, epoch=1, lr=1e-3,
                      save_best_model=False)
    thr = float(np.quantile(table["KGWAS_P"], 0.02))
    tables = [run.get_disease_critical_network(variant_threshold=thr)]
    monkeypatch.setenv(ENV, SPLIT)
    split = kt.KGWAS(data, device="cpu", exp_name="split", seed=3)
    split.initialize_model(gnn_hidden_dim=D, no_relu=True)
    assert SPLIT_KEYS <= set(split.layouts)
    split.model.load_state_dict(run.model.state_dict())
    split.kgwas_res = run.kgwas_res
    tables.append(split.get_disease_critical_network(variant_threshold=thr))
    assert all(len(next(iter(t.values()))) > 0 for t in tables[0])
    for a, b in zip(*tables):
        assert list(a) == list(b)
        for c in a:
            if a[c].dtype.kind == "f":
                np.testing.assert_array_equal(a[c], b[c], err_msg=c)
            else:
                assert list(a[c]) == list(b[c]), c
