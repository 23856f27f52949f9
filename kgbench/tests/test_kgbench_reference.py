"""The reference against the port's plain CPU path at a tiny size: the KG
transforms, the data layer, the forward, three training steps and the
KGWAS_P tail. (The tests may import the port; the reference may not.)"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from kgbench import program
from kgbench.inputs import gwas, kg, params
from kgbench.reference import calib as ref_calib
from kgbench.reference import data as ref_data
from kgbench.reference import graph as ref_graph
from kgbench.reference import model as ref_model

KG = {"n_snp": 3000, "n_gene": 300, "n_go": 150, "avg_degree": 4}
DIMS = {"SNP": 20, "Gene": 64, "GO": 16}
MODEL = {"backbone": "GAT", "aggr": "sum", "layers": 2, "hidden": 16,
         "heads": 1, "relu_head": True}
SEED = 2**31 + 11
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    raw = kg.make_kg(KG, DIMS, SEED, CPU)
    feats = dict(raw.features)
    rels = ref_graph.transform(raw.edges, raw.num_nodes)
    ss = gwas.make_sumstats(KG["n_snp"], 150, 10_000, SEED)
    ld = gwas.make_ld_scores(KG["n_snp"], SEED)
    data = program.make_data(raw, str(tmp_path_factory.mktemp("kg")), ld)
    program.load_gwas(data, ss, 1234)
    p0 = params.make_params(DIMS, MODEL["hidden"], MODEL["layers"], SEED,
                            CPU)
    run = program.make_model(data, MODEL, p0, CPU, 1234)
    return raw, feats, rels, ss, ld, data, p0, run


def test_transforms_match(built):
    raw, _, rels, _, _, data, _, _ = built
    got = data.graph.edge_index
    assert set(got) == set(rels)
    for rt, (s, d) in rels.items():
        a = np.sort(got[rt][0].astype(np.int64) * 10**6 + got[rt][1])
        b = np.sort((s * 10**6 + d).numpy())
        assert np.array_equal(a, b), rt


def test_data_layer_matches(built):
    _, _, _, ss, ld, data, _, _ = built
    np.testing.assert_allclose(program.ldsc_weight_column(data),
                               ref_data.ldsc_weights(ss, *ld), rtol=1e-12)
    np.testing.assert_array_equal(data.y, ref_data.chi2_labels(ss))
    for got, want in zip((data.train_mask, data.val_mask, data.test_mask),
                         ref_data.split(KG["n_snp"], 1234)):
        np.testing.assert_array_equal(got, want)


def test_forward_matches(built):
    raw, feats, rels, _, _, _, p0, run = built
    with torch.no_grad():
        want = ref_model.forward(p0, feats, rels, raw.num_nodes,
                                 MODEL["layers"]).numpy()
    got = run.predict_all()
    assert np.abs(want).max() > 0, "a dead head leaves nothing to compare"
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_three_steps_match(built):
    from kgwas_tpu_torch.engine.loop import train_step
    from kgwas_tpu_torch.engine.optim import build_optimizer

    raw, feats, rels, ss, ld, data, p0, run = built
    model = run.model
    model.load_state_dict(p0)
    cg, x, layouts = run._device_state()
    y_node, w_node = run._labels(cg)
    opt = build_optimizer(model.parameters(), 1e-4, 5e-4)
    train = np.asarray(data.train_mask)
    bs = [torch.as_tensor(b) for b in ref_data.batches(train, 512)[:3]]
    got = [float(train_step(model, opt, x, layouts, b, y_node, w_node))
           for b in bs]
    y = torch.as_tensor(ref_data.chi2_labels(ss), dtype=torch.float32)
    w = torch.as_tensor(ref_data.ldsc_weights(ss, *ld), dtype=torch.float32)
    want, _, changes = ref_model.train_steps(
        {k: v.clone() for k, v in p0.items()}, feats, rels, raw.num_nodes,
        MODEL["layers"], bs, y, w, 1e-4, 5e-4)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    state = model.state_dict()
    for k, v in changes[3].items():
        np.testing.assert_allclose((state[k] - p0[k]).numpy(), v.numpy(),
                                   atol=2 * 1e-4 * 3, err_msg=k)


def test_tail_matches(built):
    from kgwas_tpu_torch.stats.calibration import finalize_predictions

    _, _, _, ss, _, data, _, run = built
    pred = run.predict_all()
    table, _ = finalize_predictions(
        {k: np.array(v, copy=True) for k, v in data.lr_uni.items()},
        pred[np.asarray(data.all_mask)])
    want = ref_calib.kgwas_p(pred, np.asarray(ss["P"]))
    np.testing.assert_allclose(table["KGWAS_P"], want, rtol=1e-9, atol=1e-15)
