"""Weights, checkpoints and training of the model variants, port against the
JAX package.

  * ``params_to_jax(params_from_jax(p)) == p`` exactly for each backbone's
    JAX-initialised tree (SAGE ``lin_l`` / ``lin_r``, GCN ``lin`` and
    ``bias``, SGC ``lin`` with its bias);
  * a reference ``model.pt`` of each variant (DataParallel ``module.``
    keys) loads into the port's ``HeteroGNN`` with ``strict=True``, reads
    back into the same JAX tree through the JAX package's
    ``import_torch_state_dict``, and the two packages'
    ``load_pretrained_torch`` serve the same predictions (rtol 1e-5, atol
    1e-6: float32, another summation order; the JAX side on its XLA path);
  * a short ``KGWAS.train`` of a variant in the port (CPU), whose
    checkpoint ``kgwas_tpu.KGWAS.load_pretrained`` serves with the same
    predictions (same tolerance).
"""
import os
import pickle

import jax
import numpy as np
import pytest
import torch

from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.engine.checkpoint import import_torch_state_dict

from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.engine import flatten_params, params_from_jax, params_to_jax
from kgwas_tpu_torch.engine.checkpoint import load_pretrained_torch

from test_torch_model import _assert_tree_equal, _jax_setup
from torch_threads import few_torch_threads  # noqa: F401,E402

VARIANTS = {
    "GAT-max": dict(gnn_backbone="GAT", gnn_aggr="max"),
    "SAGE": dict(gnn_backbone="SAGE"),
    "GCN": dict(gnn_backbone="GCN", gnn_aggr="mean"),
    "SGC": dict(gnn_backbone="SGC"),
}


@pytest.mark.parametrize("backbone", ["SAGE", "GCN", "SGC"])
def test_params_round_trip_exact(backbone):
    _, _, _, params = _jax_setup(hidden=16, gnn_backbone=backbone)
    conv = next(iter(params["convs"][0].values()))
    assert {"SAGE": {"lin_l", "lin_r"}, "GCN": {"lin", "bias"},
            "SGC": {"lin"}}[backbone] == set(conv)
    _assert_tree_equal(params_to_jax(params_from_jax(params)), params)
    _assert_tree_equal(params_to_jax(params_from_jax(flatten_params(params))),
                       params)


def _data(cls, tmp_path, **kw):
    d = cls.from_synthetic(data_path=str(tmp_path), **kw)
    d.load_synthetic_gwas(seed=kw["seed"])
    d.process_gwas_file()
    return d


@pytest.mark.parametrize("name", list(VARIANTS))
def test_reference_model_pt_loads_strict_and_serves_like_jax(tmp_path, name):
    kw = dict(n_snp=160, n_gene=40, n_go=15, seed=9)
    pdata = _data(KGWAS_Data, tmp_path, **kw)
    src = KGWAS(pdata, device="cpu", seed=9).initialize_model(
        gnn_hidden_dim=16, gnn_num_layers=2, no_relu=True, **VARIANTS[name])
    sd = src.model.state_dict()
    names = {k.split(".")[4] for k in sd if k.startswith("convs.")}
    assert names == {"GAT-max": {"lin_src", "lin_dst", "att_src", "att_dst",
                                 "bias"},
                     "SAGE": {"lin_l", "lin_r"}, "GCN": {"lin", "bias"},
                     "SGC": {"lin"}}[name]
    ckpt = tmp_path / "reference_model"
    ckpt.mkdir()
    torch.save({f"module.{k}": v for k, v in sd.items()}, ckpt / "model.pt")
    with open(ckpt / "config.pkl", "wb") as f:
        pickle.dump(src.config, f)

    loaded = load_pretrained_torch(str(ckpt))
    src.model.load_state_dict(loaded, strict=True)
    tree = import_torch_state_dict(loaded, 2, VARIANTS[name]["gnn_backbone"])
    _assert_tree_equal(jax.tree_util.tree_map(np.asarray, tree),
                       params_to_jax(loaded))

    port = KGWAS(pdata, device="cpu", seed=1).load_pretrained_torch(str(ckpt))
    pred = port.predict_all()
    assert np.array_equal(pred, src.predict_all())
    assert pred.shape == (160,) and np.abs(pred).max() > 0
    jrun = JaxKGWAS(_data(JaxData, tmp_path, **kw), seed=1)
    jrun.load_pretrained_torch(str(ckpt))
    np.testing.assert_allclose(pred, np.asarray(jrun.predict_all()),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["GAT-max", "GCN"])
def test_trained_variant_is_served_by_jax(tmp_path, name):
    kw = dict(n_snp=250, n_gene=50, n_go=18, seed=123)
    pdata = _data(KGWAS_Data, tmp_path / "port", **kw)
    pdata.prepare_split()
    port = KGWAS(pdata, device="cpu", exp_name="variant", seed=123)
    port.initialize_model(gnn_hidden_dim=16, gnn_num_layers=2, no_relu=True,
                          **VARIANTS[name])
    init = {k: v.clone() for k, v in port.model.state_dict().items()}
    table = port.train(batch_size=64, epoch=2, lr=1e-3)
    losses = np.concatenate(port.epoch_losses)
    assert len(losses) == 2 * (len(pdata.train_mask) // 64)
    assert np.isfinite(losses).all()
    assert np.isfinite(table["KGWAS_P"]).all()
    moved = max(float((port.model.state_dict()[k] - v).abs().max())
                for k, v in init.items())
    assert moved > 1e-4

    ckpt = os.path.join(str(tmp_path / "port"), "model", "variant")
    served = JaxKGWAS(_data(JaxData, tmp_path / "jax", **kw), seed=1)
    served.load_pretrained(ckpt)
    assert served.config == port.config
    pred = port.predict_all()
    assert np.abs(pred).max() > 0
    np.testing.assert_allclose(np.asarray(served.predict_all()), pred,
                               rtol=1e-5, atol=1e-6)
