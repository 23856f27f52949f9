"""Serving parity: the port serves a checkpoint the JAX package trained.

The ``tests/test_golden.py`` pipeline (250 SNPs, hidden 16, 2 epochs)
trains in the JAX package and saves its checkpoint. The port's
``KGWAS(device="cpu").load_pretrained`` + ``predict_all`` +
``finalize_predictions`` must reproduce the JAX run's ``pred`` (rtol 1e-5,
atol 1e-6: float32, another summation order) and ``KGWAS_P`` (rtol 1e-5,
atol 1e-8, the golden test's tolerance; equal bins give equal p-values).
The default head is a dead ReLU at this seed (all-zero preds), so a
``no_relu`` run covers non-zero predictions too.
"""
import os

import numpy as np
import pytest

from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData

from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.stats.calibration import finalize_predictions
from kgwas_tpu_torch.utils import read_table, write_table
from torch_threads import few_torch_threads  # noqa: F401,E402

KW = dict(n_snp=250, n_gene=50, n_go=18, seed=123)


@pytest.mark.parametrize("no_relu", [False, True])
def test_port_serves_jax_checkpoint(tmp_path, no_relu):
    data = JaxData.from_synthetic(data_path=str(tmp_path), **KW)
    data.load_synthetic_gwas(seed=123)
    data.process_gwas_file()
    data.prepare_split()
    run = JaxKGWAS(data, exp_name="golden", seed=123)
    run.initialize_model(gnn_hidden_dim=16, gnn_num_layers=2, no_relu=no_relu)
    res = run.train(batch_size=64, epoch=2, lr=1e-3, save_best_model=True)
    ckpt = os.path.join(str(tmp_path), "model", "golden")

    pdata = KGWAS_Data.from_synthetic(data_path=str(tmp_path), **KW)
    pdata.load_synthetic_gwas(seed=123)
    pdata.process_gwas_file()
    port = KGWAS(pdata, device="cpu", exp_name="golden", seed=123)
    port.load_pretrained(ckpt)
    assert port.config == run.config
    pred = port.predict_all()
    assert pred.shape == (250,)
    table, scale = finalize_predictions(pdata.lr_uni, pred[pdata.all_ids])

    assert list(table) == list(res.columns)
    np.testing.assert_allclose(table["pred"], res.pred.values, rtol=1e-5,
                               atol=1e-6)
    if no_relu:
        assert np.abs(table["pred"]).max() > 0
    np.testing.assert_allclose(table["KGWAS_P"],
                               res.KGWAS_P.values.astype(np.float64),
                               rtol=1e-5, atol=1e-8)
    assert scale == pytest.approx(run.scale_factor)
    # the JAX run's pred.csv loads into the port, and the port's own
    # pred.csv has the same columns
    assert list(port.kgwas_res) == list(res.columns)
    out = str(tmp_path / "port_pred.csv")
    write_table(table, out)
    assert list(read_table(out)) == list(res.columns)


def test_port_and_jax_serve_the_same_reference_model_pt(tmp_path):
    """A reference ``model.pt`` (DataParallel ``module.`` keys) + config.pkl
    loads into both packages' ``load_pretrained_torch`` and gives the same
    predictions (rtol 1e-5, atol 1e-6: float32, another summation order)."""
    import pickle

    import torch

    kw = dict(n_snp=160, n_gene=40, n_go=15, seed=9)
    pdata = KGWAS_Data.from_synthetic(data_path=str(tmp_path), **kw)
    pdata.load_synthetic_gwas(seed=9)
    pdata.process_gwas_file()
    src = KGWAS(pdata, device="cpu", seed=9).initialize_model(
        gnn_hidden_dim=16, gnn_num_layers=2, no_relu=True)
    ckpt = tmp_path / "reference_model"
    ckpt.mkdir()
    torch.save({f"module.{k}": v for k, v in src.model.state_dict().items()},
               ckpt / "model.pt")
    with open(ckpt / "config.pkl", "wb") as f:
        pickle.dump(src.config, f)

    port = KGWAS(pdata, device="cpu", seed=1).load_pretrained_torch(str(ckpt))
    pred = port.predict_all()
    assert np.array_equal(pred, src.predict_all())
    assert np.abs(pred).max() > 0

    jdata = JaxData.from_synthetic(data_path=str(tmp_path), **kw)
    jdata.load_synthetic_gwas(seed=9)
    jdata.process_gwas_file()
    jrun = JaxKGWAS(jdata, seed=1).load_pretrained_torch(str(ckpt))
    assert pred.shape == (160,)
    np.testing.assert_allclose(pred, np.asarray(jrun.predict_all()),
                               rtol=1e-5, atol=1e-6)
