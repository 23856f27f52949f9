"""Host-streamed giant features in the port (kgwas_tpu_torch/ops/
streaming.py, engine/streamed.py, HeteroGNN.forward(h1_override=...),
initialize_model(stream_features=...)) against the dense products, the
port's in-device step and the JAX package's (kgwas_tpu/ops/streaming.py,
make_streamed_train_step, tests/test_streaming.py), from the same inputs
and parameters (params_from_jax). The chunked products add in another
order than one matmul; a gradient near 0 whose sign differs in its last
bits moves its parameter by up to 2 lr the other way (Adam's first step is
about lr whatever the gradient's size), so a step's parameters are held
within 2 lr, as chip_smoke.py holds its steps. Each tolerance is stated
where it is used. On the card the chunks go through pinned staging
buffers and a copy stream (tests/test_torch_gpu.py, chip_smoke.py phase
(e)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.engine.loop import build_optimizer as jax_optimizer
from kgwas_tpu.engine.streamed import make_streamed_train_step
from kgwas_tpu.ops import streaming as jstreaming
from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.engine import (build_optimizer, params_from_jax,
                                    params_to_jax, train_step,
                                    train_step_streamed)
from kgwas_tpu_torch.engine.checkpoint import flatten_params
from kgwas_tpu_torch.ops import streaming
from kgwas_tpu_torch.ops.streaming import (StreamedLinear, streamed_grad_w,
                                           streamed_matmul)
from torch_threads import few_torch_threads  # noqa: F401,E402

GENE_DIM = 96          # a pretend-giant Gene feature width
DATA = dict(n_snp=150, n_gene=40, n_go=15, seed=5, gene_dim=GENE_DIM)
MODEL = dict(gnn_hidden_dim=16)
CHUNK = 37             # several chunks, the last one narrower
LR = 1e-3


def test_streamed_products_match_dense_and_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((50, 300)).astype(np.float32)
    w = rng.standard_normal((300, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    dh = rng.standard_normal((50, 16)).astype(np.float32)
    streaming.reset_stats()
    out = streamed_matmul(x, torch.from_numpy(w), torch.from_numpy(b),
                          col_chunk=77, row_pad_to=64)
    assert out.shape == (64, 16)
    np.testing.assert_allclose(out[:50].numpy(), x @ w + b, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_array_equal(out[50:].numpy(), np.tile(b, (14, 1)))
    want = jstreaming.streamed_matmul(x, jnp.asarray(w), bias=jnp.asarray(b),
                                      col_chunk=77, row_pad_to=64)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    gw = streamed_grad_w(x, torch.from_numpy(dh), col_chunk=77)
    np.testing.assert_allclose(gw.numpy(), x.T @ dh, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(
        gw.numpy(), np.asarray(jstreaming.streamed_grad_w(
            x, jnp.asarray(dh), col_chunk=77)), rtol=1e-5, atol=1e-5)
    # 4 chunks a pass, two passes; nothing crosses to a device on the CPU
    assert streaming.stats["chunks"] == 8
    assert streaming.stats["h2d_bytes"] == 0


def test_streamed_linear_gradients_match_autograd():
    """StreamedLinear against autograd of the padded dense layer: the weight
    gradient by the second streamed pass, the bias gradient over every
    padded row (pad rows are the bias), no gradient for the table."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((30, 200)).astype(np.float32)
    lin = torch.nn.Linear(200, 8)
    dense = torch.nn.Linear(200, 8)
    dense.load_state_dict(lin.state_dict())
    g = torch.from_numpy(rng.standard_normal((48, 8)).astype(np.float32))
    h = StreamedLinear.apply(lin.weight, lin.bias, x, 48, 64)
    (h * g).sum().backward()
    xp = torch.zeros(48, 200)
    xp[:30] = torch.from_numpy(x)
    (dense(xp) * g).sum().backward()
    np.testing.assert_allclose(h.detach().numpy(),
                               dense(xp).detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lin.weight.grad.numpy(),
                               dense.weight.grad.numpy(), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lin.bias.grad.numpy(),
                               dense.bias.grad.numpy(), rtol=1e-5,
                               atol=1e-6)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """The same synthetic data in both packages (Gene features 96 wide), a
    JAX run with stream_features=["Gene"] and its initial parameters."""
    root = tmp_path_factory.mktemp("streamed")
    jdata = JaxData.from_synthetic(data_path=str(root / "jax") + "/", **DATA)
    pdata = KGWAS_Data.from_synthetic(data_path=str(root / "port"), **DATA)
    for d in (jdata, pdata):
        d.load_synthetic_gwas(seed=5)
        d.process_gwas_file()
        d.prepare_split()
    jrun = JaxKGWAS(jdata, exp_name="stream", seed=5)
    jrun.initialize_model(stream_features=["Gene"], **MODEL)
    init = jax.tree_util.tree_map(np.array, jrun.params)
    return jdata, jrun, init, pdata


def _port_run(pdata, init, **kw):
    run = KGWAS(pdata, device="cpu", exp_name="p", seed=5)
    run.initialize_model(**MODEL, **kw)
    run.model.load_state_dict(params_from_jax(init))
    return run


def _batch(n_snp):
    return np.random.default_rng(3).integers(0, n_snp, 32)


def test_stripped_state_keeps_the_table_on_the_host(both):
    _, _, init, pdata = both
    run = _port_run(pdata, init, stream_features=["Gene"])
    cg, x, _ = run._device_state()
    assert list(x) == list(cg.node_x)
    assert x["Gene"].shape == (cg.padded_nodes["Gene"], 1)
    assert not x["Gene"].any()
    assert run._x_host["Gene"].shape == (40, GENE_DIM)
    np.testing.assert_array_equal(run._x_host["Gene"],
                                  cg.node_x["Gene"][:40])


def test_streamed_step_matches_the_in_device_step(both):
    _, _, init, pdata = both
    s = _port_run(pdata, init, stream_features=["Gene"])
    h = _port_run(pdata, init)
    cg, xs, ls = s._device_state()
    _, xh, lh = h._device_state()
    y, w = s._labels(cg)
    bidx = torch.from_numpy(_batch(cg.num_nodes["SNP"]))
    opt_s = build_optimizer(s.model.parameters(), LR, 5e-4)
    opt_h = build_optimizer(h.model.parameters(), LR, 5e-4)
    loss_s = train_step_streamed(s.model, opt_s, xs, ls, s._x_host,
                                 cg.padded_nodes, bidx, y, w, col_chunk=CHUNK)
    loss_h = train_step(h.model, opt_h, xh, lh, bidx, y, w)
    assert float(loss_s) == pytest.approx(float(loss_h), rel=1e-5)
    gs = dict(s.model.named_parameters())
    for k, p in h.model.named_parameters():
        # the first layer's gradient: X^T dh1 chunk by chunk against one
        # matmul; sums of 40 rows
        np.testing.assert_allclose(gs[k].grad.numpy(), p.grad.numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
        np.testing.assert_allclose(gs[k].detach().numpy(),
                                   p.detach().numpy(), rtol=0, atol=2 * LR,
                                   err_msg=k)


def test_streamed_step_matches_jax(both):
    _, jrun, init, pdata = both
    jcg, jarrays, jy, jw = jrun._device_state()
    opt = jax_optimizer(LR, 5e-4)
    step = make_streamed_train_step(jrun.model_cfg, jrun.meta, opt,
                                    ["Gene"], col_chunk=CHUNK)
    b = _batch(jcg.num_nodes["SNP"])
    params = jax.tree_util.tree_map(jnp.asarray, init)
    p_j, _, loss_j = step(params, opt.init(params), jarrays, jrun._x_host,
                          jnp.asarray(b, dtype=jnp.int32), jy, jw)

    run = _port_run(pdata, init, stream_features=["Gene"])
    cg, x, lay = run._device_state()
    y, w = run._labels(cg)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    optim = build_optimizer(run.model.parameters(), LR, 5e-4)
    loss = train_step_streamed(run.model, optim, x, lay, run._x_host,
                               cg.padded_nodes, torch.from_numpy(b), y, w,
                               col_chunk=CHUNK)
    assert float(loss) == pytest.approx(float(loss_j), rel=1e-5)
    got = flatten_params(params_to_jax(run.model.state_dict()))
    want = flatten_params(jax.tree_util.tree_map(np.asarray, p_j))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * LR,
                                   err_msg=k)


def test_train_and_predict_all_with_stream_features(both, tmp_path):
    """The user API: train + predict_all with Gene streamed, against the
    JAX package's streamed run from the same parameters, and against the
    port without streaming at the same weights; the interpretation uploads
    every table, as the JAX package's does; a checkpoint serves without
    streaming (stream_features is not persisted, in both packages)."""
    jdata, _, init, pdata = both
    jrun = JaxKGWAS(jdata, exp_name="e2e", seed=5)
    jrun.initialize_model(stream_features=["Gene"], **MODEL)
    jrun.params = jax.tree_util.tree_map(jnp.asarray, init)
    jres = jrun.train(batch_size=32, epoch=2, lr=1e-3, save_best_model=False)

    run = _port_run(pdata, init, stream_features=["Gene"])
    table = run.train(batch_size=32, epoch=2, lr=1e-3, save_name="e2e")
    assert [len(e) for e in run.epoch_losses] == [len(e) for e in
                                                  jrun.epoch_losses]
    for got, want in zip(run.epoch_losses, jrun.epoch_losses):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    assert np.isfinite(table["KGWAS_P"]).all()
    pred = run.predict_all()
    assert pred.shape == (150,) and np.isfinite(pred).all()
    np.testing.assert_allclose(pred, np.asarray(jrun.predict_all()),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(table["pred"], jres.pred.values, rtol=1e-4,
                               atol=1e-5)

    dense = _port_run(pdata, init)
    dense.model.load_state_dict(run.model.state_dict())
    dense.kgwas_res = run.kgwas_res
    np.testing.assert_allclose(pred, dense.predict_all(), rtol=1e-4,
                               atol=1e-5)
    nw, _, _ = run.get_disease_critical_network(variant_threshold=0.5)
    nw_dense, _, _ = dense.get_disease_critical_network(
        variant_threshold=0.5)
    np.testing.assert_array_equal(nw["weight"], nw_dense["weight"])

    served = KGWAS(pdata, device="cpu", exp_name="s")
    served.load_pretrained(str(pdata.data_path).rstrip("/")
                           + "/model/e2e")
    assert served.stream_features == [] and "stream_features" not in \
        served.config
    np.testing.assert_allclose(served.predict_all(), pred, rtol=1e-4,
                               atol=1e-5)
