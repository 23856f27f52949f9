"""The dtype options (``stream_dtype``, ``compute_dtype``) through the whole
model, the port against the JAX package.

From the same JAX-initialised weights (``params_from_jax``) and the same
seeded KG, at hidden 128 and 2 layers:

* the forward's predictions, ``HeteroGNN.forward`` against
  ``apply_hetero_gnn(use_pallas=True)`` (the JAX package's Pallas ops in
  interpret mode), for GAT sum and mean (the merged path: #1 in bf16),
  sigmoid GAT max (per relation: #10 on bf16 messages), SAGE, GCN and SGC
  (the message-passing path: #10);
* one training step's loss and parameter gradients (#2 and #8 in bf16
  on the merged path, #8 on the others);
* one step under ``stream_dtype`` on each of the JAX package's training
  layouts (the src-chunked stream with and without padded fragments, #3,
  #4, #5, and the CSC-windowed backward, #9), which the port maps onto its
  one stream;
* ``KGWAS.train`` (3 steps) and ``KGWAS_P`` under each option
  (``compute_dtype`` is what ``--dtype bfloat16`` sets) in both packages:
  ``KGWAS_P`` finite in [0, 1] and within the JAX package's bf16 bound
  (rtol 0.1, atol 0.05) of the JAX package's.

Tolerance rtol 1e-2, atol 1e-3 on predictions and losses. bf16 keeps 8
bits, and the two packages round the same values at the same points but
sum in other orders (a sum a few float32 ulps apart can round to the
neighbouring bf16 value, 2^-8 away), through the matrix products of two
layers and the head: the worst prediction errors seen here are about 2e-3
relative. Gradients at rtol 1e-2 with an absolute floor of a share of the
largest gradient: 1e-3 under stream_dtype; 2.5e-3 under compute_dtype,
where every cotangent of a bf16 activation is rounded to bf16 (a torch
gradient has its tensor's dtype; the JAX package's custom VJPs hand some
on in float32), and a gradient summed over many nodes can cancel to a
few such roundings (worst seen 1.9e-3 of the largest). The JAX package's
own bf16 backward raises a dtype error for sigmoid GAT max (both options)
and SAGE under compute_dtype (lax.add / lax.mul of float32 and bfloat16
cotangents): there the port's bf16 gradients are held against the JAX
package's float32 ones, with a floor of 1e-2 of the largest (worst seen
5.7e-3), and the test checks that the JAX package still raises. Every
bound is far inside the JAX package's own bf16-against-f32 bound (rtol
0.1, atol 0.05; tests/test_merged_layer.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.config import ModelConfig as JaxModelConfig
from kgwas_tpu.models.hetero_gnn import apply_hetero_gnn, init_hetero_gnn

from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.engine.checkpoint import params_from_jax
from test_torch_model import _jax_setup, _port_model
from test_torch_train import jax_step_grads, port_step_grads, step_world  # noqa: F401
from test_torch_train_layouts import reached  # noqa: F401

from kgwas_tpu_torch.graph import build_merged_layouts
from kgwas_tpu_torch.models import device_layouts, layer_paths

RTOL, ATOL = 1e-2, 1e-3
VARIANTS = {
    "GAT-sum": {},
    "GAT-mean": {"gnn_aggr": "mean"},
    "sigmoid-GAT-max": {"sigmoid_gat": True, "gnn_aggr": "max"},
    "SAGE": {"gnn_backbone": "SAGE"},
    "GCN": {"gnn_backbone": "GCN"},
    "SGC": {"gnn_backbone": "SGC"},
}
DTYPES = {"stream": {"stream_dtype": "bfloat16"},
          "compute": {"compute_dtype": "bfloat16"}}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_forward_matches_jax(variant, dtype):
    """The JAX side runs jitted on jnp arrays, as KGWAS.train runs it: run
    eagerly on numpy parameters, apply_hetero_gnn casts them to numpy
    (ml_dtypes) bfloat16 under compute_dtype, and a numpy bf16 @ bf16
    product returns float32, so the eager forward's encoders would leave
    float32 where the jitted one (jnp) keeps bf16 (the two JAX forwards
    differ by up to 5.8e-3 of the largest prediction)."""
    cg_j, cfg, meta, params = _jax_setup(128, use_pallas=True,
                                         **VARIANTS[variant], **DTYPES[dtype])
    want = np.asarray(jax.jit(lambda p, a: apply_hetero_gnn(p, cfg, meta, a))(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, cg_j.arrays())))
    cg, model = _port_model(cfg, params)
    assert model.cfg.to_dict().items() >= DTYPES[dtype].items()
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu",
                             cg, layer_paths(model.cfg))
    x = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
    with torch.inference_mode():
        got = model(x, layouts)
    assert got.dtype == torch.float32
    n = cg.num_nodes["SNP"]
    got = got.numpy()[:n]
    assert np.abs(want[:n]).max() > 0 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want[:n], rtol=RTOL, atol=ATOL)


# (variant, option) whose bf16 backward the JAX package cannot take
JAX_NO_BF16_GRAD = {("sigmoid-GAT-max", "stream"),
                    ("sigmoid-GAT-max", "compute"), ("SAGE", "compute")}


def _assert_step_close(step_world, cfg_kw, floor=ATOL,  # noqa: F811
                       f32_reference=False):
    cfg = JaxModelConfig(gnn_hidden_dim=128, gnn_num_layers=2, no_relu=True,
                         use_pallas=True, **cfg_kw)
    params = jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
        jax.random.PRNGKey(0), cfg, step_world[0].meta(), 20, 32, 16))
    if f32_reference:
        with pytest.raises(TypeError, match="requires arguments to have the "
                                            "same dtypes"):
            jax_step_grads(step_world, cfg, params)
        jl, jg = jax_step_grads(step_world, dataclasses.replace(
            cfg, compute_dtype="float32", stream_dtype=None), params)
    else:
        jl, jg = jax_step_grads(step_world, cfg, params)
    pl_, pg = port_step_grads(step_world, cfg, params)
    assert pl_ == pytest.approx(jl, rel=RTOL, abs=ATOL)
    assert sorted(pg) == sorted(jg)
    top = max(np.abs(v).max() for v in jg.values())
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], rtol=RTOL, atol=floor * top,
                                   err_msg=k)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_step_grads_match_jax(step_world, variant, dtype):  # noqa: F811
    f32_ref = (variant, dtype) in JAX_NO_BF16_GRAD
    floor = 1e-2 if f32_ref else 2.5e-3 if dtype == "compute" else ATOL
    _assert_step_close(step_world, {**VARIANTS[variant], **DTYPES[dtype]},
                       floor, f32_ref)


@pytest.mark.parametrize("cfg_kw,sites", [
    ({}, {1, 2, 8}),
    ({"gather_chunk_rows": 512, "pad_fragments": False}, {1, 2, 3, 4, 8}),
    ({"gather_chunk_rows": 512, "pad_fragments": True}, {1, 2, 3, 5, 8}),
    ({"bwd_window_edges": 512, "gather_chunk_rows": 10 ** 9}, {1, 2, 9}),
], ids=["plain", "chunked", "chunked-padded", "windowed"])
def test_bf16_step_on_jax_training_layouts(step_world, reached,  # noqa: F811
                                           cfg_kw, sites):
    """stream_dtype through each JAX training layout's Pallas kernels in
    bf16 (the counters confirm which sites the JAX side reached)."""
    _assert_step_close(step_world, {"stream_dtype": "bfloat16", **cfg_kw})
    assert set(reached) == sites


GOLDEN = dict(n_snp=250, n_gene=50, n_go=18, seed=123)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bf16_pipeline_trains_like_jax(tmp_path, dtype):
    """KGWAS_Data.from_synthetic -> KGWAS.train (3 steps, from the same
    weights) -> KGWAS_P, the JAX package's and the port's, under the
    option (compute_dtype is what --dtype bfloat16 sets)."""
    kw = dict(gnn_hidden_dim=128, gnn_num_layers=2, no_relu=True,
              **DTYPES[dtype])
    data = JaxData.from_synthetic(data_path=str(tmp_path / "jax"), **GOLDEN)
    data.load_synthetic_gwas(seed=123)
    data.process_gwas_file()
    data.prepare_split()
    run = JaxKGWAS(data, exp_name="bf16", seed=123)
    run.initialize_model(use_pallas=True, **kw)
    init = jax.tree_util.tree_map(np.array, run.params)
    res = run.train(batch_size=64, epoch=1, lr=1e-3, save_best_model=False)

    pdata = KGWAS_Data.from_synthetic(data_path=str(tmp_path / "port"),
                                      **GOLDEN)
    pdata.load_synthetic_gwas(seed=123)
    pdata.process_gwas_file()
    pdata.prepare_split()
    port = KGWAS(pdata, device="cpu", exp_name="bf16", seed=123)
    port.initialize_model(**kw)
    port.model.load_state_dict(params_from_jax(init))
    table = port.train(batch_size=64, epoch=1, lr=1e-3,
                       save_best_model=False)
    jl = np.asarray(run.epoch_losses[0])
    pl_ = np.asarray(port.epoch_losses[0])
    assert len(pl_) == len(jl) == 3
    np.testing.assert_allclose(pl_, jl, rtol=RTOL, atol=ATOL)
    p = np.asarray(table["KGWAS_P"], dtype=np.float64)
    assert np.all(np.isfinite(p)) and np.all((p >= 0) & (p <= 1))
    np.testing.assert_allclose(
        p, np.asarray(res["KGWAS_P"], dtype=np.float64), rtol=0.1, atol=0.05)
