"""The dtype options around the model: configuration, checkpoints, the
optimizer, the entry points, and what still raises, against the JAX package.

* ``ModelConfig`` / ``TrainConfig`` fields, ``to_dict`` / ``from_dict``,
  ``save_config`` / ``load_config`` read by the other package, the
  ``KGWAS_STREAM_F32_LOGITS`` override with its warning, and the dtype
  names accepted (exact equality).
* A ``param_dtype="bfloat16"`` ``model.npz`` written by the JAX package
  loads into the port and back bit for bit (the leaves as their 16 bits:
  numpy reloads them as raw ``|V2``), and a bf16 train state restores bit
  for bit.
* ``Bf16Adam`` on bf16 leaves against the JAX package's optax chain
  (``engine/optim.torch_adam``, jitted) on the same leaves and gradients:
  the same operations rounded to bf16 in the same order, so the
  parameters and both moments bit for bit after 5 steps.
* The per-relation softmax GAT (GAT max, edge_dim, dropout in training)
  under a bf16 compute or stream dtype trains (it raised before its
  kernels' bf16 forms; the tests keep their names).
* The CLI's ``--dtype bfloat16`` trains (it sets compute_dtype), the
  streamed first layer is cast to the compute dtype as h1_override (the
  forward against ``apply_hetero_gnn(h1_override=...)`` at rtol 1e-2,
  atol 1e-3: tests/test_torch_bf16_model.py's bound), and the
  interpretation forward with bf16 parameters runs in float32, as
  ``apply_collect_attention`` (no compute cast), at
  tests/test_torch_interpret.py's tolerance.
"""
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu import config as jax_config
from kgwas_tpu.engine.checkpoint import save_model as jax_save_model
from kgwas_tpu.engine.optim import torch_adam
from kgwas_tpu.models import apply_collect_attention
from kgwas_tpu.models.hetero_gnn import apply_hetero_gnn

import kgwas_tpu_torch as kt
from kgwas_tpu_torch import config
from kgwas_tpu_torch.cli import main
from kgwas_tpu_torch.engine.checkpoint import (load_model, params_from_jax,
                                               params_to_jax,
                                               restore_train_state,
                                               save_train_state_async,
                                               make_async_checkpointer,
                                               flatten_params)
from kgwas_tpu_torch.engine.loop import fill_dead_grads
from kgwas_tpu_torch.engine.optim import Bf16Adam, build_optimizer
from kgwas_tpu_torch.models import gat_relation
from test_torch_interpret import ALPHA_ATOL, ALPHA_RTOL, _small_world
from test_torch_model import _jax_setup, _port_model
from torch_threads import few_torch_threads  # noqa: F401,E402

DTYPE_KEYS = ("param_dtype", "compute_dtype", "stream_dtype",
              "stream_f32_logits")


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint16)


# ------------------------------------------------------------ configuration

def test_config_fields_and_dicts_match_jax():
    jm = jax_config.ModelConfig()
    pm = config.ModelConfig()
    for k in DTYPE_KEYS:
        assert getattr(pm, k) == getattr(jm, k), k
    kw = dict(gnn_hidden_dim=64, compute_dtype="bfloat16",
              stream_dtype="bfloat16", stream_f32_logits=True,
              param_dtype="bfloat16", gnn_aggr="mean")
    pm = config.ModelConfig(**kw)
    d = pm.to_dict()
    assert config.ModelConfig.from_dict(d) == pm
    # the JAX package's dict carries into the port (its knobs dropped) and
    # the port's into the JAX package's, each key the same value
    jd = jax_config.ModelConfig(**kw).to_dict()
    assert config.ModelConfig.from_dict(jd) == pm
    assert jax_config.ModelConfig.from_dict(d).to_dict() == jd
    assert set(d) <= set(jd)
    tc = config.TrainConfig(batch_size=64, lr=3e-3, epoch=30)
    assert tc.to_dict() == jax_config.TrainConfig(batch_size=64, lr=3e-3,
                                                   epoch=30).to_dict()
    assert config.TrainConfig.from_dict(tc.to_dict()) == tc
    assert kt.TrainConfig is config.TrainConfig


def test_save_and_load_config_round_trip_with_jax(tmp_path):
    pm = config.ModelConfig(compute_dtype="bfloat16", gnn_hidden_dim=64)
    p = str(tmp_path / "port.json")
    kt.save_config(p, pm, {"train": config.TrainConfig().to_dict()})
    got = jax_config.load_config(p)
    assert got == kt.load_config(p)
    assert config.ModelConfig.from_dict(got["model"]) == pm
    assert got["train"] == jax_config.TrainConfig().to_dict()
    j = str(tmp_path / "jax.json")
    jax_config.save_config(j, jax_config.ModelConfig(
        compute_dtype="bfloat16", gnn_hidden_dim=64), {"seed": 3})
    back = kt.load_config(j)
    assert config.ModelConfig.from_dict(back["model"]) == pm
    assert back["seed"] == 3
    with open(j) as f:
        assert json.load(f) == back


@pytest.mark.parametrize("value,want", [("1", True), ("0", False)])
def test_stream_f32_logits_env_override_warns(monkeypatch, value, want):
    monkeypatch.setenv("KGWAS_STREAM_F32_LOGITS", value)
    with pytest.warns(DeprecationWarning, match="KGWAS_STREAM_F32_LOGITS"):
        pm = config.ModelConfig(stream_dtype="bfloat16")
    with pytest.warns(DeprecationWarning, match="KGWAS_STREAM_F32_LOGITS"):
        jm = jax_config.ModelConfig(stream_dtype="bfloat16")
    assert pm.stream_f32_logits is jm.stream_f32_logits is want
    # the field set: no override, no warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert config.ModelConfig(stream_f32_logits=True).stream_f32_logits


@pytest.mark.parametrize("key", ["param_dtype", "compute_dtype",
                                 "stream_dtype"])
def test_config_takes_only_float32_and_bfloat16(key):
    for v in ("float32", "bfloat16"):
        assert getattr(config.ModelConfig(**{key: v}), key) == v
    for v in ("float16", "bf16", "float64"):
        with pytest.raises(ValueError, match=key):
            config.ModelConfig(**{key: v})


# --------------------------------------------------------------- checkpoints

def test_jax_bf16_model_npz_round_trips_bitwise(tmp_path):
    cg_j, cfg, meta, params = _jax_setup(16, param_dtype="bfloat16")
    flat = flatten_params(params)
    assert {v.dtype.name for v in flat.values()} == {"bfloat16"}
    d = str(tmp_path / "jax")
    jax_save_model(params, {"gnn_hidden_dim": 16}, d)
    loaded, conf = load_model(d)
    sd = params_from_jax(loaded)
    assert {v.dtype for v in sd.values()} == {torch.bfloat16}
    _, model = _port_model(cfg, params)
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    model.load_state_dict(sd)
    back = flatten_params(params_to_jax(model.state_dict()))
    assert sorted(back) == sorted(flat)
    for k in flat:
        assert back[k].shape == flat[k].shape, k
        assert np.array_equal(_bits(back[k]), _bits(flat[k])), k
    # and the port's model.npz as the JAX package's loader reads it
    kt_dir = str(tmp_path / "port")
    from kgwas_tpu.engine.checkpoint import load_model as jax_load_model
    from kgwas_tpu_torch.engine.checkpoint import save_model
    save_model(model.state_dict(), conf, kt_dir)
    jp, _ = jax_load_model(kt_dir)
    for k, v in flatten_params(jp).items():
        assert np.array_equal(_bits(v), _bits(flat[k])), k


def test_bf16_train_state_restores_bitwise(tmp_path):
    _, cfg, _, params = _jax_setup(16, param_dtype="bfloat16")
    _, model = _port_model(cfg, params)
    opt = build_optimizer(model.parameters(), 1e-3, 5e-4)
    assert isinstance(opt, Bf16Adam)
    for p in model.parameters():
        p.grad = torch.randn(p.shape, generator=torch.Generator().manual_seed(
            p.numel())).to(torch.bfloat16)
    opt.step()
    ck = make_async_checkpointer()
    path = save_train_state_async(ck, str(tmp_path), 1, model.state_dict(),
                                  opt.state_dict())
    ck.close()
    ms, os_ = restore_train_state(path)
    for k, v in model.state_dict().items():
        assert ms[k].dtype == torch.bfloat16
        assert torch.equal(ms[k].view(torch.int16), v.view(torch.int16)), k
    opt2 = build_optimizer(model.parameters(), 1e-3, 5e-4)
    opt2.load_state_dict(os_)
    for p in model.parameters():
        a, b = opt.state[p], opt2.state[p]
        for k in ("exp_avg", "exp_avg_sq"):
            assert b[k].dtype == torch.bfloat16
            assert torch.equal(a[k].view(torch.int16),
                               b[k].view(torch.int16))
        assert int(a["step"]) == int(b["step"]) == 1


# ------------------------------------------------------------------ optimizer

def test_bf16_adam_matches_optax_on_bf16_leaves():
    rng = np.random.default_rng(0)
    shapes = [(64, 32), (32,), (7, 3)]
    p0 = [rng.standard_normal(s).astype(np.float32) * 0.3 for s in shapes]
    grads = [[rng.standard_normal(s).astype(np.float32) * 0.1
              for s in shapes] for _ in range(5)]
    tx = torch_adam(1e-2, 5e-4)
    jp = [jnp.asarray(p).astype(jnp.bfloat16) for p in p0]
    state = tx.init(jp)

    @jax.jit
    def step(jp, state, g):
        import optax
        upd, state = tx.update(g, state, jp)
        return optax.apply_updates(jp, upd), state

    tp = [torch.from_numpy(p).to(torch.bfloat16).requires_grad_()
          for p in p0]
    opt = build_optimizer(tp, 1e-2, 5e-4)
    for g in grads:
        jp, state = step(jp, state,
                         [jnp.asarray(x).astype(jnp.bfloat16) for x in g])
        for t, x in zip(tp, g):
            t.grad = torch.from_numpy(x).to(torch.bfloat16)
        opt.step()
    mu, nu = state[1].mu, state[1].nu
    for i, t in enumerate(tp):
        for got, want in ((t.detach(), jp[i]),
                          (opt.state[t]["exp_avg"], mu[i]),
                          (opt.state[t]["exp_avg_sq"], nu[i])):
            assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
            assert np.array_equal(got.view(torch.int16).numpy(),
                                  _bits(np.asarray(want)).view(np.int16))


def test_fill_dead_grads_in_param_dtype():
    lin = torch.nn.Linear(3, 2).to(torch.bfloat16)
    fill_dead_grads(lin)
    assert all(p.grad.dtype == torch.bfloat16 and not p.grad.any()
               for p in lin.parameters())


# ------------------------------------------------------- what still raises

@pytest.mark.parametrize("kw", [
    {"gnn_aggr": "max", "compute_dtype": "bfloat16"},
    {"gnn_aggr": "min", "stream_dtype": "bfloat16"},
    {"edge_dim": 4, "compute_dtype": "bfloat16"},
    {"dropout": 0.1, "stream_dtype": "bfloat16"},
], ids=["GAT-max", "GAT-min", "edge_dim", "dropout"])
def test_per_relation_softmax_bf16_raises(tmp_path, kw):
    """The per-relation softmax GAT under a bf16 compute or stream dtype no
    longer raises (its kernels' bf16 forms, tests/test_torch_bf16_relations
    .py): the option initialises, trains and predicts; param_dtype alone
    (the float32 kernels) runs as before."""
    data = kt.KGWAS_Data.from_synthetic(n_snp=50, n_gene=10, n_go=5, seed=0,
                                        data_path=str(tmp_path))
    data.load_synthetic_gwas(seed=0)
    data.process_gwas_file()
    data.prepare_split()
    run = kt.KGWAS(data, device="cpu")
    run.initialize_model(gnn_hidden_dim=16, no_relu=True, **kw)
    assert run.model.cfg.to_dict().items() >= kw.items()
    run.train(batch_size=8, epoch=1, lr=1e-3, save_best_model=False)
    assert np.all(np.isfinite(run.epoch_losses[0]))
    assert np.all(np.isfinite(run.predict_all()))
    run.initialize_model(gnn_hidden_dim=16, param_dtype="bfloat16",
                         **{k: v for k, v in kw.items() if "dtype" not in k})


def test_gat_relation_softmax_raises_in_bf16():
    """gat_relation's softmax mode in bf16 runs: a bf16 relation layer on
    one relation stream gives a float32 output (its checks against the
    float32 segment softmax of the widened values:
    tests/test_torch_bf16_relations.py)."""
    from kgwas_tpu_torch.graph import (build_merged_layouts, compile_graph,
                                       make_synthetic_kg)
    from kgwas_tpu_torch.models import device_layouts
    from kgwas_tpu_torch.models.convs import GATConv

    cg = compile_graph(make_synthetic_kg(n_snp=60, n_gene=12, n_go=6, seed=1),
                       edge_pad_multiple=512, node_pad_multiple=512)
    L = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu", cg,
                       "relations")["SNP"]
    RL = L.relations[0]
    src_t = RL.src_types[0]
    gen = torch.Generator().manual_seed(0)
    conv = GATConv(8, 8, 1, src_t == "SNP", gen)
    h = {t: torch.randn(n, 8, generator=gen).to(torch.bfloat16)
         for t, n in cg.padded_nodes.items()}
    out = gat_relation(conv, h[src_t], h["SNP"], RL, 0.2, 1.0, "softmax",
                       cdt=torch.bfloat16)
    assert out.dtype == torch.float32
    assert out.shape == (cg.padded_nodes["SNP"], 8)
    assert torch.isfinite(out).all()


# -------------------------------------------------------------- entry points

def test_cli_dtype_bfloat16_trains(tmp_path):
    run = main(["train", "--synthetic", "--device", "cpu", "--seed", "7",
                "--data-path", str(tmp_path), "--name", "bf16", "--hidden",
                "16", "--epochs", "1", "--batch-size", "256", "--dtype",
                "bfloat16"])
    assert run.model_cfg.compute_dtype == "bfloat16"
    assert "compute_dtype" not in run.config
    assert {p.dtype for p in run.model.parameters()} == {torch.float32}
    pred = run.predict_all()
    assert pred.dtype == np.float32 and np.all(np.isfinite(pred))


def test_streamed_h1_is_cast_to_the_compute_dtype():
    cg_j, cfg, meta, params = _jax_setup(128, use_pallas=True,
                                         compute_dtype="bfloat16")
    cg, model = _port_model(cfg, params)
    x = cg_j.node_x["Gene"]
    fc1 = params["gene_feat_mlp"]["fc1"]
    h1 = (x @ fc1["w"] + fc1["b"]).astype(np.float32)
    want = np.asarray(apply_hetero_gnn(params, cfg, meta, cg_j.arrays(),
                                       h1_override={"Gene": jnp.asarray(h1)}))
    from kgwas_tpu_torch.graph import build_merged_layouts
    from kgwas_tpu_torch.models import device_layouts
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu")
    xt = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
    with torch.inference_mode():
        got = model(xt, layouts, h1_override={"Gene": torch.from_numpy(h1)})
    n = cg.num_nodes["SNP"]
    np.testing.assert_allclose(got.numpy()[:n], want[:n], rtol=1e-2,
                               atol=1e-3)


@pytest.mark.parametrize("kw", [{"param_dtype": "bfloat16"},
                                {"param_dtype": "bfloat16",
                                 "gnn_aggr": "max"},
                                {"compute_dtype": "bfloat16"}],
                         ids=["param", "param-max", "compute"])
def test_collect_attention_applies_no_compute_cast(kw):
    """bf16 parameters reach the raw launches of #1 promoted to float32
    (the f32 instance); a compute dtype is not applied."""
    cfg, params, meta, cgj, model, layouts, x, cg = _small_world(2, **kw)
    want = apply_collect_attention(params, cfg, meta, cgj.arrays(), raw=True)
    got = model.collect_attention(x, layouts)
    for a, b in zip(got, want):
        assert set(a) == set(b) == set(cg.relations)
        for rk, alpha in a.items():
            e = cg.relations[rk].num_edges
            assert alpha.dtype == torch.float32
            np.testing.assert_allclose(alpha.numpy(), np.asarray(b[rk])[:e],
                                       rtol=ALPHA_RTOL, atol=ALPHA_ATOL)
