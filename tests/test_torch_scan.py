"""Scanned training dispatch: the port's TrainScan and KGWAS.train's block
loop against the JAX package's make_train_scan and its KGWAS.train.

Same seeded numpy inputs on both sides; the JAX side runs jitted, its
Pallas ops in interpret mode where the configuration reaches them, with
matmul precision "highest" (tests/conftest.py). On the CPU a block's steps
run eagerly (the plain version of the CUDA graph, which
tests/test_torch_gpu.py and chip_smoke.py phase 15 hold against eager
steps on the card, bitwise).

  (i)   TrainScan over S = 3 steps from the same parameters against
        make_train_scan: GAT sum (merged), GAT max (per relation), GCN
        ('mp'), and compute_dtype bfloat16
  (ii)  KGWAS.train(scan_steps=8, checkpoint_every=3) on
        tests/test_engine.py's tiny KG, with full blocks and a tail:
        losses, the step_N checkpoint names, the fault hook's calls and
        the heartbeats against the JAX package's same call; scan_steps=8
        against scan_steps=0 bitwise
  (iii) Bf16Adam against the optimizer it replaced, over 200 steps,
        bitwise
  (iv)  bench_lib with BENCH_SCAN=2
"""
import io
import json
import os
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu import KGWAS as JaxKGWAS
from kgwas_tpu import KGWAS_Data as JaxData
from kgwas_tpu.config import ModelConfig as JaxModelConfig
from kgwas_tpu.engine import watchdog as jax_watchdog
from kgwas_tpu.engine.loop import build_optimizer as jax_build_optimizer
from kgwas_tpu.engine.loop import make_train_scan
from kgwas_tpu.graph import compile_graph as jax_compile_graph
from kgwas_tpu.graph import make_synthetic_kg as jax_make_kg
from kgwas_tpu.models.hetero_gnn import init_hetero_gnn

from kgwas_tpu_torch import KGWAS, KGWAS_Data, bench_lib
from kgwas_tpu_torch.config import ModelConfig
from kgwas_tpu_torch.engine import (TrainScan, build_optimizer,
                                    flatten_params, params_from_jax,
                                    params_to_jax)
from kgwas_tpu_torch.engine import watchdog
from kgwas_tpu_torch.engine.optim import Bf16Adam, bias_table
from kgwas_tpu_torch.graph import (build_merged_layouts, compile_graph,
                                   make_synthetic_kg)
from kgwas_tpu_torch.models import HeteroGNN, device_layouts, layer_paths
from test_torch_gpu import PlainBf16Adam
from torch_threads import few_torch_threads  # noqa: F401,E402

KG = dict(n_snp=300, n_gene=60, n_go=30, snp_dim=20, gene_dim=32, go_dim=16,
          seed=7)
S, B, LR, WD = 3, 32, 1e-3, 5e-4
# GAT sum reaches the merged Pallas layer only at a width of 128
CASES = {
    "GAT-sum": ({}, 128),
    "GAT-max": ({"gnn_aggr": "max"}, 16),
    "GCN": ({"gnn_backbone": "GCN"}, 16),
    "compute-bf16": ({"compute_dtype": "bfloat16"}, 128),
}


@pytest.fixture(scope="module")
def world():
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
    batch_mat = np.stack([rng.choice(n, B, replace=False) for _ in range(S)])
    return cg_j, cg, y, w, batch_mat


def _port_model(cg, cfg, params):
    pcfg = ModelConfig.from_dict(cfg.to_dict())
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    model = HeteroGNN(pcfg, rel_types, 20, 32, 16, seed=1)
    model.load_state_dict(params_from_jax(params))
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu",
                             cg, layer_paths(pcfg))
    x = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
    return model, x, layouts


# --------------------------------------------------- (i) TrainScan vs JAX

@pytest.mark.parametrize("case", list(CASES))
def test_train_scan_matches_make_train_scan(world, case):
    """One TrainScan call (on the CPU S eager steps) against one call of
    the JAX package's make_train_scan, from the same parameters."""
    cg_j, cg, y, w, batch_mat = world
    kw, hidden = CASES[case]
    cfg = JaxModelConfig(gnn_hidden_dim=hidden, gnn_num_layers=2,
                         no_relu=True, use_pallas=True, **kw)
    params = jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
        jax.random.PRNGKey(0), cfg, cg_j.meta(), 20, 32, 16))
    jopt = jax_build_optimizer(LR, WD)
    jparams, _, jlosses = make_train_scan(cfg, cg_j.meta(), jopt)(
        params, jopt.init(params), cg_j.arrays(), jnp.asarray(batch_mat),
        jnp.asarray(y), jnp.asarray(w))

    model, x, layouts = _port_model(cg, cfg, params)
    opt = build_optimizer(model.parameters(), LR, WD)
    losses = TrainScan(model, opt, x, layouts, torch.from_numpy(y),
                       torch.from_numpy(w), S)(batch_mat)
    assert losses.shape == (S,)
    # float32 in another summation order (tests/test_torch_train.py);
    # under compute_dtype bf16 the bf16 model tolerance
    # (tests/test_torch_bf16_model.py)
    bf16 = case == "compute-bf16"
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-2 if bf16 else 1e-4,
                               atol=1e-3 if bf16 else 0)
    # parameters: Adam's update is about lr whatever the gradient's size
    # (tests/test_torch_train.py), so a gradient at float noise may move
    # its parameter by lr the other way: within 2 lr a step
    want = flatten_params(jax.tree_util.tree_map(np.asarray, jparams))
    got = flatten_params(params_to_jax(
        {k: v.detach().float() for k, v in model.state_dict().items()}))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(
            np.asarray(got[k], np.float32), np.asarray(want[k], np.float32),
            rtol=1e-4, atol=2 * LR * S, err_msg=k)


def test_train_scan_is_train_step_repeated(world):
    """A block's losses and the parameters after it are bitwise S single
    steps' (the CPU runs the block eagerly: the same calls)."""
    from kgwas_tpu_torch.engine import train_step

    cg_j, cg, y, w, batch_mat = world
    cfg = JaxModelConfig(gnn_hidden_dim=16, gnn_num_layers=2, no_relu=True)
    params = jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
        jax.random.PRNGKey(1), cfg, cg_j.meta(), 20, 32, 16))
    runs = []
    for scanned in (True, False):
        model, x, layouts = _port_model(cg, cfg, params)
        opt = build_optimizer(model.parameters(), LR, WD)
        yt, wt = torch.from_numpy(y), torch.from_numpy(w)
        if scanned:
            scan = TrainScan(model, opt, x, layouts, yt, wt, S)
            losses = torch.cat([scan(batch_mat), scan(batch_mat)])
        else:
            losses = torch.stack([
                train_step(model, opt, x, layouts, torch.from_numpy(b), yt,
                           wt) for b in np.concatenate([batch_mat] * 2)])
        runs.append((losses, model.state_dict()))
    assert torch.equal(runs[0][0], runs[1][0])
    for k, v in runs[0][1].items():
        assert torch.equal(v, runs[1][1][k]), k
    with pytest.raises(ValueError, match="batches for a scan"):
        TrainScan(model, opt, x, layouts, yt, wt, S)(batch_mat[:2])


# ------------------------------------------- (ii) KGWAS.train, block loop

TINY = dict(n_snp=300, n_gene=60, n_go=20, seed=11)
# 22 steps an epoch at this batch size: 2 blocks of 8 and a 6-step tail
TRAIN = dict(batch_size=12, epoch=1, lr=1e-3, save_best_model=False,
             checkpoint_every=3)



def _data(cls, root):
    data = cls.from_synthetic(data_path=str(root) + "/", **TINY)
    data.load_synthetic_gwas(seed=11)
    data.process_gwas_file()
    data.prepare_split()
    return data


def _traced_train(run, module, monkeypatch, **kw):
    """run.train(**kw) with the fault hook's steps and the heartbeat's
    touches recorded."""
    hooks, beats = [], []
    run._fault_hook = hooks.append
    monkeypatch.setattr(module, "touch_heartbeat",
                        lambda path: beats.append(path))
    run.train(heartbeat_path="hb", **kw)
    return hooks, beats


def _names(root, exp):
    d = os.path.join(str(root), "model", exp, "train_state")
    return sorted((f for f in os.listdir(d) if f.startswith("step_")),
                  key=lambda f: int(f.split("_")[1]))


@pytest.fixture(scope="module")
def block_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("blocks")
    mp = pytest.MonkeyPatch()
    try:
        jrun = JaxKGWAS(_data(JaxData, root / "jax"), exp_name="scan",
                        seed=11)
        jrun.initialize_model(gnn_hidden_dim=16, gnn_num_layers=2,
                              no_relu=True)
        init = jax.tree_util.tree_map(np.array, jrun.params)
        jax_trace = _traced_train(jrun, jax_watchdog, mp, scan_steps=8,
                                  **TRAIN)
        jrun._checkpointer_names = _names(root / "jax", "scan")
        data = _data(KGWAS_Data, root / "port")
        runs = {}
        for scan in (8, 0):
            run = KGWAS(data, device="cpu", exp_name=f"scan{scan}", seed=11)
            run.initialize_model(gnn_hidden_dim=16, gnn_num_layers=2,
                                 no_relu=True)
            run.model.load_state_dict(params_from_jax(init))
            trace = _traced_train(run, watchdog, mp, scan_steps=scan,
                                  **TRAIN)
            runs[scan] = (run, trace, _names(root / "port", f"scan{scan}"))
    finally:
        mp.undo()
    return jrun, jax_trace, runs


def test_scanned_train_matches_jax(block_runs):
    jrun, _, runs = block_runs
    run = runs[8][0]
    assert [len(e) for e in run.epoch_losses] == [22]
    assert [len(e) for e in jrun.epoch_losses] == [22]
    # float32 in another summation order, Adam (tests/test_torch_train.py)
    np.testing.assert_allclose(np.concatenate(run.epoch_losses),
                               np.concatenate(jrun.epoch_losses), rtol=1e-4)
    assert run.best_epoch == jrun.best_epoch


def test_scanned_checkpoint_names_match_jax(block_runs):
    """A save where a block crosses a multiple of checkpoint_every, named
    by the block's last step: 8 (across 3 and 6) and 16 (across 9, 12
    and 15), then the tail's 18 and 21."""
    jrun, _, runs = block_runs
    assert runs[8][2] == jrun._checkpointer_names
    assert runs[8][2] == [f"step_{n}" for n in (8, 16, 18, 21)]
    # one step at a time: every multiple
    assert runs[0][2] == [f"step_{n}" for n in range(3, 22, 3)]


def test_scanned_fault_hooks_and_heartbeats_match_jax(block_runs):
    """The fault hook once per step, a block's calls before it runs (the
    same order as the JAX package's); the heartbeat once per block and
    around each epoch-end forward."""
    _, (jhooks, jbeats), runs = block_runs
    hooks, beats = runs[8][1]
    assert hooks == jhooks == list(range(22))
    assert len(beats) == len(jbeats) == 2 + 6 + 2
    assert len(runs[0][1][1]) == 22 + 2


def test_scanned_train_is_bitwise_per_step(block_runs):
    _, _, runs = block_runs
    a, b = runs[8][0], runs[0][0]
    assert a.epoch_losses == b.epoch_losses
    for k in a.params:
        assert torch.equal(a.params[k], b.params[k]), k
    assert np.array_equal(a.predict_all(), b.predict_all())


def test_scan_steps_ignored_when_streamed(tmp_path):
    """Streamed features run every step on its own, as the JAX package's
    gate has it (scan_steps is ignored there)."""
    run = KGWAS(_data(KGWAS_Data, tmp_path), device="cpu", seed=11)
    run.initialize_model(gnn_hidden_dim=16, stream_features=["Gene"])
    run.train(batch_size=12, epoch=1, lr=1e-3, save_best_model=False,
              scan_steps=8)
    assert run.train_scan is None
    assert len(run.epoch_losses[0]) == 22


# ----------------------------------------------------------- (iii) Bf16Adam

def _bits(t):
    return t.view(torch.int16)


@pytest.mark.parametrize("wd", [0.0, 5e-4])
def test_bf16_adam_bitwise_the_plain_one(wd):
    rng = np.random.default_rng(3)
    shapes = [(64, 32), (32,), (7, 3)]
    p0 = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.3)
          .to(torch.bfloat16) for s in shapes]
    a = [p.clone() for p in p0]
    b = [p.clone() for p in p0]
    plain, opt = PlainBf16Adam(a, 1e-2, wd), Bf16Adam(b, 1e-2, wd)
    for _ in range(200):
        for pa, pb in zip(a, b):
            g = torch.from_numpy(rng.standard_normal(pa.shape).astype(
                np.float32) * 0.1).to(torch.bfloat16)
            pa.grad, pb.grad = g, g.clone()
        plain.step()
        opt.step()
        for pa, pb in zip(a, b):
            assert torch.equal(_bits(pa), _bits(pb))
    for pa, pb in zip(a, b):
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(_bits(plain.state[pa][k]),
                               _bits(opt.state[pb][k]))
        assert float(opt.state[pb]["step"]) == 200


@pytest.mark.parametrize("beta", [0.9, 0.999])
def test_bias_table_saturates_at_one(beta):
    """Past its last entry every 1 - b^t rounds to 1 in bf16, so the step
    count indexes the table clamped to its length."""
    table = bias_table(beta, torch.bfloat16)
    assert float(table[-1]) == 1.0 and float(table[-2]) < 1.0
    for t in range(len(table) + 1, len(table) + 2000, 37):
        v = np.float32(1) - np.float32(beta) ** np.float32(t)
        assert float(torch.tensor(float(v)).to(torch.bfloat16)) == 1.0


# -------------------------------------------------------------- (iv) bench

def test_bench_scan_reports_the_block(monkeypatch):
    for k, v in dict(BENCH_N_SNP=400, BENCH_N_GENE=60, BENCH_N_GO=20,
                     BENCH_HIDDEN=16, BENCH_BATCH=32, BENCH_STEPS=4,
                     BENCH_SCAN=2).items():
        monkeypatch.setenv(k, str(v))
    out = io.StringIO()
    with redirect_stdout(out):
        bench_lib.main(device="cpu")
    rec = json.loads(out.getvalue().strip().splitlines()[-1])
    assert rec["config"]["scan"] == 2
    # a slope of two host-clock series on the CPU: finite, its sign noise
    # (tests/test_torch_profiling.py)
    assert np.isfinite(rec["value"]) and np.isfinite(rec["config"]["step_ms"])
