"""``KGWAS.train`` and two gloo ranks under dst-range sub-layouts
(``KGWAS_MERGED_MAX_EDGES``), on test_torch_split_layouts' KG and setting
(Gene in 2 sub-layouts, SNP in 3):

  * ``KGWAS.train`` for 3 steps under the setting against the JAX
    package's (its Pallas ops in interpret mode): losses rtol 1e-4; its
    two pred.csv files (formatted once, then copied) byte for byte
    ``write_table``'s output
  * two gloo ranks with the split against one process
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import torch

from kgwas_tpu import KGWAS as JaxKGWAS

import kgwas_tpu_torch as kt
from kgwas_tpu_torch.engine import batch_loss, params_from_jax
from kgwas_tpu_torch.graph import build_merged_layouts
from kgwas_tpu_torch.utils import write_table

from test_torch_split_layouts import D, ENV, KG_S, SPLIT, SPLIT_KEYS, _data
from torch_threads import few_torch_threads  # noqa: F401,E402

HERE = Path(__file__).resolve().parent


def test_train_three_steps_matches_jax_under_split(tmp_path, monkeypatch):
    monkeypatch.setenv(ENV, SPLIT)
    jrun = JaxKGWAS(_data(tmp_path / "jax", True), exp_name="split", seed=3)
    jrun.initialize_model(gnn_hidden_dim=D, no_relu=True, use_pallas=True)
    assert SPLIT_KEYS <= set(jrun.meta["merged"])
    init = jax.tree_util.tree_map(np.array, jrun.params)
    jrun.train(batch_size=64, epoch=1, lr=1e-3, save_best_model=False)

    run = kt.KGWAS(_data(tmp_path / "port"), device="cpu", exp_name="split",
                   seed=3)
    run.initialize_model(gnn_hidden_dim=D, no_relu=True)
    assert SPLIT_KEYS <= set(run.layouts)
    run.model.load_state_dict(params_from_jax(init))
    table = run.train(batch_size=64, epoch=1, lr=1e-3)
    assert [len(e) for e in run.epoch_losses] == [3]
    np.testing.assert_allclose(np.concatenate(run.epoch_losses),
                               np.concatenate(jrun.epoch_losses), rtol=1e-4)
    # the table formatted once, the checkpoint's copy the same bytes
    write_table(table, str(tmp_path / "fresh.csv"))
    fresh = (tmp_path / "fresh.csv").read_bytes()
    port = tmp_path / "port"
    assert (port / "model_pred" / "new_experiments" / "split_pred.csv"
            ).read_bytes() == fresh
    assert (port / "model" / "split" / "pred.csv").read_bytes() == fresh
    assert run.pred_csv_seconds > 0


# ------------------------------------------------- two gloo ranks, split


def _rank_main(rank, world, work, threads):
    """One rank of the split world: the sharded forward, one step's summed
    gradients and 3 Adam steps (test_torch_parallel's _rank_main on one
    case), written to work/rank{rank}.npz."""
    import torch.distributed as dist

    from kgwas_tpu_torch.engine.loop import fill_dead_grads
    from kgwas_tpu_torch.engine.optim import build_optimizer
    from kgwas_tpu_torch.parallel.mesh import init_distributed, make_mesh
    from kgwas_tpu_torch.parallel.shard import (ShardedRun, sharded_forward,
                                                sharded_train_step, sum_grads)
    from test_torch_parallel import LR, WD, _port_world

    torch.set_num_threads(threads)
    work = Path(work)
    init_distributed("gloo", f"file://{work / 'store'}", world, rank)
    spec = np.load(work / "spec.npz")
    cg, model, layouts, x = _port_world(KG_S, torch.load(work / "state.pt"))
    mesh = make_mesh(data=world, model=1)
    run = ShardedRun(build_merged_layouts(cg, tile_rows=512), x, mesh, "cpu",
                     cg.padded_nodes)
    assert SPLIT_KEYS <= set(run.host_layouts)
    y, w = torch.from_numpy(spec["y"]), torch.from_numpy(spec["w"])
    out = {"pred": sharded_forward(model, run, layouts).numpy()}
    loss = batch_loss(run.forward(model, layouts, training=True),
                      torch.from_numpy(spec["batches"][0]), y, w)
    (loss / mesh.size).backward()
    fill_dead_grads(model)
    sum_grads(model, mesh)
    out["loss"] = loss.item()
    out.update({f"grad:{k}": p.grad.numpy().copy()
                for k, p in model.named_parameters()})
    model.load_state_dict(torch.load(work / "state.pt"))
    opt = build_optimizer(model.parameters(), LR, WD)
    out["losses"] = np.array([
        sharded_train_step(model, opt, run, layouts, torch.from_numpy(b), y,
                           w).item() for b in spec["batches"]])
    np.savez(work / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def test_two_gloo_ranks_with_split_match_one_process(tmp_path, monkeypatch):
    from test_torch_parallel import _assert_like_single, _setup, _single

    monkeypatch.setenv(ENV, SPLIT)
    inputs = _setup(tmp_path, KG_S)
    threads = max(1, (os.cpu_count() or 2) // 4)
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import test_torch_split_train as T; "
            "T._rank_main(int(sys.argv[3]), 2, sys.argv[4], int(sys.argv[5]))")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(HERE), str(HERE.parent), str(r),
         str(tmp_path), str(threads)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        single = _single(KG_S, tmp_path, *inputs)
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    _assert_like_single(ranks, single)
