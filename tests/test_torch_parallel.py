"""Multi-device training (``kgwas_tpu_torch/parallel``) against the JAX
package's ``kgwas_tpu/parallel`` and the single-process port.

* ``build_device_layouts``: the per-rank static layouts equal the JAX
  package's array for array, for 2 ranks on ``step_world``'s KG and for 4
  on the same KG with 1,600 GO terms (the groups whose row tiles split;
  both packages refuse the others).
* The eligibility gates, case for case with
  ``tests/test_merged_shard.py::test_sharded_merged_eligibility_gates``.
* Two ranks over gloo (processes started once for the module, a
  ``FileStore`` in a module temporary directory, each joined with its own
  timeout; each rank runs the two cases below in turn, with a share of
  the cores, while this process runs the JAX package's step), GAT sum at
  hidden 128
  on a KG whose every merged group splits over 2 (600 GO terms): the
  forward's predictions, one step's loss and parameter gradients (summed
  over the ranks) and 3 Adam steps' losses, the same on both ranks,
  against the single-process port (predictions rtol 1e-5, atol 1e-5; the
  loss rtol 1e-5; gradients at test_torch_train's bounds: the ranks sum
  over relations outside the kernel and the gradients in another order)
  and against the JAX package on its 2-device CPU mesh:
  ``make_sharded_train_step``'s 3 losses on its shard_map'd Pallas path
  (interpret mode; rtol 1e-4, tests/test_merged_shard.py's bound).
* The 'model' axis: 2 ranks, mesh {'data': 1, 'model': 2}, a Gene table
  1,024 wide column-sharded over them: the forward and one step's
  gradients against the single-process port.
* ``mesh`` as an int, a dict, a MeshConfig; a size that does not match
  the world size raises; a configuration outside the merged gate raises
  naming ROADMAP item 10b.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import kgwas_tpu_torch as kt
from kgwas_tpu_torch.config import MeshConfig, ModelConfig
from kgwas_tpu_torch.engine.loop import batch_loss, fill_dead_grads, train_step
from kgwas_tpu_torch.engine.optim import build_optimizer
from kgwas_tpu_torch.graph import (build_merged_layouts, compile_graph,
                                   make_synthetic_kg)
from kgwas_tpu_torch.models import HeteroGNN, device_layouts, layer_paths
from kgwas_tpu_torch.parallel import merged_shard
from kgwas_tpu_torch.parallel.mesh import Mesh, make_mesh
from kgwas_tpu_torch.parallel.shard import ITEM_10B
from torch_threads import few_torch_threads  # noqa: F401,E402

KG = dict(n_snp=300, n_gene=60, n_go=30, snp_dim=20, gene_dim=32, go_dim=16,
          seed=7)
KG_2 = dict(KG, n_go=600)       # every merged group splits over 2 ranks
KG_4 = dict(KG, n_go=1600)
KG_TP = dict(KG, gene_dim=1024)  # a Gene table the 'model' axis splits
HERE = Path(__file__).resolve().parent
LR, WD = 1e-3, 5e-4


def _compile(kg, jax=False):
    if jax:
        from kgwas_tpu.graph import compile_graph as jcompile
        from kgwas_tpu.graph import make_synthetic_kg as jkg

        return jcompile(jkg(**kg), edge_pad_multiple=512,
                        node_pad_multiple=512)
    return compile_graph(make_synthetic_kg(**kg), edge_pad_multiple=512,
                         node_pad_multiple=512)


# ------------------------------------------------------- the static layouts

@pytest.mark.parametrize("n_dev,kg", [(2, KG), (4, KG_4)], ids=["2", "4"])
def test_build_device_layouts_equal_jax(n_dev, kg):
    from kgwas_tpu.graph.merged_layout import build_merged_layouts as jbml
    from kgwas_tpu.parallel.merged_shard import build_device_layouts as jbdl

    ports = build_merged_layouts(_compile(kg), tile_rows=512)
    jaxes = jbml(_compile(kg, jax=True))
    assert sorted(ports) == sorted(jaxes)
    split = 0
    for t, L in ports.items():
        if (L.n_rows_total // merged_shard.TILE) % n_dev:
            with pytest.raises(ValueError, match="do not split"):
                merged_shard.build_device_layouts(L, n_dev)
            with pytest.raises(AssertionError):
                jbdl(jaxes[t], n_dev)
            continue
        got = merged_shard.build_device_layouts(L, n_dev)
        want = jbdl(jaxes[t], n_dev)
        for f in ("n_dev", "rows_per_dev", "e_dev", "n_src_total",
                  "n_rows_total"):
            assert getattr(got, f) == getattr(want, f), (t, f)
        for f in ("src", "dst_local", "tile_starts", "tile2rel", "csc_perm",
                  "csc_ids", "csc_offsets"):
            a, b = getattr(got, f), getattr(want, f)
            assert a.dtype == b.dtype and np.array_equal(a, b), (t, f)
        split += 1
    assert split >= 3


def test_sharded_merged_eligibility_gates():
    """JAX's cases: indivisible layouts (CC and MF one tile each over 8
    ranks) fall back in both packages; a 'model' axis of 2 is refused by
    the JAX package (its kernels own the feature dim) and taken by the
    port (its 'model' axis shards only the first encoder product, summed
    before the layers); both take the same layouts without it."""
    from kgwas_tpu.parallel.merged_shard import sharded_merged_eligible
    from kgwas_tpu.parallel.mesh import make_mesh as jmake_mesh

    kg1 = dict(n_snp=100, n_gene=60, n_go=20, seed=72)
    L1 = build_merged_layouts(_compile(kg1), tile_rows=512)
    assert not merged_shard.sharded_merged_eligible(L1, Mesh(data=8))
    assert not sharded_merged_eligible(_compile(kg1, jax=True).meta(),
                                       jmake_mesh(data=8, model=1))
    kg2 = dict(n_snp=1000, n_gene=800, n_go=1800, seed=71)
    L2 = build_merged_layouts(_compile(kg2), tile_rows=512)
    meta2 = _compile(kg2, jax=True).meta()
    assert not sharded_merged_eligible(meta2, jmake_mesh(data=4, model=2))
    assert merged_shard.sharded_merged_eligible(L2, Mesh(data=4, model=2))
    assert sharded_merged_eligible(meta2, jmake_mesh(data=4, model=1))
    assert merged_shard.sharded_merged_eligible(L2, Mesh(data=4))
    assert not merged_shard.sharded_merged_eligible({}, Mesh(data=1))


# ----------------------------------------------------- two ranks over gloo

# the two-rank cases: (KG, 'data' axis size, 'model' axis size)
GLOO_CASES = {"data": (KG_2, 2, 1), "model": (KG_TP, 1, 2)}


def _rank_main(rank, world, work, threads):
    """One rank: for each of GLOO_CASES (its spec and state under
    work/<case>), the sharded forward, one step's summed gradients and 3
    Adam steps, written to work/<case>/rank{rank}.npz."""
    from kgwas_tpu_torch.parallel.mesh import init_distributed
    from kgwas_tpu_torch.parallel.shard import (ShardedRun, sharded_forward,
                                                sharded_train_step,
                                                sum_grads)
    import torch.distributed as dist

    torch.set_num_threads(threads)
    work = Path(work)
    init_distributed("gloo", f"file://{work / 'store'}", world, rank)
    for name, (kg, data, model) in GLOO_CASES.items():
        case = work / name
        spec = np.load(case / "spec.npz")
        cg, model_, layouts, x = _port_world(kg, torch.load(case /
                                                            "state.pt"))
        mesh = make_mesh(data=data, model=model)
        run = ShardedRun(build_merged_layouts(cg, tile_rows=512), x, mesh,
                         "cpu", cg.padded_nodes)
        y, w = torch.from_numpy(spec["y"]), torch.from_numpy(spec["w"])
        b0 = torch.from_numpy(spec["batches"][0])
        out = {"pred": sharded_forward(model_, run, layouts).numpy()}
        loss = batch_loss(run.forward(model_, layouts, training=True), b0, y,
                          w)
        (loss / mesh.size).backward()
        fill_dead_grads(model_)
        sum_grads(model_, mesh)
        out["loss"] = loss.item()
        out.update({f"grad:{k}": p.grad.numpy().copy()
                    for k, p in model_.named_parameters()})
        model_.load_state_dict(torch.load(case / "state.pt"))
        opt = build_optimizer(model_.parameters(), LR, WD)
        out["losses"] = np.array([
            sharded_train_step(model_, opt, run, layouts, torch.from_numpy(b),
                               y, w).item() for b in spec["batches"]])
        np.savez(case / f"rank{rank}.npz", **out)
    dist.destroy_process_group()


def _port_world(kg, state):
    cg = _compile(kg)
    cfg = ModelConfig(gnn_hidden_dim=128, no_relu=True)
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    model = HeteroGNN(cfg, rel_types, kg["snp_dim"], kg["gene_dim"],
                      kg["go_dim"], seed=1)
    model.load_state_dict(state)
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu",
                             cg, layer_paths(cfg))
    x = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
    return cg, model, layouts, x


def _spawn(work, world):
    """world processes of _rank_main, started (each with a share of the
    cores: the ranks' threads would otherwise contend)."""
    threads = max(1, (os.cpu_count() or 2) // (2 * world))
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "import test_torch_parallel as T; "
            "T._rank_main(int(sys.argv[3]), int(sys.argv[4]), sys.argv[5], "
            "int(sys.argv[6]))")
    return [subprocess.Popen(
        [sys.executable, "-c", code, str(HERE), str(HERE.parent), str(r),
         str(world), str(work), str(threads)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def _join(procs, work, timeout=240):
    """Each rank joined with its own timeout; every case's rank outputs."""
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return {name: [dict(np.load(work / name / f"rank{r}.npz"))
                   for r in range(len(procs))] for name in GLOO_CASES}


def _setup(work, kg, jax_params=None):
    """The spec (labels, weights, 3 seed batches) and the initial state,
    from the JAX package's initialisation when given."""
    cg = _compile(kg)
    n, n_pad = cg.num_nodes["SNP"], cg.padded_nodes["SNP"]
    rng = np.random.default_rng(5)
    y = np.zeros(n_pad, np.float32)
    w = np.zeros(n_pad, np.float32)
    y[:n] = rng.standard_normal(n) ** 2
    w[:n] = rng.random(n) + 0.5
    batches = np.stack([rng.choice(n, 64, replace=False) for _ in range(3)])
    np.savez(work / "spec.npz", y=y, w=w, batches=batches)
    if jax_params is not None:
        from kgwas_tpu_torch.engine.checkpoint import params_from_jax

        state = params_from_jax(jax_params)
    else:
        cfg = ModelConfig(gnn_hidden_dim=128, no_relu=True)
        rel_types = {k: (r.src_type, r.rel, r.dst_type)
                     for k, r in cg.relations.items()}
        state = HeteroGNN(cfg, rel_types, kg["snp_dim"], kg["gene_dim"],
                          kg["go_dim"], seed=3).state_dict()
    torch.save(state, work / "state.pt")
    return y, w, batches


def _single(kg, work, y, w, batches):
    """The single-process port: predictions, step-1 loss and gradients, 3
    Adam steps' losses."""
    state = torch.load(work / "state.pt")
    _, model, layouts, x = _port_world(kg, state)
    y, w = torch.from_numpy(y), torch.from_numpy(w)
    with torch.inference_mode():
        pred = model(x, layouts)[:, 0].numpy()
    loss = batch_loss(model(x, layouts, training=True),
                      torch.from_numpy(batches[0]), y, w)
    loss.backward()
    fill_dead_grads(model)
    grads = {k: p.grad.numpy().copy() for k, p in model.named_parameters()}
    model.load_state_dict(state)
    opt = build_optimizer(model.parameters(), LR, WD)
    losses = [train_step(model, opt, x, layouts, torch.from_numpy(b), y,
                         w).item() for b in batches]
    return pred, loss.item(), grads, np.array(losses)


def _assert_like_single(ranks, single):
    from test_torch_train import _assert_grad

    pred, loss, grads, losses = single
    for k in ranks[0]:
        assert np.array_equal(ranks[0][k], ranks[1][k]), k  # replicated
    got = ranks[0]
    np.testing.assert_allclose(got["pred"], pred, rtol=1e-5, atol=1e-5)
    assert float(got["loss"]) == pytest.approx(loss, rel=1e-5)
    top = max(np.abs(v).max() for v in grads.values())
    for k, v in grads.items():
        _assert_grad(got[f"grad:{k}"], v, k, floor=1e-8 * top)
    np.testing.assert_allclose(got["losses"], losses, rtol=1e-5)


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    """The two ranks over gloo, started once for both cases, and the JAX
    package's 3 steps on its 2-device mesh (the shard_map'd merged
    kernels, interpret mode) from the 'data' case's parameters, run here
    while the ranks run: (rank outputs by case, the single-process inputs
    by case, the JAX losses)."""
    import jax
    import jax.numpy as jnp
    from kgwas_tpu.config import ModelConfig as JaxModelConfig
    from kgwas_tpu.engine.loop import build_optimizer as jbuild_optimizer
    from kgwas_tpu.models.hetero_gnn import init_hetero_gnn
    from kgwas_tpu.parallel.mesh import make_mesh as jmake_mesh
    from kgwas_tpu.parallel.shard import (_select_kernel_path,
                                          make_sharded_train_step,
                                          node_vector_sharding, replicated,
                                          shard_graph_arrays)

    work = tmp_path_factory.mktemp("gloo")
    cg_j = _compile(KG_2, jax=True)
    meta = cg_j.meta()
    jcfg = JaxModelConfig(gnn_hidden_dim=128, gnn_num_layers=2, no_relu=True,
                          use_pallas=True)
    params = jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
        jax.random.PRNGKey(0), jcfg, meta, KG["snp_dim"], KG["gene_dim"],
        KG["go_dim"]))
    inputs = {}
    for name, (kg, _, _) in GLOO_CASES.items():
        (work / name).mkdir()
        inputs[name] = _setup(work / name, kg,
                              params if name == "data" else None)
    procs = _spawn(work, 2)
    try:
        mesh = jmake_mesh(data=2, model=1)
        assert _select_kernel_path(jcfg, meta, mesh,
                                   training=True)[1] is not None
        y, w, batches = inputs["data"]
        yj, wj = jnp.asarray(y), jnp.asarray(w)
        step = make_sharded_train_step(jcfg, meta, jbuild_optimizer(LR, WD),
                                       mesh, cg_j.arrays())
        arrays = shard_graph_arrays(mesh, cg_j.arrays())
        p, s = params, jbuild_optimizer(LR, WD).init(params)
        jax_losses = []
        for b in batches:
            p, s, l_ = step(p, s, arrays,
                            jax.device_put(jnp.asarray(b, jnp.int32),
                                           replicated(mesh)),
                            jax.device_put(yj, node_vector_sharding(mesh)),
                            jax.device_put(wj, node_vector_sharding(mesh)))
            jax_losses.append(float(l_))
    finally:
        ranks = _join(procs, work)
    return ranks, inputs, work, jax_losses


def test_two_rank_gloo_step_matches_single_and_jax(gloo_world):
    ranks, inputs, work, jax_losses = gloo_world
    _assert_like_single(ranks["data"],
                        _single(KG_2, work / "data", *inputs["data"]))
    # the JAX package on its 2-device mesh: the shard_map'd merged kernels
    np.testing.assert_allclose(ranks["data"][0]["losses"], jax_losses,
                               rtol=1e-4)


def test_model_axis_encoder_matches_single(gloo_world):
    ranks, inputs, work, _ = gloo_world
    _assert_like_single(ranks["model"],
                        _single(KG_TP, work / "model", *inputs["model"]))


# ------------------------------------------------------------- entry points

def _small_run(tmp_path, **kw):
    data = kt.KGWAS_Data.from_synthetic(n_snp=80, n_gene=16, n_go=8, seed=0,
                                        data_path=str(tmp_path))
    data.load_synthetic_gwas(seed=0)
    data.process_gwas_file()
    data.prepare_split()
    return kt.KGWAS(data, device="cpu", seed=0).initialize_model(
        gnn_hidden_dim=8, no_relu=True, **kw)


def test_mesh_forms_and_world_size(tmp_path):
    """In a process without a process group (world size 1), mesh 1 as an
    int, a dict and a MeshConfig trains, bitwise as mesh=1; a mesh of 2
    or 4 raises the size mismatch."""
    run = _small_run(tmp_path)
    state = {k: v.clone() for k, v in run.model.state_dict().items()}
    losses = []
    for mesh in (1, {"data": 1}, MeshConfig(), make_mesh(1)):
        run.model.load_state_dict(state)
        run.train(batch_size=16, epoch=1, lr=1e-3, mesh=mesh,
                  save_best_model=False)
        assert run.mesh.shape == {"data": 1, "model": 1}
        losses.append(np.asarray(run.epoch_losses[0]))
    for a in losses[1:]:
        assert np.array_equal(a, losses[0])
    for mesh in (2, {"data": 2, "model": 2}, MeshConfig(data_axis=4)):
        with pytest.raises(ValueError, match="world size 1"):
            run.train(batch_size=16, epoch=1, mesh=mesh)
    with pytest.raises(TypeError, match="mesh must be"):
        run.train(batch_size=16, epoch=1, mesh="2")


@pytest.mark.parametrize("kw", [{"gnn_aggr": "max"}, {"dropout": 0.1},
                                {"gnn_backbone": "SAGE"},
                                {"sigmoid_gat": True}],
                         ids=["GAT-max", "dropout", "SAGE", "sigmoid"])
def test_outside_merged_gate_raises_10b(tmp_path, kw):
    run = _small_run(tmp_path, **kw)
    with pytest.raises(NotImplementedError, match="item 10b"):
        run.train(batch_size=16, epoch=1, mesh=1)
    assert "10b" in ITEM_10B


def test_cli_mesh_under_torchrun(tmp_path):
    """python -m kgwas_tpu_torch.cli train --mesh 2 under torchrun (two
    gloo ranks with --device cpu): rank 0 writes the checkpoint and
    pred.csv, whose KGWAS_P is the single-process CLI run's (rtol 1e-4,
    atol 1e-6)."""
    from kgwas_tpu_torch.cli import main
    from kgwas_tpu_torch.utils import read_table

    argv = ["train", "--synthetic", "--device", "cpu", "--seed", "3",
            "--hidden", "16", "--epochs", "1", "--batch-size", "256"]
    single = main(argv + ["--data-path", str(tmp_path / "one")])
    env = dict(os.environ, PYTHONPATH=str(HERE.parent))
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node",
         "2", "--rdzv-endpoint", "localhost:0", "--rdzv-backend",
         "c10d", "-m", "kgwas_tpu_torch.cli", *argv, "--mesh", "2",
         "--data-path", str(tmp_path / "two")],
        capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, (proc.stdout + proc.stderr)[-3000:]
    got = read_table(str(tmp_path / "two" / "model" / "KGWAS" / "pred.csv"),
                     sep=None)
    np.testing.assert_allclose(np.asarray(got["KGWAS_P"], float),
                               np.asarray(single.kgwas_res["KGWAS_P"], float),
                               rtol=1e-4, atol=1e-6)
