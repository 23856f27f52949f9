"""The model variants of the port against the JAX package: GAT with max and
min cross-relation aggregation (the per-relation path, TPU kernels #6 and
#7) and the SAGE, GCN and SGC backbones (the merged message-passing path,
#10); both backwards run #8.

From the same JAX-initialised weights, at hidden 128 on a small KG padded
to 512 rows (what the JAX package's Pallas paths need), the port (CPU,
plain versions of its kernels) against ``apply_hetero_gnn(use_pallas=True)``
with its Pallas ops in interpret mode; a counter on each Pallas wrapper
shows which TPU kernels the JAX side reached.

  * the forward: rtol 1e-4, atol 1e-5 on the real SNP rows (float32, two
    layers of sums in another order)
  * one step's loss (rel 1e-5) and parameter gradients: rtol 2e-4, atol
    2e-5, as tests/test_pallas_kernels.py holds the JAX package's own
    Pallas paths against its XLA paths
  * ties in max and min: a node with no edge in any relation of its group
    gives 0 + b_r in every relation, and the biases start equal (at 0).
    amax and amin split the cotangent evenly among the tied relations, as
    jax.grad of jnp.max / jnp.min does; a batch holding every such SNP,
    with one positive bias shared by the relations, shows it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu.config import ModelConfig as JaxModelConfig
from kgwas_tpu.models.hetero_gnn import _aggregate, apply_hetero_gnn, init_hetero_gnn

from kgwas_tpu_torch.config import ModelConfig
from kgwas_tpu_torch.engine import params_from_jax
from kgwas_tpu_torch.graph import build_merged_layouts
from kgwas_tpu_torch.models import HeteroGNN, aggregate, device_layouts, layer_path
from kgwas_tpu_torch.ops import segment, segment_softmax

from test_torch_train import jax_step_grads, port_step_grads, step_world  # noqa: F401
from test_torch_train_layouts import reached  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401,E402

D = 128
CONFIGS = {
    "GAT-max": dict(gnn_aggr="max"),
    "GAT-min": dict(gnn_aggr="min"),
    "SAGE": dict(gnn_backbone="SAGE"),
    "GCN": dict(gnn_backbone="GCN"),
    "SGC": dict(gnn_backbone="SGC"),
}
# the TPU kernels (PERF.md table) each configuration reaches in a step
SITES = {"GAT-max": {6, 7, 8}, "GAT-min": {6, 7, 8},
         "SAGE": {8, 10}, "GCN": {8, 10}, "SGC": {8, 10}}
FWD_RTOL, FWD_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 2e-4, 2e-5


def _cfg(name, **extra):
    return JaxModelConfig(gnn_hidden_dim=D, gnn_num_layers=2, no_relu=True,
                          use_pallas=True, **CONFIGS[name], **extra)


def _params(step_world, cfg, seed=0):
    return jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
        jax.random.PRNGKey(seed), cfg, step_world[0].meta(), 20, 32, 16))


def _port(step_world, cfg, params):
    cg = step_world[1]
    rel_types = {k: (r.src_type, r.rel, r.dst_type)
                 for k, r in cg.relations.items()}
    port_cfg = ModelConfig.from_dict(cfg.to_dict())
    model = HeteroGNN(port_cfg, rel_types, 20, 32, 16, seed=1)
    model.load_state_dict(params_from_jax(params))
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu",
                             cg, layer_path(port_cfg))
    x = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
    return model, layouts, x


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_matches_jax(step_world, reached, name):  # noqa: F811
    cfg = _cfg(name)
    params = _params(step_world, cfg)
    want = np.asarray(apply_hetero_gnn(params, cfg, step_world[0].meta(),
                                       step_world[0].arrays()))
    assert set(reached) == SITES[name] - {7, 8}
    model, layouts, x = _port(step_world, cfg, params)
    before = (segment_softmax.launches, segment.csr_launches)
    with torch.inference_mode():
        got = model(x, layouts).numpy()
    # the plain versions ran: no kernel launched on the CPU
    assert (segment_softmax.launches, segment.csr_launches) == before
    n = step_world[1].num_nodes["SNP"]
    assert got.shape == want.shape and np.abs(want[:n]).max() > 0
    np.testing.assert_allclose(got[:n], want[:n], rtol=FWD_RTOL,
                               atol=FWD_ATOL)


def _isolated_snps(cg):
    rels = [r for r in cg.relations.values() if r.dst_type == "SNP"]
    n = cg.num_nodes["SNP"]
    deg = sum(np.bincount(r.dst[:r.num_edges], minlength=n)[:n] for r in rels)
    return np.flatnonzero(deg == 0)


@pytest.mark.parametrize("name,ties", [
    ("GAT-max", False), ("GAT-max", True), ("GAT-min", True), ("SAGE", False),
    ("GCN", False), ("SGC", False)])
def test_step_grads_match_jax(step_world, reached, name, ties):  # noqa: F811
    world = step_world
    cfg = _cfg(name)
    params = _params(world, cfg)
    if ties:
        # the batch holds every SNP without an edge into it, and the SNP
        # relations of each layer share one positive bias: in both layers
        # such a SNP's two relations give 0 + b, a tie in every column
        # that the ReLU after the layer passes on
        iso = _isolated_snps(world[1])
        assert len(iso) >= 2
        world = world[:4] + (np.concatenate([iso, world[4][:32]]),)
        b = np.random.default_rng(3).uniform(0.1, 0.5, D).astype(np.float32)
        for layer in params["convs"]:
            for rk, rp in layer.items():
                if rk.endswith("__SNP"):
                    rp["bias"] = b.copy()
    jl, jg = jax_step_grads(world, cfg, params)
    assert set(reached) == SITES[name]
    pl_, pg = port_step_grads(world, cfg, params)
    assert pl_ == pytest.approx(jl, rel=1e-5)
    assert sorted(pg) == sorted(jg)
    # with ties, the SNP relations' biases and weights each take half of
    # the tied rows' cotangent: all of it on one relation (torch.max(dim))
    # misses JAX's
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg=k)


@pytest.mark.parametrize("aggr", ["sum", "mean", "max", "min"])
def test_aggregate_gradient_at_ties_matches_jax(aggr):
    rng = np.random.default_rng(0)
    outs = rng.standard_normal((3, 6, 4)).astype(np.float32)
    outs[1, :3] = outs[0, :3]          # rows 0-2: relations 0 and 1 tie
    outs[2, :3] = -10.0 if aggr == "max" else 10.0
    outs[:, 3] = 0.0                   # row 3: all three tie
    g = rng.standard_normal((6, 4)).astype(np.float32)
    want, vjp = jax.vjp(lambda o: _aggregate(list(o), aggr), jnp.asarray(outs))
    (want_d,) = vjp(jnp.asarray(g))
    leaf = torch.from_numpy(outs).requires_grad_()
    got = aggregate(list(leaf), aggr)
    (got_d,) = torch.autograd.grad(got, [leaf], torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("backbone,live", [
    ("GAT", [["Gene", "SNP"], ["SNP"]]), ("SAGE", [["Gene", "SNP"], ["SNP"]]),
    ("GCN", [["Gene"], ["SNP"]]), ("SGC", [["Gene"], ["SNP"]])])
def test_live_groups_follow_what_each_layer_reads(step_world, backbone, live):
    """GAT (a_dst) and SAGE (lin_r) read the destination's own row, GCN and
    SGC only the source rows: before the last layer's SNP group, GCN and
    SGC need the Gene group alone, as the JAX jit keeps it."""
    cfg = JaxModelConfig(gnn_hidden_dim=16, gnn_num_layers=2,
                         gnn_backbone=backbone)
    model, layouts, x = _port(step_world, cfg, _params(step_world, cfg))
    got, encoded = model.live_groups(layouts)
    assert got == live and encoded == set(x)
