"""The per-relation softmax GAT under a bf16 ``stream_dtype`` or
``compute_dtype`` (TPU kernels #6 and #7 on bf16 operands), the port
against the JAX package.

* The op: ``segment_softmax_spmm_fwd_plain`` / ``_bwd_plain`` on bf16
  messages (logits float32 as under ``stream_dtype``, bf16 as under
  ``compute_dtype``), with and without a dropout multiplier, against the
  JAX function ``fused_segment_softmax_spmm`` (interpret mode) and its VJP
  on the same bf16 values widened to float32, the multiplier folded into
  the messages (the same function). The port's plain versions widen and
  compute in float32, as the Pallas body does, so the two agree to float32
  rounding: rtol 1e-5, with an absolute floor of 1e-6 of the largest value
  for d_logits, whose p_e (m_e - dot_r) cancels (jax matmul precision
  'highest').
* The model: the forward and one training step of GAT max, GAT min,
  ``edge_dim`` 4, ``dropout`` 0.1 (the step's per-relation path, without
  masks, as ``KGWAS.train`` runs it) and 2-head GAT max, at hidden 128 and
  2 layers on ``step_world``'s KG, against the JAX package's **XLA path**
  (``use_pallas=False``), jitted, on ``jnp`` arrays: the JAX package's
  Pallas #6 / #7 cannot take bf16 messages (their VMEM scratch is float32:
  ``lax.dynamic_update_slice`` raises ``TypeError``), and each one-head
  step asserts that it still raises there (2 heads never reach #6 / #7 in
  the JAX package: ``apply_gat``'s fused path takes one head, so its
  ``use_pallas=True`` step runs the XLA path). Bounds as tests/test_torch_bf16_model.py:
  rtol 1e-2, atol 1e-3 on predictions and losses; gradients at rtol 1e-2
  with a floor of 1e-3 (stream) or 2.5e-3 (compute) of the largest
  gradient. Under ``compute_dtype`` the port's segment softmax computes in
  float32 and hands float32 outputs to the layers after it, where the XLA
  path rounds its softmax weights and sums to bf16: where that gap exceeds
  the bf16 bound (``F32_REFERENCE``), the step is held against the JAX
  package's float32 gradients with a floor of 1e-2 of the largest
  (tests/test_torch_bf16_model.py's ``f32_reference``): GAT min under
  ``compute_dtype``, where one bias gradient of the XLA path lies 7.6e-3
  of the largest gradient away.
* ``KGWAS.train`` (3 steps) and ``KGWAS_P`` in [0, 1] under each option,
  for GAT max and for GAT max with 2 heads, ``edge_dim``,
  ``pheno_condition`` 'ATT' and ``remat``; ``gat_relation`` in bf16 with
  and without a dropout multiplier.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kgwas_tpu.config import ModelConfig as JaxModelConfig
from kgwas_tpu.models.hetero_gnn import apply_hetero_gnn, init_hetero_gnn
from kgwas_tpu.ops.pallas_segment import fused_segment_softmax_spmm

import kgwas_tpu_torch as kt
from kgwas_tpu_torch.engine.checkpoint import flatten_params, params_to_jax
from kgwas_tpu_torch.engine.loop import batch_loss
from kgwas_tpu_torch.graph import build_merged_layouts
from kgwas_tpu_torch.models import device_layouts, layer_paths
from kgwas_tpu_torch.ops import segment_ref, segment_softmax
from test_torch_model import _port_model
from test_torch_train import jax_step_grads, step_world  # noqa: F401
from torch_threads import few_torch_threads  # noqa: F401,E402

RTOL, ATOL = 1e-2, 1e-3
VARIANTS = {
    "GAT-max": {"gnn_aggr": "max"},
    "GAT-min": {"gnn_aggr": "min"},
    "edge_dim": {"edge_dim": 4},
    "dropout": {"dropout": 0.1},
    "heads2-max": {"gat_num_head": 2, "gnn_aggr": "max"},
}
DTYPES = {"stream": {"stream_dtype": "bfloat16"},
          "compute": {"compute_dtype": "bfloat16"}}
# (variant, option) whose step the XLA path's bf16 softmax puts beyond the
# bf16 bound of the port's float32 softmax: held against float32 gradients
F32_REFERENCE = {("GAT-min", "compute")}


# ------------------------------------------------------------------ the op

def _stream(seed=3, n_rows=512, n_src=700, d=128):
    """One relation's dst-sorted stream: rows of ~4 edges, a long row, empty
    rows and a trash row of 300 pad edges on source row 0."""
    rng = np.random.default_rng(seed)
    deg = rng.poisson(4, n_rows)
    deg[rng.choice(n_rows, 30, replace=False)] = 0
    deg[7], deg[n_rows - 1] = 200, 300
    ro = np.zeros(n_rows + 1, np.int32)
    np.cumsum(deg, out=ro[1:])
    src = rng.integers(0, n_src, ro[-1]).astype(np.int32)
    src[ro[-2]:] = 0
    xs = (rng.standard_normal((n_src, d)) * 0.3).astype(np.float32)
    logits = (rng.standard_normal(ro[-1]) * 1.5).astype(np.float32)
    mult = ((rng.random(ro[-1]) >= 0.3) / 0.7).astype(np.float32)
    g = rng.standard_normal((n_rows, d)).astype(np.float32)
    return xs, src, ro, logits, mult, g


@pytest.mark.parametrize("with_mult", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bf16_segment_softmax_op_matches_pallas(dtype, with_mult):
    xs, src, ro, logits, mult, g = _stream()
    xs_b = torch.from_numpy(xs).to(torch.bfloat16)
    lg = torch.from_numpy(logits)
    if dtype == "compute":
        lg = lg.to(torch.bfloat16)
    mu = torch.from_numpy(mult) if with_mult else None
    src_t, ro_t = torch.from_numpy(src), torch.from_numpy(ro)
    out, row_max, row_sum = segment_softmax.segment_softmax_spmm_fwd_plain(
        xs_b, src_t, lg, ro_t, mu)
    assert {out.dtype, row_max.dtype, row_sum.dtype} == {torch.float32}
    w, d_logits = segment_softmax.segment_softmax_spmm_bwd_plain(
        xs_b, src_t, lg, ro_t, row_max, row_sum, out, torch.from_numpy(g), mu)
    assert {w.dtype, d_logits.dtype} == {torch.float32}

    # the JAX function on the same values widened to float32
    xs_w = xs_b.float().numpy()
    lg_w = lg.float().numpy()
    dst = np.repeat(np.arange(len(ro) - 1), np.diff(ro)).astype(np.int32)
    m = mult if with_mult else np.ones_like(mult)

    def f(msgs, logits):
        return fused_segment_softmax_spmm(msgs * jnp.asarray(m)[:, None],
                                          logits, jnp.asarray(dst), ro,
                                          len(ro) - 1, True)

    with jax.default_matmul_precision("highest"):
        msgs = jnp.take(jnp.asarray(xs_w), jnp.asarray(src), axis=0)
        want, vjp = jax.vjp(f, msgs, jnp.asarray(lg_w))
        d_msgs, want_dl = vjp(jnp.asarray(g))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    # d_msgs_e = w_e g[row_e]: the message cotangent #8 sums per source row
    got_dm = (w[:, None] * torch.from_numpy(g)[torch.from_numpy(dst).long()])
    np.testing.assert_allclose(got_dm.numpy(), np.asarray(d_msgs), rtol=1e-5,
                               atol=1e-7)
    want_dl = np.asarray(want_dl)
    np.testing.assert_allclose(d_logits.numpy(), want_dl, rtol=1e-5,
                               atol=1e-6 * np.abs(want_dl).max())


def test_bf16_plain_versions_widen_exactly():
    """On bf16 operands the plain versions give the float32 plain versions'
    bits on the widened operands (what the card's bitwise check holds the
    kernels to)."""
    xs, src, ro, logits, mult, g = _stream(seed=4)
    xs_b = torch.from_numpy(xs).to(torch.bfloat16)
    lg_b = torch.from_numpy(logits).to(torch.bfloat16)
    src_t, ro_t, mu = (torch.from_numpy(a) for a in (src, ro, mult))
    for lg in (torch.from_numpy(logits), lg_b):
        got = segment_softmax.segment_softmax_spmm_fwd_plain(
            xs_b, src_t, lg, ro_t, mu)
        want = segment_softmax.segment_softmax_spmm_fwd_plain(
            xs_b.float(), src_t, lg.float(), ro_t, mu)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        bwd = got[1:] + (got[0], torch.from_numpy(g), mu)
        got_b = segment_softmax.segment_softmax_spmm_bwd_plain(
            xs_b, src_t, lg, ro_t, *bwd)
        want_b = segment_softmax.segment_softmax_spmm_bwd_plain(
            xs_b.float(), src_t, lg.float(), ro_t, *bwd)
        for a, b in zip(got_b, want_b):
            assert torch.equal(a, b)


# ---------------------------------------------------------------- the model

def _cfg(variant, dtype, use_pallas=False):
    return JaxModelConfig(gnn_hidden_dim=128, gnn_num_layers=2, no_relu=True,
                          use_pallas=use_pallas, **VARIANTS[variant],
                          **DTYPES[dtype])


@pytest.fixture(scope="module")
def case_runs(step_world):  # noqa: F811
    """(variant, dtype, f32) -> the case's parameters, the JAX run and the
    port's, each built once for the module: the forward and the step test
    of a case share them. The JAX run: the forward's predictions, the JAX
    engine's loss and its gradients (apply_hetero_gnn and
    jax.value_and_grad of the loss, one jitted function on jnp arrays),
    with f32 of the case's configuration in float32 (F32_REFERENCE). The
    port's: the forward's predictions and one step's loss and gradients
    (test_torch_train.port_step_grads' loss) on one model and layouts."""
    cache = {}

    def get(variant, dtype, f32=False):
        key = (variant, dtype, f32)
        if key in cache:
            return cache[key]
        cfg = _cfg(variant, dtype)
        params = jax.tree_util.tree_map(np.asarray, init_hetero_gnn(
            jax.random.PRNGKey(0), cfg, step_world[0].meta(), 20, 32, 16))
        if f32:
            cfg = dataclasses.replace(cfg, compute_dtype="float32",
                                      stream_dtype=None)
        cg_j, _, y, w, batch = step_world
        meta = cg_j.meta()
        b, yj, wj = jnp.asarray(batch), jnp.asarray(y), jnp.asarray(w)

        def loss_fn(p, arrays):
            pred = apply_hetero_gnn(p, cfg, meta, arrays, training=True)
            return jnp.mean(jnp.take(wj, b) * (jnp.take(pred[:, 0], b)
                                               - jnp.take(yj, b)) ** 2)

        def run(p, arrays):
            return (apply_hetero_gnn(p, cfg, meta, arrays),
                    jax.value_and_grad(loss_fn)(p, arrays))

        pred, (loss, grads) = jax.jit(run)(
            jax.tree_util.tree_map(jnp.asarray, params),
            jax.tree_util.tree_map(jnp.asarray, cg_j.arrays()))
        out = cache[key] = SimpleNamespace(
            cfg=cfg, params=params, pred=np.asarray(pred), loss=float(loss),
            grads=flatten_params(jax.tree_util.tree_map(np.asarray, grads)))
        if not f32:
            cg, model = _port_model(cfg, params)
            layouts = device_layouts(build_merged_layouts(cg, tile_rows=512),
                                     "cpu", cg, layer_paths(model.cfg))
            x = {t: torch.from_numpy(v) for t, v in cg.node_x.items()}
            with torch.inference_mode():
                out.port_pred = model(x, layouts)
            loss = batch_loss(model(x, layouts, training=True),
                              torch.from_numpy(batch), torch.from_numpy(y),
                              torch.from_numpy(w))
            loss.backward()
            # a group the head does not read has no gradient; JAX's is 0
            grads = {k: torch.zeros_like(p) if p.grad is None else p.grad
                     for k, p in model.named_parameters()}
            out.n_snp = cg.num_nodes["SNP"]
            out.port_loss = loss.item()
            out.port_grads = flatten_params(params_to_jax(grads))
        return out

    return get


def _pallas_raises(fn):
    with pytest.raises(TypeError, match="requires arguments to have the "
                                        "same dtypes"):
        fn()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_relations_forward_matches_jax_xla(case_runs, variant, dtype):
    case = case_runs(variant, dtype)
    n = case.n_snp
    got, want = case.port_pred, case.pred
    assert got.dtype == torch.float32
    got = got.numpy()[:n]
    assert np.abs(want[:n]).max() > 0 and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want[:n], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_bf16_relations_step_matches_jax_xla(step_world, case_runs,  # noqa: F811
                                             variant, dtype):
    case = case_runs(variant, dtype)
    if case.cfg.gat_num_head == 1:
        # the JAX package's Pallas path cannot take this step (eager, as
        # jax_step_grads runs it: under jit the same fault surfaces as an
        # AssertionError of the Pallas lowering)
        _pallas_raises(lambda: jax_step_grads(
            step_world, _cfg(variant, dtype, True), case.params))
    f32_ref = (variant, dtype) in F32_REFERENCE
    if f32_ref:
        ref = case_runs(variant, dtype, f32=True)
        floor = 1e-2
    else:
        ref = case
        floor = 2.5e-3 if dtype == "compute" else ATOL
    jl, jg = ref.loss, ref.grads
    pl_, pg = case.port_loss, case.port_grads
    assert pl_ == pytest.approx(jl, rel=RTOL, abs=ATOL)
    assert sorted(pg) == sorted(jg)
    top = max(np.abs(v).max() for v in jg.values())
    for k in jg:
        np.testing.assert_allclose(pg[k], jg[k], rtol=RTOL, atol=floor * top,
                                   err_msg=k)


TRAIN_OPTIONS = {
    "GAT-max": {"gnn_aggr": "max"},
    # the other model options on the same path, together
    "heads2-ATT-remat": {"gnn_aggr": "max", "gat_num_head": 2, "edge_dim": 4,
                         "pheno_condition": "ATT", "remat": True},
}


@pytest.mark.parametrize("options", list(TRAIN_OPTIONS))
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bf16_relations_train_gives_kgwas_p(tmp_path, dtype, options):
    """KGWAS.train (3 steps) under the option, then KGWAS_P: GAT max, and
    GAT max with 2 heads, edge_dim, pheno_condition 'ATT' and remat."""
    data = kt.KGWAS_Data.from_synthetic(n_snp=250, n_gene=50, n_go=18,
                                        seed=123, data_path=str(tmp_path))
    data.load_synthetic_gwas(seed=123)
    data.process_gwas_file()
    data.prepare_split()
    run = kt.KGWAS(data, device="cpu", seed=123)
    run.initialize_model(gnn_hidden_dim=64, no_relu=True,
                         **TRAIN_OPTIONS[options], **DTYPES[dtype])
    before = (segment_softmax.launches, segment_softmax.bf16_launches)
    table = run.train(batch_size=64, epoch=1, lr=1e-3, save_best_model=False)
    # the CPU runs the plain versions: no launch is counted
    assert (segment_softmax.launches, segment_softmax.bf16_launches) == before
    losses = np.asarray(run.epoch_losses[0])
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    p = np.asarray(table["KGWAS_P"], dtype=np.float64)
    assert np.all(np.isfinite(p)) and np.all((p >= 0) & (p <= 1))


@pytest.mark.parametrize("dropout", [False, True])
def test_gat_relation_output_is_float32_in_bf16(dropout):
    """gat_relation's softmax mode under the compute dtype: bf16 messages
    and logits in, the relation's output float32, equal to the float32
    segment softmax of the widened values plus the bias; with a dropout
    multiplier (keep), the same with it."""
    from kgwas_tpu_torch.graph import compile_graph, make_synthetic_kg
    from kgwas_tpu_torch.models.convs import GATConv, gat_relation

    cg = compile_graph(make_synthetic_kg(n_snp=200, n_gene=40, n_go=20,
                                         seed=2),
                       edge_pad_multiple=512, node_pad_multiple=512)
    layouts = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu",
                             cg, "relations")
    L = layouts["Gene"]
    rk = L.rel_keys[0]
    RL = L.relations[0]
    src_t, _, dst_t = rk.split("__")[0], None, rk.split("__")[-1]
    gen = torch.Generator().manual_seed(0)
    conv = GATConv(16, 16, 1, src_t == dst_t, gen)
    b = torch.bfloat16
    # the hidden rows in the compute dtype, as HeteroGNN.forward casts them
    h_src = torch.randn(cg.padded_nodes[src_t], 16, generator=gen).to(b)
    h_dst = torch.randn(cg.padded_nodes[dst_t], 16, generator=gen).to(b)
    keep = None
    if dropout:
        keep = ((torch.rand(RL.src.shape[0], 1, generator=gen) >= 0.3)
                .float() / 0.7)
    out = gat_relation(conv, h_src, h_dst, RL, 0.2, 1.0, "softmax", keep,
                       cdt=b)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()
    xs = h_src @ conv.lin_src.weight.to(b).T
    xd = xs if conv.lin_dst is None else h_dst @ conv.lin_dst.weight.to(b).T
    a_src = (xs * conv.att_src[0, 0].to(b)).sum(-1)
    a_dst = (xd * conv.att_dst[0, 0].to(b)).sum(-1)
    logits = segment_ref.leaky_relu(a_src[RL.src.long()]
                                    + a_dst[RL.dst.long()], 0.2)
    want = segment_softmax.segment_softmax_spmm_fwd_plain(
        xs.float(), RL.src, logits.float(), RL.row_offsets,
        None if keep is None else keep[:, 0].contiguous())[0]
    torch.testing.assert_close(out, want + conv.bias.to(b), rtol=0, atol=0)
