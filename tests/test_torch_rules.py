"""Rules of the port.

* No module of ``kgwas_tpu_torch/`` and not ``chip_smoke.py`` imports jax,
  jaxlib, optax, orbax, pandas, sklearn or kgwas_tpu. This reads the source
  (an AST scan): the test interpreter may preload jax at start-up, so
  ``sys.modules`` proves nothing.
* ``KGWAS(data)`` with no device raises when CUDA is absent.
* A CPU tensor runs the plain version of each kernel wrapper and launches
  nothing, in the forward and in the backward.
* Options still unported raise NotImplementedError
  naming their ROADMAP item; the model variants of item 3 run, on the CPU here, and persist the
  JAX package's ``config``; ``initialize_model`` takes the JAX method's
  arguments: the TPU
  execution knobs are accepted and leave the same ``config`` as the JAX
  package's, and a name that is no ``ModelConfig`` field raises TypeError.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import kgwas_tpu_torch
from kgwas_tpu_torch import KGWAS, KGWAS_Data
from kgwas_tpu_torch.graph import build_merged_layouts, compile_graph, make_synthetic_kg
from kgwas_tpu_torch.models import device_layouts
from kgwas_tpu_torch.ops import build, gat_layer, segment, segment_softmax
from torch_threads import few_torch_threads  # noqa: F401,E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "optax", "orbax", "pandas", "sklearn", "kgwas_tpu"}


def _port_sources():
    files = sorted((ROOT / "kgwas_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    return files


def _imported_top_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", None))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


def test_port_imports_no_jax_pandas_sklearn_or_jax_package():
    files = _port_sources()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = {str(f.relative_to(ROOT)): sorted(_imported_top_names(f) & BANNED)
           for f in files}
    assert {k: v for k, v in bad.items() if v} == {}


def test_scan_covers_every_module_of_the_package():
    scanned = {str(f.relative_to(ROOT)) for f in _port_sources()}
    for mod in ("bench_lib.py", "engine/profiling.py", "interpret/__init__.py",
                "interpret/attention.py", "interpret/network.py",
                "stats/labels.py", "utils.py", "cohort/ukbb.py",
                "engine/resilience.py", "engine/watchdog.py",
                "engine/streamed.py", "ops/streaming.py",
                "scripts/loci.py", "scripts/run_calibration.py",
                "scripts/run_sweep.py", "scripts/summarize_calibration.py",
                "scripts/summarize_subsample.py", "demo/kgwas_101.py",
                "demo/kgwas_simulation.py", "demo/kgwas_subsampling.py",
                "demo/disease_critical_network.py", "demo/run_magma.py"):
        assert f"kgwas_tpu_torch/{mod}" in scanned, mod


def test_scan_catches_a_banned_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\nfrom jax import numpy\nimport kgwas_tpu.graph\n")
    assert _imported_top_names(f) & BANNED == {"jax", "kgwas_tpu"}


# torch's sampling functions, which draw from the global RNG unless given a
# generator, and numpy's legacy global-state functions
TORCH_SAMPLERS = {"rand", "randn", "randint", "randperm", "bernoulli",
                  "multinomial", "normal", "rand_like", "randn_like",
                  "randint_like"}
NUMPY_GLOBAL = {"rand", "randn", "randint", "random", "choice", "seed",
                "shuffle", "permutation", "normal", "uniform", "binomial",
                "poisson"}


def _global_rng_calls(path):
    """Lines that draw from a global RNG: torch.<sampler>(...) without a
    generator keyword, or np.random.<function>(...) of numpy's legacy
    global state (default_rng and Generator are explicit)."""
    bad = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)):
            continue
        f, owner = node.func, node.func.value
        if (f.attr in TORCH_SAMPLERS and isinstance(owner, ast.Name)
                and owner.id == "torch"
                and not any(k.arg == "generator" for k in node.keywords)):
            bad.append(node.lineno)
        elif (f.attr in NUMPY_GLOBAL and isinstance(owner, ast.Attribute)
              and owner.attr == "random" and isinstance(owner.value, ast.Name)
              and owner.value.id in ("np", "numpy")):
            bad.append(node.lineno)
    return bad


def test_port_draws_from_explicit_generators_only():
    """Every random draw of the package and of chip_smoke.py names its
    generator (a torch.Generator, or a numpy Generator from default_rng):
    a seed gives the same draws whatever ran before."""
    bad = {str(f.relative_to(ROOT)): _global_rng_calls(f)
           for f in _port_sources()}
    assert {k: v for k, v in bad.items() if v} == {}


def test_rng_scan_catches_global_draws(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import numpy as np, torch\n"
                 "a = torch.randn(3)\n"
                 "b = torch.rand(3, generator=g)\n"
                 "c = np.random.rand(2)\n"
                 "d = np.random.default_rng(0).random(2)\n")
    assert _global_rng_calls(f) == [2, 4]


def test_package_exports():
    assert kgwas_tpu_torch.KGWAS is KGWAS
    assert kgwas_tpu_torch.KGWAS_Data is KGWAS_Data


def test_kgwas_without_device_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = KGWAS_Data.from_synthetic(n_snp=50, n_gene=10, n_go=5, seed=0,
                                     data_path=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        KGWAS(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        KGWAS(data, device="cuda")
    assert KGWAS(data, device="cpu").device.type == "cpu"


def test_cpu_tensor_routes_to_plain_version(monkeypatch):
    def no_kernel(name):
        raise AssertionError("a CPU tensor must not reach the CUDA kernel")

    monkeypatch.setattr(build, "library", no_kernel)
    rng = np.random.default_rng(0)
    n, d = 8, 16
    xs = torch.from_numpy(rng.standard_normal((2 * n, d)).astype(np.float32))
    src = torch.from_numpy(rng.integers(0, 2 * n, 24).astype(np.int32))
    ro = torch.tensor([0, 3, 3, 5, 8, 10, 12, 12, 14,
                       16, 17, 18, 20, 20, 22, 23, 24], dtype=torch.int32)
    att = torch.from_numpy(rng.standard_normal((2, d)).astype(np.float32))
    a_dst = torch.from_numpy(rng.standard_normal(2 * n).astype(np.float32))
    before = gat_layer.launches
    got = gat_layer.merged_gat_forward(xs, src, ro, att, a_dst, n, fold=2)
    want = gat_layer.merged_gat_forward_plain(xs, src, ro, att, a_dst, n,
                                              fold=2)
    assert gat_layer.launches == before
    for g_, w_ in zip(got, want):
        assert torch.equal(g_, w_)
    assert got[0].shape == (n, d) and got[1].shape == (2 * n,)
    # empty rows: out 0, row_max NEG_BIG, row_sum 0
    assert got[1][1].item() == gat_layer.NEG_BIG and got[2][1].item() == 0


def test_cpu_backward_routes_to_plain_versions(monkeypatch):
    def no_kernel(name):
        raise AssertionError("a CPU tensor must not reach a CUDA kernel")

    monkeypatch.setattr(build, "library", no_kernel)
    g = make_synthetic_kg(n_snp=60, n_gene=12, n_go=6, seed=0)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    L = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu")["Gene"]
    R = len(L.rel_keys)
    rng = np.random.default_rng(0)
    leaves = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
              .requires_grad_()
              for s in ((L.src_base[-1], 8), (R, 8),
                        (L.row_offsets.shape[0] - 1,))]
    before = (gat_layer.launches, gat_layer.bwd_launches, segment.launches)
    out = gat_layer.MergedGATLayer.apply(*leaves, L, R, "softmax", 0.2, 1.0)
    out.square().sum().backward()
    assert (gat_layer.launches, gat_layer.bwd_launches,
            segment.launches) == before
    assert all(t.grad is not None and t.grad.abs().sum() > 0 for t in leaves)


@pytest.mark.parametrize("kernel", ["segment_softmax_spmm", "csr_segment_sum",
                                    "csc_segment_sum_without_logits"])
def test_cpu_tensors_route_variant_kernels_to_plain(monkeypatch, kernel):
    def no_kernel(name):
        raise AssertionError("a CPU tensor must not reach a CUDA kernel")

    monkeypatch.setattr(build, "library", no_kernel)
    g = make_synthetic_kg(n_snp=60, n_gene=12, n_go=6, seed=0)
    cg = compile_graph(g, edge_pad_multiple=512, node_pad_multiple=512)
    L = device_layouts(build_merged_layouts(cg, tile_rows=512), "cpu", cg,
                       "relations")["Gene"]
    RL = L.relations[0]
    rng = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.asarray(a, dtype=np.float32))  # noqa: E731
    xs = t(rng.standard_normal((RL.src_base[-1], 8))).requires_grad_()
    before = (segment_softmax.launches, segment_softmax.bwd_launches,
              segment.launches, segment.csr_launches)
    if kernel == "segment_softmax_spmm":
        logits = t(rng.standard_normal(RL.src.shape[0])).requires_grad_()
        out = segment_softmax.SegmentSoftmaxSpmm.apply(xs, logits, RL)
        leaves = [xs, logits]
    elif kernel == "csr_segment_sum":
        w = t(rng.random(RL.src.shape[0]))
        out = segment.CSRSegmentSum.apply(xs, w, RL)
        leaves = [xs]
    else:
        g_ = t(rng.standard_normal((RL.n_rows_per_rel, 8))).requires_grad_()
        out, d_att = segment.csc_segment_sum(g_, None, None, xs, None, RL)
        assert d_att is None
        leaves = [g_]
    out.square().sum().backward()
    assert (segment_softmax.launches, segment_softmax.bwd_launches,
            segment.launches, segment.csr_launches) == before
    assert all(v.grad is not None and v.grad.abs().sum() > 0 for v in leaves)


def test_train_options_of_later_items_raise(tmp_path):
    data = KGWAS_Data.from_synthetic(n_snp=50, n_gene=10, n_go=5, seed=0,
                                     data_path=str(tmp_path))
    data.load_synthetic_gwas(seed=0)
    data.process_gwas_file()
    data.prepare_split()
    run = KGWAS(data, device="cpu").initialize_model(gnn_hidden_dim=8)
    # profile_dir and metrics_log are ported (tests/test_torch_profiling.py),
    # the long-run options of item 8 too (tests/test_torch_long_runs.py),
    # and mesh (item 10: tests/test_torch_parallel.py): in a process without
    # a 2- or 4-rank process group those meshes do not match the world size
    for kw in ({"mesh": 2}, {"mesh": {"data": 4}}):
        with pytest.raises(ValueError, match="does not match the world "
                                             "size 1"):
            run.train(batch_size=8, epoch=1, **kw)
    # a mesh of one rank trains
    run.train(batch_size=8, epoch=1, mesh=1, save_best_model=False)
    assert run.mesh.size == 1 and np.all(np.isfinite(run.epoch_losses[0]))


def test_unported_options_raise(tmp_path):
    """The bf16 dtypes of item 7 all run now: a bf16 compute or stream dtype
    on the per-relation softmax GAT (GAT max / min, edge_dim, dropout in
    training: kernels #6 and #7) initialises like the rest, each option
    kept in model_cfg and out of the persisted config (their computation:
    tests/test_torch_bf16_model.py, tests/test_torch_bf16_relations.py).
    The model variants (item 3) run (test_lifted_variant_options_run), and
    so do host-streamed features (tests/test_torch_streaming.py); mesh
    (item 10): test_train_options_of_later_items_raise. An unknown dtype
    name still raises."""
    data = KGWAS_Data.from_synthetic(n_snp=50, n_gene=10, n_go=5, seed=0,
                                     data_path=str(tmp_path))
    run = KGWAS(data, device="cpu")
    for kw in ({"compute_dtype": "bfloat16", "gnn_aggr": "max"},
               {"stream_dtype": "bfloat16", "edge_dim": 4},
               {"compute_dtype": "bfloat16", "dropout": 0.1},
               {"stream_dtype": "bfloat16", "gnn_aggr": "min"}):
        run.initialize_model(gnn_hidden_dim=16, **kw)
        for k, v in kw.items():
            assert getattr(run.model_cfg, k) == v
        assert not {"compute_dtype", "stream_dtype"} & set(run.config)
        assert {k: v for k, v in kw.items() if "dtype" not in k}.items() <= \
            run.config.items()
    for kw in ({"compute_dtype": "bfloat16"}, {"stream_dtype": "bfloat16"},
               {"stream_dtype": "bfloat16", "stream_f32_logits": True},
               {"param_dtype": "bfloat16", "gnn_aggr": "max"},
               {"compute_dtype": "bfloat16", "sigmoid_gat": True,
                "gnn_aggr": "max"}):
        run.initialize_model(gnn_hidden_dim=16, **kw)
        for k, v in kw.items():
            assert getattr(run.model_cfg, k) == v
        assert not set(kw) & {"param_dtype", "compute_dtype", "stream_dtype",
                              "stream_f32_logits"} & set(run.config)
        want = "bfloat16" if "param_dtype" in kw else "float32"
        assert {str(p.dtype) for p in run.model.parameters()} == {
            f"torch.{want}"}
    with pytest.raises(ValueError, match="compute_dtype"):
        run.initialize_model(gnn_hidden_dim=16, compute_dtype="float16")


LIFTED = {
    "heads2": dict(gat_num_head=2),
    "heads2-max": dict(gat_num_head=2, gnn_aggr="max"),
    "sigmoid-min": dict(sigmoid_gat=True, gnn_aggr="min"),
    "SAGE-max": dict(gnn_backbone="SAGE", gnn_aggr="max"),
    "GCN-min": dict(gnn_backbone="GCN", gnn_aggr="min"),
    "SGC-max": dict(gnn_backbone="SGC", gnn_aggr="max"),
    "dropout": dict(dropout=0.1),
    "edge_dim-ATT": dict(edge_dim=4, pheno_condition="ATT"),
    "MSG-remat": dict(edge_dim=2, pheno_condition="MSG", remat=True),
}


@pytest.mark.parametrize("name", list(LIFTED))
def test_lifted_variant_options_run(tmp_path, name):
    """Each option of ROADMAP Queue 1 item 3 now runs through the entry
    points (train, predict_all, the interpretation) with the config the
    JAX package persists (remat is not persisted, as there)."""
    from kgwas_tpu import KGWAS as JaxKGWAS
    from kgwas_tpu import KGWAS_Data as JaxData

    kw = dict(gnn_hidden_dim=8, no_relu=True, **LIFTED[name])
    data = KGWAS_Data.from_synthetic(n_snp=80, n_gene=16, n_go=8, seed=0,
                                     data_path=str(tmp_path / "port"))
    data.load_synthetic_gwas(seed=0)
    data.process_gwas_file()
    data.prepare_split()
    run = KGWAS(data, device="cpu").initialize_model(**kw)
    jrun = JaxKGWAS(JaxData.from_synthetic(
        n_snp=80, n_gene=16, n_go=8, seed=0,
        data_path=str(tmp_path / "jax")))
    jrun.initialize_model(**kw)
    assert run.config == jrun.config
    assert run.model_cfg.remat == kw.get("remat", False)
    run.train(batch_size=16, epoch=1, lr=1e-3, save_best_model=False)
    assert len(run.epoch_losses[0]) > 0
    assert np.isfinite(run.epoch_losses[0]).all()
    pred = run.predict_all()
    assert pred.shape == (80,) and np.isfinite(pred).all()
    nw, _, _ = run.get_disease_critical_network(variant_threshold=0.5)
    gat = kw.get("gnn_backbone", "GAT") == "GAT"
    assert (len(nw["weight"]) > 0) == gat


def test_tpu_knobs_are_accepted_and_not_persisted(tmp_path):
    """The JAX package's execution knobs (and remat, the dtypes and
    stream_features at their defaults) are accepted; config holds the
    model-semantic keys only, as the JAX package's does."""
    from kgwas_tpu import KGWAS as JaxKGWAS
    from kgwas_tpu import KGWAS_Data as JaxData

    kw = dict(gnn_hidden_dim=16, gnn_aggr="mean", temperature=0.5,
              use_pallas=False, rel_fold=False, matmul_precision="default",
              pallas_mode="relation", remat=False, compute_dtype="float32",
              stream_dtype=None, param_dtype="float32", stream_features=[])
    data = KGWAS_Data.from_synthetic(n_snp=50, n_gene=10, n_go=5, seed=0,
                                     data_path=str(tmp_path / "port"))
    run = KGWAS(data, device="cpu").initialize_model(**kw)
    jdata = JaxData.from_synthetic(n_snp=50, n_gene=10, n_go=5, seed=0,
                                   data_path=str(tmp_path / "jax"))
    jrun = JaxKGWAS(jdata)
    jrun.initialize_model(**kw)
    assert run.config == jrun.config
    assert run.model_cfg.temperature == 0.5


def test_unknown_model_option_raises_type_error(tmp_path):
    data = KGWAS_Data.from_synthetic(n_snp=50, n_gene=10, n_go=5, seed=0,
                                     data_path=str(tmp_path))
    run = KGWAS(data, device="cpu")
    with pytest.raises(TypeError, match="unknown model options"):
        run.initialize_model(gnn_hidden_dim=16, no_such_option=1)
