"""KGWAS: the training and serving engine (user API) of the port.

Counterpart of ``kgwas_tpu/kgwas.py``: ``initialize_model``, ``train``,
``load_pretrained``, ``load_pretrained_torch``, ``predict_all``,
``run_magma`` and ``get_disease_critical_network``, with the long-run
options of ``train`` (``checkpoint_every`` / ``resume``, ``max_restarts``,
``heartbeat_path``), training over a device mesh (``train(mesh=...)``,
parallel/) and host-streamed feature tables
(``initialize_model(stream_features=...)``). It runs
on CUDA unless the caller passes ``device="cpu"``; with no card and no
explicit device it raises. The KGWAS_P tail is
``stats.calibration.finalize_predictions(data.lr_uni, pred[data.all_ids])``.
"""
from __future__ import annotations

import copy
import os
import shutil
from typing import Optional

import numpy as np
import torch

from .config import ModelConfig
from .engine.checkpoint import (host_train_state, latest_train_state,
                                load_model, load_pretrained_torch,
                                make_async_checkpointer, params_from_jax,
                                restore_train_state, save_model,
                                save_train_state_async)
from .engine.loop import (TrainScan, epoch_batches, forward,
                          forward_streamed, train_step)
from .engine.optim import build_optimizer
from .engine.profiling import (ThroughputMeter, profile_trace, span,
                               span_seconds, span_totals)
from .engine.streamed import strip_streamed_features, train_step_streamed
from .graph.merged_layout import build_merged_layouts, max_edges_setting
from .models.hetero_gnn import (HeteroGNN, check_supported, device_layouts,
                                 layer_paths)
from .stats.calibration import finalize_predictions
from .utils import compute_metrics, print_sys, read_table, write_table

TILE_ROWS = 512


def merged_layouts(cg) -> dict:
    """The compiled graph's merged layouts (build_merged_layouts with
    TILE_ROWS), built at the first call under each KGWAS_MERGED_MAX_EDGES
    setting and kept on the graph: a compiled graph never changes, so the
    models initialised on it under one setting share them, and a model
    initialised under another gets that setting's split."""
    spec = max_edges_setting()
    cached = getattr(cg, "_merged_layouts", None)
    if cached is None:
        cached = cg._merged_layouts = {}
    if spec not in cached:
        with span("kgwas.layouts.merged"):
            cached[spec] = build_merged_layouts(cg, tile_rows=TILE_ROWS,
                                                max_edges=spec)
    return cached[spec]


_SEMANTIC_KEYS = ("negative_slope", "dropout", "sigmoid_gat", "temperature",
                  "out_channels", "edge_dim", "pheno_condition")
# the JAX package's execution knobs (kgwas_tpu/config.py ModelConfig): how
# the TPU runs the model, not what it computes. Accepted and ignored, and
# not persisted, as the JAX package persists only the model-semantic keys
_TPU_KNOBS = ("use_pallas", "pallas_mode", "rel_fold", "matmul_precision",
              "gather_chunk_rows", "bwd_window_edges", "pad_fragments",
              "layout_operands")
# the dtype options (config.py): model options that are not persisted, as
# the JAX package persists only the model-semantic keys
_DTYPE_KEYS = ("param_dtype", "compute_dtype", "stream_dtype",
               "stream_f32_logits")


def resolve_device(device) -> torch.device:
    """CUDA unless the caller names another device; never a silent CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is absent")
    return device


class KGWAS:
    def __init__(
        self,
        data,
        weight_bias_track: bool = False,
        device: Optional[str] = None,
        proj_name: str = "KGWAS",
        exp_name: str = "KGWAS",
        seed: int = 42,
    ):
        self.seed = seed
        self.data = data
        self.data_path = data.data_path
        self.exp_name = exp_name
        self.device = resolve_device(device)
        self._graph = None
        self.stream_features = []

        if weight_bias_track:
            import wandb

            wandb.init(project=proj_name, name=exp_name)
            self.wandb = wandb
        else:
            self.wandb = False

    # ------------------------------------------------------------------ model

    @span("kgwas.model.init")
    def initialize_model(
        self,
        gnn_num_layers: int = 2,
        gnn_hidden_dim: int = 128,
        gnn_backbone: str = "GAT",
        gnn_aggr: str = "sum",
        gat_num_head: int = 1,
        no_relu: bool = False,
        stream_features: Optional[list] = None,
        **kwargs,
    ):
        """Defaults mirror the reference's, the signature the JAX package's.
        Served: GAT with any number of heads and gnn_aggr sum, mean, max or
        min, sigmoid_gat, dropout, edge_dim and pheno_condition; SAGE, GCN
        and SGC with sum, mean, max or min; remat. stream_features: node
        types whose feature tables stay on the host and stream to the card
        in column chunks twice a step (engine/streamed.py); not persisted,
        as in the JAX package. kwargs: the other model-semantic config keys
        (negative_slope, temperature, sigmoid_gat, out_channels, dropout,
        edge_dim, pheno_condition), persisted in config as the JAX package
        persists them; remat and the dtype options (param_dtype,
        compute_dtype, stream_dtype, stream_f32_logits: config.py; not
        persisted); the JAX package's TPU execution knobs (_TPU_KNOBS),
        ignored."""
        unknown = (set(kwargs) - set(_SEMANTIC_KEYS) - set(_TPU_KNOBS)
                   - set(_DTYPE_KEYS) - {"remat"})
        if unknown:
            raise TypeError(f"unknown model options {sorted(unknown)}")
        remat = bool(kwargs.pop("remat", False))
        dtypes = {k: kwargs.pop(k) for k in _DTYPE_KEYS if k in kwargs}
        self.stream_features = list(stream_features or [])
        for k in _TPU_KNOBS:
            kwargs.pop(k, None)
        self.config = {
            "gnn_num_layers": gnn_num_layers,
            "gnn_hidden_dim": gnn_hidden_dim,
            "gnn_backbone": gnn_backbone,
            "gnn_aggr": gnn_aggr,
            "gat_num_head": gat_num_head,
            "no_relu": no_relu,
            **kwargs,
        }
        self.model_cfg = ModelConfig.from_dict({**self.config,
                                                "remat": remat, **dtypes})
        check_supported(self.model_cfg)
        cg = self.data.compile()
        self.layouts = merged_layouts(cg)
        rel_types = {k: (r.src_type, r.rel, r.dst_type)
                     for k, r in cg.relations.items()}
        self.model = HeteroGNN(
            self.model_cfg, rel_types, self.data.snp_init_dim_size,
            self.data.gene_init_dim_size, self.data.go_init_dim_size,
            seed=self.seed,
        ).to(self.device)
        self._graph = None   # the device layouts follow the layer path
        return self

    def load_pretrained(self, path: str):
        """Load a checkpoint in the JAX package's format (config.pkl +
        model.npz, and pred.csv when present)."""
        params, config = load_model(path)
        self.initialize_model(**config)
        self.config = config
        self.model.load_state_dict(params_from_jax(params))
        pred_path = os.path.join(path, "pred.csv")
        if os.path.exists(pred_path):
            self.kgwas_res = read_table(pred_path, sep=None)
        self.save_name = path.rstrip("/").split("/")[-1]
        return self

    def load_pretrained_torch(self, path: str):
        """Load a reference PyTorch checkpoint directory (model.pt +
        config.pkl)."""
        import pickle

        with open(os.path.join(path, "config.pkl"), "rb") as f:
            config = pickle.load(f)
        self.initialize_model(**config)
        self.config = config
        self.model.load_state_dict(load_pretrained_torch(path))
        return self

    # ------------------------------------------------------------ device state

    def _resolve_mesh(self, mesh):
        """mesh: None (single device), an int (that many ranks on the
        'data' axis), a dict of axis sizes ({'data': 2, 'model': 1}), a
        config.MeshConfig or a parallel.mesh.Mesh. The sizes must match
        the world size of the process group (parallel/mesh.make_mesh)."""
        if mesh is None:
            return None
        from .config import MeshConfig
        from .parallel.mesh import Mesh, make_mesh

        if isinstance(mesh, Mesh):
            return mesh
        if isinstance(mesh, MeshConfig):
            return make_mesh(mesh.data_axis, mesh.model_axis)
        if isinstance(mesh, int):
            return make_mesh(data=mesh, model=1)
        if isinstance(mesh, dict):
            return make_mesh(data=mesh.get("data", 1),
                             model=mesh.get("model", 1))
        raise TypeError(f"mesh must be None, int, dict, MeshConfig or Mesh, "
                        f"got {mesh!r}")

    def _live_layouts(self):
        """The merged layouts of the destination groups the model's
        forward runs (HeteroGNN.live_groups), on every layer path: the
        ones a mesh splits."""
        live = set().union(*self.model.live_groups(self.layouts)[0])
        return {t: L for t, L in self.layouts.items() if t in live}

    def _sharded_run(self, mesh, cg, x):
        """The sharded step's per-rank state for this mesh (built once per
        model and mesh, and again after a restart drops the graph): the
        streamed x mesh composition passes the streamed types' host rows
        (the JAX package's _device_state)."""
        from .parallel.shard import ShardedRun

        cached = getattr(self, "_shard", None)
        if cached is None or cached[0] is not mesh or cached[1] is not x:
            self._shard = (mesh, x, ShardedRun(
                self._live_layouts(), x, mesh, self.device, cg.padded_nodes,
                self._x_host, cg))
        return self._shard[2]

    def _device_state(self):
        """Node features and merged streams on the device, with the degree
        norms (SAGE, GCN, SGC with sum or mean) or the per-relation streams
        (max and min, GAT with edge_dim, and GAT training with dropout)
        when the layer paths of the model's forwards need them; built once
        per model (a restart drops it, and it is built again). The
        streamed types' tables stay on the host (``_x_host``, their real
        rows) with [N_pad, 1] placeholders on the device."""
        if self._graph is None:
            cg = self.data.compile()
            with span("kgwas.layouts.device"):
                streamed = self.stream_features
                self._x_host = {t: cg.node_x[t][: cg.num_nodes[t]]
                                for t in streamed}
                x = {t: (None if t in streamed else torch.from_numpy(
                         np.ascontiguousarray(v)).to(self.device))
                     for t, v in cg.node_x.items()}
                x = strip_streamed_features(x, streamed, cg.padded_nodes,
                                            self.device)
                self._graph = (cg, x, device_layouts(
                    self.layouts, self.device, cg,
                    layer_paths(self.model_cfg)))
        return self._graph

    def _forward(self, cg, x, layouts):
        """Full-graph predictions [N_snp_pad] of the model's state, as
        enqueued (not synchronised)."""
        with span("kgwas.forward"):
            if self.stream_features:
                return forward_streamed(self.model, x, layouts,
                                        self._x_host, cg.padded_nodes)
            return forward(self.model, x, layouts)

    def _labels(self, cg):
        """(y_node, w_node) [N_snp_pad] on the device: the split's labels
        (0 past them) and the LDSC weights (0 for SNPs without one)."""
        n_pad = cg.padded_nodes["SNP"]
        y_node = np.zeros(n_pad, dtype=np.float32)
        y_lbl = self.data.graph.node_labels.get("SNP")
        if y_lbl is not None:
            y_node[: len(y_lbl)] = y_lbl
        w_node = np.zeros(n_pad, dtype=np.float32)
        for rs, w in getattr(self.data, "rs_id_to_ldsc_weight", {}).items():
            w_node[self.data.id2idx["SNP"][rs]] = w
        return (torch.from_numpy(y_node).to(self.device),
                torch.from_numpy(w_node).to(self.device))

    # --------------------------------------------------------------- training

    @span("kgwas.train")
    def train(
        self,
        batch_size: int = 512,
        num_workers: int = 0,
        lr: float = 1e-4,
        weight_decay: float = 5e-4,
        epoch: int = 10,
        save_best_model: bool = True,
        save_name: Optional[str] = None,
        data_to_cuda: bool = False,
        shuffle: bool = False,
        log_interval: int = 500,
        profile_dir: Optional[str] = None,
        metrics_log: Optional[str] = None,
        checkpoint_every: Optional[int] = None,
        resume: bool = False,
        max_restarts: int = 0,
        mesh=None,
        scan_steps: int = 8,
        heartbeat_path: Optional[str] = None,
    ):
        """Full-graph training with the JAX package's signature and the
        reference's defaults and quirks: one optimizer step per seed batch
        (consecutive, drop_last), LDSC-weighted MSE, torch Adam; after each
        epoch a full-graph forward scores the validation SNPs (the tail past
        a batch_size multiple dropped, the whole set when that leaves none)
        and the best state by ascending val Pearson (from -1000) is kept.
        The best state is saved in the JAX package's checkpoint format,
        scores the test SNPs and gives KGWAS_P; ``predict_all()`` then
        serves it. Returns the KGWAS_P table, also written as pred.csv
        (formatted once, then copied into the checkpoint directory;
        pred_csv_seconds: the host seconds of both, its kgwas.tail.pred_csv
        span).

        scan_steps=S > 1 runs the epoch in blocks of S steps while at least
        S remain, as the JAX package's lax.scan of S steps does, on one
        device without streamed features (under a mesh or with streamed
        features it is ignored, as there); the tail runs one step at a
        time; 0 or 1 runs every step on its own. On the card a block is
        one replay of a CUDA graph of S captured steps
        (engine/loop.TrainScan: the run's first block runs eagerly, the
        graph is captured once a run, and again after a restart), with the
        same bits as S steps one at a time; on the CPU a block's steps run
        eagerly. The side work goes once a block, in the JAX package's
        order: the fault hook for each of its steps before it runs, then
        the meter's ticks, a train state saved where the block crosses a
        multiple of checkpoint_every (named by the block's last step),
        wandb, the log_interval prints and the heartbeat.
        profile_dir: a torch.profiler trace of epoch 1's steps, written
        there (engine/profiling.profile_trace). metrics_log: one JSON line
        per epoch appended there (engine/profiling.ThroughputMeter).
        num_workers and data_to_cuda are accepted and do nothing: there
        are no sampler processes, and the graph always lives on the
        device.

        Long runs, as in the JAX package: checkpoint_every=N writes the
        model's and the optimizer's state after each block that crosses a
        multiple of N steps (every N-th step when blocks are single steps;
        engine/checkpoint.save_train_state_async: packed on the device,
        then copied and written on a background thread), as
        ``step_{count}`` under ``<data_path>/model/<save_name>/
        train_state``; resume=True restores the newest such state, then
        runs all ``epoch`` epochs from epoch 0. max_restarts=N: a failure
        that engine/resilience.py calls transient restores the host
        snapshot taken at the last epoch end (parameters, Adam state, best
        state and early-stop bookkeeping; not the shuffle generator),
        uploads the graph again and replays from that epoch, up to N
        times; other errors raise. heartbeat_path: a file touched after
        every block and around each epoch-end forward, for
        engine/watchdog.run_with_watchdog. ``_fault_hook(global_step)``,
        when set on the instance, is called before every step (fault
        injection), a block's calls all before the block runs.

        mesh: training over the ranks of a torch.distributed process group
        (one process per device, each calling train): an int (ranks on the
        'data' axis), a dict of axis sizes, a MeshConfig or a Mesh, which
        must match the world size (_resolve_mesh). Every configuration
        trains: each layer's rows and edges split over the 'data' axis in
        contiguous blocks of row tiles, which need not be equal (the merged
        GAT layer, the per-relation layers, the 'mp' layer), and feature
        tables at least 1024 wide over the 'model' axis
        (parallel/shard.py). Every rank returns the same table; rank 0
        alone writes the checkpoints, model.npz and pred.csv.

        train_seconds: the run's host seconds in three parts, read from
        its spans (engine/profiling.span): "setup" (kgwas.train.setup: the
        device state, labels, optimizer), "epochs" (kgwas.train.epoch and
        kgwas.train.eval: the steps and the epoch-end forwards) and "tail"
        (kgwas.train.tail: the best state's test forward, the metrics,
        KGWAS_P, the saves and pred.csv)."""
        from .engine.watchdog import touch_heartbeat

        since = span_totals()
        with span("kgwas.train.setup"):
            mesh = self._resolve_mesh(mesh)
            self.mesh = mesh
            writer = mesh is None or mesh.rank == 0
            if save_name is None:
                save_name = self.exp_name
            self.save_name = save_name

            cg, x, layouts = self._device_state()
            if mesh is not None:
                from .parallel.shard import (broadcast_state, sharded_forward,
                                             sharded_train_step)

                shard = self._sharded_run(mesh, cg, x)
            y_node, w_node = self._labels(cg)
            y_host = y_node.cpu().numpy()
            train_ids = np.asarray(self.data.train_mask)
            val_ids = np.asarray(self.data.val_mask)
            test_ids = np.asarray(self.data.test_mask)

            model = self.model
            model.train()
            optimizer = build_optimizer(model.parameters(), lr, weight_decay)
            self.optimizer = optimizer
            ckpt_dir = os.path.join(self.data_path, "model", save_name,
                                    "train_state")
            checkpointer = (make_async_checkpointer()
                            if checkpoint_every and writer else None)
            if resume:
                latest = latest_train_state(ckpt_dir)
                if latest:
                    print_sys(f"Resuming train state from {latest}")
                    model_state, opt_state = restore_train_state(latest)
                    model.load_state_dict(model_state)
                    optimizer.load_state_dict(opt_state)
            if mesh is not None:
                broadcast_state(model, mesh)
            best_state = copy.deepcopy(model.state_dict())
            min_val = -1000.0
            best_epoch = 0
            shuffle_rng = np.random.default_rng(self.seed)
            edges_per_step = (cg.total_real_edges()
                              * self.model_cfg.gnn_num_layers)
            meter = ThroughputMeter(edges_per_step, log_path=metrics_log)

            def step(b):
                bidx = torch.from_numpy(b).to(self.device)
                if mesh is not None:
                    return sharded_train_step(model, optimizer, shard,
                                              layouts, bidx, y_node, w_node)
                if self.stream_features:
                    return train_step_streamed(
                        model, optimizer, x, layouts, self._x_host,
                        cg.padded_nodes, bidx, y_node, w_node)
                return train_step(model, optimizer, x, layouts, bidx, y_node,
                                  w_node)

            # the JAX package's gate (kgwas_tpu/kgwas.py:381)
            scan_s = (scan_steps if mesh is None and not self.stream_features
                      and scan_steps and scan_steps > 1 else 1)

            def make_scan():
                """The run's scanned steps over the current device state."""
                if scan_s == 1:
                    return None
                return TrainScan(model, optimizer, x, layouts, y_node, w_node,
                                 scan_s, before_capture=(
                                     checkpointer.wait_until_finished
                                     if checkpointer else None))

            scan = make_scan()
            self.train_scan = scan

            def forward_all():
                if mesh is not None:
                    pred = sharded_forward(model, shard, layouts)
                else:
                    pred = self._forward(cg, x, layouts)
                with span("kgwas.to_host"):
                    return pred.cpu().numpy()

            print_sys("Start Training...")
            self.train_history = []
            self.epoch_losses = []
            self.restart_count = 0
            # host seconds of each epoch-end snapshot, and of each recovery
            # (from the failure to the restored state, without the
            # backoff): their spans' seconds
            self.snapshot_seconds = []
            self.recovery_seconds = []
            global_step = 0
            fault_hook = getattr(self, "_fault_hook", None)

            def after_block(blk_losses, start, ep):
                """The side work of the steps just run (the JAX package's
                _after_block): meter ticks, a save where the block crosses
                a multiple of checkpoint_every, wandb, the log_interval
                prints, the heartbeat."""
                nonlocal global_step
                n = blk_losses.shape[0]
                for _ in range(n):
                    meter.step()
                g0 = global_step
                global_step += n
                if checkpointer and (global_step // checkpoint_every
                                     > g0 // checkpoint_every):
                    save_train_state_async(
                        checkpointer, ckpt_dir, global_step,
                        model.state_dict(), optimizer.state_dict())
                if self.wandb:
                    for lv in blk_losses.tolist():
                        self.wandb.log({"training_loss": float(lv)})
                for k in range(n):
                    st = start + k
                    if st % log_interval == 0 and st >= log_interval:
                        print_sys(f"Epoch {ep + 1} Step {st + 1} Train "
                                  f"Loss: {float(blk_losses[k]):.4f}")
                touch_heartbeat(heartbeat_path)

            if max_restarts:
                from .engine.resilience import (RetryPolicy,
                                                is_transient_backend_error,
                                                sleep_backoff)

                policy = RetryPolicy(max_restarts=max_restarts)

                def host_snap(ep):
                    before = span_totals()
                    with span("kgwas.train.snapshot"):
                        state = host_train_state(
                            model.state_dict(),
                            optimizer.state_dict()).result()
                        best = host_train_state(best_state, {}).result()
                    self.snapshot_seconds.append(
                        span_seconds(before, "kgwas.train.snapshot"))
                    return {**state, "best": best["model"],
                            "min_val": min_val, "best_epoch": best_epoch,
                            "ep": ep, "global_step": global_step}

                snap = host_snap(0)

        ep = 0
        while ep < epoch:
            try:
                batches = epoch_batches(train_ids, batch_size, shuffle,
                                        shuffle_rng)
                self.epoch_losses = self.epoch_losses[:ep]
                meter.start_epoch()
                losses = []
                with profile_trace(profile_dir if ep == 0 else None), \
                        span("kgwas.train.epoch"):
                    step0 = 0
                    while step0 < len(batches):
                        n_blk = (scan_s if scan is not None
                                 and len(batches) - step0 >= scan_s else 1)
                        blk = batches[step0:step0 + n_blk]
                        if fault_hook is not None:
                            for k in range(n_blk):
                                fault_hook(global_step + k)
                        blk_losses = (scan(np.stack(blk)) if n_blk > 1
                                      else step(blk[0]).reshape(1))
                        losses.append(blk_losses)
                        after_block(blk_losses, step0, ep)
                        step0 += n_blk
                    self.epoch_losses.append(
                        torch.cat(losses).cpu().tolist() if losses else [])

                with span("kgwas.train.eval"):
                    # the epoch-end forward makes no step heartbeats
                    touch_heartbeat(heartbeat_path)
                    pred_all = forward_all()
                    touch_heartbeat(heartbeat_path)
                    # reference quirk: the val loader drops its tail past a
                    # batch_size multiple; with fewer val SNPs than a batch
                    # the whole set is scored
                    n_val_eval = (len(val_ids) // batch_size) * batch_size
                    val_eval_ids = (val_ids[:n_val_eval] if n_val_eval
                                    else val_ids)
                    val_metrics = compute_metrics(
                        {"pred": pred_all[val_eval_ids],
                         "truth": y_host[val_eval_ids]})
                    rec = meter.end_epoch(ep + 1, extra={
                        "loss": (self.epoch_losses[-1][-1] if losses
                                 else float("nan")),
                        **{f"val_{k}": v for k, v in val_metrics.items()},
                    })
                    print_sys(
                        f"Epoch {ep + 1}: Validation MSE: "
                        f"{val_metrics['mse']:.4f} Validation Pearson: "
                        f"{val_metrics['pearsonr']:.4f}. ({rec['steps']} "
                        f"steps, {rec['epoch_time_s']:.2f}s, "
                        f"{rec['edges_per_sec']:.3g} edge-traversals/s)")
                    self.train_history.append(rec)
                    if self.wandb:
                        for k, v in val_metrics.items():
                            self.wandb.log({"val_" + k: v})
                    if val_metrics["pearsonr"] > min_val:
                        min_val = val_metrics["pearsonr"]
                        best_state = copy.deepcopy(model.state_dict())
                        best_epoch = ep
                ep += 1
                if max_restarts:
                    snap = host_snap(ep)
            except Exception as e:  # noqa: BLE001 (classified below)
                if not (max_restarts
                        and self.restart_count < max_restarts
                        and is_transient_backend_error(e)):
                    raise
                self.restart_count += 1
                print_sys(
                    f"Transient backend failure ({type(e).__name__}: "
                    f"{str(e)[:200]}); restart "
                    f"{self.restart_count}/{max_restarts} from epoch "
                    f"{snap['ep'] + 1}")
                sleep_backoff(policy, self.restart_count)
                before = span_totals()
                with span("kgwas.train.recovery"):
                    # upload everything again, as the JAX package does
                    # after a backend restart
                    self._graph = None
                    cg, x, layouts = self._device_state()
                    if mesh is not None:
                        shard = self._sharded_run(mesh, cg, x)
                    y_node, w_node = self._labels(cg)
                    model.load_state_dict(snap["model"])
                    # the optimizer keeps host tensors it is given as they
                    # are: a copy, so the steps after it leave the snapshot
                    # intact
                    optimizer.load_state_dict(
                        copy.deepcopy(snap["optimizer"]))
                    # new features, layouts, labels and optimizer state:
                    # the graph is captured again after an eager block
                    scan = make_scan()
                    self.train_scan = scan
                    best_state = {k: v.to(self.device, copy=True)
                                  for k, v in snap["best"].items()}
                    min_val = snap["min_val"]
                    best_epoch = snap["best_epoch"]
                    ep = snap["ep"]
                    global_step = snap["global_step"]
                    self.train_history = self.train_history[:ep]
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                self.recovery_seconds.append(
                    span_seconds(before, "kgwas.train.recovery"))

        with span("kgwas.train.tail"):
            if checkpointer:
                checkpointer.close()
            self.params = copy.deepcopy(model.state_dict())
            model.load_state_dict(best_state)
            self.best_params = best_state
            self.best_epoch = best_epoch
            model_dir = os.path.join(self.data_path, "model", save_name)
            if save_best_model and writer:
                print_sys("Saving models to " + model_dir)
                save_model(best_state, self.config, model_dir)

            pred_all = forward_all()
            self.test_metrics = compute_metrics(
                {"pred": pred_all[test_ids], "truth": y_host[test_ids]})
            if self.wandb:
                for k, v in self.test_metrics.items():
                    self.wandb.log({"test_" + k: v})
            table, self.scale_factor = finalize_predictions(
                self.data.lr_uni, pred_all[np.asarray(self.data.all_mask)])
            if writer:
                out_dir = os.path.join(self.data_path, "model_pred",
                                       "new_experiments")
                os.makedirs(out_dir, exist_ok=True)
                out_csv = os.path.join(out_dir, save_name + "_pred.csv")
                with span("kgwas.tail.pred_csv"):
                    write_table(table, out_csv)
                    print_sys("KGWAS prediction and p-values saved to "
                              + out_csv)
                    if save_best_model:
                        # the same bytes: formatted once, copied
                        shutil.copyfile(out_csv,
                                        os.path.join(model_dir, "pred.csv"))
                self.pred_csv_seconds = span_seconds(since,
                                                     "kgwas.tail.pred_csv")
            self.kgwas_res = table
        self.train_seconds = {
            "setup": span_seconds(since, "kgwas.train.setup"),
            "epochs": span_seconds(since, "kgwas.train.epoch",
                                   "kgwas.train.eval"),
            "tail": span_seconds(since, "kgwas.train.tail")}
        return table

    # -------------------------------------------------------------- inference

    @span("kgwas.predict_all")
    def predict_all(self, params=None) -> np.ndarray:
        """Per-SNP predictions [n_snp] for every KG SNP (one full-graph
        forward; the first output channel, as the JAX package returns it).
        With no params it serves the model's state: the best state after
        ``train``, the checkpoint after ``load_pretrained``. params: a
        state_dict loaded into the model first (it stays loaded)."""
        if params is not None:
            self.model.load_state_dict(params)
        cg, x, layouts = self._device_state()
        pred = self._forward(cg, x, layouts)
        with span("kgwas.to_host"):
            return pred[: cg.num_nodes["SNP"]].cpu().numpy()

    # ------------------------------------------------------------------ magma

    def run_magma(self, path_to_magma: str, bfile: str):
        """MAGMA's gene analysis on ``kgwas_res`` (external/magma.py)."""
        from .external.magma import run_magma

        return run_magma(self, path_to_magma, bfile)

    # --------------------------------------------------------- interpretation

    def get_disease_critical_network(
        self,
        variant_threshold: float = 5e-8,
        magma_path: Optional[str] = None,
        magma_threshold: float = 0.05,
        program_threshold: float = 0.05,
        K_neighbors: int = 3,
        num_cpus: int = 1,
    ):
        """(network weight, variant interpretation, disease-critical
        network) column tables from the model's state, as predict_all
        serves it, and ``kgwas_res`` (the SNPs with P below
        variant_threshold are the hits). The interpretation forward runs
        the merged GAT forward kernel in its raw mode
        (interpret/attention.py); the tables are interpret/network.py's."""
        from .interpret.attention import get_network_weight
        from .interpret.network import generate_viz

        df_network_weight = get_network_weight(self, self.data)
        df_variant_interpretation, disease_critical_network = generate_viz(
            self,
            df_network_weight,
            self.data_path,
            variant_threshold,
            magma_path,
            magma_threshold,
            program_threshold,
            K_neighbors,
            num_cpus,
        )
        return (df_network_weight, df_variant_interpretation,
                disease_critical_network)
