"""Full-graph training over a device mesh: the sharded train step and
forward, with replicated parameters.

Counterpart of ``kgwas_tpu/parallel/shard.py`` (``_select_kernel_path``,
``make_sharded_train_step``, ``make_sharded_forward``, the 'model' axis
of ``graph_shardings``). Every rank holds the parameters, the node
features and the graph, and runs:

  * the encoders; a feature table at least ``TP_FEATURE_DIM_THRESHOLD``
    wide is column-sharded over the 'model' axis: each rank multiplies its
    columns by the first encoder layer's matching weight columns, and the
    partial products are summed over the axis (``all_reduce_sum``, whose
    gradient is the sum of the cotangents) before the bias;
  * per layer, the layer of the forward's path over the 'data' axis
    (``select_kernel_path``): the merged GAT layer (``merged_shard.py``:
    the rank's rows of the source table projected and all-gathered, #1 /
    #2 / #8 on the rank's rows and edges, the output rows all-gathered and
    summed over relations), the per-relation layers and the 'mp' layer
    (``relation_shard.py``: #6 / #7, or #10, on the rank's rows of each
    stream, #8 over its CSC, the rows all-gathered);
  * the head, and the seed-batch loss, which equals the single-process
    loss (every rank computes it from the same gathered predictions);
    feature tables streamed from the host (engine/streamed.py) stream the
    rank's rows of the first layer and all-gather them.

The backward runs on each rank with its loss divided by the mesh size, so
that the sum over ranks of each parameter's gradient is the gradient of
the loss (the collectives' gradients are their transposes); the
gradients are summed over the mesh once per step, packed into one buffer
per dtype in the parameters' order, and every rank runs the same Adam
update.

Every configuration runs: where the JAX package falls back from its
merged shard_map kernels to GSPMD-partitioned XLA ops (the per-relation
and 'mp' paths, sigmoid GAT, layouts that do not divide by the 'data'
axis), the port runs its kernels on each rank's rows, in blocks that need
not be equal.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..engine.loop import batch_loss, fill_dead_grads
from ..models.hetero_gnn import encoder_for, layer_path
from ..models.precision import matmul
from ..ops.streaming import COL_CHUNK, StreamedLinear
from .merged_shard import make_sharded_merged_fns
from .mesh import Mesh, all_gather_rows, all_reduce_sum, split_bounds
from .relation_shard import make_mp_fns, make_relation_fns

TP_FEATURE_DIM_THRESHOLD = 1024  # column-shard a feature table this wide


def select_kernel_path(cfg, layouts: dict, mesh: Mesh, training: bool,
                       cg=None, device="cpu"):
    """The JAX package's _select_kernel_path: (the forward's layer path,
    dst type -> that path's layer over the mesh's 'data' axis) for the
    merged layouts given (KGWAS.train gives the groups the forward runs:
    the JAX package's jit drops the others). 'merged' (GAT, sum or mean,
    softmax or sigmoid): merged_shard.ShardedMergedGroup; 'relations':
    relation_shard.RankRelations, from the compiled graph cg's relation
    streams; 'mp': the merged layouts' relation_shard.RankStream."""
    path = layer_path(cfg, training)
    if path == "merged":
        return path, make_sharded_merged_fns(layouts, mesh, device)
    if path == "relations":
        if cg is None:
            raise ValueError("the per-relation path needs the compiled graph")
        return path, make_relation_fns(layouts, cg, mesh, device)
    return path, make_mp_fns(layouts, mesh, device)


def tp_columns(width: int, mesh: Mesh):
    """(c0, c1): this rank's block of a feature table's columns on the
    'model' axis (numpy array_split's blocks)."""
    bounds = np.linspace(0, width, mesh.model + 1).astype(int)
    return int(bounds[mesh.model_rank]), int(bounds[mesh.model_rank + 1])


class ShardedRun:
    """What a rank keeps for the sharded step and forward of one model on
    one mesh: each layer path's per-rank layouts, built once at the path's
    first forward (fns: path -> dst type -> the layer over the mesh;
    select_kernel_path), the node features (a column-sharded table as
    this rank's columns, a placeholder in its place), and the streamed
    types' host tables. cg: the compiled graph, which the per-relation
    path needs."""

    def __init__(self, host_layouts: dict, x: dict, mesh: Mesh, device,
                 padded_nodes: dict, x_host=None, cg=None):
        self.mesh = mesh
        self.host_layouts, self.cg, self.device = host_layouts, cg, device
        self.fns = {}
        self.padded_nodes = dict(padded_nodes)
        self.x_host = dict(x_host or {})
        self.x, self.x_cols = {}, {}
        for t, v in x.items():
            if (mesh.model > 1 and t not in self.x_host
                    and v.shape[1] >= TP_FEATURE_DIM_THRESHOLD):
                c0, c1 = tp_columns(v.shape[1], mesh)
                self.x_cols[t] = (c0, c1, v[:, c0:c1].contiguous())
                v = v.new_zeros(v.shape[0], 1)
            self.x[t] = v

    def h1(self, model) -> dict:
        """The first encoder layer's pre-activations of the column-sharded
        types (partials summed over the 'model' axis) and of the streamed
        types (the rank's rows over the 'data' axis, all-gathered)."""
        cdt = model.compute_dtype
        out = {}
        for t, (c0, c1, xc) in self.x_cols.items():
            fc1 = getattr(model, encoder_for(t)).FC_hidden
            part = matmul(xc.to(cdt), fc1.weight[:, c0:c1].T, cdt)
            out[t] = (all_reduce_sum(part, self.mesh.model_group)
                      + fc1.bias.to(part.dtype))
        for t, xh in self.x_host.items():
            fc1 = getattr(model, encoder_for(t)).FC_hidden
            w, b = fc1.weight.to(torch.float32), fc1.bias.to(torch.float32)
            bounds = split_bounds(self.padded_nodes[t], self.mesh.data)
            lo, hi = bounds[self.mesh.data_rank:self.mesh.data_rank + 2]
            real = xh[lo:hi]
            mine = (StreamedLinear.apply(w, b, real, hi - lo, COL_CHUNK)
                    if len(real) else b.unsqueeze(0).expand(hi - lo, -1))
            out[t] = all_gather_rows(mine, self.mesh.data_group,
                                     np.diff(bounds).tolist())
        return out

    def forward(self, model, layouts: dict, training: bool = False):
        """Full-graph predictions [N_snp_pad, out_channels], the same on
        every rank."""
        path = layer_path(model.cfg, training)
        if path not in self.fns:
            # kept for the forwards after: never built as inference tensors
            with torch.inference_mode(False):
                self.fns[path] = select_kernel_path(
                    model.cfg, self.host_layouts, self.mesh, training,
                    self.cg, self.device)[1]
        return model(self.x, layouts, training=training,
                     h1_override=self.h1(model), mesh_fns=self.fns)


def sum_grads(model, mesh: Mesh):
    """Each parameter's gradient summed over the mesh: one all-reduce per
    dtype of a buffer packed in the parameters' order."""
    if mesh.world_group is None:
        return
    by_dtype = {}
    for p in model.parameters():
        by_dtype.setdefault(p.grad.dtype, []).append(p.grad)
    for grads in by_dtype.values():
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=mesh.world_group)
        i = 0
        for g in grads:
            g.copy_(flat[i:i + g.numel()].view_as(g))
            i += g.numel()


def broadcast_state(model, mesh: Mesh):
    """Rank 0's parameters and buffers on every rank (each rank builds the
    same model from the same seed; this makes them the same bits)."""
    if mesh.world_group is None:
        return
    for v in list(model.parameters()) + list(model.buffers()):
        dist.broadcast(v.data, src=0, group=mesh.world_group)


def sharded_train_step(model, optimizer, run: ShardedRun, layouts,
                       batch_idx, y_node, w_node):
    """One optimizer step on the seed batch over the mesh (engine.loop.
    train_step's counterpart, make_sharded_train_step). Returns the loss
    (the single-process loss) as a 0-d tensor, not synchronised."""
    optimizer.zero_grad(set_to_none=True)
    loss = batch_loss(run.forward(model, layouts, training=True),
                      batch_idx, y_node, w_node)
    (loss / run.mesh.size).backward()
    fill_dead_grads(model)
    sum_grads(model, run.mesh)
    optimizer.step()
    return loss.detach()


def sharded_forward(model, run: ShardedRun, layouts):
    """Full-graph predictions [N_snp_pad] over the mesh
    (make_sharded_forward)."""
    with torch.inference_mode():
        return run.forward(model, layouts)[:, 0]
