"""HeteroGNN: the KGWAS model as an ``nn.Module``.

Counterpart of ``kgwas_tpu/models/hetero_gnn.py`` (``init_hetero_gnn``,
``_apply_hetero_gnn`` and the three layer paths of ``apply_hetero_layer``):

  1. per-type SimpleMLP encoders -> hidden (one GO MLP shared by the three
     GO types)
  2. per layer, for each destination type whose output reaches the head
     (``HeteroGNN.live_groups``), one of three paths (``layer_path``):
       * ``merged`` (GAT, sum or mean; ``apply_merged_gat_layer``): per
         head, ONE merged GAT layer over every relation targeting the type
         (``ops/gat_layer.MergedGATLayer``), the cross-relation sum (or
         mean) folded into it; the heads concatenated, then the summed
         biases
       * ``relations`` (the per-relation loop of ``apply_hetero_layer``):
         GAT with max or min, with ``edge_dim``, or in training with
         dropout: one GAT layer per relation and head
         (``convs.gat_relation``: kernels #6 and #7, or #10 and #8 for
         ``sigmoid_gat``); SAGE, GCN and SGC with max or min: one
         message-passing layer per relation (``convs.sage_relation`` and
         the like, #10 and #8); each relation's bias added, then the
         aggregation over relations
       * ``mp`` (SAGE, GCN, SGC with sum or mean;
         ``apply_merged_mp_layer``): ONE CSR segment sum over the merged
         stream (``ops/segment.CSRSegmentSum``, kernel #10) with the static
         degree norms, then each relation's linear maps, then the sum (or
         mean) over relations
     then ReLU on every destination type. A GAT layer with H heads writes
     H*hidden columns, so the next layer and the head read H*hidden
     (the JAX package's sizing; the reference's model.py:50 cannot run
     H > 1). With ``remat`` each layer runs under
     ``torch.utils.checkpoint`` (``jax.checkpoint``'s counterpart), its
     dropout masks drawn before it.
  3. the scalar head ReLU(Linear(h_SNP)) (or no ReLU), in float32

The dtype options (``config.py``): the parameters are created in
``param_dtype``; a forward casts the features, the parameters and
``h1_override`` to ``compute_dtype`` (``models/precision.py``: each product
in its operands' promoted dtype, as the JAX package's arrays promote), and
the merged GAT layer's message table goes to the kernels in
``stream_dtype`` (else the compute dtype) while ``att`` and ``a_dst`` go in
float32; the layer output is cast back to the table's dtype before the
biases (``apply_merged_gat_layer``). The per-relation softmax GAT runs #6
and #7 on bf16 messages (and bf16 logits under the compute dtype) and
keeps each relation's output float32.

``HeteroGNN.collect_attention`` is the interpretation forward (the JAX
package's ``apply_collect_attention``): every destination group of every
layer through the merged GAT forward in its raw mode, no ReLU between
layers, no head, each relation's per-edge attention logit kept, per head.

Module and parameter names are the reference ``model.py``'s, so the
state_dict loads a reference ``model.pt`` as it is: ``snp_feat_mlp.*``,
``convs.{l}.convs.{src__rel__dst}.*`` (``models/convs.py``) and ``lin.*``.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn

from ..config import ModelConfig
from ..graph.synthetic import GO_TYPES
from ..ops.gat_layer import BWD_CHUNK_EDGES, MergedGATLayer, layout_schedule
from ..ops.gat_layer import schedule as gat_schedule
from ..ops.segment_ref import leaky_relu
from ..ops.schedule import (CSR_CHUNK_EDGES, CSR_MAX_EDGES, Schedule,
                            row_schedule)
from ..ops.segment import CSRSegmentSum, csc_fields
from .convs import (gat_relation, gcn_relation, make_conv, sage_relation,
                    sgc_relation)
from .init import torch_linear_bias, torch_linear_weight
from .mlp import SimpleMLP
from .precision import linear, matmul, torch_dtype

BACKBONES = ("GAT", "SAGE", "GCN", "SGC")
AGGRS = ("sum", "mean", "max", "min")


def encoder_for(ntype: str) -> str:
    if ntype == "SNP":
        return "snp_feat_mlp"
    if ntype == "Gene":
        return "gene_feat_mlp"
    if ntype in GO_TYPES:
        return "go_feat_mlp"
    raise ValueError(f"unknown node type {ntype!r}")


def check_supported(cfg: ModelConfig):
    """Raises on what the port does not run: an unknown backbone or
    aggregation."""
    if cfg.gnn_backbone not in BACKBONES:
        raise ValueError(f"unknown backbone {cfg.gnn_backbone!r}")
    if cfg.gnn_aggr not in AGGRS:
        raise ValueError(f"unknown hetero aggr {cfg.gnn_aggr!r}")


def layer_path(cfg: ModelConfig, training: bool = False) -> str:
    """The layer path of a forward, as apply_hetero_layer routes it
    (_merged_mp_active, _merged_path_active): 'mp' for SAGE, GCN and SGC
    with sum or mean; 'merged' for GAT with sum or mean, but 'relations'
    with edge_dim set or, in training, with dropout > 0 (whether or not a
    dropout generator is given); 'relations' for every backbone with max or
    min."""
    sum_mean = cfg.gnn_aggr in ("sum", "mean")
    if cfg.gnn_backbone != "GAT":
        return "mp" if sum_mean else "relations"
    if (not sum_mean or cfg.edge_dim is not None
            or (training and cfg.dropout > 0.0)):
        return "relations"
    return "merged"


def layer_paths(cfg: ModelConfig) -> tuple:
    """The paths of a model's forwards, in training and not: what
    device_layouts builds the layouts for."""
    return tuple(sorted({layer_path(cfg, False), layer_path(cfg, True)}))


def aggregate(outs, aggr: str):
    """The cross-relation aggregation (the JAX package's _aggregate). amax
    and amin split the gradient evenly among tied relations, as
    jax.grad of jnp.max / jnp.min does."""
    if len(outs) == 1:
        return outs[0]
    stacked = torch.stack(outs)
    if aggr == "sum":
        return stacked.sum(0)
    if aggr == "mean":
        return stacked.mean(0)
    if aggr == "max":
        return torch.amax(stacked, 0)
    if aggr == "min":
        return torch.amin(stacked, 0)
    raise ValueError(f"unknown hetero aggr {aggr!r}")


class HeteroConv(nn.Module):
    def __init__(self, rel_types: Dict[str, tuple], in_dim: int, hidden: int,
                 cfg: ModelConfig, gen: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleDict({
            rk: make_conv(cfg.gnn_backbone, in_dim, hidden, cfg.gat_num_head,
                          src_t == dst_t, gen, cfg.edge_dim,
                          cfg.pheno_condition)
            for rk, (src_t, _, dst_t) in rel_types.items()
        })


@dataclass
class DeviceLayout:
    """One edge stream on the device: a merged destination group's (R
    slots), or one relation's (one slot)."""

    rel_keys: List[str]
    src_types: List[str]
    n_rows_per_rel: int
    src_base: Tuple[int, ...]  # slot r: source rows src_base[r]..[r+1]
    src: torch.Tensor          # int32 [E_tot], dst-sorted: the gather index
    row_offsets: torch.Tensor  # int32 [R*N + 1]
    dst: torch.Tensor          # int32 [E_tot]: each edge's row
    csc_perm: torch.Tensor     # int32 [E_tot]: edges in source order
    csc_offsets: torch.Tensor  # int32 [S + 1]
    # slot r's edges are edge_base[r] .. edge_base[r+1], the first
    # rel_num_edges[r] of them real, in the relation's own order (a
    # relation stream: one slot)
    edge_base: Tuple[int, ...] = ()
    rel_num_edges: Tuple[int, ...] = ()
    # the 'mp' path's merged layouts and the relation streams: 1/deg per
    # row [R*N] and the symmetric norm per edge [E], over the real edges
    inv_deg: Optional[torch.Tensor] = None
    sym_e: Optional[torch.Tensor] = None
    # the 'relations' path: one one-slot layout per slot, in slot order
    relations: Optional[List["DeviceLayout"]] = None
    # the 'merged' path: the GAT kernels' work schedules for fold = R
    gat_schedule: Optional[Schedule] = None       # the forward's
    gat_bwd_schedule: Optional[Schedule] = None   # the backward's
    # the schedule of the stream's rows (ops/schedule.py row_schedule): a
    # relation's, for the segment softmax forward and backward ('relations'),
    # or a merged layout's R*N rows, for the CSR segment sum ('mp')
    row_schedule: Optional[Schedule] = None
    # the merged GAT forward's schedule for fold = 0 (one output row per
    # slot row: the interpretation of GAT max / min), built at its first use
    gat_fold0_schedule: Optional[Schedule] = None
    # the CSC segment sum's fields (ops/segment.py csc_fields): its
    # schedule of the source rows, and each CSC entry's cotangent row
    # dst[csc_perm] (% N when csc_fold: the merged GAT layer's fold)
    csc_schedule: Optional[Schedule] = None
    csc_rows: Optional[torch.Tensor] = None
    csc_fold: bool = False


def degree_norms(src, dst, n_src: int, n_dst: int, n_edges: int):
    """(inv_deg [n_dst], sym_e [n_edges]) float32 over the edges (src, dst)
    (numpy): the static, degree-only norms of the SAGE mean and the
    GCN/SGC symmetric norm (the JAX package's _merged_mp_norms, _sym_norm);
    sym_e is 0 past the given edges."""
    deg_dst = np.bincount(dst, minlength=n_dst).astype(np.float32)
    deg_src = np.bincount(src, minlength=n_src).astype(np.float32)
    inv_deg = np.where(deg_dst > 0, 1.0 / np.maximum(deg_dst, 1.0), 0.0)
    dinv_dst = np.where(deg_dst > 0,
                        1.0 / np.sqrt(np.maximum(deg_dst, 1.0)), 0.0)
    dinv_src = np.where(deg_src > 0,
                        1.0 / np.sqrt(np.maximum(deg_src, 1.0)), 0.0)
    sym_e = np.zeros(n_edges, dtype=np.float32)
    sym_e[:len(src)] = dinv_src[src] * dinv_dst[dst]
    return inv_deg.astype(np.float32), sym_e


def merged_mp_norms(L):
    """degree_norms of a merged layout. Pad edges sit on trash rows and
    trash source rows, so the whole stream gives the real rows' degrees."""
    return degree_norms(L.src, L.dst, L.n_src_total, L.n_rows_total,
                        len(L.src))


def relation_norms(r, n_src: int, n_dst: int):
    """degree_norms of a relation stream (graph/shard_compile.
    RelationShard) over its real edges only, as segment_mean and _sym_norm
    count them: its pad edges read source row 0, and would count there;
    they get 0."""
    e = r.num_edges
    return degree_norms(r.src[:e], r.dst[:e], n_src, n_dst, len(r.src))


def device_layouts(layouts, device, cg=None, path="merged"
                   ) -> Dict[str, DeviceLayout]:
    """The merged layouts on the device, with what the layer paths need
    (path: one of layer_path's names, or several, as layer_paths gives
    them): the GAT kernels' schedules (fold = R) for 'merged', the degree
    norms and the CSR segment sum's row schedule for 'mp', and for
    'relations' each slot's relation stream from the compiled graph cg
    (graph/shard_compile.RelationShard: its CSR, whose pad edges read
    source row 0, and its CSC, which sends their cotangents to the source
    trash row, as the JAX package does) with its rows' schedule (which the
    segment softmax kernels and the CSR segment sum take alike) and its
    degree norms over its real edges (relation_norms). Every stream whose
    backward runs the CSC segment sum carries its fields
    (segment.csc_fields): the merged ones on 'merged' (with the fold) and
    'mp', the relation streams on 'relations'. All are built once: a
    layout never changes."""
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    paths = {path} if isinstance(path, str) else set(path)
    if "relations" in paths and cg is None:
        raise ValueError("the per-relation path needs the compiled graph")

    def relation(rk):
        r = cg.relations[rk]
        n = int(cg.padded_nodes[r.dst_type])
        n_src = int(cg.padded_nodes[r.src_type])
        inv_deg, sym_e = relation_norms(r, n_src, n)
        return DeviceLayout(
            rel_keys=[rk], src_types=[r.src_type], n_rows_per_rel=n,
            src_base=(0, n_src), src=put(r.src),
            row_offsets=put(r.row_offsets), dst=put(r.dst),
            csc_perm=put(r.csc_perm), csc_offsets=put(r.csc_offsets),
            edge_base=(0, len(r.src)), rel_num_edges=(int(r.num_edges),),
            inv_deg=put(inv_deg), sym_e=put(sym_e),
            row_schedule=row_schedule(r.row_offsets).to(device),
            **csc_fields(r.dst, r.csc_perm, r.csc_offsets, n, (0, n_src), 0,
                         device))

    out = {}
    for t, L in layouts.items():
        extra = {}
        if paths & {"merged", "mp"}:   # 'relations' sums per relation
            extra = csc_fields(L.dst, L.csc_perm, L.csc_offsets,
                               L.n_rows_per_rel, L.src_base,
                               len(L.rel_keys) if "merged" in paths else 0,
                               device)
        if "mp" in paths:
            inv_deg, sym_e = merged_mp_norms(L)
            extra.update(inv_deg=put(inv_deg), sym_e=put(sym_e),
                         row_schedule=row_schedule(
                             L.row_offsets, CSR_MAX_EDGES,
                             CSR_CHUNK_EDGES).to(device))
        if "relations" in paths:
            extra["relations"] = [relation(rk) for rk in L.rel_keys]
        if "merged" in paths:
            # built once: the layout, and so the schedule, never changes
            sched = functools.partial(gat_schedule, L.row_offsets,
                                      L.n_rows_per_rel, len(L.rel_keys))
            extra.update(gat_schedule=sched().to(device),
                         gat_bwd_schedule=sched(
                             chunk_edges=BWD_CHUNK_EDGES).to(device))
        out[t] = DeviceLayout(
            rel_keys=list(L.rel_keys),
            src_types=list(L.src_types),
            n_rows_per_rel=int(L.n_rows_per_rel),
            src_base=tuple(int(b) for b in L.src_base),
            src=put(L.src),
            row_offsets=put(L.row_offsets),
            dst=put(L.dst),
            csc_perm=put(L.csc_perm),
            csc_offsets=put(L.csc_offsets),
            edge_base=tuple(int(b) for b in L.edge_base),
            rel_num_edges=tuple(int(e) for e in L.rel_num_edges),
            **extra,
        )
    return out


def fold_schedule(L: DeviceLayout, fold: int = 0):
    """Keeps the merged GAT forward's schedule for fold (0, or R) on a
    layout on the card, built at its first use (a layout never changes):
    the interpretation's, where the layer path built none. A layout on the
    CPU needs none: its plain version takes no schedule."""
    if L.src.device.type != "cuda" or layout_schedule(L, fold) is not None:
        return
    sched = gat_schedule(L.row_offsets.cpu().numpy(), L.n_rows_per_rel,
                         fold).to(L.src.device)
    if fold:
        L.gat_schedule = sched
    else:
        L.gat_fold0_schedule = sched


class HeteroGNN(nn.Module):
    def __init__(self, cfg: ModelConfig, rel_types: Dict[str, tuple],
                 snp_init_dim: int, gene_init_dim: int, go_init_dim: int,
                 seed: int = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        h = cfg.gnn_hidden_dim
        # GAT concatenates its heads: every layer after the first, and the
        # head, reads H*h columns
        wide = h * (cfg.gat_num_head if cfg.gnn_backbone == "GAT" else 1)
        gen = torch.Generator().manual_seed(int(seed))
        self.snp_feat_mlp = SimpleMLP(snp_init_dim, h, h, gen)
        self.go_feat_mlp = SimpleMLP(go_init_dim, h, h, gen)
        self.gene_feat_mlp = SimpleMLP(gene_init_dim, h, h, gen)
        self.convs = nn.ModuleList([
            HeteroConv(rel_types, h if li == 0 else wide, h, cfg, gen)
            for li in range(cfg.gnn_num_layers)
        ])
        head_in = wide if cfg.gnn_num_layers > 0 else h
        self.lin = nn.Linear(head_in, cfg.out_channels)
        with torch.no_grad():
            self.lin.weight.copy_(torch_linear_weight(gen, head_in,
                                                      cfg.out_channels))
            self.lin.bias.copy_(torch_linear_bias(gen, head_in,
                                                  cfg.out_channels))
        # drawn in float32 from the generator, then kept in param_dtype
        self.to(torch_dtype(cfg.param_dtype))

    @property
    def compute_dtype(self) -> torch.dtype:
        return torch_dtype(self.cfg.compute_dtype)

    @property
    def stream_dtype(self) -> Optional[torch.dtype]:
        """The merged GAT table's dtype when it differs from the compute
        dtype, else None."""
        sdt = torch_dtype(self.cfg.stream_dtype)
        return None if sdt in (None, self.compute_dtype) else sdt

    def source_rows(self, h, L, convs, hh: int, cdt, lo: int = 0, hi=None):
        """Rows lo..hi (all by default) of a destination group's projected
        source table for head hh: slot s's block of the concatenated source
        space is h[src_type] @ W_src^T of its relation."""
        hi = L.src_base[-1] if hi is None else hi
        parts = []
        for s, c in enumerate(convs):
            b0, b1 = L.src_base[s], L.src_base[s + 1]
            a, b = max(lo, b0), min(hi, b1)
            if a < b:
                hs = h[L.src_types[s]]
                if (a, b) != (b0, b1):
                    hs = hs[a - b0:b - b0]
                parts.append(matmul(hs, c.head_rows(c.lin_src.weight, hh).T,
                                    cdt))
        return torch.cat(parts)

    def merged_layer(self, layer: HeteroConv, h: Dict[str, torch.Tensor],
                     layouts: Dict[str, DeviceLayout], mode=None,
                     alphas: Optional[dict] = None, cdt=torch.float32,
                     sdt=None, merged_fns: Optional[dict] = None):
        """One hetero GAT layer, per head one kernel launch per destination
        group (the JAX package's loop over heads in apply_merged_gat_layer:
        each head's slice of lin_src and lin_dst @ att_dst, at D = hidden),
        the heads concatenated. mode: the kernel's weights, by default the
        model's ('softmax', or 'sigmoid' with sigmoid_gat); the
        interpretation runs 'raw'. With aggr sum or mean the kernel folds
        the R slot rows of a node into one and the summed biases follow, at
        full width, once; with max or min (interpretation only: training
        takes relation_layer) it writes each slot's rows (fold 0), and each
        relation's bias is added before the max or min. alphas: a dict that
        receives each relation's per-edge weight [E, H] over its real
        edges, in the relation's own order. cdt: the compute dtype; sdt: the
        table's stream dtype (None: the compute dtype); the interpretation
        passes float32 and rounds the table's values instead (its raw
        weights multiply the messages in float32, as the JAX package's
        per-relation collect path does). merged_fns: dst type -> the group's
        layer over a mesh (parallel/merged_shard.ShardedMergedGroup), which
        projects its rank's rows of the source table (x_lo..x_hi) and
        returns the unfolded [R*N, D] output, summed over relations here
        (the JAX package's merged_kernel_fns)."""
        cfg = self.cfg
        if mode is None:
            mode = "sigmoid" if cfg.sigmoid_gat else "softmax"
        n_heads = cfg.gat_num_head
        out = {}
        for dst_t, L in layouts.items():
            convs = [layer.convs[rk] for rk in L.rel_keys]
            n_rel = len(convs)
            fold = (n_rel if cfg.gnn_aggr in ("sum", "mean")
                    and merged_fns is None else 0)
            heads, head_alphas = [], []
            for hh in range(n_heads):
                att = torch.stack([c.att_src[0, hh].to(cdt)
                                   for c in convs])                 # [R, D]
                # a_dst = (h @ W_dst) . att_dst == h @ (W_dst^T att_dst):
                # one [N, D] x [D, R] product instead of R projections
                v = torch.stack([c.att_dst[0, hh].to(cdt) @ c.head_rows(
                    c.dst_weight(), hh).to(cdt) for c in convs], dim=1)
                a_dst_all = matmul(h[dst_t], v, cdt).T.reshape(-1)
                if merged_fns is not None:
                    fn = merged_fns[dst_t]
                    xs_local = self.source_rows(h, L, convs, hh, cdt,
                                                *fn.x_range)
                    out_dtype = xs_local.dtype
                    heads.append(fn(xs_local, att.float().contiguous(),
                                    a_dst_all.float().contiguous(), mode,
                                    cfg.negative_slope, cfg.temperature,
                                    sdt))
                    continue
                xs_all = self.source_rows(h, L, convs, hh, cdt)
                out_dtype = xs_all.dtype
                att = att.to(torch.float32)
                a_dst_all = a_dst_all.to(torch.float32)
                if alphas is not None:
                    if cfg.stream_dtype is not None:
                        xs_all = xs_all.to(torch_dtype(
                            cfg.stream_dtype)).to(xs_all.dtype)
                    head_alphas.append(self.edge_weights(L, xs_all, att,
                                                         a_dst_all, mode))
                heads.append(MergedGATLayer.apply(
                    xs_all, att.contiguous(), a_dst_all.contiguous(), L,
                    fold, mode, cfg.negative_slope, cfg.temperature, sdt))
            if alphas is not None:
                alphas.update({rk: torch.stack([a[rk] for a in head_alphas],
                                               dim=1) for rk in L.rel_keys})
            if not fold:
                rel = torch.cat([a.reshape(n_rel, L.n_rows_per_rel, -1)
                                 for a in heads], dim=-1).to(out_dtype)
                out[dst_t] = aggregate([rel[r] + c.bias.to(cdt)
                                        for r, c in enumerate(convs)],
                                       cfg.gnn_aggr)
                continue
            agg = heads[0] if n_heads == 1 else torch.cat(heads, dim=-1)
            bias = convs[0].bias.to(cdt)
            for c in convs[1:]:
                bias = bias + c.bias.to(cdt)
            if cfg.gnn_aggr == "mean":
                agg = agg / n_rel
                bias = bias / n_rel
            out[dst_t] = agg.to(out_dtype) + bias
        return out

    def edge_weights(self, L: DeviceLayout, xs_all, att, a_dst_all, mode):
        """relkey -> the weight of each real edge of the relation, in its
        own order, for one head: the logit leaky_relu(a_src[src] +
        a_dst[dst]) in the raw mode, sigmoid(logit / temperature) in the
        sigmoid mode (the JAX package's apply_gat alpha with
        raw_attention)."""
        cfg = self.cfg
        a_src_all = torch.cat([
            (xs_all[L.src_base[s]:L.src_base[s + 1]] * att[s]).sum(-1)
            for s in range(len(L.rel_keys))])
        out = {}
        for s, rk in enumerate(L.rel_keys):
            e0, e1 = L.edge_base[s], L.edge_base[s] + L.rel_num_edges[s]
            z = (a_src_all[L.src[e0:e1].long()]
                 + a_dst_all[L.dst[e0:e1].long()])
            alpha = leaky_relu(z, cfg.negative_slope)
            if mode == "sigmoid":
                alpha = torch.sigmoid(alpha / cfg.temperature)
            out[rk] = alpha
        return out

    def relation_layer(self, layer: HeteroConv, h: Dict[str, torch.Tensor],
                       layouts: Dict[str, DeviceLayout],
                       keep: Optional[dict] = None,
                       edge_attr: Optional[dict] = None):
        """One hetero layer per relation (the per-relation loop of
        apply_hetero_layer): GAT (convs.gat_relation, each head one launch
        of the per-relation kernels), SAGE, GCN or SGC
        (convs.sage_relation, ...; one launch of #10 per relation), each
        relation's bias added before the aggregation over relations. keep:
        relkey -> the dropout multiplier [E, H] (draw_keep); edge_attr:
        relkey -> edge features [E, edge_dim]."""
        cfg = self.cfg
        bb = cfg.gnn_backbone
        mode = "sigmoid" if cfg.sigmoid_gat else "softmax"
        cdt = self.compute_dtype
        out = {}
        for dst_t, L in layouts.items():
            if L.relations is None:
                raise ValueError(
                    f"layout {dst_t!r} has no per-relation streams: build it "
                    "with device_layouts(..., cg, path='relations')")
            outs = []
            for rk, RL in zip(L.rel_keys, L.relations):
                conv, h_src = layer.convs[rk], h[RL.src_types[0]]
                if bb == "GAT":
                    outs.append(gat_relation(
                        conv, h_src, h[dst_t], RL, cfg.negative_slope,
                        cfg.temperature, mode,
                        None if keep is None else keep[rk],
                        None if edge_attr is None else edge_attr.get(rk),
                        cdt, torch_dtype(cfg.stream_dtype),
                        cfg.stream_f32_logits))
                elif bb == "SAGE":
                    outs.append(sage_relation(conv, h_src, h[dst_t], RL,
                                              cdt))
                elif bb == "GCN":
                    outs.append(gcn_relation(conv, h_src, RL, cdt))
                else:
                    outs.append(sgc_relation(conv, h_src, RL, cdt))
            out[dst_t] = aggregate(outs, cfg.gnn_aggr)
        return out

    def mp_layer(self, layer: HeteroConv, h: Dict[str, torch.Tensor],
                 layouts: Dict[str, DeviceLayout]):
        """One SAGE / GCN / SGC hetero layer, one launch of the CSR segment
        sum per destination group over its merged stream (the JAX
        package's apply_merged_mp_layer)."""
        cfg = self.cfg
        bb = cfg.gnn_backbone
        cdt = self.compute_dtype
        out = {}
        for dst_t, L in layouts.items():
            if L.inv_deg is None:
                raise ValueError(
                    f"layout {dst_t!r} has no degree norms: build it with "
                    "device_layouts(..., path='mp')")
            convs = [layer.convs[rk] for rk in L.rel_keys]
            if bb == "GCN":
                # GCN projects before the aggregation: one table per slot
                xs_all = torch.cat([matmul(h[t], c.lin.weight.T, cdt)
                                    for t, c in zip(L.src_types, convs)])
            else:
                # SAGE and SGC aggregate the hidden rows themselves
                xs_all = torch.cat([h[t] for t in L.src_types])
            summed = CSRSegmentSum.apply(
                xs_all, None if bb == "SAGE" else L.sym_e, L)
            if bb == "SAGE":
                summed = summed * L.inv_deg[:, None]                # mean
            rel = summed.reshape(len(convs), L.n_rows_per_rel, -1)
            # the f32 sum promotes what follows, as in the JAX package
            if bb == "SAGE":
                outs = [linear(rel[r], c.lin_l, cdt)
                        + linear(h[dst_t], c.lin_r, cdt)
                        for r, c in enumerate(convs)]
            elif bb == "GCN":
                outs = [rel[r] + c.bias.to(cdt) for r, c in enumerate(convs)]
            else:
                outs = [linear(rel[r], c.lin, cdt)
                        for r, c in enumerate(convs)]
            out[dst_t] = aggregate(outs, cfg.gnn_aggr)
        return out

    def layer(self, layer: HeteroConv, h: Dict[str, torch.Tensor],
              layouts: Dict[str, DeviceLayout], training: bool = False,
              keep: Optional[dict] = None,
              edge_attr: Optional[dict] = None,
              merged_fns: Optional[dict] = None):
        """One hetero layer on the configuration's path (layer_path), then
        ReLU on every destination type."""
        path = layer_path(self.cfg, training)
        if path == "merged":
            out = self.merged_layer(layer, h, layouts, cdt=self.compute_dtype,
                                    sdt=self.stream_dtype,
                                    merged_fns=merged_fns)
        elif path == "relations":
            out = self.relation_layer(layer, h, layouts, keep, edge_attr)
        else:
            out = self.mp_layer(layer, h, layouts)
        return {t: torch.relu(v) for t, v in out.items()}

    def draw_keep(self, layouts: Dict[str, DeviceLayout],
                  gen: torch.Generator) -> dict:
        """One layer's dropout multipliers, relkey -> [E, H] float32 on the
        layouts' device: keep ~ bernoulli(1 - p) drawn from gen (u < 1 - p
        of gen's uniforms, on gen's device), times 1 / (1 - p), as apply_gat
        draws them on its [E_pad, H] alpha (another RNG: not its
        numbers)."""
        p = self.cfg.dropout
        out = {}
        for L in layouts.values():
            for rk, RL in zip(L.rel_keys, L.relations):
                u = torch.rand((RL.src.shape[0], self.cfg.gat_num_head),
                               generator=gen, device=gen.device)
                out[rk] = ((u < 1.0 - p).to(torch.float32)
                           / (1.0 - p)).to(RL.src.device)
        return out

    def live_groups(self, layouts: Dict[str, DeviceLayout]):
        """(per layer, the destination groups whose output reaches the
        head; the node types whose encoder output does). The last layer
        needs the SNP group alone, each layer before it the groups that the
        next layer reads: their source types and, where the layer reads the
        destination's own row (GAT's a_dst, SAGE's lin_r; not GCN or SGC),
        their own. The JAX package's jit drops the other groups as dead
        code."""
        reads_dst = self.cfg.gnn_backbone in ("GAT", "SAGE")
        need = {"SNP"}
        per_layer = []
        for _ in self.convs:
            live = [t for t in layouts if t in need]
            per_layer.append(live)
            need = set(live) if reads_dst else set()
            need = need.union(*(layouts[t].src_types for t in live))
        return per_layer[::-1], need

    def collect_attention(self, x: Dict[str, torch.Tensor],
                          layouts: Dict[str, DeviceLayout]) -> List[dict]:
        """The interpretation forward (the JAX package's
        apply_collect_attention with raw=True, after the reference): the
        encoders of every node type, then in every layer every destination
        group through merged_layer in the raw mode (sigmoid with
        sigmoid_gat), each head, with NO ReLU between layers and no head.
        Returns, per layer, relkey -> the weight of each real edge and head
        [E, H] in the relation's own order (edge_weights), the keys in
        sorted order. SAGE, GCN and SGC have no attention: one empty dict
        per layer, as the JAX package returns. No compute cast, as in
        apply_collect_attention: it runs in float32 (bf16 parameters
        promoted), the stream dtype rounding the table's values."""
        cfg = self.cfg
        if cfg.gnn_backbone != "GAT":
            return [{} for _ in self.convs]
        mode = "sigmoid" if cfg.sigmoid_gat else "raw"
        sum_mean = cfg.gnn_aggr in ("sum", "mean")
        for L in layouts.values():
            fold_schedule(L, len(L.rel_keys) if sum_mean else 0)
        per_layer = []
        with torch.no_grad():
            h = {t: getattr(self, encoder_for(t))(xt) for t, xt in x.items()}
            for layer in self.convs:
                alphas = {}
                h = self.merged_layer(layer, h, layouts, mode, alphas)
                # in relation key order: the JAX package's layer collects
                # them in its parameters' order, sorted as jit returns
                # them (a table's first occurrences follow it)
                per_layer.append({rk: alphas[rk] for rk in sorted(alphas)})
        return per_layer

    def forward(self, x: Dict[str, torch.Tensor],
                layouts: Dict[str, DeviceLayout], training: bool = False,
                dropout_gen: Optional[torch.Generator] = None,
                edge_attr: Optional[dict] = None,
                h1_override: Optional[Dict[str, torch.Tensor]] = None,
                merged_fns: Optional[dict] = None) -> torch.Tensor:
        """Full-graph forward (apply_hetero_gnn). Returns pred [N_snp_pad,
        out_channels]. training: the layer path of a training step
        (layer_path), and with dropout_gen (the counterpart of
        dropout_rng) a GAT on the per-relation path drops attention with
        the model's dropout, each layer's masks drawn before the layer runs.
        edge_attr: relkey -> edge features [E_pad, edge_dim] (or [E_pad])
        for the edge_dim term; no loader gives any, as in the JAX package.
        h1_override: type -> the first encoder layer's pre-activations
        [N_pad, hidden] (the streamed giant-feature path,
        engine/streamed.py); those types run only the encoder's tail.
        With remat each layer runs under torch.utils.checkpoint when
        gradients are on (its recompute launches the forward kernels
        again). The features, the parameters and h1_override are cast to
        the compute dtype; the prediction is float32. merged_fns: the
        merged layer over a mesh (merged_layer; parallel/shard.py)."""
        cfg = self.cfg
        cdt = self.compute_dtype
        groups, encoded = self.live_groups(layouts)
        h1_override = h1_override or {}
        h = {t: (getattr(self, encoder_for(t)).tail(h1_override[t].to(cdt),
                                                    cdt)
                 if t in h1_override
                 else getattr(self, encoder_for(t))(xt.to(cdt), cdt))
             for t, xt in x.items() if t in encoded}
        drop = (training and dropout_gen is not None and cfg.dropout > 0.0
                and cfg.gnn_backbone == "GAT"
                and layer_path(cfg, training) == "relations")
        for layer, live in zip(self.convs, groups):
            lay = {t: layouts[t] for t in live}
            # drawn outside the checkpoint: its recompute restores the
            # global RNG states, not a generator it is given. The layer
            # draws from no RNG, so the checkpoint keeps no RNG state (which
            # a CUDA graph's capture refuses to read)
            keep = self.draw_keep(lay, dropout_gen) if drop else None
            if cfg.remat and torch.is_grad_enabled():
                h = torch.utils.checkpoint.checkpoint(
                    self.layer, layer, h, lay, training, keep, edge_attr,
                    merged_fns, use_reentrant=False,
                    preserve_rng_state=False)
            else:
                h = self.layer(layer, h, lay, training, keep, edge_attr,
                               merged_fns)
        logits = linear(h["SNP"], self.lin, cdt)
        pred = logits if cfg.no_relu else torch.relu(logits)
        return pred.to(torch.float32)
