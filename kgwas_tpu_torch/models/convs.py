"""Per-relation graph convolutions: GAT, SAGE, GCN and SGC parameters, and
the per-relation layers.

Counterpart of ``kgwas_tpu/models/convs.py`` (``init_gat`` / ``apply_gat``,
``init_sage`` / ``apply_sage``, ``init_gcn`` / ``apply_gcn``, ``init_sgc`` /
``apply_sgc``). Parameter names are PyG's, as the reference ``model.py``
holds them, so a reference ``model.pt`` loads as it is:

  * GATConv: ``lin_src``, ``lin_dst`` (not for homogeneous relations: there
    ``lin_src`` projects both ends), ``att_src``, ``att_dst`` [1, H, C],
    ``bias`` [H*C]; with ``edge_dim``, ``lin_edge`` and ``att_edge``; with
    ``pheno_condition`` 'ATT', ``lin_edge_`` and ``att_edge`` (one
    ``att_edge`` when both are set, as the reference assigns it twice);
    with 'MSG', ``pheno_mlp``. The ``pheno_condition`` parameters are
    created and never read, as in the reference
  * SAGEConv: ``lin_l`` (with bias) on the mean of the source rows,
    ``lin_r`` (without) on the destination row
  * GCNConv: ``lin`` (without bias) before the normalised sum, ``bias``
  * SGConv (K=1): ``lin`` (with bias) after the normalised sum

The message-passing layer of SAGE, GCN and SGC with sum or mean runs
merged over each destination group (``hetero_gnn.HeteroGNN.mp_layer``), and
with max or min per relation (``sage_relation``, ``gcn_relation``,
``sgc_relation``). The GAT layer runs merged for sum and mean and per
relation (``gat_relation``) for max and min, with ``edge_dim``, and in
training with dropout, as the JAX package routes them.

Each layer function takes the compute dtype ``cdt`` (``models/precision.
py``): the parameters in that dtype, each product in its operands'
promoted dtype. A relation's segment sum (#10) returns float32; SAGE, GCN
and SGC round it back to their messages' dtype, as the JAX package's
segment sums return their data's dtype there, and the sigmoid GAT keeps
it, as the JAX package's Pallas sum does. The softmax GAT's segment
softmax (#6, #7) takes bf16 messages and logits and returns float32, as
the JAX package's Pallas op keeps its softmax state and output float32;
``+ bias`` keeps the relation's output float32 for the layers after it.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.segment import CSRSegmentSum
from ..ops.segment_ref import gather_rows, leaky_relu
from ..ops.segment_softmax import SegmentSoftmaxSpmm
from .init import glorot_att, glorot_weight, torch_linear_bias, torch_linear_weight
from .precision import linear, matmul

def _linear(in_dim, out, weight, bias=None):
    lin = nn.Linear(in_dim, out, bias=bias is not None)
    with torch.no_grad():
        lin.weight.copy_(weight)
        if bias is not None:
            lin.bias.copy_(bias)
    return lin


class GATConv(nn.Module):
    """One relation's GAT parameters (PyG GATConv names), drawn from gen in
    the order of init_gat's keys. Homogeneous relations have no lin_dst:
    lin_src projects both ends."""

    def __init__(self, in_dim: int, out: int, heads: int, share_dst: bool,
                 gen: torch.Generator, edge_dim=None, pheno_condition=None):
        super().__init__()
        if pheno_condition == "MSG" and edge_dim is None:
            raise ValueError("pheno_condition='MSG' requires edge_dim "
                             "(reference conv.py:76)")
        hc = heads * out
        self.lin_src = _linear(in_dim, hc, glorot_weight(gen, in_dim, hc))
        self.lin_dst = (None if share_dst else _linear(
            in_dim, hc, glorot_weight(gen, in_dim, hc)))
        self.att_src = nn.Parameter(glorot_att(gen, heads, out))
        self.att_dst = nn.Parameter(glorot_att(gen, heads, out))
        self.bias = nn.Parameter(torch.zeros(hc))
        self.lin_edge_ = self.att_edge = self.pheno_mlp = self.lin_edge = None
        if pheno_condition == "ATT":
            self.lin_edge_ = _linear(out, hc, glorot_weight(gen, out, hc))
        if pheno_condition == "ATT" or edge_dim is not None:
            self.att_edge = nn.Parameter(glorot_att(gen, heads, out))
        if pheno_condition == "MSG":
            self.pheno_mlp = _linear(edge_dim, hc,
                                     glorot_weight(gen, edge_dim, hc))
        if edge_dim is not None:
            self.lin_edge = _linear(edge_dim, hc,
                                    glorot_weight(gen, edge_dim, hc))

    @property
    def heads(self) -> int:
        return self.att_src.shape[1]

    def dst_weight(self):
        return (self.lin_src if self.lin_dst is None else self.lin_dst).weight

    def head_rows(self, weight, h: int):
        """Head h's rows of a [H*C, in] projection: a contiguous [C, in]."""
        c = self.att_src.shape[2]
        return weight[h * c:(h + 1) * c]


class SAGEConv(nn.Module):
    """PyG SAGEConv((-1, -1), C): lin_l(mean of x_src) + lin_r(x_dst)."""

    def __init__(self, in_src: int, in_dst: int, out: int,
                 gen: torch.Generator):
        super().__init__()
        self.lin_l = _linear(in_src, out, torch_linear_weight(gen, in_src, out),
                             torch_linear_bias(gen, in_src, out))
        self.lin_r = _linear(in_dst, out, torch_linear_weight(gen, in_dst, out))


class GCNConv(nn.Module):
    """PyG GCNConv without self loops: the symmetric-normalised sum of
    lin(x_src), plus bias."""

    def __init__(self, in_src: int, out: int, gen: torch.Generator):
        super().__init__()
        self.lin = _linear(in_src, out, glorot_weight(gen, in_src, out))
        self.bias = nn.Parameter(torch.zeros(out))


class SGConv(nn.Module):
    """PyG SGConv, K=1: lin of the symmetric-normalised sum of x_src."""

    def __init__(self, in_src: int, out: int, gen: torch.Generator):
        super().__init__()
        self.lin = _linear(in_src, out, torch_linear_weight(gen, in_src, out),
                           torch_linear_bias(gen, in_src, out))


def make_conv(backbone: str, in_dim: int, hidden: int, heads: int,
              share_dst: bool, gen: torch.Generator, edge_dim=None,
              pheno_condition=None) -> nn.Module:
    """One relation's conv from in_dim to hidden (GAT: hidden per head),
    drawn from gen in the order the JAX package's init_* functions draw."""
    if backbone == "GAT":
        return GATConv(in_dim, hidden, heads, share_dst, gen, edge_dim,
                       pheno_condition)
    if backbone == "SAGE":
        return SAGEConv(in_dim, in_dim, hidden, gen)
    if backbone == "GCN":
        return GCNConv(in_dim, hidden, gen)
    if backbone == "SGC":
        return SGConv(in_dim, hidden, gen)
    raise ValueError(f"unknown backbone {backbone!r}")


class EdgeLogits(torch.autograd.Function):
    """``EdgeLogits.apply(a_src, a_dst, layout)`` -> a_src[src_e] +
    a_dst[dst_e] over a relation stream. Its backward sums each edge's
    cotangent per destination row in the stream's order (row_offsets) and
    per source row in its CSC's (csc_perm, csc_offsets; a pad edge's goes
    to the source trash row, as the CSC routes it everywhere in the port)
    with torch.segment_reduce: a fixed order, where index_select's
    backward (index_add_) adds with float atomics on CUDA and two runs
    differ in the last bits. ``unsafe=True`` skips segment_reduce's checks
    of the offsets, which read them on the host (a layout's offsets are
    checked when it is built), so a CUDA graph can capture it."""

    @staticmethod
    def forward(ctx, a_src, a_dst, layout):
        ctx.layout = layout
        return gather_rows(a_src, layout.src) + gather_rows(a_dst, layout.dst)

    @staticmethod
    def backward(ctx, g):
        L = ctx.layout
        d_dst = torch.segment_reduce(g, "sum", offsets=L.row_offsets.long(),
                                     unsafe=True)
        d_src = torch.segment_reduce(gather_rows(g, L.csc_perm), "sum",
                                     offsets=L.csc_offsets.long(),
                                     unsafe=True)
        return d_src, d_dst, None


def edge_logits(conv: GATConv, edge_attr, n_edges: int, cdt=torch.float32):
    """The edge-feature term of the logits [E, H] (reference
    conv.py:207-215): (edge_attr @ lin_edge) . att_edge per head, or None
    without edge_attr or lin_edge. Dim-1 attributes may come as [E]."""
    if edge_attr is None or conv.lin_edge is None:
        return None
    ea = linear(edge_attr.reshape(n_edges, -1), conv.lin_edge, cdt)
    return (ea.reshape(n_edges, conv.heads, -1)
            * conv.att_edge[0].to(cdt)).sum(-1)


def gat_relation(conv: GATConv, h_src, h_dst, layout, negative_slope: float,
                 temperature: float, mode: str = "softmax", keep=None,
                 edge_attr=None, cdt=torch.float32, sdt=None,
                 f32_logits=False):
    """One relation's GAT layer, one pass per head: the head's projections
    (each its own contiguous [N, C] product), the per-edge logits
    leaky_relu(a_src[src] + a_dst[dst] (+ the edge_attr term)) / temperature
    (plain tensor code; the gathers' backward in a fixed order,
    EdgeLogits), then
      * softmax: segment_softmax.SegmentSoftmaxSpmm (kernels #6 and #7) over
        the relation's one-slot layout;
      * sigmoid: the weights sigmoid(logit) (0 on pad edges) and
        segment.CSRSegmentSum (kernel #10; its backward, #8, gives the
        weights their gradient);
    the heads concatenated, then the bias. [N_dst_pad, H*C].

    keep: the dropout's per-edge, per-head multiplier [E, H] (keep_e / (1 -
    p)) applied after the softmax or sigmoid, or None. edge_attr: the
    relation's edge features [E, edge_dim] (or [E]), or None. cdt: the
    compute dtype; sdt: the stream dtype the messages are rounded to
    (None: none), and the logits with them unless f32_logits (apply_gat's
    stream_dtype and stream_f32_logits). The softmax mode's output is
    float32 (#6 on bf16 messages computes in float32)."""
    n_edges = layout.src.shape[0]
    e_term = edge_logits(conv, edge_attr, n_edges, cdt)
    if mode == "sigmoid":
        valid = (torch.arange(n_edges, device=layout.src.device)
                 < layout.rel_num_edges[0])
    outs = []
    for h in range(conv.heads):
        xs = matmul(h_src, conv.head_rows(conv.lin_src.weight, h).T, cdt)
        # homogeneous relations: lin_src projects the destination end too
        xd = xs if conv.lin_dst is None else matmul(
            h_dst, conv.head_rows(conv.lin_dst.weight, h).T, cdt)
        xs_logit = xs
        if sdt is not None:
            xs = xs.to(sdt)
            if not f32_logits:
                xs_logit = xs
        a_src = (xs_logit * conv.att_src[0, h].to(cdt)).sum(-1)
        a_dst = (xd * conv.att_dst[0, h].to(cdt)).sum(-1)
        z = EdgeLogits.apply(a_src, a_dst, layout)
        if e_term is not None:
            z = z + e_term[:, h]
        logits = leaky_relu(z, negative_slope) / temperature
        mult = None if keep is None else keep[:, h].contiguous()
        if mode == "sigmoid":
            w = torch.where(valid, torch.sigmoid(logits), 0.0)
            outs.append(CSRSegmentSum.apply(
                xs, w if mult is None else w * mult, layout))
        else:
            outs.append(SegmentSoftmaxSpmm.apply(xs, logits, layout, mult))
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=-1)
    return out + conv.bias.to(cdt)


def sage_relation(conv: SAGEConv, h_src, h_dst, layout, cdt=torch.float32):
    """One relation's SAGE layer (apply_sage): the CSR segment sum (#10;
    backward #8) of the source rows over the relation's stream, times
    1/deg over its real edges (layout.inv_deg), then lin_l + lin_r(h_dst)."""
    summed = CSRSegmentSum.apply(h_src, None, layout) * layout.inv_deg[:, None]
    return (linear(summed.to(h_src.dtype), conv.lin_l, cdt)
            + linear(h_dst, conv.lin_r, cdt))


def gcn_relation(conv: GCNConv, h_src, layout, cdt=torch.float32):
    """One relation's GCN layer (apply_gcn): lin(h_src) summed with the
    symmetric norm of the relation's real edges (layout.sym_e, 0 on pad
    edges; in the messages' dtype), plus bias."""
    xp = matmul(h_src, conv.lin.weight.T, cdt)
    summed = CSRSegmentSum.apply(xp, layout.sym_e.to(xp.dtype), layout)
    return summed.to(xp.dtype) + conv.bias.to(cdt)


def sgc_relation(conv: SGConv, h_src, layout, cdt=torch.float32):
    """One relation's SGC layer (apply_sgc, K=1): lin of the symmetric-
    normalised sum of the source rows."""
    summed = CSRSegmentSum.apply(h_src, layout.sym_e.to(h_src.dtype), layout)
    return linear(summed.to(h_src.dtype), conv.lin, cdt)
