"""Per-relation graph convolutions: GAT, SAGE, GCN and SGC parameters, and
the per-relation GAT layer.

Counterpart of ``kgwas_tpu/models/convs.py`` (``init_gat`` / ``apply_gat``'s
fused branch, ``init_sage``, ``init_gcn``, ``init_sgc``). Parameter names
are PyG's, as the reference ``model.py`` holds them, so a reference
``model.pt`` loads as it is:

  * GATConv: ``lin_src``, ``lin_dst`` (not for homogeneous relations: there
    ``lin_src`` projects both ends), ``att_src``, ``att_dst`` [1, H, C],
    ``bias``
  * SAGEConv: ``lin_l`` (with bias) on the mean of the source rows,
    ``lin_r`` (without) on the destination row
  * GCNConv: ``lin`` (without bias) before the normalised sum, ``bias``
  * SGConv (K=1): ``lin`` (with bias) after the normalised sum

The message-passing layer of SAGE, GCN and SGC runs merged over each
destination group (``hetero_gnn.HeteroGNN.mp_layer``); the GAT layer runs
merged for sum and mean and per relation (``gat_relation``) for max and
min.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.segment_ref import gather_rows, leaky_relu
from ..ops.segment_softmax import SegmentSoftmaxSpmm
from .init import glorot_att, glorot_weight, torch_linear_bias, torch_linear_weight


def _linear(in_dim, out, weight, bias=None):
    lin = nn.Linear(in_dim, out, bias=bias is not None)
    with torch.no_grad():
        lin.weight.copy_(weight)
        if bias is not None:
            lin.bias.copy_(bias)
    return lin


class GATConv(nn.Module):
    """One relation's GAT parameters (PyG GATConv names). Homogeneous
    relations have no lin_dst: lin_src projects both ends."""

    def __init__(self, in_dim: int, out: int, heads: int, share_dst: bool,
                 gen: torch.Generator):
        super().__init__()
        self.lin_src = _linear(in_dim, heads * out,
                               glorot_weight(gen, in_dim, heads * out))
        self.lin_dst = (None if share_dst else _linear(
            in_dim, heads * out, glorot_weight(gen, in_dim, heads * out)))
        self.att_src = nn.Parameter(glorot_att(gen, heads, out))
        self.att_dst = nn.Parameter(glorot_att(gen, heads, out))
        self.bias = nn.Parameter(torch.zeros(heads * out))

    def dst_weight(self):
        return (self.lin_src if self.lin_dst is None else self.lin_dst).weight


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


def make_conv(backbone: str, hidden: int, heads: int, share_dst: bool,
              gen: torch.Generator) -> nn.Module:
    """One relation's conv at width hidden, drawn from gen in the order the
    JAX package's init_* functions draw."""
    if backbone == "GAT":
        return GATConv(hidden, hidden, heads, share_dst, gen)
    if backbone == "SAGE":
        return SAGEConv(hidden, hidden, hidden, gen)
    if backbone == "GCN":
        return GCNConv(hidden, hidden, gen)
    if backbone == "SGC":
        return SGConv(hidden, hidden, gen)
    raise ValueError(f"unknown backbone {backbone!r}")


def gat_relation(conv: GATConv, h_src, h_dst, layout, negative_slope: float,
                 temperature: float):
    """One relation's GAT layer, softmax mode, one head: the projections,
    the per-edge logits leaky_relu(a_src[src] + a_dst[dst]) / temperature
    (plain tensor code), then segment_softmax.SegmentSoftmaxSpmm (kernels
    #6 and #7) over the relation's one-slot layout, then the bias.
    [N_dst_pad, C]."""
    xs = h_src @ conv.lin_src.weight.T
    # homogeneous relations: lin_src projects the destination end too
    xd = xs if conv.lin_dst is None else h_dst @ conv.lin_dst.weight.T
    a_src = (xs * conv.att_src[0, 0]).sum(-1)
    a_dst = (xd * conv.att_dst[0, 0]).sum(-1)
    logits = leaky_relu(gather_rows(a_src, layout.src)
                        + gather_rows(a_dst, layout.dst),
                        negative_slope) / temperature
    return SegmentSoftmaxSpmm.apply(xs, logits, layout) + conv.bias
