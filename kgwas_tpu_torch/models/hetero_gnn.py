"""HeteroGNN: the KGWAS model as an ``nn.Module``.

Counterpart of ``kgwas_tpu/models/hetero_gnn.py`` (``init_hetero_gnn`` and
``_apply_hetero_gnn`` on the merged GAT path, ``apply_merged_gat_layer``):

  1. per-type SimpleMLP encoders -> hidden (one GO MLP shared by the three
     GO types)
  2. per layer, for each destination type whose output reaches the head
     (``HeteroGNN.live_groups``), ONE merged GAT layer over every
     relation targeting it (``ops/gat_layer.MergedGATLayer``: the forward
     kernel, and the backward and CSC segment-sum kernels for its
     gradient), the cross-relation sum (or mean) folded into it, then the
     summed biases, then ReLU on every destination type
  3. the scalar head ReLU(Linear(h_SNP)) (or no ReLU)

Module and parameter names are the reference ``model.py``'s, so the
state_dict loads a reference ``model.pt`` as it is:
``snp_feat_mlp.*``, ``convs.{l}.convs.{src__rel__dst}.{lin_src, lin_dst,
att_src, att_dst, bias}`` (no ``lin_dst`` when src and dst types are the
same) and ``lin.*``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from ..config import ModelConfig
from ..graph.synthetic import GO_TYPES
from ..ops.gat_layer import MergedGATLayer
from .init import glorot_att, glorot_weight, torch_linear_bias, torch_linear_weight
from .mlp import SimpleMLP

_VARIANTS = "ROADMAP.md Queue 1 item 3 (model variants)"


def encoder_for(ntype: str) -> str:
    if ntype == "SNP":
        return "snp_feat_mlp"
    if ntype == "Gene":
        return "gene_feat_mlp"
    if ntype in GO_TYPES:
        return "go_feat_mlp"
    raise ValueError(f"unknown node type {ntype!r}")


def check_supported(cfg: ModelConfig):
    if cfg.gnn_backbone != "GAT":
        raise NotImplementedError(
            f"backbone {cfg.gnn_backbone!r} is not ported yet: {_VARIANTS}")
    if cfg.gat_num_head != 1:
        raise NotImplementedError(
            f"multi-head GAT ({cfg.gat_num_head} heads) is not ported yet: "
            f"{_VARIANTS}")
    if cfg.gnn_aggr not in ("sum", "mean"):
        raise NotImplementedError(
            f"aggr={cfg.gnn_aggr!r} is not ported yet (sum and mean are): "
            f"{_VARIANTS}")


class GATConv(nn.Module):
    """One relation's GAT parameters (PyG GATConv names). Homogeneous
    relations have no lin_dst: lin_src projects both ends."""

    def __init__(self, in_dim: int, out: int, heads: int, share_dst: bool,
                 gen: torch.Generator):
        super().__init__()
        self.lin_src = nn.Linear(in_dim, heads * out, bias=False)
        self.lin_dst = (None if share_dst
                        else nn.Linear(in_dim, heads * out, bias=False))
        with torch.no_grad():
            self.lin_src.weight.copy_(glorot_weight(gen, in_dim, heads * out))
            if self.lin_dst is not None:
                self.lin_dst.weight.copy_(
                    glorot_weight(gen, in_dim, heads * out))
        self.att_src = nn.Parameter(glorot_att(gen, heads, out))
        self.att_dst = nn.Parameter(glorot_att(gen, heads, out))
        self.bias = nn.Parameter(torch.zeros(heads * out))

    def dst_weight(self):
        return (self.lin_src if self.lin_dst is None else self.lin_dst).weight


class HeteroConv(nn.Module):
    def __init__(self, rel_types: Dict[str, tuple], hidden: int, heads: int,
                 gen: torch.Generator):
        super().__init__()
        self.convs = nn.ModuleDict({
            rk: GATConv(hidden, hidden, heads, src_t == dst_t, gen)
            for rk, (src_t, _, dst_t) in rel_types.items()
        })


@dataclass
class DeviceLayout:
    """One merged destination group's stream, on the device."""

    rel_keys: List[str]
    src_types: List[str]
    n_rows_per_rel: int
    src_base: Tuple[int, ...]  # slot r: source rows src_base[r]..[r+1]
    src: torch.Tensor          # int32 [E_tot], dst-sorted
    row_offsets: torch.Tensor  # int32 [R*N + 1]
    dst: torch.Tensor          # int32 [E_tot]: each edge's row
    csc_perm: torch.Tensor     # int32 [E_tot]: edges in source order
    csc_offsets: torch.Tensor  # int32 [S + 1]


def device_layouts(layouts, device) -> Dict[str, DeviceLayout]:
    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {
        t: DeviceLayout(
            rel_keys=list(L.rel_keys),
            src_types=list(L.src_types),
            n_rows_per_rel=int(L.n_rows_per_rel),
            src_base=tuple(int(b) for b in L.src_base),
            src=put(L.src),
            row_offsets=put(L.row_offsets),
            dst=put(L.dst),
            csc_perm=put(L.csc_perm),
            csc_offsets=put(L.csc_offsets),
        )
        for t, L in layouts.items()
    }


class HeteroGNN(nn.Module):
    def __init__(self, cfg: ModelConfig, rel_types: Dict[str, tuple],
                 snp_init_dim: int, gene_init_dim: int, go_init_dim: int,
                 seed: int = 0):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        h = cfg.gnn_hidden_dim
        gen = torch.Generator().manual_seed(int(seed))
        self.snp_feat_mlp = SimpleMLP(snp_init_dim, h, h, gen)
        self.go_feat_mlp = SimpleMLP(go_init_dim, h, h, gen)
        self.gene_feat_mlp = SimpleMLP(gene_init_dim, h, h, gen)
        self.convs = nn.ModuleList([
            HeteroConv(rel_types, h, cfg.gat_num_head, gen)
            for _ in range(cfg.gnn_num_layers)
        ])
        self.lin = nn.Linear(h, cfg.out_channels)
        with torch.no_grad():
            self.lin.weight.copy_(torch_linear_weight(gen, h, cfg.out_channels))
            self.lin.bias.copy_(torch_linear_bias(gen, h, cfg.out_channels))

    def merged_layer(self, layer: HeteroConv, h: Dict[str, torch.Tensor],
                     layouts: Dict[str, DeviceLayout]):
        """One hetero GAT layer, one kernel launch per destination group."""
        cfg = self.cfg
        mode = "sigmoid" if cfg.sigmoid_gat else "softmax"
        out = {}
        for dst_t, L in layouts.items():
            convs = [layer.convs[rk] for rk in L.rel_keys]
            n_rel = len(convs)
            att = torch.stack([c.att_src[0, 0] for c in convs])      # [R, D]
            # a_dst = (h @ W_dst) . att_dst == h @ (W_dst^T att_dst): one
            # [N, D] x [D, R] product instead of R projections
            v = torch.stack([c.att_dst[0, 0] @ c.dst_weight() for c in convs],
                            dim=1)
            a_dst_all = (h[dst_t] @ v).T.reshape(-1)
            xs_all = torch.cat([h[L.src_types[s]] @ convs[s].lin_src.weight.T
                                for s in range(n_rel)])
            agg = MergedGATLayer.apply(
                xs_all, att.contiguous(), a_dst_all.contiguous(), L, n_rel,
                mode, cfg.negative_slope, cfg.temperature)
            bias = convs[0].bias
            for c in convs[1:]:
                bias = bias + c.bias
            if cfg.gnn_aggr == "mean":
                agg = agg / n_rel
                bias = bias / n_rel
            out[dst_t] = agg + bias
        return out

    def live_groups(self, layouts: Dict[str, DeviceLayout]):
        """(per layer, the destination groups whose output reaches the
        head; the node types whose encoder output does). The last layer
        needs the SNP group alone, each layer before it the groups that the
        next layer reads: their source types and, for a_dst, their own.
        The JAX package's jit drops the other groups as dead code."""
        need = {"SNP"}
        per_layer = []
        for _ in self.convs:
            per_layer.append([t for t in layouts if t in need])
            need = need.union(*(layouts[t].src_types for t in need))
        return per_layer[::-1], need

    def forward(self, x: Dict[str, torch.Tensor],
                layouts: Dict[str, DeviceLayout]) -> torch.Tensor:
        """Full-graph forward. Returns pred [N_snp_pad, out_channels]."""
        groups, encoded = self.live_groups(layouts)
        h = {t: getattr(self, encoder_for(t))(xt) for t, xt in x.items()
             if t in encoded}
        for layer, live in zip(self.convs, groups):
            out = self.merged_layer(layer, h, {t: layouts[t] for t in live})
            h = {t: torch.relu(v) for t, v in out.items()}
        logits = self.lin(h["SNP"])
        return logits if self.cfg.no_relu else torch.relu(logits)
