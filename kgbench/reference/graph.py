"""The reference KG transforms in plain PyTorch: PyG's ToUndirected then
AddSelfLoops, as the reference ``kgwas_data.py`` applies them at load time.

  * a bipartite relation (s, r, d) keeps its edges and gains (d, rev_r, s)
    with the edges flipped;
  * a homogeneous relation is symmetrised: its edges and their flips,
    duplicates removed (PyG's coalesce);
  * then every homogeneous relation gains the loops (i, i), i < N, without
    removing loops already there.

Also the shapes of each destination group that the model's forward runs,
for the benchmark's operation counts.
"""
from __future__ import annotations

import torch

from ..inputs.params import REV


def transform(edges: dict, num_nodes: dict) -> dict:
    """(src, rel, dst) -> (src int64 [E], dst int64 [E]) after the
    transforms, on the edges' device."""
    out = {}
    for (s, r, d), ei in edges.items():
        src, dst = ei[0], ei[1]
        if s != d:
            out[(s, r, d)] = (src, dst)
            out[(d, REV + r, s)] = (dst, src)
            continue
        n = num_nodes[s]
        key = torch.cat([src * n + dst, dst * n + src])
        key = torch.unique(key)
        loops = torch.arange(n, device=src.device)
        out[(s, r, d)] = (torch.cat([key // n, loops]),
                          torch.cat([key % n, loops]))
    return out


def live_groups(rels: dict, layers: int, head_type: str = "SNP"):
    """(per layer, the destination types whose output reaches the head; the
    node types the encoders must give). A GAT layer reads its destination's
    own row (a_dst) and every source type of the relations into it."""
    need = {head_type}
    per_layer = []
    for _ in range(layers):
        live = sorted(need)
        per_layer.append(live)
        need = set(live) | {s for (s, _, d) in rels if d in live}
    return per_layer[::-1], need


def group_shapes(rels: dict, num_nodes: dict, layers: int,
                 head_type: str = "SNP") -> list:
    """Per layer, per live destination type: {"dst", "R" relations, "N"
    destination rows, "S" source rows (the relations' source tables
    stacked), "E" edges, "src_rows" {source type: rows projected}}."""
    per_layer, _ = live_groups(rels, layers, head_type)
    out = []
    for live in per_layer:
        groups = []
        for d in live:
            into = [(s, r) for (s, r, dd) in rels if dd == d]
            src_rows = {}
            for s, _ in into:
                src_rows[s] = src_rows.get(s, 0) + num_nodes[s]
            groups.append({
                "dst": d, "R": len(into), "N": num_nodes[d],
                "S": sum(num_nodes[s] for s, _ in into),
                "E": sum(int(rels[(s, r, d)][0].numel()) for s, r in into),
                "src_rows": src_rows})
        out.append(groups)
    return out
