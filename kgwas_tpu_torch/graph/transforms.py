"""Graph transforms mirroring PyG's ToUndirected / AddSelfLoops semantics.

The reference applies ``T.ToUndirected()(data); T.AddSelfLoops()(data)`` at KG
load time (reference kgwas/kgwas_data.py:271-272). Downstream relation
inventories (``rev_*`` names, reference kgwas/utils.py:501,535,595) depend on
these exact semantics, so we reproduce them:

ToUndirected (PyG semantics):
  * bipartite edge type (src_type != dst_type): add a NEW relation
    ``(dst_type, 'rev_' + rel, src_type)`` with flipped [dst, src] indices.
  * homogeneous edge type (src_type == dst_type): symmetrize in place —
    concatenate flipped edges and coalesce (sort + dedupe).

AddSelfLoops (PyG semantics):
  * homogeneous edge types only (bipartite skipped): append all (i, i),
    i in [0, N) — no dedupe against existing self loops.
"""
from __future__ import annotations

import numpy as np

from ..engine.profiling import span
from ..native import shardops
from .schema import HeteroGraph

REV_PREFIX = "rev_"


def coalesce(edge_index: np.ndarray, num_src: int, num_dst: int) -> np.ndarray:
    """Sort edges as PyG's coalesce does (by row = src, then col = dst) and
    remove duplicates (native/shardops.coalesce). Returns int64 [2, E']."""
    if edge_index.shape[1] == 0:
        return edge_index.astype(np.int64)
    return np.stack(shardops.coalesce(edge_index[0], edge_index[1], num_dst))


def to_undirected(g: HeteroGraph) -> HeteroGraph:
    new_edges = {}
    for et, ei in g.edge_index.items():
        src_t, rel, dst_t = et
        if src_t == dst_t:
            flipped = ei[::-1]
            both = np.concatenate([ei, flipped], axis=1)
            n = g.num_nodes(src_t)
            new_edges[et] = coalesce(both, n, n)
        else:
            new_edges[et] = ei.astype(np.int64)
            rev_et = (dst_t, REV_PREFIX + rel, src_t)
            new_edges[rev_et] = ei[::-1].astype(np.int64)
    g.edge_index = new_edges
    return g


def add_self_loops(g: HeteroGraph) -> HeteroGraph:
    for et in list(g.edge_index.keys()):
        src_t, _, dst_t = et
        if src_t != dst_t:
            continue
        n = g.num_nodes(src_t)
        loops = np.arange(n, dtype=np.int64)
        loop_ei = np.stack([loops, loops])
        g.edge_index[et] = np.concatenate([g.edge_index[et], loop_ei], axis=1)
    return g


@span("kgwas.data.transforms")
def standard_kg_transforms(g: HeteroGraph) -> HeteroGraph:
    """The exact transform pipeline of reference kgwas/kgwas_data.py:271-272."""
    return add_self_loops(to_undirected(g))
