"""Shard compiler: HeteroGraph -> static-shape, destination-sorted arrays.

Counterpart of ``kgwas_tpu/graph/shard_compile.py`` (``compile_graph``): the
stable sort by destination, the CSC's stable sort by source and the CSR
offsets run through the port's native ops (``native/shardops.py``: a
counting sort in C++), whose numpy versions give the same arrays.

Layout per relation (src_type, rel, dst_type):
  * ``src`` int32 [E_pad]  -- source node indices, destination-sorted order
  * ``dst`` int32 [E_pad]  -- destination node indices, ascending
  * pads at the tail: dst = trash_row(dst_type), src = 0
  * ``row_offsets`` int32 [N_pad+1] -- CSR offsets over dst

Layout per node type:
  * ``x`` float32 [N_pad, D] -- features, zero-padded rows
  * trash_row = N (real nodes are [0, N)); N_pad >= N+1 rounded up

Pad edges aggregate into the trash row, which no real node reads and which
is never the source of a real edge, so the forward is exact.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np

from ..native import shardops
from .schema import EdgeType, HeteroGraph, edge_key


def round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass
class RelationShard:
    key: str
    src_type: str
    rel: str
    dst_type: str
    src: np.ndarray          # int32 [E_pad]
    dst: np.ndarray          # int32 [E_pad]
    num_edges: int           # real edge count
    row_offsets: np.ndarray  # int32 [N_dst_pad + 1]
    # CSC view (source-sorted): perm maps src-sorted position -> dst-sorted
    # edge index; pad edges route to the source-side trash row
    csc_perm: np.ndarray        # int32 [E_pad]
    csc_src_sorted: np.ndarray  # int32 [E_pad]
    csc_offsets: np.ndarray     # int32 [N_src_pad + 1]


@dataclass
class CompiledGraph:
    node_x: Dict[str, np.ndarray]            # ntype -> [N_pad, D]
    num_nodes: Dict[str, int]                # real N per type
    padded_nodes: Dict[str, int]             # N_pad per type
    relations: Dict[str, RelationShard]      # edge_key -> shard
    edge_types: Tuple[EdgeType, ...]

    def total_real_edges(self) -> int:
        return sum(r.num_edges for r in self.relations.values())


def compile_graph(
    g: HeteroGraph,
    edge_pad_multiple: int = 512,
    node_pad_multiple: int = 8,
) -> CompiledGraph:
    g.validate()
    num_nodes = {t: g.num_nodes(t) for t in g.node_types}
    padded_nodes = {t: round_up(n + 1, node_pad_multiple)
                    for t, n in num_nodes.items()}

    node_x = {}
    for t in g.node_types:
        x = np.asarray(g.node_features[t], dtype=np.float32)
        n_pad = padded_nodes[t]
        if n_pad > x.shape[0]:
            x = np.concatenate(
                [x, np.zeros((n_pad - x.shape[0], x.shape[1]), dtype=x.dtype)],
                axis=0,
            )
        node_x[t] = x

    relations = {}
    for et in g.edge_types:
        src_t, rel, dst_t = et
        ei = np.asarray(g.edge_index[et])
        if ei.dtype.kind not in "iu":
            ei = ei.astype(np.int64)
        e = int(ei.shape[1])
        e_pad = max(round_up(e, edge_pad_multiple), edge_pad_multiple)
        trash = num_nodes[dst_t]

        # stable: keeps the input order within a destination
        order = shardops.stable_order(ei[1], num_nodes[dst_t])
        src_arr = np.zeros(e_pad, dtype=np.int32)
        dst_arr = np.full(e_pad, trash, dtype=np.int32)
        src_arr[:e] = ei[0].astype(np.int64)[order]
        dst_arr[:e] = ei[1].astype(np.int64)[order]

        row_offsets = shardops.csr_offsets(
            dst_arr, padded_nodes[dst_t]).astype(np.int32)
        # CSC: stable-sort edge positions by source (pads keyed to the
        # source-side trash row so they cluster at the tail)
        src_key = src_arr.astype(np.int64)
        src_key[e:] = num_nodes[src_t]
        csc_perm = shardops.stable_order(
            src_key, num_nodes[src_t] + 1).astype(np.int32)
        csc_src_sorted = src_key[csc_perm].astype(np.int32)
        csc_offsets = shardops.csr_offsets(
            csc_src_sorted, padded_nodes[src_t]).astype(np.int32)

        relations[edge_key(et)] = RelationShard(
            key=edge_key(et),
            src_type=src_t,
            rel=rel,
            dst_type=dst_t,
            src=src_arr,
            dst=dst_arr,
            num_edges=e,
            row_offsets=row_offsets,
            csc_perm=csc_perm,
            csc_src_sorted=csc_src_sorted,
            csc_offsets=csc_offsets,
        )

    return CompiledGraph(
        node_x=node_x,
        num_nodes=num_nodes,
        padded_nodes=padded_nodes,
        relations=relations,
        edge_types=tuple(g.edge_types),
    )
