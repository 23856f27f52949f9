"""Merged per-destination-type edge layout for the fused GAT layer kernel.

Counterpart of ``MergedDstLayout`` and ``build_merged_layouts`` in
``kgwas_tpu/graph/merged_layout.py``. Every relation targeting one
destination node type joins ONE edge stream:

  * row space = the concatenation of each relation's padded dst row block
    (relation slot r owns rows [r*N_pad, (r+1)*N_pad)), so per-relation
    softmax segments never cross relation boundaries and a row's slot is
    ``row // N_pad``
  * edge stream = the concatenation of the per-relation dst-sorted streams;
    src indices point into the concatenated projected-feature table
    xs_all = concat([h[src_type_r] @ W_r for r in slots])
  * the hetero 'sum' aggregation is the sum of the R row blocks

The TPU-only reorderings of this stream (chunked, windowed, owned-plain,
dst-range splits) are not part of the port: the CUDA kernel reads the
plain stream and gathers its source rows itself.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np

from .shard_compile import CompiledGraph, RelationShard


@dataclass
class MergedDstLayout:
    """Merged layout for one destination node type."""

    dst_type: str
    rel_keys: List[str]            # relation order (slot r)
    src_types: List[str]           # per slot
    n_rows_per_rel: int            # N_dst_pad (same for all slots)
    n_rows_total: int              # R * N_dst_pad
    # edge stream (concatenated, per-relation dst-sorted)
    src: np.ndarray                # int32 [E_tot] into concat src space
    dst: np.ndarray                # int32 [E_tot] into concat row space
    row_offsets: np.ndarray        # int32 [n_rows_total + 1]
    tile2rel: np.ndarray           # int32 [n_rows_total / tile_rows]
    num_edges: int                 # total real edges
    # concat src space: slot r owns rows [src_base[r], src_base[r+1])
    src_base: np.ndarray           # int32 [R + 1]
    n_src_total: int
    # CSC (source-sorted) over the concat src space
    csc_perm: np.ndarray           # int32 [E_tot]
    csc_ids: np.ndarray            # int32 [E_tot]
    csc_offsets: np.ndarray        # int32 [n_src_total + 1]
    # per-relation edge slices in the merged stream: slot r's edges are
    # edge_base[r] .. edge_base[r+1], its real ones the first
    # rel_num_edges[r] of them, in the relation's own order
    edge_base: np.ndarray          # int32 [R + 1]
    rel_num_edges: np.ndarray      # int32 [R]


def build_merged_layouts(cg: CompiledGraph, tile_rows: int
                         ) -> Dict[str, MergedDstLayout]:
    """One MergedDstLayout per destination node type of the compiled graph.
    Every node type's padded row count must be a multiple of tile_rows."""
    by_dst: Dict[str, List[RelationShard]] = {}
    for r in cg.relations.values():
        by_dst.setdefault(r.dst_type, []).append(r)

    layouts = {}
    for dst_t, rels in by_dst.items():
        rels = sorted(rels, key=lambda r: r.key)  # deterministic slot order
        n_pad = cg.padded_nodes[dst_t]
        if n_pad % tile_rows:
            raise ValueError(
                f"{dst_t}: padded rows {n_pad} are not a multiple of "
                f"tile_rows={tile_rows}")
        R = len(rels)

        src_base = np.zeros(R + 1, dtype=np.int64)
        for i, r in enumerate(rels):
            src_base[i + 1] = src_base[i] + cg.padded_nodes[r.src_type]
        n_src_total = int(src_base[-1])
        if n_src_total % tile_rows:
            raise ValueError(
                f"{dst_t}: concatenated source rows {n_src_total} are not a "
                f"multiple of tile_rows={tile_rows}")

        edge_base = np.zeros(R + 1, dtype=np.int64)
        for i, r in enumerate(rels):
            edge_base[i + 1] = edge_base[i] + len(r.src)

        src_parts, dst_parts, off_parts = [], [], []
        tile2rel = []
        for i, r in enumerate(rels):
            src_parts.append(r.src.astype(np.int64) + src_base[i])
            # pad edges of relation i point at its trash row within slot i
            dst_parts.append(r.dst.astype(np.int64) + i * n_pad)
            off_parts.append(r.row_offsets[:-1].astype(np.int64) + edge_base[i])
            tile2rel += [i] * (n_pad // tile_rows)
        src = np.concatenate(src_parts)
        dst = np.concatenate(dst_parts)
        row_offsets = np.concatenate(
            off_parts + [np.asarray([edge_base[-1]], dtype=np.int64)]
        )

        # pad edges are keyed to their slot's source trash row
        src_key = src.copy()
        for i, r in enumerate(rels):
            pad_slice = slice(edge_base[i] + r.num_edges, edge_base[i + 1])
            src_key[pad_slice] = src_base[i] + cg.num_nodes[r.src_type]
        csc_perm = np.argsort(src_key, kind="stable").astype(np.int32)
        csc_ids = src_key[csc_perm].astype(np.int32)
        counts = np.bincount(csc_ids, minlength=n_src_total)
        csc_offsets = np.zeros(n_src_total + 1, dtype=np.int64)
        np.cumsum(counts, out=csc_offsets[1:])

        layouts[dst_t] = MergedDstLayout(
            dst_type=dst_t,
            rel_keys=[r.key for r in rels],
            src_types=[r.src_type for r in rels],
            n_rows_per_rel=n_pad,
            n_rows_total=int(R * n_pad),
            src=src_key.astype(np.int32),
            dst=dst.astype(np.int32),
            row_offsets=row_offsets.astype(np.int32),
            tile2rel=np.asarray(tile2rel, dtype=np.int32),
            num_edges=int(sum(r.num_edges for r in rels)),
            src_base=src_base.astype(np.int32),
            n_src_total=n_src_total,
            csc_perm=csc_perm,
            csc_ids=csc_ids,
            csc_offsets=csc_offsets.astype(np.int32),
            edge_base=edge_base.astype(np.int32),
            rel_num_edges=np.asarray([r.num_edges for r in rels],
                                     dtype=np.int32),
        )
    return layouts
