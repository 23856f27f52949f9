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

Dst-range sub-layouts (``split_merged_layout``, the JAX package's): with
``KGWAS_MERGED_MAX_EDGES`` set, a group whose stream holds more edges than
its cap is replaced by sub-layouts ``"<type>@<k>"``, each over one range of
the destination's nodes (whole row tiles) in every slot, with the same
concatenated source space. The softmax is per destination row, so the
split is exact; it bounds each launch's [E, D] transients.

The TPU-only reorderings of this stream (chunked, windowed, owned-plain)
are not part of the port: the CUDA kernel reads the plain stream and
gathers its source rows itself. The stable sorts and CSR offsets run
through the native ops (``native/shardops.py``).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from ..native import shardops
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
    # a dst-range sub-layout (split_merged_layout) covers the nodes
    # node_base .. node_base + n_rows_per_rel of base_type (None for a
    # whole group), and keeps its parent's source degrees [n_src_total]
    # (the GCN / SGC norms count every edge of a source row)
    base_type: Optional[str] = None
    node_base: int = 0
    parent_src_deg: Optional[np.ndarray] = None


MAX_EDGES_ENV = "KGWAS_MERGED_MAX_EDGES"


def max_edges_setting() -> str:
    """The dst-range split's setting (MAX_EDGES_ENV; "0", splitting
    nothing, where it is unset or empty)."""
    return os.environ.get(MAX_EDGES_ENV, "0") or "0"


def build_merged_layouts(cg: CompiledGraph, tile_rows: int,
                         max_edges: Optional[str] = None
                         ) -> Dict[str, MergedDstLayout]:
    """One MergedDstLayout per destination node type of the compiled graph,
    each whose stream holds more edges than max_edges allows replaced by
    its dst-range sub-layouts (split_oversized_layouts; max_edges: one
    integer or 'Type:edges,...,default:edges', _parse_max_edges; by default
    the environment's max_edges_setting, as the JAX package reads it).
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
        csc_perm = shardops.stable_order(src_key, n_src_total
                                         ).astype(np.int32)
        csc_ids = src_key[csc_perm].astype(np.int32)
        csc_offsets = shardops.csr_offsets(csc_ids, n_src_total)

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

    spec = max_edges_setting() if max_edges is None else max_edges
    if spec != "0":
        layouts = split_oversized_layouts(layouts, _parse_max_edges(spec),
                                          tile_rows)
    return layouts


def split_merged_layout(L: MergedDstLayout, n_parts: int,
                        tile_rows: int) -> List[MergedDstLayout]:
    """Split one merged layout into at most n_parts dst-node-range
    sub-layouts (the JAX package's split_merged_layout): sub k covers nodes
    [k * n_sub, (k + 1) * n_sub) of the padded dst space in every slot
    (n_sub a tile multiple), with the same concatenated source space, so
    each sub's backward adds into the same source table's gradient. Its
    edges are the parent's on those rows, in the parent's order; a slot's
    pad edges sit on its trash row and land in the sub that holds it, so
    each slot's first rel_num_edges edges stay its real ones."""
    N = L.n_rows_per_rel
    R = len(L.rel_keys)
    n_sub = ((N + n_parts - 1) // n_parts + tile_rows - 1
             ) // tile_rows * tile_rows
    rel_of_edge = L.dst.astype(np.int64) // N
    node = L.dst.astype(np.int64) - rel_of_edge * N
    real = np.zeros(len(L.src), dtype=bool)
    for r in range(R):
        real[L.edge_base[r]:L.edge_base[r] + L.rel_num_edges[r]] = True
    # GCN / SGC take the parent's source degrees: a sub's own stream holds
    # only its destination range's edges
    parent_src_deg = (L.parent_src_deg if L.parent_src_deg is not None
                      else np.bincount(L.src, minlength=L.n_src_total
                                       ).astype(np.float32))
    subs = []
    for k, b in enumerate(range(0, N, n_sub)):
        rows = min(b + n_sub, N) - b
        if rows % tile_rows:
            raise ValueError(f"{L.dst_type}: sub-layout rows {rows} are not "
                             f"a multiple of tile_rows={tile_rows}")
        mask = (node >= b) & (node < b + rows)
        # the parent stream is slot-major, dst-ascending in each slot, so
        # the masked stream is sorted under the remapped rows
        sub_src = L.src[mask]
        sub_rel = rel_of_edge[mask]
        sub_dst = sub_rel * rows + (node[mask] - b)
        n_rows_total = R * rows
        edge_base = np.zeros(R + 1, dtype=np.int64)
        np.cumsum(np.bincount(sub_rel, minlength=R), out=edge_base[1:])
        csc_perm = shardops.stable_order(sub_src, L.n_src_total
                                         ).astype(np.int32)
        csc_ids = sub_src[csc_perm].astype(np.int32)
        subs.append(MergedDstLayout(
            dst_type=f"{L.dst_type}@{k}",
            rel_keys=list(L.rel_keys),
            src_types=list(L.src_types),
            n_rows_per_rel=rows,
            n_rows_total=int(n_rows_total),
            src=sub_src.astype(np.int32),
            dst=sub_dst.astype(np.int32),
            row_offsets=shardops.csr_offsets(sub_dst, n_rows_total
                                             ).astype(np.int32),
            tile2rel=np.repeat(np.arange(R, dtype=np.int32),
                               rows // tile_rows),
            num_edges=int(mask.sum()),
            src_base=np.asarray(L.src_base, np.int32),
            n_src_total=L.n_src_total,
            csc_perm=csc_perm,
            csc_ids=csc_ids,
            csc_offsets=shardops.csr_offsets(csc_ids, L.n_src_total
                                             ).astype(np.int32),
            edge_base=edge_base.astype(np.int32),
            rel_num_edges=np.bincount(sub_rel[real[mask]], minlength=R
                                      ).astype(np.int32),
            base_type=L.base_type or L.dst_type,
            node_base=L.node_base + b,
            parent_src_deg=parent_src_deg,
        ))
    return subs


def _parse_max_edges(spec: str):
    """KGWAS_MERGED_MAX_EDGES: one integer (every group's cap) or
    'Type:edges,Type2:edges,default:edges'; a cap of 0 splits nothing.
    Returns dst type -> its cap."""
    if ":" not in spec:
        n = int(spec)
        return lambda t: n
    table = {}
    for part in spec.split(","):
        k, v = part.split(":")
        table[k.strip()] = int(v)
    default = table.get("default", 0)
    return lambda t: table.get(t, default)


def split_oversized_layouts(layouts: Dict[str, MergedDstLayout], cap_fn,
                            tile_rows: int) -> Dict[str, MergedDstLayout]:
    """Every layout whose stream holds more edges than its cap (cap_fn:
    dst type -> edges, or one int) replaced by its dst-range sub-layouts,
    as many as the cap needs and the row tiles allow."""
    if isinstance(cap_fn, int):
        n = cap_fn
        cap_fn = lambda t: n  # noqa: E731
    out: Dict[str, MergedDstLayout] = {}
    for dst_t, L in layouts.items():
        max_edges = cap_fn(dst_t)
        if max_edges <= 0 or len(L.src) <= max_edges:
            out[dst_t] = L
            continue
        n_parts = min(-(-len(L.src) // max_edges),
                      L.n_rows_per_rel // tile_rows)
        for sub in split_merged_layout(L, n_parts, tile_rows):
            out[sub.dst_type] = sub
    return out
