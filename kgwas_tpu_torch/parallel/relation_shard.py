"""The per-relation and 'mp' layers over the mesh's 'data' axis: each rank
runs the layer kernels on its own block of each destination stream's rows.

Counterpart of the JAX package's GSPMD partition of the paths outside its
merged gate (``kgwas_tpu/parallel/shard.py``: ``_gspmd_cfg``, and
``graph_shardings``' rows and edges over 'data'), with the merged layer's
scheme (``merged_shard.py``):

  * a stream's rows split contiguously by whole row tiles (rank i owns
    tiles [floor(i * T / n), floor((i + 1) * T / n)), ``mesh.split_bounds``)
    with exactly the edges that target them: a contiguous slice of the
    stream's CSR (``rank_stream``). Its pad edges read source row 0 and
    sit on the destination trash row, so they belong to the rank that owns
    that row; the rank's CSC is the stream's restricted to its edges, over
    the full source space, so their cotangents go to the source trash row
    as on one device;
  * the source table is projected on the rank's block of source rows and
    all-gathered (the halo exchange; its gradient, the reduce-scatter of
    ``d_xs``, hands each rank the sum for its rows): ``RankStream.source``;
  * the per-relation path (``RankRelations``: GAT with max / min /
    ``edge_dim`` / dropout in training, per relation and head #6 and #7, or
    #10 with the sigmoid; SAGE, GCN and SGC with max / min, #10) runs
    ``models/convs.py``'s relation layers on the rank's streams, each
    relation's rows aggregated on the rank and all-gathered once per
    destination type;
  * the 'mp' path (``mp_rank_stream``: SAGE, GCN and SGC with sum or
    mean) runs #10 over the rank's rows of the merged layout (its
    ``CSR_MAX_EDGES`` schedule), all-gathers the sums, and keeps the dense
    maps after them replicated;
  * every backward is #8 without the logit term over the rank's CSC.

Blocks of unequal sizes go through the collectives padded to the largest.
A rank whose block holds no row of a stream launches no kernel for it and
takes part in the collectives alone (its output a function of the gathered
table, so the reduce-scatter of the backward runs on every rank).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..models.hetero_gnn import DeviceLayout, merged_mp_norms, relation_norms
from ..ops.schedule import CSR_CHUNK_EDGES, CSR_MAX_EDGES, row_schedule
from ..ops.segment import csc_fields
from ..ops.split import SplitCall, base_groups
from .merged_shard import TILE
from .mesh import Mesh, all_gather_rows, split_bounds


def row_blocks(n_rows: int, n_dev: int) -> list:
    """The ranks' row bounds of a stream of n_rows rows: whole tiles of
    TILE rows (the last tile may be short), split_bounds over the tiles."""
    tiles = split_bounds(-(-n_rows // TILE), n_dev)
    return [min(t * TILE, n_rows) for t in tiles]


@dataclass
class RankStream:
    """One rank's block of one edge stream: rows r0..r1 of the stream's
    row space, edges e0..e1 (the CSR's slice), and layout, that block as
    a one-slot DeviceLayout (src into the full source table; row_offsets,
    dst and csc_rows local; its CSC over the full source space; its rows'
    schedule; rel_num_edges its real edges; inv_deg and sym_e its slices),
    None for a block without rows. x_lo..x_hi: the source rows this rank
    projects; x_sizes and row_sizes: every rank's blocks (the
    collectives'); group: the 'data' axis, None in one process (then the
    table is the whole one, and the collectives are the identity)."""

    rows: tuple
    edges: tuple
    layout: Optional[DeviceLayout]
    x_lo: int
    x_hi: int
    x_sizes: tuple
    row_sizes: tuple
    group: object = None

    @property
    def empty(self) -> bool:
        return self.layout is None

    def source(self, table):
        """The stream's source table: table(lo, hi) gives rows lo..hi of it
        (projected). Over a group the rank's rows x_lo..x_hi, all-gathered;
        without one the whole table."""
        if self.group is None:
            return table(0, None)
        return all_gather_rows(table(self.x_lo, self.x_hi), self.group,
                               self.x_sizes)

    def gather(self, out):
        """The stream's rows from every rank's block of them."""
        return all_gather_rows(out, self.group, self.row_sizes)


def rank_stream(src, dst, row_offsets, csc_perm, csc_ids, n_src: int,
                num_real: int, n_dev: int, i: int, device, group=None,
                sched_args=(), inv_deg=None, sym_e=None, rel_keys=(),
                src_types=()) -> RankStream:
    """Rank i of n_dev's RankStream of a dst-sorted stream (host numpy
    arrays: src [E] into the n_src source rows, dst [E] rows, row_offsets
    [n_rows + 1], its CSC csc_perm / csc_ids; a relation's first num_real
    edges real, None for a merged stream). sched_args: row_schedule's
    (max_edges, chunk_edges) for the rows (the segment softmax kernels'
    and a relation's CSR sum take the default, the merged 'mp' stream
    CSR_MAX_EDGES); inv_deg [n_rows] and sym_e [E]: the degree norms,
    sliced to the block."""
    n_rows = len(row_offsets) - 1
    rb = row_blocks(n_rows, n_dev)
    r0, r1 = rb[i], rb[i + 1]
    e0, e1 = int(row_offsets[r0]), int(row_offsets[r1])
    xb = split_bounds(n_src, n_dev)
    part = dict(rows=(r0, r1), edges=(e0, e1), x_lo=xb[i], x_hi=xb[i + 1],
                x_sizes=tuple(np.diff(xb).tolist()),
                row_sizes=tuple(np.diff(rb).tolist()), group=group)
    if r1 == r0:
        return RankStream(layout=None, **part)
    put = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a)).to(device)
    ro = (np.asarray(row_offsets[r0:r1 + 1], np.int64) - e0).astype(np.int32)
    rows = (np.asarray(dst[e0:e1], np.int64) - r0).astype(np.int32)
    # each edge's source row as the stream's CSC routes it (a pad edge: the
    # trash row), restricted to the block's edges in their stable order
    key = np.empty(len(src), np.int64)
    key[np.asarray(csc_perm, np.int64)] = csc_ids
    key = key[e0:e1]
    perm = np.argsort(key, kind="stable").astype(np.int32)
    offsets = np.zeros(n_src + 1, np.int32)
    np.cumsum(np.bincount(key, minlength=n_src), out=offsets[1:])
    n_loc = r1 - r0
    layout = DeviceLayout(
        rel_keys=list(rel_keys), src_types=list(src_types),
        n_rows_per_rel=n_loc, src_base=(0, n_src),
        src=put(np.asarray(src[e0:e1], np.int32)), row_offsets=put(ro),
        dst=put(rows), csc_perm=put(perm), csc_offsets=put(offsets),
        edge_base=(0, e1 - e0),
        rel_num_edges=(() if num_real is None else
                       (int(np.clip(num_real - e0, 0, e1 - e0)),)),
        inv_deg=None if inv_deg is None else put(inv_deg[r0:r1]),
        sym_e=None if sym_e is None else put(sym_e[e0:e1]),
        row_schedule=row_schedule(ro, *sched_args).to(device),
        **csc_fields(rows, perm, offsets, n_loc, (0, n_src), 0, device))
    return RankStream(layout=layout, **part)


def relation_rank_stream(r, cg, n_dev: int, i: int, device, group=None):
    """Rank i's block of a relation stream (graph/shard_compile.
    RelationShard), with its degree norms over the real edges, as
    device_layouts' relation() builds the whole one."""
    n = int(cg.padded_nodes[r.dst_type])
    n_src = int(cg.padded_nodes[r.src_type])
    inv_deg, sym_e = relation_norms(r, n_src, n)
    return rank_stream(r.src, r.dst, r.row_offsets, r.csc_perm,
                       r.csc_src_sorted, n_src, int(r.num_edges), n_dev, i,
                       device, group, inv_deg=inv_deg, sym_e=sym_e,
                       rel_keys=[r.key], src_types=[r.src_type])


def mp_rank_stream(L, n_dev: int, i: int, device, group=None):
    """Rank i's block of a merged layout's R * N rows for the 'mp' path,
    with its degree norms (merged_mp_norms) and the CSR sum's schedule."""
    inv_deg, sym_e = merged_mp_norms(L)
    return rank_stream(L.src, L.dst, L.row_offsets, L.csc_perm, L.csc_ids,
                       int(L.n_src_total), None, n_dev, i,
                       device, group, (CSR_MAX_EDGES, CSR_CHUNK_EDGES),
                       inv_deg, sym_e, list(L.rel_keys), list(L.src_types))


class RankRelations:
    """One destination group's relation streams on this rank of the 'data'
    axis (HeteroGNN.relation_layer's rank_fns): one RankStream per slot, in
    slot order. The relations share the destination's row space, so the
    rank owns the same rows rows[0]..rows[1] of each."""

    def __init__(self, L, cg, mesh: Mesh, device):
        self.streams = [relation_rank_stream(
            cg.relations[rk], cg, mesh.data, mesh.data_rank, device,
            mesh.data_group) for rk in L.rel_keys]
        self.rows = self.streams[0].rows
        self.gather = self.streams[0].gather


def make_relation_fns(layouts: dict, cg, mesh: Mesh, device) -> dict:
    """dst_type -> RankRelations for every destination type of the merged
    layouts given (a split group's sub-layouts share one): the rank's
    blocks of the relation streams, built once per mesh."""
    return {t: RankRelations(subs[0][1], cg, mesh, device)
            for t, subs in base_groups(layouts).items()}


def make_mp_fns(layouts: dict, mesh: Mesh, device) -> dict:
    """dst type -> the rank's RankStream of each merged layout for the 'mp'
    path (HeteroGNN.mp_layer's rank_fns), a split group's dst-range
    sub-layouts' rows each blocked like any layout's and held in node order
    by a SplitCall; built once per mesh."""
    out = {}
    for t, subs in base_groups(layouts).items():
        ranks = [mp_rank_stream(L, mesh.data, mesh.data_rank, device,
                                mesh.data_group) for _, L in subs]
        out[t] = ranks[0] if subs[0][1].base_type is None else SplitCall(
            ranks, [L.n_rows_per_rel for _, L in subs],
            len(subs[0][1].rel_keys))
    return out
