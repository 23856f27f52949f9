"""The merged GAT layer over the mesh's 'data' axis: each rank runs the
layer's kernels on its rows.

Counterpart of ``kgwas_tpu/parallel/merged_shard.py``:

  * the merged row space of a destination group (R * N rows, slot-major)
    is split contiguously across the ranks of the 'data' axis by whole row
    tiles: rank i owns tiles [floor(i * T / n), floor((i + 1) * T / n)) of
    the T tiles, with exactly the edges that target them
    (``build_device_layouts``; where the tiles divide evenly, the JAX
    package's static numpy layouts, array for array);
  * forward: the projected source table ``xs_all`` is row-sharded the same
    way (rank i holds rows [floor(i * S / n), floor((i + 1) * S / n)) of
    the concatenated source space); the rank all-gathers it (the halo
    exchange) and runs the merged GAT forward kernel (#1,
    ``merged_gat_fwd.cu``) over its rows with its own schedule;
  * backward: the edge kernel (#2, ``merged_gat_bwd.cu``), then the CSC
    segment sum (#8, ``csc_segment_sum.cu``) over the rank's CSC against
    the full source space, then the reduce-scatter of ``d_xs`` (the
    all-gather's transpose) hands each rank the sum for its rows.

Blocks of unequal sizes go through the collectives padded to the largest
(``mesh.gather_rows``). A rank whose block holds no row tile launches no
kernel and takes part in the collectives alone.

The layer returns the rank's rows of the unfolded [R * N, D] output, as
the JAX package's shard_map'd layer does; the caller all-gathers them and
takes the cross-relation sum (``HeteroGNN.merged_layer`` with
``merged_fns``). The kernels number a row's relation slot row // N, so a
rank's rows run in the row space of the slots they touch ([s_lo * N,
s_hi * N): its other rows have no edges), with those slots' att and a_dst.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..graph.merged_layout import MergedDstLayout
from ..ops import gat_layer, segment
from ..ops.gat_layer import BWD_CHUNK_EDGES
from ..ops.split import SplitCall, base_groups
from .mesh import (Mesh, all_gather_rows, gather_rows, reduce_scatter_rows,
                   split_bounds)

# the JAX package's row tile and edge block (pallas_segment.BN, BE): rows
# split by whole tiles, per-rank edge arrays padded to a block multiple
TILE = 512
BE = 512


@dataclass
class DeviceMergedLayout:
    """Static per-device slices of a MergedDstLayout (leading axis =
    device), as the JAX package builds them."""

    n_dev: int
    rows_per_dev: int            # rows of the largest block
    e_dev: int                   # padded edges per device (common)
    src: np.ndarray              # int32 [n_dev, e_dev] (full src space ids)
    dst_local: np.ndarray        # int32 [n_dev, e_dev] (device-local rows)
    tile_starts: np.ndarray      # int32 [n_dev, tiles_per_dev + 1] (local)
    tile2rel: np.ndarray         # int32 [n_dev, tiles_per_dev]
    csc_perm: np.ndarray         # int32 [n_dev, e_dev]
    csc_ids: np.ndarray          # int32 [n_dev, e_dev]
    csc_offsets: np.ndarray      # int32 [n_dev, n_src_total + 1]
    n_src_total: int
    n_rows_total: int
    # rank d owns rows row_bounds[d]..[d + 1] and projects source rows
    # src_bounds[d]..[d + 1] (split_bounds; equal blocks where they divide)
    row_bounds: tuple = ()
    src_bounds: tuple = ()


def build_device_layouts(L: MergedDstLayout, n_dev: int) -> DeviceMergedLayout:
    """Rank d's rows (its block of row tiles, split_bounds), edges (padded
    to e_dev: pad edges read source row 0 and target row rows_per_dev, the
    largest block's row count) and CSC over the full source space (pad
    entries keyed to the last source row, so they sort last). A rank with
    fewer tiles than the largest block repeats its last tile start and
    slot in tile_starts and tile2rel."""
    n_tiles = -(-L.n_rows_total // TILE)
    tiles = split_bounds(n_tiles, n_dev)
    tpd = max(b - a for a, b in zip(tiles, tiles[1:]))
    row_bounds = np.minimum(np.asarray(tiles, np.int64) * TILE,
                            L.n_rows_total)
    rows_per_dev = min(tpd * TILE, L.n_rows_total)
    starts = L.row_offsets[::TILE]
    starts = np.concatenate([starts[:n_tiles],
                             L.row_offsets[-1:]])       # [n_tiles + 1]

    per_dev_edges = [int(starts[tiles[d + 1]] - starts[tiles[d]])
                     for d in range(n_dev)]
    e_dev = max(max(per_dev_edges), BE)
    e_dev = ((e_dev + BE - 1) // BE) * BE

    src = np.zeros((n_dev, e_dev), dtype=np.int32)
    dst_local = np.full((n_dev, e_dev), rows_per_dev, dtype=np.int32)
    tile_starts = np.zeros((n_dev, tpd + 1), dtype=np.int32)
    tile2rel = np.zeros((n_dev, tpd), dtype=np.int32)
    csc_perm = np.zeros((n_dev, e_dev), dtype=np.int32)
    csc_ids = np.zeros((n_dev, e_dev), dtype=np.int32)
    csc_offsets = np.zeros((n_dev, L.n_src_total + 1), dtype=np.int32)

    for d in range(n_dev):
        t0, t1 = tiles[d], tiles[d + 1]
        lo, hi = int(starts[t0]), int(starts[t1])
        e = hi - lo
        src[d, :e] = L.src[lo:hi]
        dst_local[d, :e] = L.dst[lo:hi] - row_bounds[d]
        ts = starts[t0:t1 + 1] - lo
        tile_starts[d, :len(ts)] = ts
        tile_starts[d, len(ts):] = ts[-1]
        if t1 > t0:
            tile2rel[d, :t1 - t0] = L.tile2rel[t0:t1]
            tile2rel[d, t1 - t0:] = L.tile2rel[t1 - 1]
        key = np.full(e_dev, L.n_src_total - 1, dtype=np.int64)
        key[:e] = src[d, :e]
        perm = np.argsort(key, kind="stable").astype(np.int32)
        csc_perm[d] = perm
        csc_ids[d] = key[perm].astype(np.int32)
        counts = np.bincount(csc_ids[d].astype(np.int64),
                             minlength=L.n_src_total)
        np.cumsum(counts, out=csc_offsets[d, 1:])

    return DeviceMergedLayout(
        n_dev=n_dev, rows_per_dev=rows_per_dev, e_dev=e_dev, src=src,
        dst_local=dst_local, tile_starts=tile_starts, tile2rel=tile2rel,
        csc_perm=csc_perm, csc_ids=csc_ids, csc_offsets=csc_offsets,
        n_src_total=L.n_src_total, n_rows_total=L.n_rows_total,
        row_bounds=tuple(int(r) for r in row_bounds),
        src_bounds=tuple(split_bounds(L.n_src_total, n_dev)))


class RankShard:
    """One rank's part of a destination group's merged layer, on its
    device: its edges (src into the full source space; rows in the space
    of the slots s_lo..s_hi it touches, its own rows at off..off +
    rows_per_dev there), their row offsets and the kernels' schedules, the
    CSC over the full source space (csc_segment_sum's DeviceLayout, rows
    in the group's R * N space), the rows of the full source table its
    slots own (src_base, for the bf16 instances' per-row scores), and the
    rows of the source table it projects (x_lo..x_hi)."""

    def __init__(self, L: MergedDstLayout, DL: DeviceMergedLayout, i: int,
                 device):
        n = L.n_rows_per_rel
        lo = DL.row_bounds[i]
        rpd = DL.row_bounds[i + 1] - lo
        self.rows_per_dev, self.n_rows_per_rel = rpd, n
        self.row0 = lo                     # first owned row, R * N space
        self.n_rel = len(L.rel_keys)
        self.x_lo, self.x_hi = DL.src_bounds[i], DL.src_bounds[i + 1]
        # every rank's rows and source rows: the collectives' blocks
        self.row_sizes = tuple(np.diff(DL.row_bounds).tolist())
        self.x_sizes = tuple(np.diff(DL.src_bounds).tolist())
        if rpd == 0:                       # no row tile: no kernel runs
            return
        self.s_lo, self.s_hi = lo // n, -(-(lo + rpd) // n)
        self.off = lo - self.s_lo * n
        e = int(DL.tile_starts[i, -1])     # the rank's real edges
        src = DL.src[i, :e]
        rows = DL.dst_local[i, :e] + self.off
        n_loc = (self.s_hi - self.s_lo) * n
        ro = np.zeros(n_loc + 1, np.int32)
        np.cumsum(np.bincount(rows, minlength=n_loc), out=ro[1:])
        put = lambda a: torch.from_numpy(  # noqa: E731
            np.ascontiguousarray(a, dtype=np.int32)).to(device)
        self.src, self.row_offsets = put(src), put(ro)
        # the slots s_lo..s_hi own these rows of the full source table
        self.src_base = tuple(int(b) for b in L.src_base[self.s_lo:
                                                          self.s_hi + 1])
        gat_layer.check_src_owner(src, ro, n, self.src_base)
        self.sched = self.bwd_sched = None
        if torch.device(device).type == "cuda":   # the plain versions take none
            self.sched = gat_layer.schedule(ro, n, 0).to(device)
            self.bwd_sched = gat_layer.schedule(
                ro, n, 0, chunk_edges=BWD_CHUNK_EDGES).to(device)
        # the CSC of the real edges: the pad entries sort last
        perm = DL.csc_perm[i, :e]
        off_src = np.minimum(DL.csc_offsets[i], e)
        grow = rows + self.s_lo * n        # rows in the R * N space
        self.csc = _CSCLayout(
            n_rows_per_rel=n, src_base=tuple(int(b) for b in L.src_base),
            src=self.src, dst=put(grow), csc_perm=put(perm),
            csc_offsets=put(off_src),
            **segment.csc_fields(grow, perm, off_src, n, L.src_base, 0,
                                 device))

    @property
    def empty(self) -> bool:
        return self.rows_per_dev == 0


@dataclass
class _CSCLayout:
    """What csc_segment_sum reads of a DeviceLayout."""

    n_rows_per_rel: int
    src_base: tuple
    src: torch.Tensor
    dst: torch.Tensor
    csc_perm: torch.Tensor
    csc_offsets: torch.Tensor
    csc_schedule: object = None
    csc_rows: torch.Tensor = None
    csc_fold: bool = False


class ShardedMergedGAT(torch.autograd.Function):
    """``ShardedMergedGAT.apply(xs_local, att, a_dst_all, shard, group,
    mode, negative_slope, temperature[, stream_dtype])`` -> the rank's
    rows_per_dev rows of the group's unfolded [R * N, D] layer output,
    float32. xs_local: the rank's rows x_lo..x_hi of the source table
    (all-gathered over group, the 'data' axis); att [R, D] and a_dst_all
    [R * N] replicated. stream_dtype: the dtype the gathered table is cast
    to (MergedGATLayer's). Gradients: d_xs reduce-scattered to the rank's
    rows; d_att and d_a_dst this rank's edges' share (the caller sums
    parameter gradients over the mesh)."""

    @staticmethod
    def forward(ctx, xs_local, att, a_dst_all, shard, group, mode,
                negative_slope, temperature, stream_dtype=None):
        xs_all = gather_rows(xs_local, group, shard.x_sizes)
        if stream_dtype is not None:
            xs_all = xs_all.to(stream_dtype)
        ctx.shard, ctx.group = shard, group
        ctx.xs_dtype = xs_local.dtype
        if shard.empty:   # the backward's reduce-scatter still runs
            ctx.shape = xs_all.shape
            return xs_all.new_zeros(0, xs_all.shape[1], dtype=torch.float32)
        n = shard.n_rows_per_rel
        att_loc = att[shard.s_lo:shard.s_hi].contiguous()
        a_dst = a_dst_all[shard.s_lo * n:shard.s_hi * n].contiguous()
        # a bf16 table's scores per source row, for the forward and the
        # backward (MergedGATLayer's)
        a_src = (gat_layer.merged_gat_a_src(xs_all, att_loc, shard.src_base)
                 if xs_all.dtype == torch.bfloat16 and xs_all.is_cuda
                 else None)
        out, row_max, row_sum = gat_layer.merged_gat_forward(
            xs_all, shard.src, shard.row_offsets, att_loc, a_dst, n, 0, mode,
            negative_slope, temperature, sched=shard.sched, a_src=a_src)
        ctx.save_for_backward(xs_all, att, a_dst, row_max, row_sum, a_src)
        ctx.options = (mode, negative_slope, temperature)
        return out[shard.off:shard.off + shard.rows_per_dev]

    @staticmethod
    def backward(ctx, g):
        s = ctx.shard
        if s.empty:
            d_xs = reduce_scatter_rows(g.new_zeros(ctx.shape), ctx.group,
                                       s.x_sizes)
            return (d_xs.to(ctx.xs_dtype), None, None, None, None, None,
                    None, None, None)
        xs_all, att, a_dst, row_max, row_sum, a_src = ctx.saved_tensors
        n = s.n_rows_per_rel
        mode, slope, temp = ctx.options
        # the cotangent in the group's R * N row space, the rank's rows set
        g_all = g.new_zeros(s.n_rel * n, g.shape[1])
        g_all[s.row0:s.row0 + s.rows_per_dev] = g
        att_loc = att[s.s_lo:s.s_hi].contiguous()
        w, dz, d_a_dst = gat_layer.merged_gat_bwd(
            xs_all, s.src, s.row_offsets, att_loc, a_dst, row_max, row_sum,
            g_all[s.s_lo * n:s.s_hi * n], n, 0, mode, slope, temp,
            sched=s.bwd_sched, a_src=a_src)
        d_xs_all, d_att = segment.csc_segment_sum(g_all, w, dz, xs_all, att,
                                                  s.csc, 0)
        d_xs = reduce_scatter_rows(d_xs_all, ctx.group, s.x_sizes)
        d_a_dst_all = a_dst.new_zeros(s.n_rel * n)
        d_a_dst_all[s.s_lo * n:s.s_hi * n] = d_a_dst
        return (d_xs.to(ctx.xs_dtype), d_att, d_a_dst_all, None, None, None,
                None, None, None)


class ShardedMergedGroup:
    """One destination group's sharded merged layer, which
    HeteroGNN.merged_layer (merged_fns) calls per head with the rank's rows
    x_range of the projected source table."""

    def __init__(self, L: MergedDstLayout, mesh: Mesh, device):
        self.mesh = mesh
        self.shard = RankShard(L, build_device_layouts(L, mesh.data),
                               mesh.data_rank, device)
        self.x_range = (self.shard.x_lo, self.shard.x_hi)

    def __call__(self, xs_local, att, a_dst_all, mode, negative_slope,
                 temperature, stream_dtype=None):
        """The group's unfolded [R * N, D] output on every rank of the
        'data' axis: the rank's rows, all-gathered."""
        own = ShardedMergedGAT.apply(
            xs_local, att, a_dst_all, self.shard, self.mesh.data_group, mode,
            negative_slope, temperature, stream_dtype)
        return all_gather_rows(own, self.mesh.data_group,
                               self.shard.row_sizes)


def make_sharded_merged_fns(layouts: dict, mesh: Mesh, device) -> dict:
    """dst type -> ShardedMergedGroup for every merged layout (the JAX
    package's make_sharded_merged_kernel_fns, which builds one per entry of
    meta["merged"]), a split group's dst-range sub-layouts' rows each
    sharded like any layout's and joined by a SplitCall: the static
    per-rank layouts and schedules, built once per mesh."""
    out = {}
    for t, subs in base_groups(layouts).items():
        fns = [ShardedMergedGroup(L, mesh, device) for _, L in subs]
        out[t] = fns[0] if subs[0][1].base_type is None else SplitCall(
            fns, [L.n_rows_per_rel for _, L in subs],
            len(subs[0][1].rel_keys))
    return out
