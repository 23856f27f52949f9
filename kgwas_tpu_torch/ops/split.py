"""The merged layer ops over a split destination group.

With ``KGWAS_MERGED_MAX_EDGES`` (``graph/merged_layout.split_merged_layout``)
a destination type's merged layout is replaced by dst-range sub-layouts,
each over one range of the type's nodes in every slot, all reading the
group's one concatenated source table. ``SplitGroup`` holds a group's
sub-layouts in node order and stands for the whole group in the layer paths
(``models/hetero_gnn.py``): its rows are the sub-layouts' rows joined in
node order in every slot, so the layer code reads as for one layout.

``SplitMergedGAT`` and ``SplitCSRSum`` are ``MergedGATLayer`` and
``CSRSegmentSum`` over such a group, each one autograd function: every
sub-layout's kernels launch on its own rows (its slice of the group's a_dst
and cotangent), the outputs are joined into the group's rows, and the
backward adds the sub-layouts' source-table gradients into one buffer,
which it returns as the unsplit op does. ``SplitCall`` joins the
sub-layouts' layers over a mesh (``parallel/``) the same way.

The kernel wrappers are looked up on their modules at each call, as the
unsplit ops do, so that a wrapper swapped in at run time (a plain version,
a counter) is the one that runs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from . import gat_layer, segment


def base_groups(layouts) -> dict:
    """Destination type -> [(key, layout)] of its whole group, or of its
    dst-range sub-layouts in node order (host or device layouts)."""
    out: dict = {}
    for t, L in layouts.items():
        out.setdefault(L.base_type or t, []).append((t, L))
    for subs in out.values():
        subs.sort(key=lambda kv: kv[1].node_base)
    return out


def split_slots(t, sizes, n_slots: int):
    """The parts of t [n_slots * N, ...] (slot-major, N = sum(sizes)): per
    size, its rows of every slot, [n_slots * size, ...] contiguous (row
    views of a contiguous t where n_slots is 1)."""
    if n_slots == 1:
        return list(t.split(list(sizes)))
    v = t.reshape(n_slots, -1, *t.shape[1:])
    return [p.reshape(-1, *t.shape[1:]) for p in v.split(list(sizes), dim=1)]


def join_slots(parts, n_slots: int):
    """split_slots' inverse: the parts' rows joined in every slot."""
    if n_slots == 1:
        return torch.cat(parts)
    rest = parts[0].shape[1:]
    return torch.cat([p.reshape(n_slots, -1, *rest) for p in parts],
                     dim=1).reshape(-1, *rest)


@dataclass
class SplitGroup:
    """A split destination type's sub-layouts (models/hetero_gnn.
    DeviceLayout), in node order, as one layout: its slots, source space
    and relation streams are every sub-layout's; its rows per slot are
    theirs joined. inv_deg [R*N] and sym_e (the sub-layouts' streams
    concatenated) are the 'mp' path's norms, None off it."""

    keys: Tuple[str, ...]
    parts: tuple
    inv_deg: Optional[torch.Tensor] = None
    sym_e: Optional[torch.Tensor] = None

    @property
    def rel_keys(self):
        return self.parts[0].rel_keys

    @property
    def src_types(self):
        return self.parts[0].src_types

    @property
    def src_base(self):
        return self.parts[0].src_base

    @property
    def relations(self):
        return self.parts[0].relations

    @property
    def sizes(self):
        return tuple(L.n_rows_per_rel for L in self.parts)

    @property
    def n_rows_per_rel(self):
        return sum(self.sizes)


class SplitMergedGAT(torch.autograd.Function):
    """``SplitMergedGAT.apply(xs_all, att, a_dst_all, group, fold, mode,
    negative_slope, temperature[, stream_dtype])``: MergedGATLayer over a
    SplitGroup, with the group's a_dst_all [R*N] and output ([N, D] with
    fold=R, else [R*N, D])."""

    @staticmethod
    def forward(ctx, xs_all, att, a_dst_all, group, fold, mode,
                negative_slope, temperature, stream_dtype=None):
        if stream_dtype is not None:
            xs_all = xs_all.to(stream_dtype)
        # the bf16 instances' per-row scores, once for the group's table
        a_src = (gat_layer.merged_gat_a_src(xs_all, att, group.src_base)
                 if xs_all.dtype == torch.bfloat16 and xs_all.is_cuda
                 else None)
        n_rel = len(group.rel_keys)
        outs, stats = [], []
        for L, a_dst in zip(group.parts,
                            split_slots(a_dst_all, group.sizes, n_rel)):
            out, row_max, row_sum = gat_layer.merged_gat_forward(
                xs_all, L.src, L.row_offsets, att, a_dst, L.n_rows_per_rel,
                fold, mode, negative_slope, temperature,
                sched=gat_layer.layout_schedule(L, fold), a_src=a_src)
            outs.append(out)
            stats += (row_max, row_sum)
        ctx.save_for_backward(xs_all, att, a_dst_all, a_src, *stats)
        ctx.group = group
        ctx.options = (fold, mode, negative_slope, temperature)
        return join_slots(outs, 1 if fold else n_rel)

    @staticmethod
    def backward(ctx, g):
        xs_all, att, a_dst_all, a_src, *stats = ctx.saved_tensors
        group, fold = ctx.group, ctx.options[0]
        n_rel = len(group.rel_keys)
        gs = split_slots(g.contiguous(), group.sizes, 1 if fold else n_rel)
        a_dsts = split_slots(a_dst_all, group.sizes, n_rel)
        d_xs = d_att = None
        d_a_dst = []
        for k, L in enumerate(group.parts):
            dx, da, dd = gat_layer.merged_gat_backward(
                xs_all, att, a_dsts[k], stats[2 * k], stats[2 * k + 1],
                gs[k].contiguous(), L, *ctx.options, a_src=a_src)
            if d_xs is None:
                d_xs, d_att = dx, da
            else:   # one buffer: the table's gradient summed in place
                d_xs.add_(dx)
                d_att.add_(da)
            d_a_dst.append(dd)
        return (d_xs, d_att, join_slots(d_a_dst, n_rel), None, None, None,
                None, None, None)


class SplitCSRSum(torch.autograd.Function):
    """``SplitCSRSum.apply(x, w, group)``: CSRSegmentSum over a SplitGroup,
    [R*N, D]; w: the group's constant per-edge weights (the sub-layouts'
    streams concatenated, SplitGroup.sym_e) or None, given no gradient."""

    @staticmethod
    def forward(ctx, x, w, group):
        ctx.save_for_backward(x, w)
        ctx.group = group
        return join_slots([segment.csr_segment_sum(
            x, L.src, L.row_offsets, wk,
            sched=getattr(L, "row_schedule", None))
            for L, wk in zip(group.parts, _edge_parts(w, group))],
            len(group.rel_keys))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        group = ctx.group
        gs = split_slots(g.contiguous(), group.sizes, len(group.rel_keys))
        wf = None if w is None else w.to(torch.float32)
        d_x = None
        for L, gk, wk in zip(group.parts, gs, _edge_parts(wf, group)):
            dx, _ = segment.csc_segment_sum(gk.contiguous(), wk, None, x,
                                            None, L)
            if d_x is None:
                d_x = dx
            else:   # one buffer: the table's gradient summed in place
                d_x.add_(dx)
        return d_x, None, None


def _edge_parts(w, group):
    """Each sub-layout's block of the group's per-edge w (None: Nones)."""
    if w is None:
        return [None] * len(group.parts)
    return w.split([L.src.shape[0] for L in group.parts])


class SplitCall:
    """A split group's per-sub-layout parts over a mesh (parallel/: each
    sub-layout's layer, or its rank's stream), in node order, as one:
    ``call(xs, att, a_dst_all, *rest)`` runs each part on its rows of the
    group's a_dst_all [R*N] and joins their unfolded [R*rows, D] outputs
    into the group's [R*N, D]. Every other attribute (x_range, source: the
    source table's rows, which the sub-layouts share) is the first part's."""

    def __init__(self, parts, sizes, n_rel: int):
        self.parts, self.sizes, self.n_rel = tuple(parts), tuple(sizes), n_rel

    def __getattr__(self, name):
        if name == "parts" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.parts[0], name)

    def __call__(self, xs, att, a_dst_all, *rest):
        return join_slots([
            fn(xs, att, a.contiguous(), *rest) for fn, a in zip(
                self.parts, split_slots(a_dst_all, self.sizes, self.n_rel))],
            self.n_rel)
