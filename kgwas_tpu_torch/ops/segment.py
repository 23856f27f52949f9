"""Sorted segment sums over a layout's CSR and CSC: kernels #8 and #10.

**CSC segment sum** (``csc_segment_sum``, ``csrc/csc_segment_sum.cu``).
Counterpart of ``kgwas_tpu/ops/pallas_segment.py``'s ``pallas_segment_sum``
(``_segsum_kernel``) as ``gather_rows_csc``'s backward uses it:
``take(d_msgs, csc_perm)`` followed by the sorted segment sum over source
rows. Here the ``[E, D]`` message cotangent is never formed. Per source row
s of the concatenated table ``xs_all``:

    d_xs[s]      = sum_{e: src_e = s} (w_e g[row_e] + dz_e att[slot(s)])
    d_att[slot]  = sum_{s in slot} c_s xs[s],   c_s = sum_{e: src_e = s} dz_e

with ``w`` and ``dz`` from a layer's edge backward (``gat_layer.
merged_gat_bwd``), ``g`` the layer output's cotangent (row ``row_e % N`` of
it with the fold), and ``slot(s)`` the relation whose block
``[src_base[r], src_base[r+1])`` holds s. With ``dz=None`` there is no
logit term and no ``d_att`` (the per-relation GAT and message-passing
backwards), and with ``w=None`` every weight is 1. Without the logit term
it also gives, on request (``edge_grad``), the weights' gradient
``d_w[e] = g[row_e] . xs[src_e]``, written once per edge at its CSC entry
(the backward of a CSR segment sum whose weights are a function of
parameters: the per-relation sigmoid GAT layer). ``src_e`` is the source
row the CSC gives the edge: pad edges sit at their slot's trash source row.
The kernel takes its work from a static schedule over source rows
(``csc_schedule``: packed short rows of one slot, chunks of long ones) and
reads each CSC entry's cotangent row from ``csc_rows`` (``row_e`` in CSC
order, with the fold's ``% N``), both built once per layout by
``csc_fields`` and kept on its ``DeviceLayout``; the wrapper keeps its
scratch on the schedule from the first launch.

**CSR segment sum** (``csr_segment_sum``, ``csrc/csr_segment_sum.cu``).
Counterpart of ``segment_sum_edges`` (``_pallas_segment_sum_ts``) with the
source-row gather before it fused in: ``out[r] = sum_{e in row r} w_e
x[src_e]`` over a dst-sorted CSR, ``w`` optional. The kernel takes its work
from a static schedule of the rows (``schedule.row_schedule`` with
``CSR_MAX_EDGES``, ``CSR_CHUNK_EDGES``: packed short rows, chunks of long
ones added in part order by a second launch), which ``device_layouts``
builds once per 'mp' layout and keeps on its ``DeviceLayout``; the wrapper
keeps the chunks' scratch on the schedule from the first launch.
``CSRSegmentSum`` is it as an autograd function; its backward is
``csc_segment_sum`` with ``w`` and no logit term, and the weights'
gradient from the same launch when ``w`` requires one (static degree norms
do not; the sigmoid GAT layer's weights do).

**bf16 tables.** ``xs_all`` and ``x`` may be bfloat16 (the dtype
options); the wrappers then launch the kernels' bf16 instances (entry
points ``kgwas_csc_segment_sum_bf16``, ``kgwas_csr_segment_sum_bf16``;
counted in ``bf16_launches`` and ``csr_bf16_launches``). Outputs stay
float32, as the TPU kernels write them. With the logit term, each formed
message cotangent row ``w_e g[row_e] + dz_e att[slot]`` is rounded to
bf16 before it is summed, and ``c_s`` sums the bf16-rounded ``dz_e``: the
JAX package's backward layer kernel writes ``d_msgs`` in bf16 and dots
``dz`` rounded to bf16 with the messages for ``d_att``. Without it, a
weighted sum rounds each product ``w_e g[row_e]`` to bf16 (the cotangent
of bf16 messages that the JAX package multiplied by float32 weights comes
back through the cast to bf16), an unweighted one adds the float32 rows
(the JAX package's segment sum hands its float32 cotangent on as it is).
In the CSR sum a
bf16 ``w`` rounds each product ``w_e x[src_e]`` to bf16 (the JAX package
forms ``msgs * w`` in bf16 there); an f32 ``w`` multiplies in float32.

Each wrapper launches its kernel for CUDA tensors and runs its ``_plain``
version for CPU tensors; there is no other route. ``launches`` (CSC) and
``csr_launches`` count calls of the wrappers that reach the card (a call
is two device launches when its schedule cuts a row into chunks).
"""
from __future__ import annotations

import ctypes
from types import SimpleNamespace

import numpy as np
import torch

from .schedule import (BWD_ITEM_MAX_EDGES, CSC_CHUNK_EDGES,
                       CSC_LOGIT_MAX_EDGES, CSC_MAX_EDGES, CSR_CHUNK_EDGES,
                       CSR_MAX_EDGES, ITEM_MAX_ROWS, check_device_schedule,
                       check_stream, row_schedule, schedule)
from .segment_ref import csr_rows, gather_rows, round_bf16, segment_sum

MAX_SLOTS = 32

launches = 0
csr_launches = 0
bf16_launches = 0
csr_bf16_launches = 0


def _slots(layout, xs_all, att):
    src_base = list(layout.src_base)
    n_rel = len(src_base) - 1
    if xs_all.dim() != 2 or xs_all.shape[0] != src_base[-1]:
        raise ValueError(f"xs_all {tuple(xs_all.shape)} does not match the "
                         f"layout's {src_base[-1]} source rows")
    if att is not None and att.shape != (n_rel, xs_all.shape[1]):
        raise ValueError(f"att {tuple(att.shape)} != ({n_rel}, "
                         f"{xs_all.shape[1]})")
    return src_base, n_rel


def csc_sources(layout):
    """Each edge's source row [E] (int64) as the layout's CSC routes it."""
    ids = csr_rows(layout.csc_offsets)
    src = torch.empty_like(ids)
    src[layout.csc_perm.long()] = ids
    return src


def csc_schedule(csc_offsets, src_base, max_edges=CSC_MAX_EDGES,
                 chunk_edges=CSC_CHUNK_EDGES):
    """The CSC kernel's schedule of a layout's source rows (host, numpy):
    no item holds rows of two slots, and its item_breaks are each slot's
    first item."""
    src_base = [int(b) for b in src_base]
    return schedule(csc_offsets, src_base[-1], 0, max_edges, chunk_edges,
                    max_units=ITEM_MAX_ROWS, breaks=src_base[1:-1])


def csc_rows_of(dst, csc_perm, n_rows_per_rel, fold):
    """Each CSC entry's cotangent row (numpy or torch): dst[csc_perm],
    % N with the fold."""
    rows = dst[csc_perm.long() if torch.is_tensor(csc_perm) else csc_perm]
    return rows % n_rows_per_rel if fold else rows


def csc_fields(dst, csc_perm, csc_offsets, n_rows_per_rel, src_base, fold,
               device):
    """What a DeviceLayout (models/hetero_gnn.py) keeps for the CSC
    segment sum, from the stream's host arrays (numpy): its schedule on
    device (csc_schedule), each CSC entry's cotangent row (csc_rows, int32)
    and csc_fold. fold: the merged GAT layer's R (its backward has the
    logit term, so larger items), else 0."""
    rows = csc_rows_of(np.asarray(dst), np.asarray(csc_perm),
                       n_rows_per_rel, fold)
    sched = csc_schedule(csc_offsets, src_base, CSC_LOGIT_MAX_EDGES if fold
                         else CSC_MAX_EDGES)
    return {"csc_schedule": sched.to(device),
            "csc_rows": torch.from_numpy(
                np.ascontiguousarray(rows, dtype=np.int32)).to(device),
            "csc_fold": bool(fold)}


def csc_segment_sum_plain(g, w, dz, xs_all, att, layout, fold=0,
                          edge_grad=False):
    """Plain PyTorch version: the [E, D] message cotangent formed in full
    and summed per source row with index_add_; d_w = (x[src] *
    g[dst]).sum(-1). Same arguments and results as csc_segment_sum (bf16
    xs_all: d_msgs rows and dz rounded to bf16, float32 outputs)."""
    src_base, n_rel = _slots(layout, xs_all, att)
    _check_edge_grad(dz, edge_grad)
    bf16 = xs_all.dtype == torch.bfloat16
    if bf16:
        xs_all = xs_all.to(torch.float32)
    n = layout.n_rows_per_rel
    dst = layout.dst.long()
    src = csc_sources(layout)
    rows = g[dst % n if fold else dst]
    d_msgs = rows if w is None else w[:, None] * rows
    if dz is None:
        if bf16 and w is not None:
            d_msgs = round_bf16(d_msgs)
        d_xs = torch.zeros_like(xs_all).index_add_(0, src, d_msgs)
        if edge_grad:
            return d_xs, None, (xs_all[src] * rows).sum(-1)
        return d_xs, None
    d_msgs = d_msgs + dz[:, None] * att[dst // n]
    if bf16:
        d_msgs, dz = round_bf16(d_msgs), round_bf16(dz)
    d_xs = torch.zeros_like(xs_all).index_add_(0, src, d_msgs)
    c = torch.zeros(xs_all.shape[0], dtype=xs_all.dtype,
                    device=xs_all.device).index_add_(0, src, dz)
    slot = torch.repeat_interleave(
        torch.arange(n_rel, device=xs_all.device),
        torch.tensor(src_base, device=xs_all.device).diff())
    d_att = torch.zeros_like(att).index_add_(0, slot, c[:, None] * xs_all)
    return d_xs, d_att


def _csc_plan(layout, sched, n_rel, d, logits, dev):
    """What csc_segment_sum keeps on the layout's schedule from its first
    launch at feature width d: the layout's arrays checked, the slots'
    source-row and item boundaries as C arrays, and the scratch of the
    chunk partials (and of the d_att partials with the logit term)."""
    from .gat_layer import check_cuda_args

    key = (dev, d, logits)
    plan = sched.cache.get(key)
    if plan is not None:
        return plan
    src_base = list(layout.src_base)
    if n_rel > MAX_SLOTS:
        raise ValueError(f"src_base {src_base}: at most {MAX_SLOTS} slots")
    check_device_schedule(sched, src_base[-1], 1, BWD_ITEM_MAX_EDGES, dev)
    if len(sched.item_breaks) != n_rel + 1:
        raise ValueError(f"a schedule of {len(sched.item_breaks) - 1} slots "
                         f"given for {n_rel}")
    e = layout.csc_perm.shape[0]
    if layout.csc_rows.shape != (e,):
        raise ValueError(f"csc_rows must be ({e},)")
    check_cuda_args(dev, csc_rows=layout.csc_rows, csc_perm=layout.csc_perm,
                    csc_offsets=layout.csc_offsets)
    f32 = dict(dtype=torch.float32, device=dev)
    plan = sched.cache[key] = SimpleNamespace(
        bases=(ctypes.c_longlong * (n_rel + 1))(*src_base),
        item_bases=(ctypes.c_longlong * (n_rel + 1))(*sched.item_breaks),
        part_acc=torch.empty(sched.n_parts, d, **f32),
        part_c=torch.empty(sched.n_parts, **f32) if logits else None,
        partial=(torch.empty(sched.items.shape[0], d, **f32) if logits
                 else None))
    return plan


def _check_edge_grad(dz, edge_grad):
    if edge_grad and dz is not None:
        raise ValueError("the weights' gradient is taken without dz only")


def csc_segment_sum(g, w, dz, xs_all, att, layout, fold=0, edge_grad=False):
    """(d_xs_all [S, D], d_att [R, D] or None) of one layer's source rows,
    and with edge_grad (only with dz=None) d_w [E] third.

    g [N, D] with fold=R (else [R*N, D]) is the layer output's cotangent;
    w, dz [E] the per-edge weights and logit cotangents (w=None: weight 1;
    dz=None: no logit term, and att, d_att are None); xs_all [S, D] and att
    [R, D] the layer's inputs; layout a DeviceLayout (models/hetero_gnn.py)
    with csc_fields for this fold, whose csc_schedule, csc_rows, csc_perm,
    csc_offsets and src_base this reads. d_w[e] = g[row_e] . xs_all[s_e]
    for the source row s_e the CSC gives edge e (a pad edge: its slot's
    trash source row)."""
    if xs_all.device.type == "cpu":
        return csc_segment_sum_plain(g, w, dz, xs_all, att, layout, fold,
                                     edge_grad)
    if xs_all.device.type != "cuda":
        raise ValueError(f"unsupported device {xs_all.device}")
    if (dz is None) != (att is None):
        raise ValueError("dz and att are given together or not at all")
    _check_edge_grad(dz, edge_grad)
    src_base, n_rel = _slots(layout, xs_all, att)
    n = layout.n_rows_per_rel
    d = xs_all.shape[1]
    if g.shape != ((n if fold else n * n_rel), d):
        raise ValueError(f"g {tuple(g.shape)} does not match the layout")
    e = layout.csc_perm.shape[0]
    edge = {k: v for k, v in (("w", w), ("dz", dz)) if v is not None}
    if any(v.shape != (e,) for v in edge.values()):
        raise ValueError(f"w and dz must be ({e},)")
    sched = getattr(layout, "csc_schedule", None)
    if sched is None or layout.csc_fold != bool(fold):
        raise ValueError(f"the layout has no CSC fields for fold {fold} "
                         "(segment.csc_fields)")
    from .gat_layer import check_cuda_args

    dev = xs_all.device
    plan = _csc_plan(layout, sched, n_rel, d, dz is not None, dev)
    check_cuda_args(dev, g=g, xs_all=xs_all, **edge,
                    **({} if att is None else {"att": att}))
    bf16 = xs_all.dtype == torch.bfloat16
    from .build import library

    d_xs = torch.empty(xs_all.shape, dtype=torch.float32, device=dev)
    d_att = None if att is None else torch.empty_like(att)
    d_w = torch.empty(e, dtype=torch.float32, device=dev) if edge_grad \
        else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    err = library("csc_segment_sum_bf16" if bf16 else "csc_segment_sum")(
        g.data_ptr(), ptr(w), ptr(dz), xs_all.data_ptr(), ptr(att),
        layout.csc_rows.data_ptr(), layout.csc_perm.data_ptr(),
        layout.csc_offsets.data_ptr(), sched.items.data_ptr(),
        sched.items.shape[0], sched.split_units.data_ptr(),
        sched.part_offsets.data_ptr(), sched.split_units.shape[0],
        plan.part_acc.data_ptr(), ptr(plan.part_c), plan.bases,
        plan.item_bases, d_xs.data_ptr(), ptr(d_att), ptr(d_w),
        ptr(plan.partial), n_rel, d,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"csc_segment_sum launch failed: cudaError {err}")
    global launches, bf16_launches
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return (d_xs, d_att, d_w) if edge_grad else (d_xs, d_att)


def _check_csr(x, src, row_offsets, w):
    if x.dim() != 2 or src.dim() != 1 or row_offsets.dim() != 1:
        raise ValueError("x must be 2-D, src and row_offsets 1-D")
    if w is not None and w.shape != src.shape:
        raise ValueError(f"w {tuple(w.shape)} != src {tuple(src.shape)}")


def _csr_operands(x, w):
    """(x, w, round_products) as the kernels take them: with a bf16 w and
    a bf16 x, each product is rounded to bf16 (w goes as float32, exact);
    a bf16 w with a wider x multiplies in x's dtype."""
    if w is None or w.dtype != torch.bfloat16:
        return x, w, False
    if x.dtype == torch.bfloat16:
        return x, w.to(torch.float32), True
    return x, w.to(x.dtype), False


def csr_segment_sum_plain(x, src, row_offsets, w=None):
    """Plain PyTorch version: gather, weight and index_add_ per row. Same
    arguments and result as csr_segment_sum (bf16 x: float32 sums, the
    products of a bf16 w rounded to bf16)."""
    _check_csr(x, src, row_offsets, w)
    x, w, round_products = _csr_operands(x, w)
    rows = csr_rows(row_offsets)
    msgs = gather_rows(x, src[:rows.shape[0]])
    if msgs.dtype == torch.bfloat16:
        msgs = msgs.to(torch.float32)
    if w is not None:
        msgs = w[:rows.shape[0], None] * msgs
        if round_products:
            msgs = round_bf16(msgs)
    return segment_sum(msgs, rows, row_offsets.shape[0] - 1)


def csr_segment_sum(x, src, row_offsets, w=None, sched=None):
    """out [n_rows, D], out[r] = sum over row r's edges e of w_e x[src_e].

    x [S, D] f32 (or bf16) source rows; src [E] int32 into x (dst-sorted);
    row_offsets [n_rows + 1] int32; w [E] f32 (or bf16) per-edge weights
    or None (1). out is float32.
    Empty rows give 0. sched: the stream's row_schedule on the device with
    CSR_MAX_EDGES and CSR_CHUNK_EDGES (DeviceLayout.row_schedule on 'mp';
    built from row_offsets when not given); the plain version needs none."""
    if x.device.type == "cpu":
        return csr_segment_sum_plain(x, src, row_offsets, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_csr(x, src, row_offsets, w)
    from .gat_layer import check_cuda_args

    dev = x.device
    x, w, round_products = _csr_operands(x, w)
    check_cuda_args(dev, x=x, **({} if w is None else {"w": w}))
    bf16 = x.dtype == torch.bfloat16
    n_rows = row_offsets.shape[0] - 1
    if sched is None:
        sched = row_schedule(row_offsets, CSR_MAX_EDGES,
                             CSR_CHUNK_EDGES).to(dev)
    check_stream(sched, ("csr", dev), src, row_offsets, n_rows)
    d = x.shape[1]
    # the chunks' partial sums for the combine, kept on the schedule from
    # its first launch at this width
    part_acc = sched.cache.get(("csr", dev, d))
    if part_acc is None:
        part_acc = sched.cache[("csr", dev, d)] = torch.empty(
            sched.n_parts, d, dtype=torch.float32, device=dev)
    from .build import library

    out = torch.empty(n_rows, d, dtype=torch.float32, device=dev)
    args = (x.data_ptr(), src.data_ptr(), row_offsets.data_ptr(),
            None if w is None else w.data_ptr(), out.data_ptr(),
            sched.items.data_ptr(), sched.items.shape[0],
            sched.split_units.data_ptr(), sched.part_offsets.data_ptr(),
            sched.split_units.shape[0], part_acc.data_ptr(), n_rows, d)
    stream = torch.cuda.current_stream(dev).cuda_stream
    if bf16:   # its walk stages items of at most this many edges
        err = library("csr_segment_sum_bf16")(
            *args, int(round_products),
            max(sched.max_edges, sched.chunk_edges), stream)
    else:
        err = library("csr_segment_sum")(*args, stream)
    if err != 0:
        raise RuntimeError(f"csr_segment_sum launch failed: cudaError {err}")
    global csr_launches, csr_bf16_launches
    if bf16:
        csr_bf16_launches += 1
    else:
        csr_launches += 1
    return out


class CSRSegmentSum(torch.autograd.Function):
    """``CSRSegmentSum.apply(x, w, layout)`` -> csr_segment_sum over the
    layout's stream (src, row_offsets), [n_rows, D]. The backward is
    csc_segment_sum(g, w, None) over the layout's CSC, with the weights'
    gradient d_w[e] = g[row_e] . x[src_e] from the same launch when w
    requires one."""

    @staticmethod
    def forward(ctx, x, w, layout):
        # the gradients are float32 (the engine casts them to x's and w's
        # dtypes), as the JAX package's VJP gives them
        ctx.save_for_backward(x, w)
        ctx.layout = layout
        return csr_segment_sum(x, layout.src, layout.row_offsets, w,
                               sched=getattr(layout, "row_schedule", None))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        wf = None if w is None else w.to(torch.float32)
        if w is not None and ctx.needs_input_grad[1]:
            d_x, _, d_w = csc_segment_sum(g.contiguous(), wf, None, x, None,
                                          ctx.layout, edge_grad=True)
            return d_x, d_w, None
        d_x, _ = csc_segment_sum(g.contiguous(), wf, None, x, None,
                                 ctx.layout)
        return d_x, None, None
