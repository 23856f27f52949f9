"""Per-relation segment softmax fused with the SpMM: kernels #6 and #7.

Counterpart of ``kgwas_tpu/ops/pallas_segment.py``'s
``fused_segment_softmax_spmm`` (``_fused_forward`` / ``_fwd_kernel`` and its
VJP ``_fused_backward`` / ``_bwd_kernel``) with ``gather_rows_csc`` fused in
front, as ``kgwas_tpu/models/convs.py``'s ``apply_gat`` runs it on the
per-relation GAT path (gnn_aggr max and min). Over one relation's
dst-sorted CSR (``src`` into the projected source table ``xs``,
``row_offsets``) and given per-edge logits:

    out[r] = sum_{e in row r} softmax_r(logits)_e m_e xs[src_e]

with an optional per-edge multiplier m (``mult``, None: 1) after the
softmax: the dropout of ``apply_gat`` (keep_e / (1 - p), drawn outside; the
kernels take it as a compile-time flag, so a launch without it runs as
before). ``segment_softmax_spmm_fwd`` launches ``csrc/segment_softmax_spmm_fwd.cu``
and ``segment_softmax_spmm_bwd`` launches ``csrc/segment_softmax_spmm_bwd.
cu`` for CUDA tensors; for CPU tensors they run their ``_plain`` versions.
There is no other route. ``launches`` and ``bwd_launches`` count calls of
the two wrappers that reach the card (a forward call is two device launches
when its schedule cuts a row into chunks). Both kernels take their work
from one static schedule of the relation's rows (``schedule.row_schedule``,
built once per relation stream and kept on its ``DeviceLayout``: packed
short rows, chunks of long ones; the forward combines a row's chunks in a
fixed order by a second launch, the backward writes each chunk's edges).
``SegmentSoftmaxSpmm`` is the op as an autograd function: its
backward is ``segment_softmax_spmm_bwd`` (per-edge ``p_e`` and
``d_logit_e``), then ``segment.csc_segment_sum(g, p, None)`` over the
relation's CSC for ``d_xs``: the ``[E, D]`` message cotangent is never
formed.

**bf16 operands.** ``xs`` may be bfloat16 (a bf16 compute or stream
dtype), with float32 or bfloat16 logits (float32 under ``stream_dtype``,
bf16 under ``compute_dtype``); the backward's ``out`` and ``g`` stay
float32 (the forward's output and its cotangent: the kernel forms a packed
row's ``dot_r`` from its edges, which is ``out_r . g_r`` only for the
forward's own output). The wrappers then launch the kernels'
bf16 instances (entry points ``kgwas_segment_softmax_spmm_fwd_bf16`` and
``kgwas_segment_softmax_spmm_bwd_bf16`` of the same sources; counted in
``bf16_launches`` and ``bf16_bwd_launches``), which compute the float32
instances' arithmetic on the operands widened to float32 (exact), as the
TPU kernels' bodies are float32 throughout: the row max and sum, every
weight and sum, and the outputs (``out``, ``row_max``, ``row_sum``, ``w``,
``d_logits``) are float32. The plain versions widen explicitly and compute
the same. In the autograd function, ``d_xs`` comes from #8's bf16
instance (each product ``w_e g[row_e]`` rounded to bf16, as for the
sigmoid GAT) and ``d_logits`` is handed back in the logits' dtype.
"""
from __future__ import annotations

import torch

from . import segment
from .schedule import (BWD_ITEM_MAX_EDGES, check_device_schedule,
                       check_stream, row_schedule)
from .segment_ref import EPS, NEG_BIG, csr_rows, gather_rows, segment_max, segment_sum

EXP_CLAMP = 60.0

launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0


def _check(xs, src, logits, row_offsets, mult=None):
    if xs.dim() != 2 or src.dim() != 1 or row_offsets.dim() != 1:
        raise ValueError("xs must be 2-D, src and row_offsets 1-D")
    for name, t in (("logits", logits), ("mult", mult)):
        if t is not None and t.shape != src.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != src "
                             f"{tuple(src.shape)}")
    return row_offsets.shape[0] - 1


def _widened(*ts):
    """bf16 tensors as float32 (exact); other dtypes as they are."""
    return tuple(t.float() if t.dtype == torch.bfloat16 else t for t in ts)


def segment_softmax_spmm_fwd_plain(xs, src, logits, row_offsets, mult=None):
    """Plain PyTorch version in the TPU kernel's formulas and constants
    (NEG_BIG, exp(min(l - m, 60)), +1e-16). Same arguments and results as
    segment_softmax_spmm_fwd (bf16 operands widened to float32)."""
    n_rows = _check(xs, src, logits, row_offsets, mult)
    xs, logits = _widened(xs, logits)
    dst = csr_rows(row_offsets)
    e = dst.shape[0]
    l = logits[:e]
    row_max = segment_max(l, dst, n_rows)
    p = torch.exp(torch.clamp(l - row_max[dst], max=EXP_CLAMP))
    row_sum = segment_sum(p, dst, n_rows)
    pm = p if mult is None else p * mult[:e]
    out = segment_sum(pm[:, None] * gather_rows(xs, src[:e]), dst, n_rows)
    return out / (row_sum + EPS)[:, None], row_max, row_sum


def segment_softmax_spmm_fwd(xs, src, logits, row_offsets, sched=None,
                             mult=None):
    """(out [n_rows, D], row_max [n_rows], row_sum [n_rows]).

    xs [S, D] f32 (or bf16) projected source rows; src [E] int32 into xs
    (dst-sorted); logits [E] f32 (or bf16, with bf16 xs); row_offsets
    [n_rows + 1] int32, every
    edge in a row; mult [E] f32 per-edge multipliers of the messages after
    the softmax, or None (1; the row max and sum do not see them). Empty
    rows give 0, NEG_BIG and 0. sched: the stream's row_schedule on the
    device (built from row_offsets when not given); the plain version needs
    none."""
    if xs.device.type == "cpu":
        return segment_softmax_spmm_fwd_plain(xs, src, logits, row_offsets,
                                              mult)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    n_rows = _check(xs, src, logits, row_offsets, mult)
    from .gat_layer import check_cuda_args

    dev = xs.device
    bf16 = xs.dtype == torch.bfloat16
    check_cuda_args(dev, ("xs", "logits") if bf16 else (), xs=xs, src=src,
                    logits=logits, row_offsets=row_offsets,
                    **({} if mult is None else {"mult": mult}))
    if sched is None:
        sched = row_schedule(row_offsets).to(dev)
    d = xs.shape[1]
    # the chunks' partials (m, s, acc) for the combine, kept on the
    # schedule from its first launch (checked then) at this width
    part = sched.cache.get((dev, d))
    if part is None:
        check_device_schedule(sched, n_rows, 1, BWD_ITEM_MAX_EDGES, dev)
        f32 = dict(dtype=torch.float32, device=dev)
        part = sched.cache[(dev, d)] = (
            torch.empty(sched.n_parts, **f32),
            torch.empty(sched.n_parts, **f32),
            torch.empty(sched.n_parts, d, **f32))
    elif sched.n_rows != n_rows:
        raise ValueError(f"schedule of {sched.n_rows} rows given for "
                         f"{n_rows}")
    part_m, part_s, part_acc = part
    from .build import library

    out = torch.empty(n_rows, d, dtype=torch.float32, device=dev)
    row_max = torch.empty(n_rows, dtype=torch.float32, device=dev)
    row_sum = torch.empty(n_rows, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (xs.data_ptr(), src.data_ptr(), logits.data_ptr(),
            None if mult is None else mult.data_ptr(),
            row_offsets.data_ptr(), out.data_ptr(), row_max.data_ptr(),
            row_sum.data_ptr(), sched.items.data_ptr(), sched.items.shape[0],
            sched.split_units.data_ptr(), sched.part_offsets.data_ptr(),
            sched.split_units.shape[0], part_m.data_ptr(), part_s.data_ptr(),
            part_acc.data_ptr(), n_rows, d)
    if bf16:   # its walk stages items of at most this many edges
        err = library("segment_softmax_spmm_fwd_bf16")(
            *args, int(logits.dtype == torch.bfloat16),
            max(sched.max_edges, sched.chunk_edges), stream)
    else:
        err = library("segment_softmax_spmm_fwd")(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"segment_softmax_spmm_fwd launch failed: cudaError {err}")
    global launches, bf16_launches
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return out, row_max, row_sum


def segment_softmax_spmm_bwd_plain(xs, src, logits, row_offsets, row_max,
                                   row_sum, out, g, mult=None):
    """Plain PyTorch version of the backward kernel, in the TPU backward
    kernel's formulas (dot_r from the saved output). Same arguments and
    results as segment_softmax_spmm_bwd (bf16 operands widened to
    float32)."""
    _check(xs, src, logits, row_offsets, mult)
    xs, logits = _widened(xs, logits)
    dst = csr_rows(row_offsets)
    e = dst.shape[0]
    lse = row_max + torch.log(row_sum + EPS)
    p = torch.exp(torch.clamp(logits[:e] - lse[dst], max=EXP_CLAMP))
    dot = (out * g).sum(-1)
    m = (gather_rows(xs, src[:e]) * gather_rows(g, dst)).sum(-1)
    if mult is None:
        return p, p * (m - dot[dst])
    mu = mult[:e]
    return p * mu, p * (mu * m - dot[dst])


def segment_softmax_spmm_bwd(xs, src, logits, row_offsets, row_max, row_sum,
                             out, g, sched=None, mult=None):
    """Edge-level VJP of segment_softmax_spmm_fwd: (w [E], d_logits [E]).

    The arguments are the forward's, its out / row_max / row_sum and the
    cotangent g [n_rows, D] of out. w_e = p_e m_e is the softmax weight of
    edge e times its multiplier (mult, None: 1), d_logits the logits'
    cotangent, p_e (m_e xs[src_e] . g_r - dot_r). The message cotangent p_e g_row is
    never formed: segment.csc_segment_sum(g, w, None) sums it per source
    row. xs may be bf16 (then logits f32 or bf16); out, g, w and d_logits
    are f32. sched: the stream's
    row_schedule on the device, the forward's (built from row_offsets when
    not given). The kernel forms dot_r =
    out_r . g_r from the row's own edges where an item holds the whole row
    (sum_e p_e xs[src_e] . g_r), and from out on chunked rows. The plain
    version needs no schedule."""
    if xs.device.type == "cpu":
        return segment_softmax_spmm_bwd_plain(xs, src, logits, row_offsets,
                                              row_max, row_sum, out, g, mult)
    if xs.device.type != "cuda":
        raise ValueError(f"unsupported device {xs.device}")
    n_rows = _check(xs, src, logits, row_offsets, mult)
    d = xs.shape[1]
    if out.shape != (n_rows, d) or g.shape != (n_rows, d):
        raise ValueError(f"out and g must be ({n_rows}, {d})")
    if row_max.shape != (n_rows,) or row_sum.shape != (n_rows,):
        raise ValueError(f"row_max / row_sum must be ({n_rows},)")
    from .gat_layer import check_cuda_args

    dev = xs.device
    bf16 = xs.dtype == torch.bfloat16
    check_cuda_args(dev, ("xs", "logits") if bf16 else (),
                    xs=xs, logits=logits, row_max=row_max, row_sum=row_sum,
                    out=out, g=g, **({} if mult is None else {"mult": mult}))
    if sched is None:
        sched = row_schedule(row_offsets).to(dev)
    check_stream(sched, ("bwd", dev), src, row_offsets, n_rows)
    from .build import library

    e = src.shape[0]
    w = torch.empty(e, dtype=torch.float32, device=dev)
    d_logits = torch.empty(e, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (xs.data_ptr(), src.data_ptr(), logits.data_ptr(),
            None if mult is None else mult.data_ptr(),
            row_offsets.data_ptr(), row_max.data_ptr(), row_sum.data_ptr(),
            out.data_ptr(), g.data_ptr(), w.data_ptr(), d_logits.data_ptr(),
            sched.items.data_ptr(), sched.items.shape[0], n_rows, d)
    if bf16:   # its walk stages items of at most this many edges
        err = library("segment_softmax_spmm_bwd_bf16")(
            *args, int(logits.dtype == torch.bfloat16),
            max(sched.max_edges, sched.chunk_edges), stream)
    else:
        err = library("segment_softmax_spmm_bwd")(*args, stream)
    if err != 0:
        raise RuntimeError(
            f"segment_softmax_spmm_bwd launch failed: cudaError {err}")
    global bwd_launches, bf16_bwd_launches
    if bf16:
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return w, d_logits


def segment_softmax_spmm_backward(xs, logits, row_max, row_sum, out, g,
                                  layout, mult=None):
    """VJP of segment_softmax_spmm_fwd with respect to (xs, logits): the
    edge kernel, then the CSC segment sum. layout is the relation's
    one-slot DeviceLayout (models/hetero_gnn.py)."""
    w, d_logits = segment_softmax_spmm_bwd(
        xs, layout.src, logits, layout.row_offsets, row_max, row_sum, out, g,
        sched=getattr(layout, "row_schedule", None), mult=mult)
    d_xs, _ = segment.csc_segment_sum(g, w, None, xs, None, layout)
    return d_xs, d_logits


def segment_softmax_spmm_backward_plain(xs, logits, row_max, row_sum, out, g,
                                        layout, mult=None):
    """Plain version of segment_softmax_spmm_backward: the two plain
    halves."""
    w, d_logits = segment_softmax_spmm_bwd_plain(
        xs, layout.src, logits, layout.row_offsets, row_max, row_sum, out, g,
        mult)
    d_xs, _ = segment.csc_segment_sum_plain(g, w, None, xs, None, layout)
    return d_xs, d_logits


class SegmentSoftmaxSpmm(torch.autograd.Function):
    """``SegmentSoftmaxSpmm.apply(xs, logits, layout, mult=None)`` -> out
    [N, D] float32 over the relation's stream (layout.src,
    layout.row_offsets), each message times mult [E] after the softmax
    (None: 1; a constant, it gets no gradient). The forward saves out,
    row_max and row_sum; the backward recomputes each edge's softmax
    weight from them. With bf16 xs and logits, their gradients come back in
    their dtypes."""

    @staticmethod
    def forward(ctx, xs, logits, layout, mult=None):
        out, row_max, row_sum = segment_softmax_spmm_fwd(
            xs, layout.src, logits, layout.row_offsets,
            sched=getattr(layout, "row_schedule", None), mult=mult)
        ctx.save_for_backward(xs, logits, row_max, row_sum, out, mult)
        ctx.layout = layout
        return out

    @staticmethod
    def backward(ctx, g):
        *saved, mult = ctx.saved_tensors
        d_xs, d_logits = segment_softmax_spmm_backward(
            *saved, g.contiguous(), ctx.layout, mult=mult)
        xs, logits = saved[:2]
        return d_xs.to(xs.dtype), d_logits.to(logits.dtype), None, None
