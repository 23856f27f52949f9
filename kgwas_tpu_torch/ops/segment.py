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
backwards), and with ``w=None`` every weight is 1. ``src_e`` is the source
row the CSC gives the edge: pad edges sit at their slot's trash source row.

**CSR segment sum** (``csr_segment_sum``, ``csrc/csr_segment_sum.cu``).
Counterpart of ``segment_sum_edges`` (``_pallas_segment_sum_ts``) with the
source-row gather before it fused in: ``out[r] = sum_{e in row r} w_e
x[src_e]`` over a dst-sorted CSR, ``w`` optional. ``CSRSegmentSum`` is it
as an autograd function; its backward is ``csc_segment_sum`` with ``w`` and
no logit term (the weights are static degree norms and get no gradient).

Each wrapper launches its kernel for CUDA tensors and runs its ``_plain``
version for CPU tensors; there is no other route. ``launches`` (CSC) and
``csr_launches`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from .segment_ref import csr_rows, gather_rows, segment_sum

# source rows per block of the CSC kernel (csc_segment_sum.cu kBlockRows): a
# block's d_att partial belongs to one slot, so every slot boundary
# src_base[r] must be a multiple of it
BLOCK_ROWS = 64
MAX_SLOTS = 32

launches = 0
csr_launches = 0


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


def csc_segment_sum_plain(g, w, dz, xs_all, att, layout, fold=0):
    """Plain PyTorch version: the [E, D] message cotangent formed in full
    and summed per source row with index_add_. Same arguments and results
    as csc_segment_sum."""
    src_base, n_rel = _slots(layout, xs_all, att)
    n = layout.n_rows_per_rel
    dst = layout.dst.long()
    src = csc_sources(layout)
    rows = g[dst % n if fold else dst]
    d_msgs = rows if w is None else w[:, None] * rows
    if dz is None:
        return torch.zeros_like(xs_all).index_add_(0, src, d_msgs), None
    d_msgs = d_msgs + dz[:, None] * att[dst // n]
    d_xs = torch.zeros_like(xs_all).index_add_(0, src, d_msgs)
    c = torch.zeros(xs_all.shape[0], dtype=xs_all.dtype,
                    device=xs_all.device).index_add_(0, src, dz)
    slot = torch.repeat_interleave(
        torch.arange(n_rel, device=xs_all.device),
        torch.tensor(src_base, device=xs_all.device).diff())
    d_att = torch.zeros_like(att).index_add_(0, slot, c[:, None] * xs_all)
    return d_xs, d_att


def csc_segment_sum(g, w, dz, xs_all, att, layout, fold=0):
    """(d_xs_all [S, D], d_att [R, D] or None) of one layer's source rows.

    g [N, D] with fold=R (else [R*N, D]) is the layer output's cotangent;
    w, dz [E] the per-edge weights and logit cotangents (w=None: weight 1;
    dz=None: no logit term, and att, d_att are None); xs_all [S, D] and att
    [R, D] the layer's inputs; layout a DeviceLayout (models/hetero_gnn.py),
    whose dst, csc_perm, csc_offsets and src_base this reads."""
    if xs_all.device.type == "cpu":
        return csc_segment_sum_plain(g, w, dz, xs_all, att, layout, fold)
    if xs_all.device.type != "cuda":
        raise ValueError(f"unsupported device {xs_all.device}")
    if (dz is None) != (att is None):
        raise ValueError("dz and att are given together or not at all")
    src_base, n_rel = _slots(layout, xs_all, att)
    n = layout.n_rows_per_rel
    d = xs_all.shape[1]
    if g.shape != ((n if fold else n * n_rel), d):
        raise ValueError(f"g {tuple(g.shape)} does not match the layout")
    if n_rel > MAX_SLOTS or any(b % BLOCK_ROWS for b in src_base):
        raise ValueError(f"src_base {src_base}: at most {MAX_SLOTS} slots, "
                         f"each a multiple of {BLOCK_ROWS} rows")
    e = layout.csc_perm.shape[0]
    edge = {k: v for k, v in (("w", w), ("dz", dz)) if v is not None}
    if any(v.shape != (e,) for v in edge.values()):
        raise ValueError(f"w and dz must be ({e},)")
    from .gat_layer import check_cuda_args

    check_cuda_args(xs_all.device, g=g, xs_all=xs_all, dst=layout.dst,
                    csc_perm=layout.csc_perm, csc_offsets=layout.csc_offsets,
                    **edge, **({} if att is None else {"att": att}))
    from .build import library

    n_src = src_base[-1]
    d_xs = torch.empty_like(xs_all)
    d_att = partial = None
    if dz is not None:
        d_att = torch.empty_like(att)
        partial = torch.empty(n_src // BLOCK_ROWS, d, dtype=torch.float32,
                              device=xs_all.device)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    bases = (ctypes.c_longlong * (n_rel + 1))(*src_base)
    stream = torch.cuda.current_stream(xs_all.device).cuda_stream
    err = library("csc_segment_sum")(
        g.data_ptr(), ptr(w), ptr(dz), xs_all.data_ptr(), ptr(att),
        layout.dst.data_ptr(), layout.csc_perm.data_ptr(),
        layout.csc_offsets.data_ptr(), bases, d_xs.data_ptr(), ptr(d_att),
        ptr(partial), n_rel, n, int(bool(fold)), d, stream)
    if err != 0:
        raise RuntimeError(f"csc_segment_sum launch failed: cudaError {err}")
    global launches
    launches += 1
    return d_xs, d_att


def _check_csr(x, src, row_offsets, w):
    if x.dim() != 2 or src.dim() != 1 or row_offsets.dim() != 1:
        raise ValueError("x must be 2-D, src and row_offsets 1-D")
    if w is not None and w.shape != src.shape:
        raise ValueError(f"w {tuple(w.shape)} != src {tuple(src.shape)}")


def csr_segment_sum_plain(x, src, row_offsets, w=None):
    """Plain PyTorch version: gather, weight and index_add_ per row. Same
    arguments and result as csr_segment_sum."""
    _check_csr(x, src, row_offsets, w)
    rows = csr_rows(row_offsets)
    msgs = gather_rows(x, src[:rows.shape[0]])
    if w is not None:
        msgs = w[:rows.shape[0], None] * msgs
    return segment_sum(msgs, rows, row_offsets.shape[0] - 1)


def csr_segment_sum(x, src, row_offsets, w=None):
    """out [n_rows, D], out[r] = sum over row r's edges e of w_e x[src_e].

    x [S, D] f32 source rows; src [E] int32 into x (dst-sorted);
    row_offsets [n_rows + 1] int32; w [E] f32 per-edge weights or None (1).
    Empty rows give 0."""
    if x.device.type == "cpu":
        return csr_segment_sum_plain(x, src, row_offsets, w)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    _check_csr(x, src, row_offsets, w)
    from .gat_layer import check_cuda_args

    check_cuda_args(x.device, x=x, src=src, row_offsets=row_offsets,
                    **({} if w is None else {"w": w}))
    from .build import library

    n_rows = row_offsets.shape[0] - 1
    out = torch.empty(n_rows, x.shape[1], dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = library("csr_segment_sum")(
        x.data_ptr(), src.data_ptr(), row_offsets.data_ptr(),
        None if w is None else w.data_ptr(), out.data_ptr(), n_rows,
        x.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"csr_segment_sum launch failed: cudaError {err}")
    global csr_launches
    csr_launches += 1
    return out


class CSRSegmentSum(torch.autograd.Function):
    """``CSRSegmentSum.apply(x, w, layout)`` -> csr_segment_sum over the
    layout's stream (src, row_offsets), [n_rows, D]. The backward is
    csc_segment_sum(g, w, None) over the layout's CSC; w gets no
    gradient."""

    @staticmethod
    def forward(ctx, x, w, layout):
        ctx.save_for_backward(x, w)
        ctx.layout = layout
        return csr_segment_sum(x, layout.src, layout.row_offsets, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        d_x, _ = csc_segment_sum(g.contiguous(), w, None, x, None, ctx.layout)
        return d_x, None, None
