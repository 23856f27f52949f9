"""CSC segment sum: the source-row half of the merged GAT layer's backward.

Counterpart of ``kgwas_tpu/ops/pallas_segment.py``'s ``pallas_segment_sum``
(``_segsum_kernel``) as ``gather_rows_csc``'s backward uses it:
``take(d_msgs, csc_perm)`` followed by the sorted segment sum over source
rows. Here the ``[E, D]`` message cotangent is never formed. Per source row
s of the concatenated table ``xs_all``:

    d_xs[s]      = sum_{e: src_e = s} (w_e g[row_e] + dz_e att[slot(s)])
    d_att[slot]  = sum_{s in slot} c_s xs[s],   c_s = sum_{e: src_e = s} dz_e

with ``w`` and ``dz`` from ``gat_layer.merged_gat_bwd``, ``g`` the layer
output's cotangent (row ``row_e % N`` of it with the fold), and ``slot(s)``
the relation whose block ``[src_base[r], src_base[r+1])`` holds s.

``csc_segment_sum`` launches ``csrc/csc_segment_sum.cu`` for CUDA tensors
and runs ``csc_segment_sum_plain`` for CPU tensors; there is no other
route. ``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

# source rows per block of the kernel (csc_segment_sum.cu kBlockRows): a
# block's d_att partial belongs to one slot, so every slot boundary
# src_base[r] must be a multiple of it
BLOCK_ROWS = 64
MAX_SLOTS = 32

launches = 0


def _slots(layout, xs_all, att):
    src_base = list(layout.src_base)
    n_rel = len(src_base) - 1
    if xs_all.dim() != 2 or xs_all.shape[0] != src_base[-1]:
        raise ValueError(f"xs_all {tuple(xs_all.shape)} does not match the "
                         f"layout's {src_base[-1]} source rows")
    if att.shape != (n_rel, xs_all.shape[1]):
        raise ValueError(f"att {tuple(att.shape)} != ({n_rel}, "
                         f"{xs_all.shape[1]})")
    return src_base, n_rel


def csc_segment_sum_plain(g, w, dz, xs_all, att, layout, fold=0):
    """Plain PyTorch version: the [E, D] message cotangent formed in full
    and summed per source row with index_add_. Same arguments and results
    as csc_segment_sum."""
    src_base, n_rel = _slots(layout, xs_all, att)
    n = layout.n_rows_per_rel
    dst = layout.dst.long()
    src = layout.src.long()
    d_msgs = (w[:, None] * g[dst % n if fold else dst]
              + dz[:, None] * att[dst // n])
    d_xs = torch.zeros_like(xs_all).index_add_(0, src, d_msgs)
    c = torch.zeros(xs_all.shape[0], dtype=xs_all.dtype,
                    device=xs_all.device).index_add_(0, src, dz)
    slot = torch.repeat_interleave(
        torch.arange(n_rel, device=xs_all.device),
        torch.tensor(src_base, device=xs_all.device).diff())
    d_att = torch.zeros_like(att).index_add_(0, slot, c[:, None] * xs_all)
    return d_xs, d_att


def csc_segment_sum(g, w, dz, xs_all, att, layout, fold=0):
    """(d_xs_all [S, D], d_att [R, D]) of one destination group's layer.

    g [N, D] with fold=R (else [R*N, D]) is the layer output's cotangent;
    w, dz [E] the per-edge weights and logit cotangents of merged_gat_bwd;
    xs_all [S, D] and att [R, D] the layer's inputs; layout the group's
    DeviceLayout (models/hetero_gnn.py), whose src, dst, csc_perm,
    csc_offsets and src_base this reads."""
    if xs_all.device.type == "cpu":
        return csc_segment_sum_plain(g, w, dz, xs_all, att, layout, fold)
    if xs_all.device.type != "cuda":
        raise ValueError(f"unsupported device {xs_all.device}")
    src_base, n_rel = _slots(layout, xs_all, att)
    n = layout.n_rows_per_rel
    d = xs_all.shape[1]
    if g.shape != ((n if fold else n * n_rel), d):
        raise ValueError(f"g {tuple(g.shape)} does not match the layout")
    if n_rel > MAX_SLOTS or any(b % BLOCK_ROWS for b in src_base):
        raise ValueError(f"src_base {src_base}: at most {MAX_SLOTS} slots, "
                         f"each a multiple of {BLOCK_ROWS} rows")
    e = layout.csc_perm.shape[0]
    if w.shape != (e,) or dz.shape != (e,):
        raise ValueError(f"w and dz must be ({e},)")
    from .gat_layer import check_cuda_args

    check_cuda_args(xs_all.device, g=g, w=w, dz=dz, xs_all=xs_all, att=att,
                    dst=layout.dst, csc_perm=layout.csc_perm,
                    csc_offsets=layout.csc_offsets)
    from .build import library

    n_src = src_base[-1]
    d_xs = torch.empty_like(xs_all)
    d_att = torch.empty_like(att)
    partial = torch.empty(n_src // BLOCK_ROWS, d, dtype=torch.float32,
                          device=xs_all.device)
    bases = (ctypes.c_longlong * (n_rel + 1))(*src_base)
    stream = torch.cuda.current_stream(xs_all.device).cuda_stream
    err = library("csc_segment_sum")(
        g.data_ptr(), w.data_ptr(), dz.data_ptr(), xs_all.data_ptr(),
        att.data_ptr(), layout.dst.data_ptr(), layout.csc_perm.data_ptr(),
        layout.csc_offsets.data_ptr(), bases, d_xs.data_ptr(),
        d_att.data_ptr(), partial.data_ptr(), n_rel, n, int(bool(fold)), d,
        stream)
    if err != 0:
        raise RuntimeError(f"csc_segment_sum launch failed: cudaError {err}")
    global launches
    launches += 1
    return d_xs, d_att
