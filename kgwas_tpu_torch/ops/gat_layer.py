"""Merged-relation GAT layer: CUDA kernel wrappers, plain versions, autograd.

Counterpart of ``kgwas_tpu/ops/pallas_gat_layer.py`` (``_merged_forward``,
``_merged_backward`` and the ops that call them, ``fused_gat_layer`` /
``fused_gat_layer_unnorm``) fused with the source-row gather before them
(``gather_rows_csc``, whose backward is ``ops/segment.py``). The edge stream
is one destination group's merged CSR (``graph/merged_layout.py``): ``src``
indexes the concatenated projected source table ``xs_all``, ``row_offsets``
bounds each row's edges, and a row's relation slot is
``row // n_rows_per_rel``.

``merged_gat_forward`` launches ``csrc/merged_gat_fwd.cu`` and
``merged_gat_bwd`` launches ``csrc/merged_gat_bwd.cu`` for CUDA tensors;
for CPU tensors they run ``merged_gat_forward_plain`` and
``merged_gat_bwd_plain``. There is no other route. ``launches`` and
``bwd_launches`` count calls of the two wrappers that reach the card; each
such call is two device launches when the schedule cuts a unit into
chunks (the items, then the combine), else one. ``MergedGATLayer`` is the
layer as an autograd function: its backward is ``merged_gat_bwd`` followed
by ``segment.csc_segment_sum``.

bf16 messages. ``xs_all`` may be bfloat16 (the dtype options: the stream
or compute dtype); then ``merged_gat_forward`` and ``merged_gat_bwd``
launch the bf16 instances of the two kernels (entry points
``kgwas_merged_gat_fwd_bf16`` and ``kgwas_merged_gat_bwd_bf16`` of the
same sources; counted in ``bf16_launches`` and ``bf16_bwd_launches``),
and the plain versions round where the TPU kernels round
(``pallas_gat_layer.py`` ``_logits_row``, ``_make_fwd_kernel``,
``_make_bwd_kernel``):
``att`` to bf16 before the score, each weight to bf16 before it multiplies
its message (the softmax weight exp(l - row_max) against the row's max),
``g`` to bf16 before ``g . msg``; every product of two bf16 values is exact
in float32, every sum is float32, and ``att``, ``a_dst``, the outputs, the
row statistics and the edge terms stay float32. The softmax backward takes
``dot_row`` (the output row dotted with ``g``, in float32) as the sum over
the row's edges of the rounded weight times ``g . msg`` with ``g`` unrounded,
over ``row_sum + 1e-16``. The [E, D] message cotangent, which the TPU
kernel rounds to bf16 when it writes it, is rounded where
``segment.csc_segment_sum`` forms each row.

An edge's score depends on its source row alone: slot r owns the rows
``src_base[r]`` .. ``src_base[r+1]`` of ``xs_all`` (``check_src_owner``,
run once where a layout is built). So the bf16 instances take the scores
per source row, ``a_src[s] = bf16(att[slot(s)]) . xs_all[s]``, from a pass
of their own (``merged_gat_a_src``: ``kgwas_merged_gat_a_src_bf16`` in
``merged_gat_fwd.cu``, counted in ``a_src_launches``; its plain version
``merged_gat_a_src_plain``), with the bits of the per-edge score; the
edge kernels read ``a_src[src_e]``, 4 bytes an edge. A bf16 table on the
card needs ``a_src=`` in both wrappers; ``MergedGATLayer`` runs the pass
once per forward and saves ``a_src`` for the backward.

Both kernels take their work from a static schedule (``schedule``, built
once per layout on the host, ``ops/schedule.py``): items that pack the slot
rows of consecutive units (output rows) up to ``max_edges`` edges, and
chunks of at most ``chunk_edges`` edges of the slot rows of a longer unit,
whose partials a second launch combines in a fixed order.
"""
from __future__ import annotations

import ctypes

import torch

from . import segment
from .schedule import (BWD_ITEM_MAX_EDGES, ITEM_MAX_EDGES, ITEM_MAX_ROWS,
                       ITEM_MAX_UNITS, check_device_schedule)
from .schedule import schedule as _schedule
from .segment_ref import round_bf16

NEG_BIG = -1e9
EXP_CLAMP = 60.0
EPS = 1e-16
MODES = ("softmax", "sigmoid", "raw")
MAX_EDGES = 128   # the default max_edges (PERF.md: tuned on the card)
# the default chunk_edges: a whole slot row of up to 511 pad edges is one
# chunk, so a trash row's sum of identical terms keeps the plain version's
# sequential order (shorter chunks round it differently; PERF.md)
CHUNK_EDGES = 512
# the backward's chunk_edges: its sums are trees, so a trash row may be cut
# shorter, and its warps then end with the others'
BWD_CHUNK_EDGES = 128

launches = 0
bwd_launches = 0
bf16_launches = 0
bf16_bwd_launches = 0
a_src_launches = 0
A_SRC_MAX_SLOTS = 32   # merged_gat_fwd.cu kMaxSlots


def schedule(row_offsets, n_rows_per_rel, fold=0, max_edges=MAX_EDGES,
             chunk_edges=CHUNK_EDGES):
    """The merged GAT kernels' schedule of a stream (ops/schedule.py): a
    unit is a node (fold = R: its R slot rows r*N + n) or a slot row
    (fold = 0), at most ITEM_MAX_UNITS units a packed item."""
    return _schedule(row_offsets, n_rows_per_rel, fold, max_edges,
                     chunk_edges)


def _check(xs_all, src, row_offsets, att, a_dst_all, n_rows_per_rel, fold,
           mode):
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    n_rows = row_offsets.shape[0] - 1
    if n_rows_per_rel <= 0 or n_rows % n_rows_per_rel:
        raise ValueError(
            f"row count {n_rows} is not a multiple of n_rows_per_rel "
            f"{n_rows_per_rel}")
    n_rel = n_rows // n_rows_per_rel
    if fold not in (0, n_rel):
        raise ValueError(f"fold must be 0 or R={n_rel}, got {fold}")
    if xs_all.dim() != 2 or att.shape != (n_rel, xs_all.shape[1]):
        raise ValueError(
            f"xs_all {tuple(xs_all.shape)} and att {tuple(att.shape)} do not "
            f"match R={n_rel}")
    if a_dst_all.shape != (n_rows,):
        raise ValueError(f"a_dst_all {tuple(a_dst_all.shape)} != ({n_rows},)")
    if src.dim() != 1:
        raise ValueError("src must be 1-D")
    return n_rows, n_rel


_INT_ARGS = ("src", "row_offsets", "dst", "csc_rows", "csc_perm",
             "csc_offsets")
# the value tables a kernel also takes in bf16 (its bf16 instance)
_BF16_ARGS = ("xs_all", "x")


def check_cuda_args(device, bf16=(), **tensors):
    """What every kernel of the port takes: tensors on ``device``,
    contiguous, int32 for the layout's index arrays, float32 or bfloat16
    for the value tables (``xs_all``, ``x``, and the names in ``bf16``,
    which a call takes in either: the relation wrappers' ``xs`` and
    ``logits``; bf16 rows of an even width, 4-byte aligned) and float32
    for the rest, feature rows at most 512 wide and 16-byte aligned when
    their width is a multiple of 128 (float4 rows)."""
    for name, t in tensors.items():
        dtype = torch.int32 if name in _INT_ARGS else torch.float32
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if ((name in _BF16_ARGS or name in bf16)
                and t.dtype == torch.bfloat16):
            if t.dim() == 2 and t.shape[1] % 2:
                raise ValueError(f"{name}: bf16 rows must have an even "
                                 f"width, got {t.shape[1]}")
            if t.dim() == 2 and t.data_ptr() % 4:
                raise ValueError(f"{name}: bf16 rows must be 4-byte "
                                 "aligned")
        elif t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dim() == 2:
            if t.shape[1] > 512:
                raise ValueError(
                    f"feature width {t.shape[1]} > 512 is not supported")
            if t.shape[1] % 128 == 0 and t.data_ptr() % 16:
                raise ValueError(f"{name} must be 16-byte aligned")


def merged_gat_forward_plain(xs_all, src, row_offsets, att, a_dst_all,
                             n_rows_per_rel, fold=0, mode="softmax",
                             negative_slope=0.2, temperature=1.0):
    """Plain PyTorch version: gather, per-edge logits, scatter softmax and
    index_add aggregation. Same arguments and results as
    merged_gat_forward; with bf16 xs_all, each weight rounded to bf16
    before it multiplies its message."""
    n_rows, n_rel = _check(xs_all, src, row_offsets, att, a_dst_all,
                           n_rows_per_rel, fold, mode)
    dev = xs_all.device
    d = xs_all.shape[1]
    bf16 = xs_all.dtype == torch.bfloat16
    dst, msgs, _, l = _edge_terms(xs_all, src, row_offsets, att, a_dst_all,
                                  n_rows_per_rel, negative_slope, temperature)
    row_max = torch.full((n_rows,), NEG_BIG, dtype=torch.float32, device=dev)
    row_sum = torch.zeros(n_rows, dtype=torch.float32, device=dev)
    out = torch.zeros(n_rows, d, dtype=torch.float32, device=dev)
    if mode == "softmax":
        row_max = row_max.scatter_reduce(0, dst, l, "amax", include_self=True)
        w = torch.exp(torch.clamp(l - row_max[dst], max=EXP_CLAMP))
        row_sum.index_add_(0, dst, w)
        out.index_add_(0, dst, (round_bf16(w) if bf16 else w)[:, None]
                       * msgs)
        out = out / (row_sum + EPS)[:, None]
    else:
        w = torch.sigmoid(l) if mode == "sigmoid" else l * temperature
        out.index_add_(0, dst, (round_bf16(w) if bf16 else w)[:, None]
                       * msgs)
    if fold:
        out = out.reshape(fold, n_rows_per_rel, d).sum(0)
    return out, row_max, row_sum


def _device_schedule(sched, row_offsets, n_rows, n_rows_per_rel, fold,
                     device, backward=False):
    """The schedule a launch uses: the caller's, checked against the
    stream, or (tests and ad-hoc calls) one built now from row_offsets."""
    if sched is None:
        sched = schedule(row_offsets, n_rows_per_rel, fold,
                         chunk_edges=BWD_CHUNK_EDGES if backward
                         else CHUNK_EDGES).to(device)
    return check_device_schedule(
        sched, n_rows, fold if fold else 1,
        BWD_ITEM_MAX_EDGES if backward else ITEM_MAX_EDGES, device)


def _check_src_base(src_base, n_rel, n_src):
    """src_base: n_rel + 1 non-decreasing row indices of a table of n_src
    rows, at most A_SRC_MAX_SLOTS slots."""
    base = [int(b) for b in src_base]
    if len(base) != n_rel + 1:
        raise ValueError(f"src_base {base} does not give R={n_rel} slots")
    if n_rel > A_SRC_MAX_SLOTS:
        raise ValueError(f"{n_rel} slots > {A_SRC_MAX_SLOTS} are not "
                         "supported")
    if base[0] < 0 or base[-1] > n_src or any(
            b1 < b0 for b0, b1 in zip(base, base[1:])):
        raise ValueError(f"src_base {base} is not a non-decreasing split "
                         f"of {n_src} source rows")
    return base


def check_src_owner(src, row_offsets, n_rows_per_rel, src_base):
    """Raises unless every edge of slot row r*N + n reads a source row that
    slot r owns, src_base[r] <= src[e] < src_base[r+1], over the stream's
    row_offsets[-1] edges: the bf16 instances take each edge's score as
    a_src[src_e], scored with its slot's att. Host arrays or tensors (a
    host sync); run once where a layout is built."""
    ro = torch.as_tensor(row_offsets).cpu().long()
    n_rows = ro.shape[0] - 1
    base = torch.tensor(_check_src_base(src_base, n_rows // n_rows_per_rel,
                                        torch.iinfo(torch.int64).max))
    s = torch.as_tensor(src).cpu().long()[:int(ro[-1])]
    slot = torch.repeat_interleave(
        torch.arange(n_rows) // n_rows_per_rel, ro.diff())
    bad = ((s < base[slot]) | (s >= base[slot + 1])).nonzero()
    if bad.numel():
        e = int(bad[0, 0])
        r = int(slot[e])
        raise ValueError(
            f"edge {e} of slot {r} reads source row {int(s[e])}, outside "
            f"the slot's rows {int(base[r])}..{int(base[r + 1])}")


def merged_gat_a_src_plain(xs_all, att, src_base):
    """Plain version of merged_gat_a_src: each source row's score with its
    slot's att (rounded to bf16 for a bf16 table), the score the plain
    versions form per edge; 0 on rows outside the slots."""
    x = xs_all.to(torch.float32)
    if xs_all.dtype == torch.bfloat16:
        att = round_bf16(att)
    base = [int(b) for b in src_base]
    a_src = torch.zeros(xs_all.shape[0], dtype=torch.float32,
                        device=xs_all.device)
    for r, (b0, b1) in enumerate(zip(base, base[1:])):
        a_src[b0:b1] = (x[b0:b1] * att[r]).sum(-1)
    return a_src


def merged_gat_a_src(xs_all, att, src_base):
    """The bf16 instances' scores per source row: a_src [S] float32 with
    a_src[s] = bf16(att[r]) . xs_all[s] for src_base[r] <= s <
    src_base[r+1] (R = len(src_base) - 1 slots, att [R, D] float32), 0
    outside the slots. A bf16 xs_all on the card launches
    kgwas_merged_gat_a_src_bf16 (counted in a_src_launches); a CPU table
    runs merged_gat_a_src_plain."""
    if xs_all.device.type == "cpu":
        return merged_gat_a_src_plain(xs_all, att, src_base)
    if xs_all.device.type != "cuda":
        raise ValueError(f"unsupported device {xs_all.device}")
    if xs_all.dtype != torch.bfloat16:
        raise TypeError(f"the score pass takes a bf16 table, got "
                        f"{xs_all.dtype}")
    n_rel = len(src_base) - 1
    if xs_all.dim() != 2 or att.shape != (n_rel, xs_all.shape[1]):
        raise ValueError(f"xs_all {tuple(xs_all.shape)} and att "
                         f"{tuple(att.shape)} do not match R={n_rel}")
    check_cuda_args(xs_all.device, xs_all=xs_all, att=att)
    n_src = xs_all.shape[0]
    base = _check_src_base(src_base, n_rel, n_src)
    from .build import library

    dev = xs_all.device
    whole = base[0] == 0 and base[-1] == n_src
    a_src = (torch.empty if whole else torch.zeros)(
        n_src, dtype=torch.float32, device=dev)
    err = library("merged_gat_a_src_bf16")(
        xs_all.data_ptr(), att.data_ptr(), a_src.data_ptr(),
        (ctypes.c_longlong * (n_rel + 1))(*base), n_rel, xs_all.shape[1],
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"merged_gat_a_src launch failed: cudaError {err}")
    global a_src_launches
    a_src_launches += 1
    return a_src


def _check_a_src(xs_all, a_src):
    """a_src for a bf16 instance's launch: merged_gat_a_src of xs_all,
    which a bf16 table on the card must be given."""
    if a_src is None:
        raise ValueError("a bf16 xs_all on the card needs a_src "
                         "(merged_gat_a_src)")
    if (a_src.shape != (xs_all.shape[0],) or a_src.dtype != torch.float32
            or a_src.device != xs_all.device or not a_src.is_contiguous()):
        raise ValueError(f"a_src must be float32 ({xs_all.shape[0]},) on "
                         f"{xs_all.device}, contiguous")
    return a_src


def merged_gat_forward(xs_all, src, row_offsets, att, a_dst_all,
                       n_rows_per_rel, fold=0, mode="softmax",
                       negative_slope=0.2, temperature=1.0, sched=None,
                       a_src=None):
    """Merged GAT layer forward over one destination group.

    xs_all [S, D] f32 (or bf16) concatenated projected source rows; src [E] int32 into
    xs_all (dst-sorted); row_offsets [R*N+1] int32; att [R, D] per-slot
    attention vectors; a_dst_all [R*N] per-row destination logits;
    n_rows_per_rel = N. Returns (out, row_max, row_sum): out is [R*N, D],
    or with fold=R the cross-relation sum [N, D]; row_max and row_sum are
    [R*N] (NEG_BIG and 0 for empty rows and for the sigmoid/raw modes).
    sched: the stream's schedule for this fold on the device (built
    from row_offsets when not given); the plain version needs none.
    a_src: merged_gat_a_src of xs_all and att over the layout's
    src_base, which a bf16 xs_all on the card needs; the plain version
    scores each edge itself and does not read it."""
    if xs_all.device.type == "cpu":
        return merged_gat_forward_plain(
            xs_all, src, row_offsets, att, a_dst_all, n_rows_per_rel, fold,
            mode, negative_slope, temperature)
    if xs_all.device.type != "cuda":
        raise ValueError(f"unsupported device {xs_all.device}")
    n_rows, n_rel = _check(xs_all, src, row_offsets, att, a_dst_all,
                           n_rows_per_rel, fold, mode)
    check_cuda_args(xs_all.device, xs_all=xs_all, src=src,
                    row_offsets=row_offsets, att=att, a_dst_all=a_dst_all)
    bf16 = xs_all.dtype == torch.bfloat16
    d = xs_all.shape[1]
    if fold and n_rel > ITEM_MAX_ROWS:
        raise ValueError(f"fold over R={n_rel} > 32 relations is not supported")
    if bf16:
        _check_a_src(xs_all, a_src)
    sched = _device_schedule(sched, row_offsets, n_rows, n_rows_per_rel,
                             fold, xs_all.device)
    from .build import library

    dev = xs_all.device
    n_out = n_rows_per_rel if fold else n_rows
    out = torch.empty(n_out, d, dtype=torch.float32, device=dev)
    row_max = torch.empty(n_rows, dtype=torch.float32, device=dev)
    row_sum = torch.empty(n_rows, dtype=torch.float32, device=dev)
    # the chunks' partials (m, s, acc) for the combine
    part_m = torch.empty(sched.n_parts, dtype=torch.float32, device=dev)
    part_s = torch.empty(sched.n_parts, dtype=torch.float32, device=dev)
    part_acc = torch.empty(sched.n_parts, d, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scores = (a_src.data_ptr(),) if bf16 else ()
    err = library("merged_gat_fwd_bf16" if bf16 else "merged_gat_fwd")(
        xs_all.data_ptr(), src.data_ptr(), row_offsets.data_ptr(),
        att.data_ptr(), a_dst_all.data_ptr(), *scores, out.data_ptr(),
        row_max.data_ptr(), row_sum.data_ptr(), sched.items.data_ptr(),
        sched.items.shape[0], sched.split_units.data_ptr(),
        sched.part_offsets.data_ptr(), sched.split_units.shape[0],
        part_m.data_ptr(), part_s.data_ptr(), part_acc.data_ptr(),
        n_rows_per_rel, sched.fold_slots, d, MODES.index(mode),
        negative_slope, temperature, stream)
    if err != 0:
        raise RuntimeError(f"merged_gat_fwd launch failed: cudaError {err}")
    global launches, bf16_launches
    if bf16:
        bf16_launches += 1
    else:
        launches += 1
    return out, row_max, row_sum


def _edge_terms(xs_all, src, row_offsets, att, a_dst_all, n_rows_per_rel,
                negative_slope, temperature):
    """Per edge: destination row, gathered source row (float32), pre-
    activation logit z and scaled logit l = leaky_relu(z) / temperature;
    with bf16 xs_all, att rounded to bf16 for the score."""
    n_rows = row_offsets.shape[0] - 1
    row_offsets = row_offsets.long()
    dst = torch.repeat_interleave(torch.arange(n_rows, device=xs_all.device),
                                  row_offsets[1:] - row_offsets[:-1])
    x = xs_all[src[:dst.shape[0]].long()]
    if xs_all.dtype == torch.bfloat16:
        x = x.to(torch.float32)
        att = round_bf16(att)
    z = (x * att[dst // n_rows_per_rel]).sum(-1) + a_dst_all[dst]
    l = torch.where(z >= 0, z, negative_slope * z) / temperature
    return dst, x, z, l


def merged_gat_bwd_plain(xs_all, src, row_offsets, att, a_dst_all, row_max,
                         row_sum, g, n_rows_per_rel, fold=0, mode="softmax",
                         negative_slope=0.2, temperature=1.0):
    """Plain PyTorch version of the merged_gat_bwd kernel, in the TPU
    backward kernel's formulas and constants. Same arguments and results
    as merged_gat_bwd; with bf16 xs_all, g rounded to bf16 for g_row . x_e,
    and dot_row from the forward's rounded weights and the unrounded g."""
    n_rows, _ = _check(xs_all, src, row_offsets, att, a_dst_all,
                       n_rows_per_rel, fold, mode)
    bf16 = xs_all.dtype == torch.bfloat16
    dst, x, z, l = _edge_terms(xs_all, src, row_offsets, att, a_dst_all,
                               n_rows_per_rel, negative_slope, temperature)
    g_rows = g[dst % n_rows_per_rel if fold else dst]
    m = ((round_bf16(g_rows) if bf16 else g_rows) * x).sum(-1)  # g_row . x_e
    leaky_d = torch.where(z >= 0, 1.0, negative_slope)
    if mode == "softmax":
        lse = row_max + torch.log(row_sum + EPS)
        w = torch.exp(torch.clamp(l - lse[dst], max=EXP_CLAMP))
        # dot_r = out_row . g_row, from the row's own edges
        dot_r = torch.zeros(n_rows, dtype=x.dtype, device=x.device)
        if bf16:
            alpha = round_bf16(torch.exp(torch.clamp(l - row_max[dst],
                                                     max=EXP_CLAMP)))
            dot_r.index_add_(0, dst, alpha * (g_rows * x).sum(-1))
            dot_r = dot_r / (row_sum + EPS)
        else:
            dot_r.index_add_(0, dst, w * m)
        dz = w * (m - dot_r[dst]) * leaky_d / temperature
    elif mode == "sigmoid":
        w = torch.sigmoid(l)
        dz = m * w * (1.0 - w) * leaky_d / temperature
    else:
        w = l * temperature
        dz = m * leaky_d
    d_a_dst = torch.zeros(n_rows, dtype=x.dtype, device=x.device)
    d_a_dst.index_add_(0, dst, dz)
    return w, dz, d_a_dst


def merged_gat_bwd(xs_all, src, row_offsets, att, a_dst_all, row_max,
                   row_sum, g, n_rows_per_rel, fold=0, mode="softmax",
                   negative_slope=0.2, temperature=1.0, sched=None,
                   a_src=None):
    """Edge-level backward of merged_gat_forward over one destination group.

    The arguments are merged_gat_forward's, plus its row_max / row_sum and
    the cotangent g of its output ([N, D] with fold=R, else [R*N, D]).
    Returns (w, dz, d_a_dst): per edge of the stream the aggregation weight
    w_e and the cotangent dz_e of the pre-activation logit z_e, both [E],
    and d_a_dst [R*N] = the sum of dz_e over each row. The [E, D] message
    cotangent w_e g_row + dz_e att[slot] is never formed:
    segment.csc_segment_sum reduces it per source row. sched as in
    merged_gat_forward, of items of at most BWD_ITEM_MAX_EDGES edges
    (built with BWD_CHUNK_EDGES when not given); a_src as in
    merged_gat_forward (the forward's, which the layer saves)."""
    if xs_all.device.type == "cpu":
        return merged_gat_bwd_plain(
            xs_all, src, row_offsets, att, a_dst_all, row_max, row_sum, g,
            n_rows_per_rel, fold, mode, negative_slope, temperature)
    if xs_all.device.type != "cuda":
        raise ValueError(f"unsupported device {xs_all.device}")
    n_rows, n_rel = _check(xs_all, src, row_offsets, att, a_dst_all,
                           n_rows_per_rel, fold, mode)
    n_out = n_rows_per_rel if fold else n_rows
    if g.shape != (n_out, xs_all.shape[1]):
        raise ValueError(f"g {tuple(g.shape)} != ({n_out}, {xs_all.shape[1]})")
    if row_max.shape != (n_rows,) or row_sum.shape != (n_rows,):
        raise ValueError(f"row_max / row_sum must be ({n_rows},)")
    check_cuda_args(xs_all.device, xs_all=xs_all, src=src,
                    row_offsets=row_offsets, att=att, a_dst_all=a_dst_all,
                    row_max=row_max, row_sum=row_sum, g=g)
    bf16 = xs_all.dtype == torch.bfloat16
    if fold and n_rel > ITEM_MAX_ROWS:
        raise ValueError(f"fold over R={n_rel} > 32 relations is not supported")
    if bf16:
        _check_a_src(xs_all, a_src)
    sched = _device_schedule(sched, row_offsets, n_rows, n_rows_per_rel,
                             fold, xs_all.device, backward=True)
    from .build import library

    dev = xs_all.device
    e = src.shape[0]
    w = torch.empty(e, dtype=torch.float32, device=dev)
    dz = torch.empty(e, dtype=torch.float32, device=dev)
    d_a_dst = torch.empty(n_rows, dtype=torch.float32, device=dev)
    part_dot = torch.empty(sched.n_parts, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    scores = (a_src.data_ptr(),) if bf16 else ()
    err = library("merged_gat_bwd_bf16" if bf16 else "merged_gat_bwd")(
        xs_all.data_ptr(), src.data_ptr(), row_offsets.data_ptr(),
        att.data_ptr(), a_dst_all.data_ptr(), *scores, row_max.data_ptr(),
        row_sum.data_ptr(), g.data_ptr(), w.data_ptr(), dz.data_ptr(),
        d_a_dst.data_ptr(), sched.items.data_ptr(), sched.items.shape[0],
        sched.split_units.data_ptr(), sched.part_offsets.data_ptr(),
        sched.split_units.shape[0], part_dot.data_ptr(), n_rows_per_rel,
        sched.fold_slots, xs_all.shape[1], MODES.index(mode),
        negative_slope, temperature, stream)
    if err != 0:
        raise RuntimeError(f"merged_gat_bwd launch failed: cudaError {err}")
    global bwd_launches, bf16_bwd_launches
    if bf16:
        bf16_bwd_launches += 1
    else:
        bwd_launches += 1
    return w, dz, d_a_dst


def layout_schedule(layout, fold, backward=False):
    """The forward's or the backward's schedule the layout carries
    (DeviceLayout.gat_schedule or .gat_fold0_schedule, .gat_bwd_schedule),
    if it is this fold's; else None, and the wrapper builds one."""
    names = (("gat_bwd_schedule",) if backward
             else ("gat_schedule", "gat_fold0_schedule"))
    for name in names:
        sched = getattr(layout, name, None)
        if sched is not None and sched.fold_slots == (fold if fold else 1):
            return sched
    return None


def merged_gat_backward_plain(xs_all, att, a_dst_all, row_max, row_sum, g,
                              layout, fold=0, mode="softmax",
                              negative_slope=0.2, temperature=1.0,
                              a_src=None):
    """Plain version of merged_gat_backward: the two plain halves (which
    score each edge themselves: a_src is not read)."""
    w, dz, d_a_dst = merged_gat_bwd_plain(
        xs_all, layout.src, layout.row_offsets, att, a_dst_all, row_max,
        row_sum, g, layout.n_rows_per_rel, fold, mode, negative_slope,
        temperature)
    d_xs_all, d_att = segment.csc_segment_sum_plain(
        g, w, dz, xs_all, att, layout, fold)
    return d_xs_all, d_att, d_a_dst


def merged_gat_backward(xs_all, att, a_dst_all, row_max, row_sum, g, layout,
                        fold=0, mode="softmax", negative_slope=0.2,
                        temperature=1.0, a_src=None):
    """VJP of merged_gat_forward with respect to (xs_all, att, a_dst_all):
    merged_gat_bwd, then the CSC segment sum over source rows. layout is
    the group's DeviceLayout (models/hetero_gnn.py); a_src: the forward's
    scores of a bf16 table on the card (merged_gat_a_src)."""
    w, dz, d_a_dst = merged_gat_bwd(
        xs_all, layout.src, layout.row_offsets, att, a_dst_all, row_max,
        row_sum, g, layout.n_rows_per_rel, fold, mode, negative_slope,
        temperature, sched=layout_schedule(layout, fold, backward=True),
        a_src=a_src)
    d_xs_all, d_att = segment.csc_segment_sum(g, w, dz, xs_all, att, layout,
                                              fold)
    return d_xs_all, d_att, d_a_dst


class MergedGATLayer(torch.autograd.Function):
    """The merged GAT layer with its gradient:
    ``MergedGATLayer.apply(xs_all, att, a_dst_all, layout, fold, mode,
    negative_slope, temperature[, stream_dtype])`` -> out ([N, D] with
    fold=R, else [R*N, D]), float32. The forward saves row_max / row_sum
    (and a bf16 table's a_src); the backward recomputes every edge's
    logit from xs_all, att and a_dst_all (a bf16 table's from a_src and
    a_dst_all). stream_dtype: the dtype the table is cast to inside the
    layer (the stream dtype), so that xs_all's gradient is float32, as
    the JAX package's custom VJP leaves it; every gradient is float32."""

    @staticmethod
    def forward(ctx, xs_all, att, a_dst_all, layout, fold, mode,
                negative_slope, temperature, stream_dtype=None):
        if stream_dtype is not None:
            xs_all = xs_all.to(stream_dtype)
        # the bf16 instances read the scores per source row, taken once
        # for the forward and the backward; the plain versions (a CPU
        # table) score each edge themselves
        a_src = (merged_gat_a_src(xs_all, att, layout.src_base)
                 if xs_all.dtype == torch.bfloat16 and xs_all.is_cuda
                 else None)
        out, row_max, row_sum = merged_gat_forward(
            xs_all, layout.src, layout.row_offsets, att, a_dst_all,
            layout.n_rows_per_rel, fold, mode, negative_slope, temperature,
            sched=layout_schedule(layout, fold), a_src=a_src)
        ctx.save_for_backward(xs_all, att, a_dst_all, row_max, row_sum,
                              a_src)
        ctx.layout = layout
        ctx.options = (fold, mode, negative_slope, temperature)
        return out

    @staticmethod
    def backward(ctx, g):
        xs_all, att, a_dst_all, row_max, row_sum, a_src = ctx.saved_tensors
        d_xs_all, d_att, d_a_dst = merged_gat_backward(
            xs_all, att, a_dst_all, row_max, row_sum, g.contiguous(),
            ctx.layout, *ctx.options, a_src=a_src)
        return d_xs_all, d_att, d_a_dst, None, None, None, None, None, None
