"""Plain segment primitives: the reference formulas of the port's kernels.

Counterpart of ``kgwas_tpu/ops/segment.py`` in plain PyTorch. Edges arrive
destination-sorted from the shard compiler; pad edges sit at the tail with
``dst`` = the trash row. The plain versions of the kernels in
``segment_softmax.py`` and ``segment.py`` are written with these, and so
are the CPU paths of the model.
"""
from __future__ import annotations

import torch

NEG_BIG = -1e9  # finite -inf stand-in: keeps pad lanes NaN-free
EPS = 1e-16     # the softmax denominator's guard (PyG softmax)


def gather_rows(x, idx):
    """x[idx] along axis 0 (idx int32 or int64)."""
    return x.index_select(0, idx)


def round_bf16(t):
    """t (float32) rounded to the nearest bf16, kept in float32: where the
    TPU kernels round on bf16 operands (the kernels' bf16 instances)."""
    return t.to(torch.bfloat16).to(torch.float32)


def segment_sum(data, segment_ids, num_segments: int):
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids, data)


def segment_max(data, segment_ids, num_segments: int):
    """Per-segment max, NEG_BIG for empty segments."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), NEG_BIG,
                     dtype=data.dtype, device=data.device)
    index = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, index.expand_as(data), data, "amax",
                              include_self=True)


def segment_mean(data, segment_ids, num_segments: int, valid):
    """Mean over the real edges of each segment; empty segments give 0."""
    vf = valid.to(data.dtype)
    data = data * vf.reshape((-1,) + (1,) * (data.dim() - 1))
    sums = segment_sum(data, segment_ids, num_segments)
    counts = segment_sum(vf, segment_ids, num_segments)
    return sums / torch.clamp(counts, min=1.0).reshape(
        (-1,) + (1,) * (sums.dim() - 1))


def segment_softmax(logits, segment_ids, num_segments: int, valid):
    """Softmax over destination segments as PyG computes it (max shift,
    +1e-16 in the denominator), over the real edges; pad edges get 0."""
    v = valid.reshape((-1,) + (1,) * (logits.dim() - 1))
    masked = torch.where(v, logits, torch.full_like(logits, NEG_BIG))
    seg_max = segment_max(masked, segment_ids, num_segments).detach()
    shifted = torch.where(v, logits - gather_rows(seg_max, segment_ids), 0.0)
    expd = torch.where(v, torch.exp(shifted), 0.0)
    denom = segment_sum(expd, segment_ids, num_segments) + EPS
    return expd / gather_rows(denom, segment_ids)


def leaky_relu(x, negative_slope: float):
    return torch.where(x >= 0, x, negative_slope * x)


def csr_rows(row_offsets):
    """Each edge's row [E] (int64) of a CSR's row_offsets [n_rows + 1]."""
    ro = row_offsets.long()
    return torch.repeat_interleave(
        torch.arange(ro.shape[0] - 1, device=ro.device), ro[1:] - ro[:-1])
