"""The static work schedules of the port's edge-stream kernels.

A schedule splits one CSR-like stream (``offsets`` [n_rows + 1]: row k holds
entries ``offsets[k] .. offsets[k+1]``) into items, one warp each (see
``csrc/gat_items.cuh``). It is built once per layout on the host (numpy)
and kept on the device beside the layout (``models/hetero_gnn.py``
``DeviceLayout``).

A unit is one output row: a destination node with the merged GAT layer's
fold (its R slot rows r*N + n), else one row. Items are int32 quadruples,
in unit order:

  packed (u0, u1, -1, -1): units u0..u1-1 and all their rows, at most
      max_edges entries together, at most ITEM_MAX_ROWS rows and max_units
      units;
  chunk (row, part, e0, e1): entries e0..e1-1 (at most chunk_edges) of one
      row of a unit with more than max_edges entries; its partial result
      goes to scratch index part, and a second launch combines a unit's
      parts in part order.

Users: the merged GAT layer (``gat_layer``: rows of a destination group,
fold R), the per-relation segment softmax forward and backward
(``segment_softmax``: one relation's rows, ``row_schedule``), the CSR
segment sum (``segment``: a merged layout's R*N rows, ``row_schedule``)
and the CSC segment sum (``segment``: source rows of a layout's CSC, whose
items never straddle a slot boundary). The segment kernels' item sizes are
set here, beside the function that builds their schedules.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

# the kernels' item limits (csrc/gat_items.cuh): edges of a merged GAT
# forward item and of the other kernels' items, rows and (merged GAT
# layer) units of one packed item
ITEM_MAX_EDGES, BWD_ITEM_MAX_EDGES = 512, 256
ITEM_MAX_ROWS, ITEM_MAX_UNITS = 32, 8
# The segment kernels' item sizes (each at most BWD_ITEM_MAX_EDGES, the
# most they stage; PERF.md holds the max_edges sweeps that chose them).
# A relation's rows for segment_softmax_spmm_fwd and _bwd (one schedule
# serves both): items of up to 32 rows and ROW_MAX_EDGES edges, a longer
# row cut into chunks of ROW_CHUNK_EDGES (a relation's trash row sums up to
# 511 identical pad terms: its chunks round otherwise than the plain
# version's sequential sum, within the trash rows' rtol 1e-4).
ROW_MAX_EDGES, ROW_CHUNK_EDGES = 128, 128
# A merged layout's R*N rows for csr_segment_sum, the same way.
CSR_MAX_EDGES, CSR_CHUNK_EDGES = 64, 128
# The CSC segment sum's source rows: items of one slot. With the logit term
# (the merged GAT layer) an item's fixed cost is larger (w and dz through
# csc_perm, c per row, its d_att partial), so its items are larger.
CSC_MAX_EDGES, CSC_LOGIT_MAX_EDGES, CSC_CHUNK_EDGES = 64, 256, 128


@dataclasses.dataclass
class Schedule:
    """The static work schedule of one stream (see the module note).
    items int32 [n_items, 4]; the units cut into chunks are split_units
    [n_split], and their parts for slot r are part_offsets[j*F + r] ..
    part_offsets[j*F + r + 1]."""

    n_rows: int
    fold_slots: int
    max_edges: int
    chunk_edges: int
    items: torch.Tensor
    split_units: torch.Tensor
    part_offsets: torch.Tensor
    n_parts: int
    # the first item of each of 0, the breaks, and the end: item_breaks[j]
    # .. item_breaks[j + 1] hold the units between them
    item_breaks: tuple = ()
    # what a kernel wrapper keeps from its first launch on this schedule
    # (checked once): scratch buffers, used only between the device
    # launches of one call on the caller's stream
    cache: dict = dataclasses.field(default_factory=dict, init=False,
                                    repr=False, compare=False)

    def to(self, device):
        return dataclasses.replace(
            self, items=self.items.to(device),
            split_units=self.split_units.to(device),
            part_offsets=self.part_offsets.to(device))


def schedule(row_offsets, n_rows_per_rel, fold=0, max_edges=128,
             chunk_edges=ITEM_MAX_EDGES, max_units=ITEM_MAX_UNITS,
             breaks=()):
    """The schedule of a stream (numpy, on the host). With fold = R a unit
    is a node (its R slot rows r*N + n, N = n_rows_per_rel), else a row.
    Consecutive units are packed into one item while their entries add up
    to at most max_edges (at most ITEM_MAX_ROWS rows and max_units units,
    and no item holds both unit b - 1 and unit b for b in breaks); a unit
    with more entries is cut into chunks of at most chunk_edges entries of
    one row each."""
    for name, k in (("max_edges", max_edges), ("chunk_edges", chunk_edges)):
        if not 1 <= k <= ITEM_MAX_EDGES:
            raise ValueError(f"{name} must be in 1..{ITEM_MAX_EDGES}, got "
                             f"{k}")
    if torch.is_tensor(row_offsets):
        row_offsets = row_offsets.cpu().numpy()
    ro = np.asarray(row_offsets, dtype=np.int64)
    n_rows = len(ro) - 1
    n = int(n_rows_per_rel)
    f = int(fold) if fold else 1
    if f > ITEM_MAX_ROWS:
        raise ValueError(f"fold over R={f} > {ITEM_MAX_ROWS} relations is "
                         "not supported")
    deg = np.diff(ro)
    unit_deg = deg.reshape(f, n).sum(0) if fold else deg
    n_units = len(unit_deg)
    max_units = min(int(max_units), ITEM_MAX_ROWS // f)
    cum = np.zeros(n_units + 1, dtype=np.int64)
    np.cumsum(unit_deg, out=cum[1:])
    # the first unit after u that an item must not reach past: the next
    # break or the end
    breaks = [int(b) for b in breaks]
    if any(not 0 <= b <= n_units for b in breaks):
        raise ValueError(f"breaks {breaks} outside 0..{n_units}")
    stops = np.unique(np.asarray(breaks + [n_units], dtype=np.int64))
    stops = stops[stops > 0]
    # for each unit u: the most units from u whose entries fit (a long unit
    # never fits), and the next stop after u; an item from u ends at the
    # least of them and u + max_units
    first = np.arange(n_units, dtype=np.int64)
    fits = (np.searchsorted(cum, cum[:-1] + max_edges, side="right")
            - 1).tolist()
    nxt = stops[np.searchsorted(stops, first, side="right")].tolist()
    long = (unit_deg > max_edges).tolist()
    items, units, split_units, part_offsets = [], [], [], [0]
    n_parts = 0
    u = 0
    while u < n_units:
        if long[u]:
            split_units.append(u)
            for r in range(f):
                row = r * n + u if fold else u
                beg, end = int(ro[row]), int(ro[row + 1])
                for b in range(beg, end, chunk_edges):
                    items.append((row, n_parts, b, min(b + chunk_edges, end)))
                    units.append(u)
                    n_parts += 1
                part_offsets.append(n_parts)
            u += 1
            continue
        end = min(fits[u], u + max_units, nxt[u])
        items.append((u, end, -1, -1))
        units.append(u)
        u = end
    item_breaks = np.searchsorted(np.asarray(units, dtype=np.int64),
                                  [0] + breaks + [n_units])
    return Schedule(
        n_rows=n_rows, fold_slots=f, max_edges=int(max_edges),
        chunk_edges=int(chunk_edges),
        items=torch.tensor(items, dtype=torch.int32).reshape(-1, 4),
        split_units=torch.tensor(split_units, dtype=torch.int32),
        part_offsets=torch.tensor(part_offsets, dtype=torch.int32),
        n_parts=n_parts, item_breaks=tuple(int(i) for i in item_breaks))


def row_schedule(row_offsets, max_edges=ROW_MAX_EDGES,
                 chunk_edges=ROW_CHUNK_EDGES):
    """The schedule of a stream's rows, fold 0 (host, numpy): a unit is a
    row, up to ITEM_MAX_ROWS of them an item. A relation's stream takes the
    defaults; a merged layout's takes CSR_MAX_EDGES, CSR_CHUNK_EDGES."""
    n_rows = len(row_offsets) - 1
    return schedule(row_offsets, n_rows, 0, max_edges, chunk_edges,
                    max_units=ITEM_MAX_ROWS)


def check_device_schedule(sched, n_rows, fold_slots, most_edges, device):
    """Raises unless sched is a schedule of n_rows rows and fold_slots on
    device whose items hold at most most_edges entries."""
    if sched.n_rows != n_rows or sched.fold_slots != fold_slots:
        raise ValueError(
            f"schedule of {sched.n_rows} rows and fold {sched.fold_slots} "
            f"given for {n_rows} rows and fold {fold_slots}")
    if max(sched.max_edges, sched.chunk_edges) > most_edges:
        raise ValueError(f"the kernel takes items of at most {most_edges} "
                         "edges")
    for name in ("items", "split_units", "part_offsets"):
        t = getattr(sched, name)
        if t.device != device or t.dtype != torch.int32:
            raise ValueError(f"schedule {name} must be int32 on {device}")
    if sched.items.data_ptr() % 16 or not sched.items.is_contiguous():
        raise ValueError("schedule items must be contiguous, 16-byte aligned")
    return sched


def check_stream(sched, key, src, row_offsets, n_rows):
    """Checks a row kernel's stream arrays (src, row_offsets) and its
    schedule of n_rows rows on device key[-1], unless they are the ones
    checked at the last launch under key on this schedule (a layout's
    arrays and schedule never change)."""
    stream = (src.data_ptr(), src.dtype, row_offsets.data_ptr(),
              row_offsets.dtype)
    if sched.cache.get(key) != stream:
        from .gat_layer import check_cuda_args

        check_cuda_args(key[-1], src=src, row_offsets=row_offsets)
        check_device_schedule(sched, n_rows, 1, BWD_ITEM_MAX_EDGES, key[-1])
        sched.cache[key] = stream
    elif sched.n_rows != n_rows:
        raise ValueError(f"schedule of {sched.n_rows} rows given for "
                         f"{n_rows}")
