"""Host-to-device streamed products over a feature table kept on the host.

Counterpart of ``kgwas_tpu/ops/streaming.py``. Giant frozen feature tables
(PoPS gene features, 57,742 columns: reference ``kgwas_data.py:244``) stay
in host memory; only the first encoder layer reads them:

    h1  = X @ W1 + b1       forward: X streamed in column chunks
    dW1 = X^T @ dh1         backward: a second streamed pass; no dX

``StreamedLinear`` is that layer as an autograd function, so ``W1`` and
``b1`` stay ordinary parameters of the model. The products are plain
``torch.matmul`` (the JAX package runs them outside any Pallas kernel).

On the card a chunk of columns is gathered on the host, in row blocks on
a few threads, into one of two pinned staging buffers (a column slice of
a row-major table is a strided gather), copied on a copy stream into one
of two device buffers, and multiplied on the current stream once an event
says its copy landed: the copy of chunk k+1 overlaps the product of chunk
k. ``stats`` counts the host gather time, the chunks and the bytes copied
to the device.
"""
from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

COL_CHUNK = 8192

# host gather seconds, chunks and host-to-device bytes since the last reset
stats = {"gather_s": 0.0, "chunks": 0, "h2d_bytes": 0}


def reset_stats():
    stats.update(gather_s=0.0, chunks=0, h2d_bytes=0)


# host threads of the gather: numpy's copy releases the GIL, and one thread
# does not reach the host's memory rate on a strided copy
GATHER_THREADS = min(8, os.cpu_count() or 1)
_pool = None


def _gather(dst: np.ndarray, x_host, c0: int, c1: int):
    """dst = x_host[:, c0:c1] (a strided copy), in row blocks on
    GATHER_THREADS threads."""
    global _pool
    t0 = time.perf_counter()
    n = dst.shape[0]
    rows = max(1, -(-n // GATHER_THREADS))
    blocks = [(r, min(r + rows, n)) for r in range(0, n, rows)]
    if len(blocks) > 1:
        if _pool is None:
            _pool = ThreadPoolExecutor(GATHER_THREADS,
                                       thread_name_prefix="gather")
        list(_pool.map(lambda b: np.copyto(dst[b[0]:b[1]],
                                           x_host[b[0]:b[1], c0:c1],
                                           casting="same_kind"), blocks))
    else:
        np.copyto(dst, x_host[:, c0:c1], casting="same_kind")
    stats["gather_s"] += time.perf_counter() - t0
    stats["chunks"] += 1


class _Staging:
    """Two pinned host buffers and two device buffers of n x col_chunk
    float32 each, and a copy stream; kept across calls (pinned memory is
    slow to allocate)."""

    def __init__(self, n: int, col_chunk: int, device):
        size = n * col_chunk
        self.host = [torch.empty(size, dtype=torch.float32, pin_memory=True)
                     for _ in range(2)]
        self.dev = [torch.empty(size, dtype=torch.float32, device=device)
                    for _ in range(2)]
        self.copied = [torch.cuda.Event() for _ in range(2)]
        self.consumed = [None, None]
        self.stream = torch.cuda.Stream(device=device)
        self.key = (n, col_chunk, device)


_staging = None


def _stage(n, col_chunk, device):
    global _staging
    key = (n, col_chunk, device)
    if _staging is None or _staging.key != key:
        _staging = None
        _staging = _Staging(n, col_chunk, device)
    return _staging


def column_chunks(x_host, device, col_chunk: int = COL_CHUNK):
    """Yield (c0, c1, chunk): the columns [c0, c1) of the host table as an
    [N, c1 - c0] float32 tensor on ``device``, in column order. On the card
    the chunk lives in a reused buffer: the caller must have issued its
    last use of it (on the current stream) before asking for the next."""
    n, d = x_host.shape
    bounds = [(c0, min(c0 + col_chunk, d)) for c0 in range(0, d, col_chunk)]
    device = torch.device(device)
    if device.type != "cuda":
        for c0, c1 in bounds:
            dst = np.empty((n, c1 - c0), dtype=np.float32)
            _gather(dst, x_host, c0, c1)
            yield c0, c1, torch.from_numpy(dst).to(device)
        return
    st = _stage(n, col_chunk, device)
    compute = torch.cuda.current_stream(device)

    def issue(k):
        c0, c1 = bounds[k]
        b = k % 2
        width = c1 - c0
        # the pinned buffer's previous copy (chunk k - 2) must have landed
        st.copied[b].synchronize()
        host = st.host[b][: n * width].view(n, width)
        _gather(host.numpy(), x_host, c0, c1)
        with torch.cuda.stream(st.stream):
            if st.consumed[b] is not None:
                # the device buffer's previous product (chunk k - 2)
                st.stream.wait_event(st.consumed[b])
            dev = st.dev[b][: n * width].view(n, width)
            dev.copy_(host, non_blocking=True)
            st.copied[b].record(st.stream)
        stats["h2d_bytes"] += n * width * 4
        return dev

    dev = issue(0)
    for k, (c0, c1) in enumerate(bounds):
        nxt = issue(k + 1) if k + 1 < len(bounds) else None
        compute.wait_event(st.copied[k % 2])
        yield c0, c1, dev
        ev = torch.cuda.Event()
        ev.record(compute)
        st.consumed[k % 2] = ev
        dev = nxt


def streamed_matmul(x_host, w: torch.Tensor, bias=None,
                    col_chunk: int = COL_CHUNK, row_pad_to=None):
    """h = x_host @ w (+ bias): x_host [N, D] on the host (numpy or a
    memmap), w [D, H] on the device. Rows past N up to row_pad_to are the
    product of zero features: bias alone (the in-HBM pad rows)."""
    n, _ = x_host.shape
    n_out = row_pad_to if row_pad_to is not None else n
    acc = torch.zeros((n_out, w.shape[1]), dtype=w.dtype, device=w.device)
    for c0, c1, xc in column_chunks(x_host, w.device, col_chunk):
        acc[:n] += xc @ w[c0:c1]
    if bias is not None:
        acc += bias
    return acc


def streamed_grad_w_t(x_host, dh: torch.Tensor,
                      col_chunk: int = COL_CHUNK) -> torch.Tensor:
    """dW^T = dh^T @ x_host, [H, D] (a Linear weight's layout), streamed
    over column chunks: chunk [c0, c1) gives columns [c0, c1)."""
    n, d = x_host.shape
    out = torch.empty((dh.shape[1], d), dtype=dh.dtype, device=dh.device)
    dh_t = dh[:n].t()
    for c0, c1, xc in column_chunks(x_host, dh.device, col_chunk):
        out[:, c0:c1] = dh_t @ xc
    return out


def streamed_grad_w(x_host, dh: torch.Tensor,
                    col_chunk: int = COL_CHUNK) -> torch.Tensor:
    """dW = x_host^T @ dh, [D, H], streamed over column chunks."""
    return streamed_grad_w_t(x_host, dh, col_chunk).t()


class StreamedLinear(torch.autograd.Function):
    """h1 = x_host @ weight^T + bias over a host table, rows padded to
    n_pad with bias rows. weight is a Linear's [H, D]. Backward: the weight
    gradient by a second streamed pass, the bias gradient the sum of dh1
    over all n_pad rows (the pad rows' h1 is the bias), none for x_host."""

    @staticmethod
    def forward(ctx, weight, bias, x_host, n_pad, col_chunk):
        ctx.x_host, ctx.col_chunk = x_host, col_chunk
        return streamed_matmul(x_host, weight.detach().t(), bias.detach(),
                               col_chunk, row_pad_to=n_pad)

    @staticmethod
    def backward(ctx, dh1):
        dw = streamed_grad_w_t(ctx.x_host, dh1, ctx.col_chunk)
        return dw, dh1.sum(dim=0), None, None, None
