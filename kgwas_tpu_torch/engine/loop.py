"""The training step, the scanned steps, the full-graph forward and the
seed-batch schedule.

Counterpart of ``kgwas_tpu/engine/loop.py``. A step is one full-graph
forward and backward with the loss restricted to the step's seed batch, the
LDSC-weighted MSE of the reference: ``mean(w * (pred[:, 0][b] - y[b])^2)``.
``TrainScan`` runs S steps a call, the counterpart of ``make_train_scan``
(S steps under one ``lax.scan``): on the card one replay of a CUDA graph
that holds S captured copies of ``train_step``.
"""
from __future__ import annotations

import numpy as np
import torch

from .profiling import span


def batch_loss(pred, batch_idx, y_node, w_node):
    p = pred[:, 0][batch_idx]
    return torch.mean(w_node[batch_idx] * (p - y_node[batch_idx]) ** 2)


def train_step(model, optimizer, x, layouts, batch_idx, y_node, w_node,
               dropout_gen=None):
    """One optimizer step on the seed batch ``batch_idx`` (an int64 tensor on
    the model's device): the forward in training (its layer path; the JAX
    engine's training=True), dropping attention only with ``dropout_gen``,
    a ``torch.Generator`` (the JAX engine passes no dropout_rng, and
    KGWAS.train passes none). Returns the loss as a 0-d tensor, not
    synchronised."""
    optimizer.zero_grad(set_to_none=True)
    loss = batch_loss(model(x, layouts, training=True,
                            dropout_gen=dropout_gen),
                      batch_idx, y_node, w_node)
    loss.backward()
    fill_dead_grads(model)
    optimizer.step()
    return loss.detach()


def fill_dead_grads(model):
    """A zero gradient for each parameter with no path to the loss (a group
    the head does not read): the JAX step's gradient is 0 there, and Adam
    still decays it, so the optimizer's state follows the JAX chain."""
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)


class TrainScan:
    """S optimizer steps a call on the rows of a seed-batch matrix [S, B]
    (``make_train_scan``'s counterpart), over fixed model, optimizer,
    features, layouts and labels.

    On the card the first call runs its S steps eagerly; that builds what
    the steps keep outside a graph's memory pool (the schedules' plans and
    scratch, the stream checks, the optimizer's state). The next call
    captures S copies of ``train_step`` in one ``torch.cuda.CUDAGraph``
    (capture runs nothing): copy i reads row i of a static int64 [S, B]
    batch buffer and writes its loss into a static [S] tensor. Each call
    from then on copies its batches in (pinned, non_blocking) and replays
    the graph on the current stream. The optimizer must be capturable
    (engine/optim.build_optimizer). A capture or replay that fails raises:
    nothing falls back to eager steps. ``reset()`` drops the graph, to be
    captured again at the next call: after ``optimizer.load_state_dict``,
    which replaces the state tensors the graph reads. New features,
    layouts or labels need a new TrainScan.

    On the CPU every call runs its S steps eagerly (the plain version).

    before_capture: called just before a capture (KGWAS.train waits there
    for its checkpoint writes). The capture runs in the
    ``"thread_local"`` error mode, so the checkpoint writer's thread and
    the profiler's may call CUDA meanwhile; ``.item()``, a copy to the host
    or a synchronisation inside the step still breaks the capture and
    raises."""

    def __init__(self, model, optimizer, x, layouts, y_node, w_node,
                 steps: int, before_capture=None):
        if steps < 1:
            raise ValueError(f"steps must be >= 1, got {steps}")
        self.model, self.optimizer = model, optimizer
        self.x, self.layouts = x, layouts
        self.y_node, self.w_node = y_node, w_node
        self.steps = steps
        self.before_capture = before_capture
        self.graph = None
        self.warm = False    # an eager call ran on this state
        self.captures = 0
        self.replays = 0

    def reset(self):
        """Drops the graph: the next call captures it again."""
        self.graph = None

    def _eager(self, batch_mat):
        dev = self.y_node.device
        return torch.stack([
            train_step(self.model, self.optimizer, self.x, self.layouts,
                       torch.as_tensor(np.asarray(b)).to(dev), self.y_node,
                       self.w_node)
            for b in batch_mat])

    @span("kgwas.scan.capture")
    def capture(self, batch: int):
        """Captures S copies of train_step on a static int64 [S, batch]
        batch buffer."""
        dev = self.y_node.device
        self.graph = None
        if self.before_capture is not None:
            self.before_capture()
        self.batch = torch.zeros((self.steps, batch), dtype=torch.int64,
                                 device=dev)
        self.losses = torch.zeros(self.steps, dtype=torch.float32,
                                  device=dev)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            for i in range(self.steps):
                self.losses[i].copy_(train_step(
                    self.model, self.optimizer, self.x, self.layouts,
                    self.batch[i], self.y_node, self.w_node))
        self.graph = graph
        self.captures += 1

    def __call__(self, batch_mat):
        """Losses [S] (a device tensor, not synchronised) of S steps, step
        i on row i of batch_mat (a numpy integer array or an integer
        tensor, [S, B])."""
        if len(batch_mat) != self.steps:
            raise ValueError(f"{len(batch_mat)} batches for a scan of "
                             f"{self.steps} steps")
        if self.y_node.device.type != "cuda" or not self.warm:
            with span("kgwas.scan.eager"):
                losses = self._eager(batch_mat)
            self.warm = True
            return losses
        src = (batch_mat if isinstance(batch_mat, torch.Tensor)
               else torch.from_numpy(np.ascontiguousarray(batch_mat)))
        if self.graph is None:
            self.capture(src.shape[1])
        with span("kgwas.scan.replay"):
            if src.device.type == "cpu":
                src = src.pin_memory()
            self.batch.copy_(src, non_blocking=True)
            self.graph.replay()
            self.replays += 1
            return self.losses.clone()


def forward(model, x, layouts):
    """Full-graph predictions [N_snp_pad]: the first output channel."""
    with torch.inference_mode():
        return model(x, layouts)[:, 0]


def forward_streamed(model, x, layouts, x_host, padded_nodes):
    """``forward`` with host-streamed features (make_forward_streamed's
    counterpart): x holds the stripped tables, x_host the streamed ones."""
    from .streamed import compute_h1

    with torch.inference_mode():
        h1 = compute_h1(model, x_host, padded_nodes)
        return model(x, layouts, h1_override=h1)[:, 0]


def epoch_batches(ids, batch_size: int, shuffle: bool, rng) -> list:
    """Seed batches: consecutive chunks with drop_last, shuffled first with
    the numpy generator ``rng`` when asked."""
    ids = np.asarray(ids)
    if shuffle:
        ids = ids[rng.permutation(len(ids))]
    n_steps = len(ids) // batch_size
    return [ids[i * batch_size:(i + 1) * batch_size] for i in range(n_steps)]
