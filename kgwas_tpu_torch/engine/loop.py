"""The training step, the full-graph forward and the seed-batch schedule.

Counterpart of ``kgwas_tpu/engine/loop.py``. A step is one full-graph
forward and backward with the loss restricted to the step's seed batch, the
LDSC-weighted MSE of the reference: ``mean(w * (pred[:, 0][b] - y[b])^2)``.
"""
from __future__ import annotations

import numpy as np
import torch


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
