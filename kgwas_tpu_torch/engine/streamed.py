"""The training step with host-streamed giant input features.

Counterpart of ``kgwas_tpu/engine/streamed.py``. For node types whose
feature table should not live in device memory (PoPS gene features,
57,742 columns at the full KG's scale), the table stays on the host and
only the first encoder layer reads it (``ops/streaming.StreamedLinear``);
the model runs the rest of the encoder on those first-layer
pre-activations (``HeteroGNN.forward(h1_override=...)``). The math is the
in-device path's; the cost is two host-to-device passes over the table
per step (the forward, and the weight gradient in the backward).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..models.hetero_gnn import encoder_for
from ..ops.streaming import COL_CHUNK, StreamedLinear
from .loop import batch_loss, fill_dead_grads


def strip_streamed_features(x: Dict[str, torch.Tensor], streamed_types,
                            padded_nodes, device) -> Dict[str, torch.Tensor]:
    """The node features with each streamed type's entry (its table, or
    None) replaced by an [N_pad, 1] zero placeholder on ``device``, in the
    same order: the table never reaches the device, and the model takes
    those types through h1_override."""
    out = dict(x)
    for t in streamed_types:
        out[t] = torch.zeros((padded_nodes[t], 1), dtype=torch.float32,
                             device=device)
    return out


def compute_h1(model, x_host: Dict[str, np.ndarray], padded_nodes,
               col_chunk: int = COL_CHUNK) -> Dict[str, torch.Tensor]:
    """Streamed first-layer pre-activations of each streamed type, padded
    to N_pad with bias rows (zero features give fc1's bias, as the in-device
    pad rows do); differentiable in the encoders' first layers. float32
    (bf16 parameters promoted, as the JAX package's host product promotes
    them); the model casts them to the compute dtype, as h1_override."""
    out = {}
    for t, xh in x_host.items():
        fc1 = getattr(model, encoder_for(t)).FC_hidden
        out[t] = StreamedLinear.apply(fc1.weight.to(torch.float32),
                                      fc1.bias.to(torch.float32), xh,
                                      padded_nodes[t], col_chunk)
    return out


def train_step_streamed(model, optimizer, x, layouts, x_host, padded_nodes,
                        batch_idx, y_node, w_node,
                        col_chunk: int = COL_CHUNK):
    """``engine.loop.train_step`` with the streamed types' first encoder
    layer over their host tables (x: the stripped features). Returns the
    loss as a 0-d tensor, not synchronised."""
    optimizer.zero_grad(set_to_none=True)
    h1 = compute_h1(model, x_host, padded_nodes, col_chunk)
    loss = batch_loss(model(x, layouts, training=True, h1_override=h1),
                      batch_idx, y_node, w_node)
    loss.backward()
    fill_dead_grads(model)
    optimizer.step()
    return loss.detach()
