"""The optimizer of the reference: ``torch.optim.Adam(params, lr,
weight_decay)``.

Counterpart of ``kgwas_tpu/engine/optim.py``, whose optax chain copies
these semantics: weight decay coupled into the gradient before the moments
(g <- g + wd * p, not AdamW), every parameter decayed (biases included),
bias-corrected moments, eps added outside the square root.
"""
from __future__ import annotations

import torch


def build_optimizer(params, lr: float, weight_decay: float = 0.0):
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay,
                            betas=(0.9, 0.999), eps=1e-8)
