"""The optimizer of the reference: ``torch.optim.Adam(params, lr,
weight_decay)``.

Counterpart of ``kgwas_tpu/engine/optim.py``, whose optax chain copies
these semantics: weight decay coupled into the gradient before the moments
(g <- g + wd * p, not AdamW), every parameter decayed (biases included),
bias-corrected moments, eps added outside the square root.

bf16 parameters (``param_dtype="bfloat16"``) take ``Bf16Adam``: the same
update with the moments kept in bf16 and every operation rounded to bf16
in the order of the optax chain (``add_decayed_weights``,
``scale_by_adam``, ``scale(-lr)``, ``apply_updates``), whose state holds
the moments in the parameters' dtype; its Python constants (1 - b1, b1,
weight_decay, eps, -lr) are bf16 there too, as JAX casts a Python scalar
to the array's dtype, and the bias corrections 1 - b^t are taken in
float32 and rounded to bf16, as optax takes them.
"""
from __future__ import annotations

import numpy as np
import torch


def build_optimizer(params, lr: float, weight_decay: float = 0.0):
    params = list(params)
    if any(p.dtype == torch.bfloat16 for p in params):
        return Bf16Adam(params, lr=lr, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay,
                            betas=(0.9, 0.999), eps=1e-8)


class Bf16Adam(torch.optim.Optimizer):
    """torch Adam's semantics on parameters of any dtype, in their dtype
    (see the module docstring)."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      betas=betas, eps=eps))

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            b1, b2 = group["betas"]
            lr, wd, eps = group["lr"], group["weight_decay"], group["eps"]
            dt = next((p.dtype for p in group["params"]), torch.float32)

            def c(v):
                return torch.tensor(v, dtype=torch.float32).to(dt)

            c_wd, c_lr, c_eps = c(wd), c(-lr), c(eps)
            c1, c2, c3, c4 = c(1 - b1), c(b1), c(1 - b2), c(b2)
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                st["step"] += 1
                t = int(st["step"])
                g = p.grad.to(p.dtype)
                if wd:
                    g = g + c_wd * p
                mu = c1 * g + c2 * st["exp_avg"]
                nu = c3 * (g * g) + c4 * st["exp_avg_sq"]
                st["exp_avg"], st["exp_avg_sq"] = mu, nu
                bc1 = c(float(np.float32(1) - np.float32(b1) ** np.float32(t)))
                bc2 = c(float(np.float32(1) - np.float32(b2) ** np.float32(t)))
                u = (mu / bc1) / (torch.sqrt(nu / bc2) + c_eps)
                p.copy_(p + c_lr * u)
