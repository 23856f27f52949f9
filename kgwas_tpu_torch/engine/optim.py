"""The optimizer of the reference: ``torch.optim.Adam(params, lr,
weight_decay)``.

Counterpart of ``kgwas_tpu/engine/optim.py``, whose optax chain copies
these semantics: weight decay coupled into the gradient before the moments
(g <- g + wd * p, not AdamW), every parameter decayed (biases included),
bias-corrected moments, eps added outside the square root.

On the card the optimizer is capturable: its step count and bias
corrections live on the device and every update is in place, so a step
captured in a CUDA graph (engine/loop.TrainScan) does on each replay what
the eager step does. Eager and captured steps of one run use the same
optimizer, so they give the same bits. On the CPU it is torch's Adam as
the reference builds it.

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
    """torch Adam (``Bf16Adam`` for bf16 parameters); on the card with
    ``capturable=True`` and the ``foreach`` implementation."""
    params = list(params)
    if any(p.dtype == torch.bfloat16 for p in params):
        return Bf16Adam(params, lr=lr, weight_decay=weight_decay)
    cuda = any(p.device.type == "cuda" for p in params)
    extra = dict(capturable=True, foreach=True) if cuda else {}
    return torch.optim.Adam(params, lr=lr, weight_decay=weight_decay,
                            betas=(0.9, 0.999), eps=1e-8, **extra)


def bias_table(b: float, dtype) -> torch.Tensor:
    """[T] float32 of 1 - b^t for t = 1..T, each taken in numpy float32 and
    rounded to ``dtype``, as optax takes them, up to the first t whose
    value rounds to 1 (every later one does too: b^t only shrinks)."""
    vals = []
    one = np.float32(1)
    while True:
        v = one - np.float32(b) ** np.float32(len(vals) + 1)
        vals.append(float(v))
        if torch.tensor(vals[-1], dtype=torch.float32).to(dtype) == 1:
            break
        if len(vals) >= 1 << 24:
            raise ValueError(f"beta {b}: 1 - b^t does not reach 1")
    return torch.tensor(vals, dtype=torch.float32).to(dtype).float()


class Bf16Adam(torch.optim.Optimizer):
    """torch Adam's semantics on parameters of any dtype, in their dtype
    (see the module docstring). Capturable: the step count is a device
    tensor, the bias corrections come from ``bias_table`` indexed by it on
    the device, and the moments and parameters are updated in place."""

    def __init__(self, params, lr: float, weight_decay: float = 0.0,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        # capturable: load_state_dict moves each step count to its
        # parameter's device (torch.optim's rule for "step")
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      betas=betas, eps=eps, capturable=True))
        self._consts = {}

    def _group_consts(self, group, dt, device):
        """The group's bf16 constants (CPU scalars, as the eager update
        takes them) and the bias-correction tables on the device: the
        divisors on the CPU; on the card their float32 reciprocals, since
        CUDA divides by a CPU scalar as a product with its reciprocal."""
        b1, b2 = group["betas"]
        key = (b1, b2, group["lr"], group["weight_decay"], group["eps"], dt,
               device)
        if key not in self._consts:
            def c(v):
                return torch.tensor(v, dtype=torch.float32).to(dt)

            tables = []
            for b in (b1, b2):
                t = bias_table(b, dt)
                if device.type == "cuda":
                    t = torch.ones_like(t) / t
                tables.append(t.to(device))
            self._consts[key] = (c(group["weight_decay"]), c(-group["lr"]),
                                 c(group["eps"]), c(1 - b1), c(b1),
                                 c(1 - b2), c(b2), *tables)
        return self._consts[key]

    @torch.no_grad()
    def step(self):
        for group in self.param_groups:
            wd = group["weight_decay"]
            dt = next((p.dtype for p in group["params"]), torch.float32)
            for p in group["params"]:
                if p.grad is None:
                    continue
                (c_wd, c_lr, c_eps, c1, c2, c3, c4, tab1,
                 tab2) = self._group_consts(group, dt, p.device)
                st = self.state[p]
                if not st:
                    st["step"] = torch.zeros((), dtype=torch.float32,
                                             device=p.device)
                    st["exp_avg"] = torch.zeros_like(p)
                    st["exp_avg_sq"] = torch.zeros_like(p)
                elif st["step"].device != p.device:
                    st["step"] = st["step"].to(p.device)
                st["step"] += 1
                g = p.grad.to(p.dtype)
                if wd:
                    g = g + c_wd * p
                mu = c1 * g + c2 * st["exp_avg"]
                nu = c3 * (g * g) + c4 * st["exp_avg_sq"]
                st["exp_avg"].copy_(mu)
                st["exp_avg_sq"].copy_(nu)
                bc1 = _bias(tab1, st["step"])
                bc2 = _bias(tab2, st["step"])
                if p.device.type == "cuda":
                    # a product with the reciprocal in float32, rounded once
                    m_hat = (mu.float() * bc1).to(dt)
                    n_hat = (nu.float() * bc2).to(dt)
                else:
                    m_hat = (mu.float() / bc1).to(dt)
                    n_hat = (nu.float() / bc2).to(dt)
                u = m_hat / (torch.sqrt(n_hat) + c_eps)
                p.copy_(p + c_lr * u)


def _bias(table, step):
    """table[min(t, T) - 1] for the device step count t (0-d float32), read
    on the device (indexing with a 0-d tensor would read t on the host)."""
    idx = step.clamp(max=table.shape[0]).long().reshape(1) - 1
    return table.index_select(0, idx).reshape(())
