"""The dtype options' arithmetic: the JAX package's casts and promotions.

The JAX package casts the features and every parameter to
``compute_dtype`` at the start of a forward, and from there each product
takes the promoted dtype of its operands (bf16 with f32 gives f32: a
segment sum's f32 output keeps the layers after it in f32). PyTorch
promotes elementwise operations the same way but not matrix products,
so the layers multiply through ``matmul`` and ``linear``, which cast the
weight to the compute dtype and both operands to their promoted dtype.
With every dtype float32 each cast is a no-op and the product is the one
the layers computed before the options existed.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a config dtype name (None: None)."""
    return None if name is None else DTYPES[name]


def matmul(a, w, cdt=torch.float32):
    """a @ w with w (a parameter, or a product of parameters) in the compute
    dtype cdt, both promoted."""
    dt = torch.promote_types(a.dtype, cdt)
    return a.to(dt) @ w.to(cdt).to(dt)


def linear(x, lin, cdt=torch.float32):
    """lin(x) (an nn.Linear) with its parameters in cdt, promoted with x."""
    dt = torch.promote_types(x.dtype, cdt)
    b = None if lin.bias is None else lin.bias.to(cdt).to(dt)
    return F.linear(x.to(dt), lin.weight.to(cdt).to(dt), b)
