"""SimpleMLP: the 3-layer node-feature encoder (``kgwas_tpu/models/mlp.py``).

h = ReLU(W1 x); h = ReLU(W2 h); out = W3 h   (no final activation)

``SimpleMLP.tail`` is ``apply_mlp_tail``: the same after W1 x + b1. Both
take the compute dtype (``models/precision.py``).

Submodule names are the reference's (FC_hidden, FC_hidden2, FC_output), so
the state_dict keys match a reference ``model.pt``.
"""
from __future__ import annotations

import torch
from torch import nn

from .init import torch_linear_bias, torch_linear_weight
from .precision import linear


def _linear(gen, fan_in, fan_out):
    lin = nn.Linear(fan_in, fan_out)
    with torch.no_grad():
        lin.weight.copy_(torch_linear_weight(gen, fan_in, fan_out))
        lin.bias.copy_(torch_linear_bias(gen, fan_in, fan_out))
    return lin


class SimpleMLP(nn.Module):
    def __init__(self, input_dim: int, hidden_dim: int, output_dim: int,
                 gen: torch.Generator):
        super().__init__()
        self.FC_hidden = _linear(gen, input_dim, hidden_dim)
        self.FC_hidden2 = _linear(gen, hidden_dim, hidden_dim)
        self.FC_output = _linear(gen, hidden_dim, output_dim)

    def forward(self, x, cdt=torch.float32):
        return self.tail(linear(x, self.FC_hidden, cdt), cdt)

    def tail(self, h1_pre, cdt=torch.float32):
        """The encoder after its first layer, given that layer's
        pre-activation (the streamed-feature path, where h1_pre = X W1^T +
        b1 is computed over a host table: apply_mlp_tail)."""
        h = torch.relu(h1_pre)
        h = torch.relu(linear(h, self.FC_hidden2, cdt))
        return linear(h, self.FC_output, cdt)
