"""Model configuration of the port.

Counterpart of ``kgwas_tpu/config.py``'s ``ModelConfig``, holding only the
model-semantic fields that a KGWAS checkpoint persists (``config.pkl``). The
TPU execution knobs of the JAX package have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    gnn_num_layers: int = 2
    gnn_hidden_dim: int = 128
    # GAT (1 head; sum and mean merged, max and min per relation; sigmoid
    # with sum and mean only) | SAGE | GCN | SGC (sum and mean)
    gnn_backbone: str = "GAT"
    gnn_aggr: str = "sum"      # cross-relation aggregation: sum|mean|max|min
    gat_num_head: int = 1
    no_relu: bool = False
    negative_slope: float = 0.2
    temperature: float = 1.0
    sigmoid_gat: bool = False
    out_channels: int = 1

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
