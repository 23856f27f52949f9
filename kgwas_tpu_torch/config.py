"""Model configuration of the port.

Counterpart of ``kgwas_tpu/config.py``'s ``ModelConfig``, holding the
model-semantic fields that a KGWAS checkpoint persists (``config.pkl``) and
``remat``, which it does not persist. The TPU execution knobs of the JAX
package have no counterpart here.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ModelConfig:
    gnn_num_layers: int = 2
    gnn_hidden_dim: int = 128
    gnn_backbone: str = "GAT"  # GAT | SAGE | GCN | SGC
    gnn_aggr: str = "sum"      # cross-relation aggregation: sum|mean|max|min
    gat_num_head: int = 1      # GAT heads, concatenated (H * hidden wide)
    no_relu: bool = False
    negative_slope: float = 0.2
    dropout: float = 0.0       # GAT attention dropout (with a generator)
    sigmoid_gat: bool = False
    temperature: float = 1.0
    out_channels: int = 1
    # the edge-feature attention term's width (lin_edge, att_edge)
    edge_dim: Optional[int] = None
    # 'ATT' | 'MSG' | None: parameters created and never read (reference)
    pheno_condition: Optional[str] = None
    remat: bool = False        # recompute each layer in the backward

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})
