"""Model and training configuration of the port.

Counterpart of ``kgwas_tpu/config.py``'s ``ModelConfig``, ``TrainConfig``,
``MeshConfig``, ``save_config`` and ``load_config``. ``ModelConfig`` holds the
model-semantic fields that a KGWAS checkpoint persists (``config.pkl``),
``remat`` and the dtype options, which it does not persist:

  * ``param_dtype``: the dtype the parameters are created and kept in (the
    optimizer's moments follow it);
  * ``compute_dtype``: the features, the parameters and the streamed
    first-layer pre-activations are cast to it at the start of a forward
    (inside autograd: the gradients reach the ``param_dtype`` leaves);
  * ``stream_dtype``: the dtype of the merged GAT layer's message table and
    of the per-relation sigmoid GAT's messages (None: the compute dtype);
  * ``stream_f32_logits``: with ``stream_dtype``, the per-relation sigmoid
    GAT's logits read the unrounded table.

Each dtype is "float32" or "bfloat16" (the JAX CLI's choices); f32 is the
default everywhere. The TPU execution knobs of the JAX package
(``use_pallas``, ``matmul_precision``, ...) have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import json
import os
import warnings
from dataclasses import dataclass
from typing import Optional

DTYPES = ("float32", "bfloat16")


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
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    stream_dtype: Optional[str] = None   # None: the compute dtype
    stream_f32_logits: bool = False
    remat: bool = False        # recompute each layer in the backward

    def __post_init__(self):
        for k in ("param_dtype", "compute_dtype", "stream_dtype"):
            v = getattr(self, k)
            if not (v in DTYPES or (k == "stream_dtype" and v is None)):
                raise ValueError(f"{k} must be one of {DTYPES}, got {v!r}")
        # KGWAS_STREAM_F32_LOGITS predates the stream_f32_logits field: it
        # is honoured, with a warning toward the field
        env = os.environ.get("KGWAS_STREAM_F32_LOGITS")
        if env is not None and not self.stream_f32_logits:
            warnings.warn(
                "KGWAS_STREAM_F32_LOGITS env var is deprecated; set "
                "ModelConfig(stream_f32_logits=True) instead "
                "(env value honored this run)",
                DeprecationWarning,
                stacklevel=2,
            )
            object.__setattr__(self, "stream_f32_logits", env == "1")

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference KGWAS.train kwargs)."""

    batch_size: int = 512
    lr: float = 1e-4
    weight_decay: float = 5e-4   # torch-Adam coupled L2 (not AdamW)
    epoch: int = 10
    save_best_model: bool = True
    shuffle: bool = False
    eval_batch_size: int = 512
    full_batch: bool = False     # one step per epoch over all train SNPs
    data_parallel_devices: int = 1

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass(frozen=True)
class MeshConfig:
    """The device mesh of a multi-device run (the JAX package's
    MeshConfig): the 'data' axis partitions the merged GAT layer's rows
    and edges, the 'model' axis the columns of feature tables at least
    parallel/shard.TP_FEATURE_DIM_THRESHOLD wide. The port runs one process
    per device, so data_axis * model_axis is the world size of the
    torch.distributed process group (parallel/mesh.py)."""

    data_axis: int = 1
    model_axis: int = 1
    axis_names: tuple = ("data", "model")

    def to_dict(self):
        return dataclasses.asdict(self)


def save_config(path: str, model_cfg: ModelConfig,
                extra: Optional[dict] = None):
    """config.json: {"model": model_cfg.to_dict(), **extra}."""
    payload = {"model": model_cfg.to_dict()}
    if extra:
        payload.update(extra)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, default=str)


def load_config(path: str) -> dict:
    with open(path) as f:
        return json.load(f)
