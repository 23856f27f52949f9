"""Initial parameters of the KGWAS model in the reference ``model.py``'s
key names (PyG GATConv names inside ``convs.{layer}.convs.{src__rel__dst}``),
drawn in one call on the device from the seed.

Distributions are the reference's initialisers: torch.nn.Linear's
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for the encoders' weights and biases
and the head's bias, PyG glorot for the GAT projections and attention
vectors, zeros for the GAT biases. One departure: the head's weight is
drawn from U(0, 1/sqrt(fan_in)), so that no seed starts with a dead ReLU
head (all predictions 0, every gradient 0), which would leave nothing to
compare.
"""
from __future__ import annotations

import math

import torch

from . import generator
from .kg import RAW_RELATIONS, feature_dim

REV = "rev_"
ENCODERS = (("snp_feat_mlp", "SNP"), ("go_feat_mlp", "GO"),
            ("gene_feat_mlp", "Gene"))


def relation_types() -> list:
    """(src, rel, dst) of every relation after ToUndirected: a bipartite
    relation and its reverse, a homogeneous one once."""
    out = []
    for s, r, d, _ in RAW_RELATIONS:
        out.append((s, r, d))
        if s != d:
            out.append((d, REV + r, s))
    return out


def relation_key(rt) -> str:
    return "__".join(rt)


def param_specs(dims: dict, hidden: int, layers: int) -> list:
    """[(name, shape, kind, bound)]: kind 'sym' draws U(-bound, bound),
    'pos' U(0, bound), 'zero' zeros."""
    specs = []

    def linear(prefix, fan_in, fan_out):
        b = 1.0 / math.sqrt(fan_in)
        specs.append((f"{prefix}.weight", (fan_out, fan_in), "sym", b))
        specs.append((f"{prefix}.bias", (fan_out,), "sym", b))

    for name, t in ENCODERS:
        d_in = feature_dim(dims, t)
        linear(f"{name}.FC_hidden", d_in, hidden)
        linear(f"{name}.FC_hidden2", hidden, hidden)
        linear(f"{name}.FC_output", hidden, hidden)
    glorot = math.sqrt(6.0 / (hidden + hidden))
    att = math.sqrt(6.0 / (1 + hidden))
    for li in range(layers):
        for rt in relation_types():
            p = f"convs.{li}.convs.{relation_key(rt)}"
            specs.append((f"{p}.lin_src.weight", (hidden, hidden), "sym",
                          glorot))
            if rt[0] != rt[2]:
                specs.append((f"{p}.lin_dst.weight", (hidden, hidden), "sym",
                              glorot))
            specs.append((f"{p}.att_src", (1, 1, hidden), "sym", att))
            specs.append((f"{p}.att_dst", (1, 1, hidden), "sym", att))
            specs.append((f"{p}.bias", (hidden,), "zero", 0.0))
    b = 1.0 / math.sqrt(hidden)
    specs.append(("lin.weight", (1, hidden), "pos", b))
    specs.append(("lin.bias", (1,), "sym", b))
    return specs


def make_params(dims: dict, hidden: int, layers: int, seed: int, device,
                *tags: int) -> dict:
    """name -> float32 tensor on device: one uniform draw for every leaf,
    sliced and scaled."""
    specs = param_specs(dims, hidden, layers)
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    u = torch.rand(sum(sizes), generator=generator(seed, device, 5, *tags),
                   device=device, dtype=torch.float32)
    out, off = {}, 0
    for (name, shape, kind, bound), n in zip(specs, sizes):
        v = u[off:off + n].reshape(shape)
        off += n
        if kind == "sym":
            v = (v * 2 - 1) * bound
        elif kind == "pos":
            v = v * bound
        else:
            v = torch.zeros_like(v)
        out[name] = v.contiguous()
    return out
