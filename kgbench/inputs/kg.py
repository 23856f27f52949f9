"""The raw knowledge graph: the reference KGWAS schema (SNP, Gene and the
three GO types; seven raw relations before ToUndirected / AddSelfLoops),
random edges and uniform feature tables, all drawn on the device from the
seed in one call per table.

Sizes come from the configuration's ``kg`` group (n_snp, n_gene, n_go per
GO type, avg_degree) and its ``feature_dims`` (SNP, Gene, GO).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import GENE, GO_TYPES, SNP, generator

# (src, rel, dst, edges per source node: "deg" = avg_degree) in the
# reference bundle's relation order
RAW_RELATIONS = (
    (SNP, "TSS", GENE, 1),
    (SNP, "Enhancer-eQTL-Gene", GENE, "deg"),
    (GENE, "Gene-PPI-Gene", GENE, "deg"),
    (GENE, "Gene-memberof-BiologicalProcess", "BiologicalProcess", 2),
    (GENE, "Gene-memberof-CellularComponent", "CellularComponent", 2),
    (GENE, "Gene-memberof-MolecularFunction", "MolecularFunction", 2),
    ("BiologicalProcess", "BP-parentof-BP", "BiologicalProcess", 2),
)


@dataclass
class RawKG:
    num_nodes: dict   # node type -> rows
    features: dict    # node type -> float32 [N, D] on the device
    edges: dict       # (src, rel, dst) -> int64 [2, E] on the device


def num_nodes(kg_spec: dict) -> dict:
    return {SNP: int(kg_spec["n_snp"]), GENE: int(kg_spec["n_gene"]),
            **{t: int(kg_spec["n_go"]) for t in GO_TYPES}}


def feature_dim(dims: dict, ntype: str) -> int:
    return int(dims["GO"] if ntype in GO_TYPES else dims[ntype])


def make_features(kg_spec: dict, dims: dict, seed: int, device) -> dict:
    """Node type -> float32 [N, D] uniform in [0, 1) on device, one draw
    per type."""
    out = {}
    for i, (t, n) in enumerate(num_nodes(kg_spec).items()):
        gen = generator(seed, device, 1, i)
        out[t] = torch.rand((n, feature_dim(dims, t)), generator=gen,
                            device=device, dtype=torch.float32)
    return out


def make_edges(kg_spec: dict, seed: int, device) -> dict:
    """(src, rel, dst) -> int64 [2, E] on device: E = n_src x the
    relation's degree, ends uniform over the node sets (duplicates and
    self loops kept, as a raw bundle may hold them)."""
    nodes = num_nodes(kg_spec)
    out = {}
    for i, (s, r, d, per) in enumerate(RAW_RELATIONS):
        e = nodes[s] * (int(kg_spec["avg_degree"]) if per == "deg" else per)
        gen = generator(seed, device, 2, i)
        src = torch.randint(0, nodes[s], (e,), generator=gen, device=device)
        dst = torch.randint(0, nodes[d], (e,), generator=gen, device=device)
        out[(s, r, d)] = torch.stack([src, dst])
    return out


def make_kg(kg_spec: dict, dims: dict, seed: int, device) -> RawKG:
    return RawKG(num_nodes(kg_spec), make_features(kg_spec, dims, seed,
                                                   device),
                 make_edges(kg_spec, seed, device))
