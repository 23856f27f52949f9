"""Bytes and floating-point operations of the model's work, from shapes.

A group is one destination type of one layer (reference/graph.group_shapes):
R relations, N destination rows, S source rows (the relations' projected
source tables stacked), E edges, D the hidden width. Counts follow what
the inputs need: real rows and edges, no padding; each input read once and
each output written once, whatever a kernel reads again; 4-byte values and
indices.

  * merged GAT forward (one launch per group): reads the source table
    [S, D], the edge sources [E], the row offsets [R N + 1], att [R, D] and
    a_dst [R N]; writes the output [N, D] and each row's softmax max and
    sum [R N]; 4 D operations an edge (the logit's dot product and the
    weighted sum).
  * merged GAT backward, counted as one operation (the layer backward and
    the CSC segment sum): reads the source table, the edge sources, the
    row offsets, att, a_dst, the saved max and sum, the output's cotangent
    [N, D], the CSC permutation [E] and offsets [S + 1]; writes the
    table's cotangent [S, D], att's [R, D] and a_dst's [R N]. The per-edge
    weights and logit cotangents passed between its two kernels are not
    counted: another implementation need not write them. 6 D operations an
    edge (two dot products, one weighted sum) and 4 D a source row.
  * a dense product [M, K] x [K, N]: 2 M K N; its backward 2 M K N for the
    weight's gradient and 2 M K N for the input's, unless the input is a
    leaf (the node features).
"""
from __future__ import annotations

WORD = 4


def gat_fwd(g: dict, d: int):
    """(bytes, flops) of one merged GAT forward over group g."""
    rn = g["R"] * g["N"]
    words = (g["S"] * d + g["E"] + rn + 1 + g["R"] * d + rn
             + g["N"] * d + 2 * rn)
    return WORD * words, 4 * d * g["E"]


def gat_bwd(g: dict, d: int):
    """(bytes, flops) of one merged GAT backward over group g."""
    rn = g["R"] * g["N"]
    reads = (g["S"] * d + g["E"] + rn + 1 + g["R"] * d + rn + 2 * rn
             + g["N"] * d + g["E"] + g["S"] + 1)
    writes = g["S"] * d + g["R"] * d + rn
    return WORD * (reads + writes), 6 * d * g["E"] + 4 * d * g["S"]


def dense(m: int, k: int, n: int, train: bool, leaf_input: bool = False):
    """Operations of y = x W^T (+ b) for x [m, k], W [n, k]; with train its
    backward too."""
    f = 2 * m * k * n
    if not train:
        return f
    return f + 2 * m * k * n + (0 if leaf_input else 2 * m * k * n)


def model_flops(groups: list, encoded: dict, dims: dict, d: int,
                n_snp: int, train: bool) -> int:
    """Operations of one full-graph forward (train: and its backward) of
    the model: the encoders of the encoded types ({type: rows}, dims
    {type: input width}), per group the source projections and the a_dst
    products, the merged GAT layer, and the head over n_snp rows."""
    f = 0
    for t, rows in encoded.items():
        f += dense(rows, dims[t], d, train, leaf_input=True)
        f += 2 * dense(rows, d, d, train)
    for layer in groups:
        for g in layer:
            for rows in g["src_rows"].values():
                f += dense(rows, d, d, train)
            f += dense(g["N"], d, g["R"], train)
            f += gat_fwd(g, d)[1]
            if train:
                f += gat_bwd(g, d)[1]
    f += dense(n_snp, d, 1, train)
    return f


def roofline_s(nbytes: float, flops: float, peaks: dict) -> float:
    """The least time of an operation at the card's published peaks."""
    return max(nbytes / peaks["hbm_bytes_per_s"],
               flops / peaks["f32_flops_per_s"])
