"""The operation counts against hand counts on a tiny layout."""
from __future__ import annotations

import pytest

from kgbench.metrics import counts

# 2 relations into 3 destination rows, 5 source rows, 7 edges, D = 4
G = {"dst": "SNP", "R": 2, "N": 3, "S": 5, "E": 7, "src_rows": {"Gene": 5}}


def test_gat_forward_by_hand():
    # reads xs 5*4, src 7, row offsets 2*3+1, att 2*4, a_dst 2*3; writes
    # out 3*4, row max and row sum 2*3 each: 20+7+7+8+6+12+12 = 72 words
    assert counts.gat_fwd(G, 4) == (4 * 72, 4 * 4 * 7)


def test_gat_backward_by_hand():
    # reads xs 20, src 7, offsets 7, att 8, a_dst 6, max and sum 12, g 12,
    # CSC permutation 7, CSC offsets 6: 85; writes d_xs 20, d_att 8,
    # d_a_dst 6: 34. Operations: 6*D an edge, 4*D a source row
    assert counts.gat_bwd(G, 4) == (4 * 119, 6 * 4 * 7 + 4 * 4 * 5)


def test_dense_by_hand():
    assert counts.dense(3, 4, 5, train=False) == 120
    assert counts.dense(3, 4, 5, train=True) == 360
    assert counts.dense(3, 4, 5, train=True, leaf_input=True) == 240


def test_model_flops_by_hand():
    enc = {"SNP": 3, "Gene": 5}
    dims = {"SNP": 2, "Gene": 6}
    d = 4
    want_fwd = (counts.dense(3, 2, d, False) + 2 * counts.dense(3, d, d, False)
                + counts.dense(5, 6, d, False) + 2 * counts.dense(5, d, d, False)
                + counts.dense(5, d, d, False) + counts.dense(3, d, 2, False)
                + 4 * d * 7 + counts.dense(3, d, 1, False))
    assert counts.model_flops([[G]], enc, dims, d, 3, False) == want_fwd
    train = counts.model_flops([[G]], enc, dims, d, 3, True)
    # the backward: each product twice more (weight and input gradients),
    # but no input gradient into the node features; the edge work 4D an
    # edge forward, 6D an edge and 4D a source row backward
    want_train = (3 * want_fwd - 2 * 4 * d * 7
                  - counts.dense(3, 2, d, False) - counts.dense(5, 6, d, False)
                  + 6 * d * 7 + 4 * d * 5)
    assert train == want_train


def test_roofline_takes_the_larger_bound():
    peaks = {"hbm_bytes_per_s": 2.0, "f32_flops_per_s": 10.0}
    assert counts.roofline_s(4.0, 10.0, peaks) == pytest.approx(2.0)
    assert counts.roofline_s(1.0, 30.0, peaks) == pytest.approx(3.0)
