"""One training step's gradients against the JAX package's, on each of its
training layouts (test (vi) of ``test_torch_train.py``).

The JAX package trains on the plain merged stream (TPU kernels #1, #2, #8)
and on TPU-only reorderings of it (src-chunked with or without padded
fragments, CSC windows), each with its own Pallas kernels (#3, #4, #5,
#9). The port has one stream and one set of kernels (merged_gat_fwd,
merged_gat_bwd, csc_segment_sum). Here one step's loss and parameter
gradients from the same JAX-initialised weights are held against
``jax.grad`` of the JAX loss (use_pallas=True) on each layout, and a
counter on each Pallas wrapper confirms which ``pallas_call`` sites the JAX
side reached: the mapping of #3, #4, #5 and #9 onto the port's kernels.
"""
import collections

import pytest

from kgwas_tpu.ops import pallas_gat_layer as P
from kgwas_tpu.ops import pallas_segment as S

from test_torch_train import assert_step_grads_match, step_world  # noqa: F401

# TPU kernel number (PERF.md table) -> its pallas_call wrapper
SITES = {
    1: (P, "_merged_forward"),
    2: (P, "_merged_backward"),
    3: (P, "_merged_forward_chunked"),
    4: (P, "_merged_backward_chunked"),
    5: (P, "_merged_backward_chunked_split"),
    6: (S, "_fused_forward"),
    7: (S, "_fused_backward"),
    8: (S, "pallas_segment_sum"),
    9: (S, "segment_sum_windows"),
    10: (S, "_pallas_segment_sum_ts"),
}


@pytest.fixture
def reached(monkeypatch):
    """Counts the calls of every Pallas wrapper in SITES."""
    counts = collections.Counter()
    for k, (module, name) in SITES.items():
        def counted(*args, _fn=getattr(module, name), _k=k, **kwargs):
            counts[_k] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, name, counted)
    return counts


@pytest.mark.parametrize("cfg_kw,sites", [
    # the plain stream: #1 forward, #2 backward, #8 the CSC segment sum
    ({}, {1, 2, 8}),
    # src-chunked stream, fragments not padded: #3 forward, #4 backward
    # with the read-merge, #8 over the chunk-grouped cotangents
    ({"gather_chunk_rows": 512, "pad_fragments": False}, {1, 2, 3, 4, 8}),
    # padded fragments: #5 writes one cotangent buffer per chunk
    ({"gather_chunk_rows": 512, "pad_fragments": True}, {1, 2, 3, 5, 8}),
    # plain stream with a CSC-windowed backward permute: #9
    ({"bwd_window_edges": 512, "gather_chunk_rows": 10 ** 9}, {1, 2, 9}),
], ids=["plain", "chunked", "chunked-padded", "windowed"])
def test_step_grads_match_jax_training_layout(step_world, reached,  # noqa: F811
                                              cfg_kw, sites):
    assert_step_grads_match(step_world, cfg_kw)
    assert set(reached) == sites
    # JAX's backward, like the port's, runs the layer gradient for the 3
    # groups whose output reaches the loss (layer 2: SNP; layer 1: SNP and
    # Gene), whatever the layout
    assert reached[2] + reached[4] + reached[5] == 3
