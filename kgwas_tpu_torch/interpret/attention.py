"""Attention-weight export: model -> per-edge weight table.

Counterpart of ``kgwas_tpu/interpret/attention.py`` (after reference
kgwas/utils.py:437-494, get_network_weight). The interpretation forward is
``HeteroGNN.collect_attention``: the merged GAT forward kernel in its raw
mode over every destination group of every layer, with the reference's two
quirks kept: the raw (pre-softmax) weight weights the messages, and no
ReLU runs between layers. The table is a column table (``dict[str,
np.ndarray]``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import print_sys

COLUMNS = ("h_idx", "t_idx", "weight", "h_type", "rel_type", "t_type",
           "layer")


def attention_tables(model, x, layouts, relations) -> dict:
    """Run the interpretation forward of model (a HeteroGNN) on the node
    features x and device layouts, and build the edge-weight table with
    columns h_idx, t_idx, weight (float64), h_type, rel_type, t_type and
    layer ('l1', 'l2', ...); a weight is the mean over the heads.
    relations: the compiled graph's RelationShards, whose real edges (src,
    dst) the weights follow."""
    layers = model.collect_attention(x, layouts)

    # parallel-edge dedup (reference utils.py:493 drop_duplicates) per
    # (relation, layer) with a packed int64 key, keeping the FIRST
    # occurrence. Equivalent to the global pass only when the relation
    # names are unique over the union of all layers' relation keys; a
    # collision falls back to the global pass.
    all_keys: set = set()
    for alphas in layers:
        all_keys.update(alphas.keys())
    rel_names = [relations[rk].rel for rk in all_keys]
    names_unique = len(set(rel_names)) == len(rel_names)

    specs = [(li, rk) for li, alphas in enumerate(layers) for rk in alphas]
    if not specs:
        return {c: np.zeros(0, dtype=np.int64 if c.endswith("_idx") else
                            np.float64 if c == "weight" else object)
                for c in COLUMNS}
    # one device -> host copy of every relation's weights, the mean over
    # heads of [E, H] (float32, as the JAX package takes it)
    flat_w = torch.cat([_head_mean(layers[li][rk]) for li, rk in specs]
                       ).cpu().numpy().astype(np.float64)

    hs, ts, ws = [], [], []
    groups = []  # (h_type, rel, t_type, layer name, rows)
    off = 0
    for li, rk in specs:
        rel = relations[rk]
        e = rel.num_edges
        if layers[li][rk].shape[0] != e:
            raise ValueError(f"{rk}: {layers[li][rk].shape[0]} weights for "
                             f"{e} real edges")
        a = flat_w[off:off + e]
        off += e
        h = rel.src[:e].astype(np.int64)
        t = rel.dst[:e].astype(np.int64)
        if names_unique:
            _, first = np.unique((h << 32) | t, return_index=True)
            first.sort()  # drop_duplicates keeps the first, in order
            h, t, a = h[first], t[first], a[first]
        hs.append(h)
        ts.append(t)
        ws.append(a)
        groups.append((rel.src_type, rel.rel, rel.dst_type, f"l{li + 1}",
                       len(h)))

    lengths = [g[4] for g in groups]

    def constant(col: int) -> np.ndarray:
        return np.repeat(np.array([g[col] for g in groups], dtype=object),
                         lengths)

    table = {
        "h_idx": np.concatenate(hs),
        "t_idx": np.concatenate(ts),
        "weight": np.concatenate(ws),
        "h_type": constant(0),
        "rel_type": constant(1),
        "t_type": constant(2),
        "layer": constant(3),
    }
    if not names_unique:  # reference dedupes parallel edges (utils.py:493)
        codes = {}
        rel_code = np.repeat([codes.setdefault(g[1], len(codes))
                              for g in groups], lengths)
        layer_code = np.repeat([int(g[3][1:]) for g in groups], lengths)
        keys = np.stack([table["h_idx"], table["t_idx"], rel_code,
                         layer_code], axis=1)
        _, first = np.unique(keys, axis=0, return_index=True)
        first.sort()
        table = {k: v[first] for k, v in table.items()}
    return table


def _head_mean(alpha):
    alpha = alpha.float()
    return alpha.mean(dim=1) if alpha.dim() == 2 else alpha


def get_network_weight(run, data) -> dict:
    """run: a KGWAS engine; its model's current state is served."""
    print_sys("Retrieving weights...")
    cg, x, layouts = run._device_state()
    streamed = getattr(run, "stream_features", [])
    if streamed:
        # as the JAX package's interpretation: every feature table on the
        # device, streamed ones included
        x = {**x, **{t: torch.from_numpy(np.ascontiguousarray(
            cg.node_x[t])).to(run.device) for t in streamed}}
    return attention_tables(run.model, x, layouts, cg.relations)
