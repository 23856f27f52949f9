"""Checkpoints: the JAX package's artifact format and the weight carry.

Counterpart of ``kgwas_tpu/engine/checkpoint.py``. A model directory holds
``model.npz`` (the JAX parameter tree, flattened with ``/``-joined keys) and
``config.pkl`` (the model-semantic config dict), so either package serves
the other's checkpoints. ``params_from_jax`` / ``params_to_jax`` carry
weights between the JAX tree ([in, out] weights, att [H, C]) and the
port's state_dict ([out, in] weights, att [1, H, C], reference
``model.py`` key names), for every backbone (GAT ``lin_src``, ``lin_dst``,
``att_src``, ``att_dst``, ``bias`` at any number of heads, and ``lin_edge``,
``att_edge``, ``lin_edge_``, ``pheno_mlp``; SAGE ``lin_l``, ``lin_r``; GCN
``lin``, ``bias``; SGC ``lin``). ``load_pretrained_torch`` reads a reference
``model.pt`` of any backbone, which loads straight into ``HeteroGNN``.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict

import numpy as np
import torch

SEP = "/"
_MLPS = ("snp_feat_mlp", "go_feat_mlp", "gene_feat_mlp")
_MLP_MAP = {"FC_hidden": "fc1", "FC_hidden2": "fc2", "FC_output": "fc3"}
_MLP_INV = {v: k for k, v in _MLP_MAP.items()}
# a conv's linear maps: GAT lin_src / lin_dst (and lin_edge, lin_edge_,
# pheno_mlp), SAGE lin_l / lin_r, GCN and SGC lin ({"w": [in, out], "b":
# [out]} in the JAX tree, "b" where there is a bias)
_LINEARS = ("lin_src", "lin_dst", "lin_edge", "lin_edge_", "pheno_mlp",
            "lin_l", "lin_r", "lin")
# GAT attention vectors: [H, C] in the JAX tree, [1, H, C] in the port
_ATTS = ("att_src", "att_dst", "att_edge")


def flatten_params(params, prefix="") -> Dict[str, np.ndarray]:
    out = {}
    if isinstance(params, dict):
        for k, v in params.items():
            out.update(flatten_params(v, f"{prefix}{k}{SEP}"))
    elif isinstance(params, (list, tuple)):
        for i, v in enumerate(params):
            out.update(flatten_params(v, f"{prefix}{i}{SEP}"))
    else:
        out[prefix[: -len(SEP)]] = np.asarray(params)
    return out


def unflatten_params(flat: Dict[str, np.ndarray]):
    root: dict = {}
    for key, val in flat.items():
        parts = key.split(SEP)
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)


def _listify(node):
    """Dicts whose keys are 0..n-1 become lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _listify(v) for k, v in node.items()}
    keys = list(node.keys())
    if keys and all(k.isdigit() for k in keys):
        idx = sorted(int(k) for k in keys)
        if idx == list(range(len(idx))):
            return [node[str(i)] for i in idx]
    return node


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.array(v, copy=True)


def params_from_jax(params) -> Dict[str, torch.Tensor]:
    """JAX parameter tree (or its ``/``-flattened dict) -> HeteroGNN
    state_dict."""
    if isinstance(params, dict) and any(SEP in k for k in params):
        params = unflatten_params(params)
    sd = {}
    for name in _MLPS:
        if name not in params:
            continue
        for layer, p in params[name].items():
            sd[f"{name}.{_MLP_INV[layer]}.weight"] = _np(p["w"]).T
            sd[f"{name}.{_MLP_INV[layer]}.bias"] = _np(p["b"])
    for li, layer in enumerate(params["convs"]):
        for rk, rp in layer.items():
            pre = f"convs.{li}.convs.{rk}"
            for k, v in rp.items():
                if k in _LINEARS:
                    sd[f"{pre}.{k}.weight"] = _np(v["w"]).T
                    if "b" in v:
                        sd[f"{pre}.{k}.bias"] = _np(v["b"])
                elif k in _ATTS:
                    a = _np(v)
                    sd[f"{pre}.{k}"] = a.reshape(1, *a.shape)
                elif k == "bias":
                    sd[f"{pre}.bias"] = _np(v)
                else:
                    raise KeyError(f"unmapped conv param {rk}/{k}")
    sd["lin.weight"] = _np(params["lin"]["w"]).T
    sd["lin.bias"] = _np(params["lin"]["b"])
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def params_to_jax(state_dict) -> dict:
    """HeteroGNN (or reference ``model.pt``) state_dict -> JAX parameter
    tree of numpy arrays. DataParallel ``module.`` prefixes are dropped."""
    sd = {(k[7:] if k.startswith("module.") else k): _np(v)
          for k, v in state_dict.items()}
    n_layers = 1 + max((int(k.split(".")[1]) for k in sd
                        if k.startswith("convs.")), default=-1)
    params: dict = {"convs": [dict() for _ in range(n_layers)], "lin": {}}
    for key, val in sd.items():
        parts = key.split(".")
        if parts[0] in _MLPS:
            dest = params.setdefault(parts[0], {}).setdefault(
                _MLP_MAP[parts[1]], {})
            dest["w" if parts[2] == "weight" else "b"] = (
                val.T if parts[2] == "weight" else val)
        elif parts[0] == "convs":
            if parts[2] != "convs":
                raise KeyError(f"unmapped conv param {key}")
            rp = params["convs"][int(parts[1])].setdefault(parts[3], {})
            tail = parts[4:]
            if tail[0] in _LINEARS:
                lin = rp.setdefault(tail[0], {})
                if tail[1] == "weight":
                    lin["w"] = val.T
                else:
                    lin["b"] = val
            elif tail[0] in _ATTS:
                rp[tail[0]] = val.reshape(val.shape[-2], val.shape[-1])
            elif tail[0] == "bias":
                rp["bias"] = val
            else:
                raise KeyError(f"unmapped conv param {key}")
        elif parts[0] == "lin":
            params["lin"]["w" if parts[1] == "weight" else "b"] = (
                val.T if parts[1] == "weight" else val)
        else:
            raise KeyError(f"unmapped param {key}")
    return params


def save_model(state_dict, config: dict, path_dir: str):
    """Write model.npz (JAX tree, ``/``-flattened) and config.pkl."""
    os.makedirs(path_dir, exist_ok=True)
    flat = flatten_params(params_to_jax(state_dict))
    np.savez(os.path.join(path_dir, "model.npz"), **flat)
    with open(os.path.join(path_dir, "config.pkl"), "wb") as f:
        pickle.dump(config, f, pickle.HIGHEST_PROTOCOL)


def load_model(path_dir: str):
    """(JAX parameter tree, config dict) of a model directory."""
    with open(os.path.join(path_dir, "config.pkl"), "rb") as f:
        config = pickle.load(f)
    with np.load(os.path.join(path_dir, "model.npz")) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_params(flat), config


def load_pretrained_torch(path: str) -> Dict[str, torch.Tensor]:
    """state_dict of a reference checkpoint directory's model.pt, without
    DataParallel ``module.`` prefixes."""
    sd = torch.load(os.path.join(path, "model.pt"), map_location="cpu",
                    weights_only=True)
    return {(k[7:] if k.startswith("module.") else k): v
            for k, v in sd.items()}
