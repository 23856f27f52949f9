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

bf16 parameters (``param_dtype="bfloat16"``) carry both ways as their
16 bits: numpy has no bf16 of its own, and an ``np.savez`` of the JAX
package's bf16 arrays reloads as raw 2-byte ``|V2`` values where no bf16
dtype is registered, so a bf16 leaf goes numpy ``uint16`` <-> torch
``int16`` <-> ``.view(torch.bfloat16)``, never through a float conversion.
``params_to_jax`` gives numpy's registered ``bfloat16`` dtype where there
is one (the JAX package's ``ml_dtypes``), else ``|V2``.

The train state of a long run (the counterpart of the JAX package's orbax
``save_train_state_async`` / ``restore_train_state`` /
``latest_train_state``) is the port's own ``torch.save`` file
(``AsyncCheckpointer``).
"""
from __future__ import annotations

import copy
import os
import pickle
from concurrent.futures import ThreadPoolExecutor
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


def _bf16_np() -> np.dtype:
    """numpy's bfloat16 dtype where one is registered, else raw |V2."""
    try:
        return np.dtype("bfloat16")
    except TypeError:
        return np.dtype("V2")


def _is_bf16(a: np.ndarray) -> bool:
    """A numpy bf16 array: the registered dtype or its raw |V2 bytes."""
    return a.dtype.kind == "V" and a.dtype.itemsize == 2


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view(np.uint16).view(
                _bf16_np()).copy()
        v = v.numpy()
    return np.array(v, copy=True)


def _torch(a: np.ndarray) -> torch.Tensor:
    a = np.ascontiguousarray(a)
    if _is_bf16(a):
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


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
    return {k: _torch(v) for k, v in sd.items()}


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


# ---------------------------------------------------------------------------
# Train-state checkpoints of a long run (checkpoint_every / resume)
# ---------------------------------------------------------------------------
# The JAX package saves (params, opt_state) with orbax; the port's format is
# its own: one torch.save file ``step_{N}`` holding the model's and the
# optimizer's state_dicts, written as ``step_{N}.tmp`` and renamed, so a
# partly written file is never the newest state. model.npz + config.pkl
# stay the format both packages read.

TRAIN_STATE_FILE = "step_{}"


class _Slot:
    """Where a device tensor sat in a state being copied to the host."""

    def __init__(self, index: int):
        self.index = index


class HostCopy:
    """A host copy of a nested state (a model's and an optimizer's
    state_dicts), taken in two halves. The constructor packs the device
    tensors, on the current stream, into one flat device buffer per dtype
    (one launch each: the values as they are now, whatever the next step
    writes) and copies the host tensors. ``result()`` copies the packed
    buffers to the host, on a side stream after the packing, and returns
    the state with host tensors; a background thread can call it while the
    steps go on."""

    def __init__(self, state):
        self._tensors = []
        self._tree = self._strip(state)
        groups = {}
        for i, t in enumerate(self._tensors):
            groups.setdefault(t.dtype, []).append(i)
        self._shapes = [t.shape for t in self._tensors]
        self._flat = [(idx, torch.cat([self._tensors[i].reshape(-1)
                                       for i in idx]))
                      for idx in groups.values()]
        self._tensors = None
        self._event = None
        if self._flat:
            self._event = torch.cuda.Event()
            self._event.record()

    def _strip(self, obj):
        if isinstance(obj, torch.Tensor):
            if obj.device.type == "cpu":
                return obj.detach().clone()
            self._tensors.append(obj.detach())
            return _Slot(len(self._tensors) - 1)
        if isinstance(obj, dict):
            return {k: self._strip(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._strip(v) for v in obj)
        return copy.deepcopy(obj)

    def result(self):
        host = [None] * len(self._shapes)
        if self._flat:
            side = torch.cuda.Stream(device=self._flat[0][1].device)
            with torch.cuda.stream(side):
                side.wait_event(self._event)
                for idx, flat in self._flat:
                    parts = flat.to("cpu").split(
                        [self._shapes[i].numel() for i in idx])
                    for i, part in zip(idx, parts):
                        host[i] = part.view(self._shapes[i])
            self._flat = []
        return self._fill(self._tree, host)

    def _fill(self, obj, host):
        if isinstance(obj, _Slot):
            return host[obj.index]
        if isinstance(obj, dict):
            return {k: self._fill(v, host) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(self._fill(v, host) for v in obj)
        return obj


def host_train_state(model_state: dict, optimizer_state: dict) -> HostCopy:
    """The HostCopy of a model's and an optimizer's state_dicts
    (``{"model": ..., "optimizer": ...}``), taken before the next step can
    change them."""
    return HostCopy({"model": model_state, "optimizer": optimizer_state})


class AsyncCheckpointer:
    """Writes train states on one background thread, in order. ``save``
    returns once the state is packed on the device; the thread copies it
    to the host and writes it. ``wait_until_finished`` blocks until every
    write has landed, and raises a write's error."""

    def __init__(self):
        self._pool = ThreadPoolExecutor(max_workers=1,
                                        thread_name_prefix="ckpt")
        self._pending = []

    def save(self, path: str, state: HostCopy):
        self._pending.append(self._pool.submit(self._write, path, state))

    @staticmethod
    def _write(path, state):
        tmp = path + ".tmp"
        torch.save(state.result(), tmp)
        os.replace(tmp, path)

    def wait_until_finished(self):
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self):
        self.wait_until_finished()
        self._pool.shutdown()


def make_async_checkpointer() -> AsyncCheckpointer:
    return AsyncCheckpointer()


def save_train_state_async(checkpointer: AsyncCheckpointer, path_dir: str,
                           step: int, model_state: dict,
                           optimizer_state: dict) -> str:
    """Non-blocking save of the model's and the optimizer's state_dicts as
    ``path_dir/step_{step}``. Returns the path."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(os.path.abspath(path_dir),
                        TRAIN_STATE_FILE.format(step))
    checkpointer.save(path, host_train_state(model_state, optimizer_state))
    return path


def restore_train_state(path: str, map_location="cpu"):
    """(model state_dict, optimizer state_dict) of a saved train state."""
    state = torch.load(path, map_location=map_location, weights_only=True)
    return state["model"], state["optimizer"]


def latest_train_state(path_dir: str):
    """The newest ``step_{N}`` in path_dir, or None. A ``step_{N}.tmp``
    (a write cut short) is never it."""
    if not os.path.isdir(path_dir):
        return None
    steps = [
        int(d.split("_")[1])
        for d in os.listdir(path_dir)
        if d.startswith("step_") and d.split("_")[1].isdigit()
    ]
    if not steps:
        return None
    return os.path.join(path_dir, TRAIN_STATE_FILE.format(max(steps)))
