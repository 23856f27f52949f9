"""The system under test, kgwas_tpu_torch, fed the benchmark's inputs.

The raw KG goes to the port as ``KGWAS_Data.from_synthetic`` hands its own
synthetic KG over: a ``graph.schema.HeteroGraph`` of numpy tables through
the port's ``standard_kg_transforms``, node ids ``rs<i>`` / ``G<i>`` /
``GO<i>``, the sumstats and LD-score column tables loaded by
``load_synthetic_gwas``; so ``process_gwas_file``, ``prepare_split`` and
``compile`` run as they do on real data. Parameters are loaded with
``load_state_dict`` in the reference's key names.
"""
from __future__ import annotations

import numpy as np
import torch

from .inputs import GENE, GO_TYPES, SNP


def make_data(raw, data_path: str, ld=None):
    """A KGWAS_Data over the raw KG (kgbench.inputs.kg.RawKG), its feature
    tables copied to the host; ld: the (ld, w_ld) tables, or None where
    no sumstats will be loaded."""
    from kgwas_tpu_torch.graph.schema import HeteroGraph
    from kgwas_tpu_torch.graph.transforms import standard_kg_transforms
    from kgwas_tpu_torch.kgwas_data import KGWAS_Data

    data = KGWAS_Data(data_path=data_path, offline=True)
    data._synthetic = True
    g = HeteroGraph()
    for t, v in raw.features.items():
        g.node_features[t] = v.cpu().numpy()
    for rt, ei in raw.edges.items():
        g.edge_index[rt] = ei.cpu().numpy()
    data.graph = standard_kg_transforms(g).validate()
    data.snp_init_dim_size = data.graph.feature_dim(SNP)
    data.gene_init_dim_size = data.graph.feature_dim(GENE)
    data.go_init_dim_size = data.graph.feature_dim(GO_TYPES[1])
    names = {SNP: "rs", GENE: "G", **{t: "GO" for t in GO_TYPES}}
    data.idx2id = {t: dict(enumerate(f"{names[t]}{i}" for i in range(n)))
                   for t, n in raw.num_nodes.items()}
    data.id2idx = {t: {v: k for k, v in m.items()}
                   for t, m in data.idx2id.items()}
    if ld is not None:
        data._synth_ld, data._synth_w_ld = ld
    return data


def load_gwas(data, sumstats: dict, seed: int):
    """The sumstats through the port's data layer: load_synthetic_gwas
    (whose seed is the split's), process_gwas_file, prepare_split."""
    data._synth_sumstats = sumstats
    data.load_synthetic_gwas(seed=seed)
    data.process_gwas_file()
    data.prepare_split()


def make_model(data, model_cfg: dict, params: dict, device, seed: int,
               exp_name: str = "kgbench"):
    """KGWAS with initialize_model at the configuration's options, the
    benchmark's parameters loaded."""
    from kgwas_tpu_torch.kgwas import KGWAS

    run = KGWAS(data, exp_name=exp_name, seed=seed, device=str(device))
    run.initialize_model(
        gnn_num_layers=model_cfg["layers"], gnn_hidden_dim=model_cfg["hidden"],
        gnn_backbone=model_cfg["backbone"], gnn_aggr=model_cfg["aggr"],
        gat_num_head=model_cfg["heads"], no_relu=not model_cfg["relu_head"])
    run.model.load_state_dict(params, strict=True)
    return run


def ldsc_weight_column(data) -> np.ndarray:
    """The port's LDSC weight of each sumstats row, in row order."""
    ids = data.lr_uni["ID"].tolist()
    return np.array([data.rs_id_to_ldsc_weight[i] for i in ids])


def allow_tf32(on: bool):
    """TF32 in float32 products on or off. The configurations state
    float32 with TF32 off; only the control turns it on."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
