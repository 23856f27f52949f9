"""The benchmark's inputs, made from ``--seed``: the raw knowledge graph and
its feature tables (``kg.py``), the GWAS sumstats and LD scores
(``gwas.py``) and the initial parameters in the reference model's key names
(``params.py``). Nothing here imports the program: the harness hands these
inputs to the program and to the reference alike.
"""
from __future__ import annotations

import numpy as np
import torch

SNP, GENE = "SNP", "Gene"
GO_TYPES = ("CellularComponent", "BiologicalProcess", "MolecularFunction")


def sub_seed(seed: int, *tags: int) -> int:
    """A 32-bit seed for one stream of the run: seed (any whole number >= 0,
    also past 2**32) and tags hashed by numpy's SeedSequence."""
    return int(np.random.SeedSequence([int(seed), *tags]).generate_state(1)[0])


def generator(seed: int, device, *tags: int) -> torch.Generator:
    """A torch.Generator on device, seeded from (seed, tags)."""
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *tags))
