"""The control comes out not correct: the reference in the program's place,
one precision below the configuration's (kgbench.control), reads above at
least one of the cell's limits, on three seeds, at the cell's widths over
a smaller KG. Needs the card (TF32 exists only there):

    python -m pytest kgbench/tests -q -m gpu
"""
from __future__ import annotations

import pytest

from kgbench import control, run

SEEDS = (2**31 + 21, 2**31 + 22, 2**31 + 23)
CONTROLS = ("tf32", "float32")
WORKLOADS = [w["name"] for w in __import__("json").loads(
    (run.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run.set_environment(run.ROOT)
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_is_not_correct(workload, card):
    cell = run.load_cell(run.ROOT, workload)
    cell["config"]["kg"].update(n_snp=20_000, n_gene=2_000, n_go=1_176)
    if "gwas" in cell["config"]:
        cell["config"]["gwas"]["n_causal"] = 1_000
    limits = cell["limits"]
    for seed in SEEDS:
        r = control.readings(workload, seed, str(card), cell)
        over = [(kind, k) for kind in CONTROLS for k, v in
                r.get(kind, {}).items() if k in limits and v > limits[k]]
        assert over, (seed, r)
        # the float32 reference against itself stays inside every limit
        assert all(v <= limits[k] for k, v in r["f32_again"].items()
                   if k in limits), (seed, r["f32_again"])
