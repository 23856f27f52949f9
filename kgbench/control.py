"""The control of each cell's comparison, at the cell's own size.

    python -m kgbench.control --workload <cell> --seeds 1,2,3

For each seed, the reference computed in the nearest precision below the
configuration's stands in for the program (TF32 products for the float32
model with TF32 off; float32 for the float64 data layer and KGWAS_P tail),
and a training cell's reference also runs with half of each batch left
out (the mean over the rest). Each of the cell's numbers is read as the
run's check reads it, against the float32 (float64) reference; the
float32 reference run again gives its own rounding. One JSON line a seed.
The limits in kgbench/limits/ lie between these readings and those of
sound runs of the program; the benchmark's own runs do not run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import tempfile

from .run import ROOT, load_cell, set_environment


def readings(workload: str, seed: int, device: str = "cuda", cell=None):
    import torch

    from . import program
    from .harness import Context, now

    cell = cell or load_cell(ROOT, workload)
    program.allow_tf32(False)
    driver = importlib.import_module(
        f"kgbench.drivers.{cell['traffic']['driver']}")
    with tempfile.TemporaryDirectory(prefix="kgbench_") as tmp:
        ctx = Context(workload, cell["config"], cell["traffic"],
                      cell["limits"], seed, 0.0, False, torch.device(device),
                      now(), tmp, cell["peaks"])
        return driver.control(ctx)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds, e.g. 1,2,3")
    args = ap.parse_args(argv)
    cell = load_cell(ROOT, args.workload)
    set_environment(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("kgbench.control: no CUDA card", file=sys.stderr)
        return 3
    for s in args.seeds.split(","):
        out = readings(args.workload, int(s), cell=cell)
        print(json.dumps({"workload": args.workload, "seed": int(s),
                          "readings": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
