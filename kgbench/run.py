"""The benchmark of kgwas_tpu_torch: one run of one cell.

    python -m kgbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (the directory holding BENCHMARK.json).
The cell's entry in BENCHMARK.json names its configuration
(``kgbench/configs/<config>.json``) and its traffic mix
(``kgbench/traffic/<traffic>.json``, whose ``driver`` names the module of
``kgbench/drivers/`` that runs it); its limits are
``kgbench/limits/<cell>.json``; a per-layer metric is read by
``kgbench/metrics/<metric>.py`` (``read(record)``: a number, or None where
the run gave nothing to read). So a cell, a configuration, a mix or a
metric is added by adding files and entries.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a torch.profiler trace
of a segment run after the window, and from the window's own spans. The
last line of standard output is the result (one JSON object); the numbers
compared with the reference, each beside its limit, are the last lines of
standard error and the result's last key, ``checks``.

Exit codes: 0 a result was printed; 3 no CUDA card, or fewer than the
cell asks for; 4 JAX or the JAX package was loaded in this process.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "kgwas_tpu")


def load_cell(root: Path, workload: str) -> dict:
    """The cell's entries: workload, config (the file's contents), traffic,
    limits, end_to_end and per_layer metrics that apply to it."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload),
                None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if workload in m.get("workloads", [workload])
                 and m["moves"] in moved]
    return {
        "cell": cell,
        "config": json.loads((root / cfg_entry["file"]).read_text()),
        "traffic": json.loads(
            (HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads(
            (HERE / "limits" / f"{workload}.json").read_text()),
        "peaks": json.loads((HERE / "metrics" / "peaks.json").read_text()),
        "end_to_end": e2e,
        "per_layer": per_layer,
    }


def reader_file(name: str) -> Path:
    """The reader of a per-layer metric: ``metrics/<name>.py``; else, for
    a quantity split by cell, the file of its shared part: ``<base>.py``
    for ``<base>.<part>`` (roofline.gat_fwd.train), then for
    ``<part>_<base>`` (train_idle_pct)."""
    candidates = [name]
    if "." in name:
        candidates.append(name.rsplit(".", 1)[0])
    if "_" in name:
        candidates.append(name.split("_", 1)[1])
    for c in candidates:
        path = HERE / "metrics" / f"{c}.py"
        if path.is_file():
            return path
    raise FileNotFoundError(f"no reader for metric {name!r} in "
                            f"{HERE / 'metrics'}")


def metric_reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"kgbench_metric_{name.replace('.', '_')}", reader_file(name))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_environment(root: Path):
    """Build and kernel caches at fixed paths inside the checkout."""
    os.environ["KGWAS_TORCH_BUILD_DIR"] = str(root / "build" / "kernels")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "triton")


def forbidden_modules() -> list:
    return sorted({k.split(".")[0] for k in sys.modules} & set(FORBIDDEN))


def device_info(device, outcome, trace: bool) -> dict:
    import torch

    if device.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1}
    info["memory_peak_bytes"] = outcome.memory_peak_bytes
    tr = outcome.record.trace
    if trace and tr is not None:
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
    return info


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             root: Path = ROOT, device: str = "cuda", cell=None,
             t_start: float = T_START) -> dict:
    """One run; returns the result object. cell: load_cell's dict (read
    from root where None)."""
    import torch

    from . import program
    from .harness import Context

    cell = cell or load_cell(root, workload)
    program.allow_tf32(False)
    dev = torch.device(device)
    driver = importlib.import_module(
        f"kgbench.drivers.{cell['traffic']['driver']}")
    with tempfile.TemporaryDirectory(prefix="kgbench_") as tmp:
        ctx = Context(workload, cell["config"], cell["traffic"],
                      cell["limits"], seed, seconds, trace, dev, t_start,
                      tmp, cell["peaks"])
        out = driver.run(ctx)
    if trace:
        metrics = {}
        for m in cell["per_layer"]:
            v = metric_reader(m["name"])(out.record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(out.metrics[m["name"]]),
                               "unit": m["unit"]}
                   for m in cell["end_to_end"]}
    correct = out.failed == 0 and all(v <= lim for _, v, lim in out.checks)
    result = {"correct": bool(correct), "attempted": int(out.attempted),
              "failed": int(out.failed), "metrics": metrics,
              "device": device_info(dev, out, trace)}
    if trace and out.record.trace is not None:
        result["breakdown"] = out.record.trace.breakdown()
    result["checks"] = {n: {"value": v, "limit": lim}
                        for n, v, lim in out.checks}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be >= 0")

    cell = load_cell(ROOT, args.workload)
    set_environment(ROOT)
    import torch

    chips = int(cell["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"kgbench: the cell needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " found", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), cell=cell)
    found = forbidden_modules()
    if found:
        print(f"kgbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
