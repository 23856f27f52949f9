"""Host utilities: logging, metrics and tab-separated column tables.

A table is a ``dict[str, np.ndarray]`` of equal-length columns, the port's
stand-in for the JAX package's DataFrames.
"""
from __future__ import annotations

import pickle
import sys

import numpy as np


def print_sys(s):
    """stderr logging."""
    print(s, flush=True, file=sys.stderr)


def load_dict(path):
    """A pickled object (the KG's id maps, GO names, gene sets)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def compute_metrics(results: dict) -> dict:
    """MSE and Pearson r of ``results["pred"]`` against ``results["truth"]``;
    r is NaN when either side is constant."""
    from scipy.stats import pearsonr

    pred = np.asarray(results["pred"], dtype=np.float64)
    truth = np.asarray(results["truth"], dtype=np.float64)
    mse = float(np.mean((pred - truth) ** 2))
    if np.std(pred) == 0 or np.std(truth) == 0:
        r = float("nan")
    else:
        r = float(pearsonr(pred, truth)[0])
    return {"mse": mse, "pearsonr": r}


def _cell_text(col: np.ndarray) -> np.ndarray:
    col = np.asarray(col)
    if col.dtype.kind == "f":
        text = col.astype(str)
        text[np.isnan(col)] = ""
        return text
    return col.astype(str)


def write_table(table: dict, path: str, sep: str = "\t"):
    """Write a column table as text with a header line, columns in order:
    each column converted to text at once, the file written in one call."""
    names = list(table)
    cols = [_cell_text(table[k]).tolist() for k in names]
    lines = [sep.join(names)]
    lines.extend(map(sep.join, zip(*cols)))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def _parse(values):
    for kind in (np.int64, np.float64):
        try:
            return np.array(
                [np.nan if kind is np.float64 and v == "" else v
                 for v in values], dtype=kind)
        except ValueError:
            continue
    return np.array(values, dtype=object)


def read_table(path: str, sep: str = "\t") -> dict:
    """Read a table written by write_table (or pandas ``to_csv(sep=...)``):
    integer, float or string columns."""
    with open(path) as f:
        header = f.readline().rstrip("\n").split(sep)
        rows = [line.rstrip("\n").split(sep) for line in f if line.strip()]
    cols = list(zip(*rows)) if rows else [()] * len(header)
    return {name: _parse(list(c)) for name, c in zip(header, cols)}
