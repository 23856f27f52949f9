"""Host utilities: logging, pickle IO, metrics and column tables.

A table is a ``dict[str, np.ndarray]`` of equal-length columns, the port's
stand-in for the JAX package's DataFrames. ``read_table`` and
``write_table`` are its text IO, with pandas' ``read_csv`` / ``to_csv``
semantics on numpy alone.
"""
from __future__ import annotations

import csv
import os
import pickle
import sys

import numpy as np


def print_sys(s):
    """stderr logging."""
    print(s, flush=True, file=sys.stderr)


def save_dict(path, obj):
    with open(path, "wb") as f:
        pickle.dump(obj, f, pickle.HIGHEST_PROTOCOL)


def load_dict(path):
    """A pickled object (the KG's id maps, GO names, gene sets)."""
    with open(path, "rb") as f:
        return pickle.load(f)


def compute_metrics(results: dict, binary=False, coverage=None,
                    uncertainty_reg=1, loss_fct=None) -> dict:
    """MSE and Pearson r of ``results["pred"]`` against ``results["truth"]``;
    r is NaN when either side is constant. The other arguments are the JAX
    package's signature, unused there too."""
    from scipy.stats import pearsonr

    pred = np.asarray(results["pred"], dtype=np.float64)
    truth = np.asarray(results["truth"], dtype=np.float64)
    mse = float(np.mean((pred - truth) ** 2))
    if np.std(pred) == 0 or np.std(truth) == 0:
        r = float("nan")
    else:
        r = float(pearsonr(pred, truth)[0])
    return {"mse": mse, "pearsonr": r}


def find_nearest(array, value):
    array = np.asarray(array)
    idx = (np.abs(array - value)).argmin()
    return array[idx]


def flatten(list_of_lists):
    return [item for sublist in list_of_lists for item in sublist]


def ensure_dir(path):
    os.makedirs(path, exist_ok=True)
    return path


def find_connected_components_details(edges):
    """Connected components with per-component node and edge lists,
    iterative DFS."""
    graph = {}
    for u, v in edges:
        graph.setdefault(u, []).append(v)
        graph.setdefault(v, []).append(u)

    def dfs(vertex):
        visited_nodes = set()
        visited_edges = set()
        stack = [vertex]
        while stack:
            current = stack.pop()
            if current in visited_nodes:
                continue
            visited_nodes.add(current)
            for neighbor in graph[current]:
                stack.append(neighbor)
                if (current, neighbor) not in visited_edges and (
                    neighbor,
                    current,
                ) not in visited_edges:
                    visited_edges.add((current, neighbor))
        return list(visited_nodes), list(visited_edges)

    visited = set()
    components = []
    for vertex in graph:
        if vertex not in visited:
            nodes, comp_edges = dfs(vertex)
            components.append({"nodes": nodes, "edges": comp_edges})
            visited.update(nodes)
    return components


# ---------------------------------------------------------------- text tables

def _cell_text(col: np.ndarray) -> np.ndarray:
    col = np.asarray(col)
    if col.dtype.kind == "f":
        text = col.astype(str)
        text[np.isnan(col)] = ""
        return text
    if col.dtype.kind == "O":
        # a missing value (NaN) is written as an empty cell
        return np.array(["" if isinstance(v, float) and v != v else str(v)
                         for v in col.tolist()], dtype=object)
    return col.astype(str)


def _quoted(cells: np.ndarray, sep: str) -> np.ndarray:
    """csv QUOTE_MINIMAL, as pandas' ``to_csv`` quotes: a cell holding the
    separator, a quote or a line break is quoted, its quotes doubled."""
    cells = np.asarray(cells, dtype=object)
    need = np.zeros(len(cells), dtype=bool)
    for ch in {sep, '"', "\n", "\r"}:
        need |= np.char.find(cells.astype(str), ch) >= 0
    if need.any():
        cells = cells.copy()
        cells[need] = ['"' + c.replace('"', '""') + '"' for c in cells[need]]
    return cells


def write_columns(cols: list, path: str, sep: str = "\t", names=None):
    """Write columns as text, as pandas' ``to_csv(path, sep=sep,
    index=False)`` writes a frame of them: a header line of ``names``
    (``header=None`` when names is None), NaN as an empty cell, text quoted
    where csv's QUOTE_MINIMAL quotes it, floats as numpy prints them (as
    pandas does). Each column is converted to text at once, the file
    written in one call. Columns may repeat (``df[["eid", "eid"]]``)."""
    texts = []
    for col in cols:
        text = _cell_text(col)
        if text.dtype.kind == "O" or len(cols) == 1:
            text = _quoted(text, sep)
            if len(cols) == 1:
                # csv writes a row of one empty field as ""
                text[text == ""] = '""'
        texts.append(text.tolist())
    lines = ([] if names is None else
             [sep.join(_quoted(np.array(names, dtype=object), sep).tolist())])
    lines.extend(map(sep.join, zip(*texts)))
    with open(path, "w") as f:
        f.write("".join(line + "\n" for line in lines))


def write_table(table: dict, path: str, sep: str = "\t"):
    """Write a column table as text with a header line, columns in order,
    as pandas' ``to_csv(path, sep=sep, index=False)`` writes it
    (``write_columns``)."""
    write_columns(list(table.values()), path, sep, names=list(table))


# pandas' default missing-value tokens (pandas._libs.parsers.STR_NA_VALUES)
NA_TOKENS = np.array(
    ["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan",
     "1.#IND", "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a",
     "nan", "null"])
_BOOL_TOKENS = {"True": True, "TRUE": True, "true": True,
                "False": False, "FALSE": False, "false": False}


def _parse(values):
    """One text column as read_csv types it: int64; float64 (correctly
    rounded, and ints with a missing value become floats); bool; else an
    object column of strings with NaN for the missing cells."""
    text = np.array(values, dtype=str)
    na = np.isin(text, NA_TOKENS)
    if (np.char.find(text, "_") >= 0).any():
        # numpy's casts read "1_000" as a number, pandas as text
        na_text = np.array(text.tolist(), dtype=object)
        na_text[na] = np.nan
        return na_text
    if not na.any():
        try:
            return text.astype(np.int64)
        except (ValueError, OverflowError):
            pass
        if len(text) and np.isin(text, list(_BOOL_TOKENS)).all():
            return np.array([_BOOL_TOKENS[v] for v in text.tolist()])
    try:
        return np.where(na, "nan", text).astype(np.float64)
    except ValueError:
        pass
    out = np.array(text.tolist(), dtype=object)
    out[na] = np.nan
    return out


def _column_names(header):
    """pandas' names for a header line: an empty cell is "Unnamed: i", a
    repeated name gets ".1", ".2", ..."""
    names, seen = [], set()
    for i, h in enumerate(header):
        name = h if h else f"Unnamed: {i}"
        base, k = name, 0
        while name in seen:
            k += 1
            name = f"{base}.{k}"
        seen.add(name)
        names.append(name)
    return names


def read_table(path: str, sep="\t", header=0) -> dict:
    """Read a delimited text table as pandas' ``read_csv`` does, one whole
    column at a time. sep=None sniffs the separator from the first line
    with ``csv.Sniffer``, as ``read_csv(sep=None, engine="python")`` does.
    header=None: no header line, columns named 0, 1, ... Quoted fields
    follow csv's rules (quote char ", doubled to escape it); blank lines
    are skipped; pandas' default NA tokens are missing values; each column
    becomes int64, float64, bool or strings (``_parse``)."""
    with open(path, newline="") as f:
        if sep is None:
            first = f.readline()
            sep = csv.Sniffer().sniff(first).delimiter
            f.seek(0)
        rows = [r for r in csv.reader(f, delimiter=sep, quotechar='"',
                                      doublequote=True, strict=True) if r]
    if header is None:
        width = max((len(r) for r in rows), default=0)
        names = list(range(width))
    else:
        if not rows:
            raise ValueError(f"{path}: no header line")
        names = _column_names(rows.pop(0))
        width = len(names)
    for r in rows:
        if len(r) > width:
            raise ValueError(f"{path}: a row has {len(r)} fields, the header "
                             f"{width}")
        if len(r) < width:
            r.extend([""] * (width - len(r)))
    cols = list(zip(*rows)) if rows else [()] * width
    return {name: _parse(list(c)) for name, c in zip(names, cols)}


def take(table: dict, rows) -> dict:
    """The rows of a column table selected by a mask or indices."""
    return {k: np.asarray(v)[rows] for k, v in table.items()}


def rename(table: dict, columns: dict) -> dict:
    """pandas' ``rename(columns=...)``: names replaced, order kept."""
    return {columns.get(k, k): v for k, v in table.items()}


def n_rows(table: dict) -> int:
    return len(next(iter(table.values()))) if table else 0



def sort_order(col) -> np.ndarray:
    """Row order of pandas' ``sort_values()`` on one column (quicksort,
    ascending, missing values last): numpy's quicksort argsort of the
    present values, as pandas calls it, so tied rows come out in the same
    order on the same numpy."""
    col = np.asarray(col)
    if col.dtype.kind == "f":
        na = np.isnan(col)
    elif col.dtype.kind == "O":
        na = np.array([v != v for v in col.tolist()], dtype=bool)
    else:
        na = np.zeros(len(col), dtype=bool)
    idx = np.arange(len(col))
    present = idx[~na][col[~na].argsort(kind="quicksort")]
    return np.concatenate([present, idx[na]])


def head_text(table: dict, n: int = 10, columns=None) -> str:
    """The first n rows of a column table as aligned text, each row's
    number first (what printing pandas' ``df[columns].head(n)`` shows);
    floats at 6 significant digits."""
    columns = list(table) if columns is None else list(columns)
    rows = min(n, n_rows(table))

    def cell(v):
        return f"{v:.6g}" if isinstance(v, (float, np.floating)) else str(v)

    cols = [[""] + [str(i) for i in range(rows)]]
    for c in columns:
        cols.append([str(c)] + [cell(v) for v in
                                np.asarray(table[c])[:rows].tolist()])
    widths = [max(map(len, col)) for col in cols]
    return "\n".join("  ".join(col[r].rjust(w) for col, w in zip(cols, widths))
                     for r in range(rows + 1))


def unique_in_order(col) -> list:
    """pandas' ``Series.unique()``: each value once, in order of first
    appearance."""
    return list(dict.fromkeys(np.asarray(col).tolist()))
