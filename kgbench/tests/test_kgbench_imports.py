"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference and the inputs import nothing of the port: every import of every
kgbench source, its top-level name (the part before the first dot)
compared whole, relative imports resolved inside kgbench."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "kgwas_tpu"}
PORT = "kgwas_tpu_torch"
# kgbench modules that reach the port: the reference and inputs import none
PORT_SIDE = {"kgbench.program", "kgbench.drivers", "kgbench.run",
             "kgbench.control", "kgbench.tests"}
SOURCES = sorted(PKG.rglob("*.py"))


def imports(path: Path) -> set:
    """Every module path imported by the source, relative ones made
    absolute from the file's package."""
    pkg = ["kgbench", *path.relative_to(PKG).parent.parts]
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = pkg[:len(pkg) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            out.add(mod)
            out |= {f"{mod}.{a.name}" for a in node.names}
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value)
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax(path):
    bad = {m for m in imports(path) if m.split(".")[0] in FORBIDDEN}
    assert not bad, f"{path}: {sorted(bad)}"


@pytest.mark.parametrize("path", [p for p in SOURCES if p.parent.name in
                                  ("reference", "inputs")],
                         ids=lambda p: str(p.relative_to(PKG)))
def test_reference_and_inputs_stay_off_the_port(path):
    bad = {m for m in imports(path) if m.split(".")[0] == PORT
           or any(m == s or m.startswith(s + ".") for s in PORT_SIDE)}
    assert not bad, f"{path}: {sorted(bad)}"


def test_the_check_compares_whole_names():
    assert "kgwas_tpu_torch".split(".")[0] not in FORBIDDEN
    assert "kgwas_tpu.ops".split(".")[0] in FORBIDDEN
