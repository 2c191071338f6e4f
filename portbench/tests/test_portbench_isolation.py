"""No module of the benchmark imports JAX, Flax or the JAX package
(``repro``), and the reference imports nothing of the program either.
Top-level names are compared whole: ``repro_torch`` is not ``repro``."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


FILES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_anywhere(path):
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_program(path):
    assert not imported_roots(path) & (FORBIDDEN | {"repro_torch"})


def test_the_scan_sees_each_kind_of_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy\nfrom repro.sparse import x\nimport repro_torch\n"
                 "importlib.import_module('jaxlib')\n")
    assert imported_roots(f) == {"jax", "repro", "repro_torch", "jaxlib"}
