"""Nothing the benchmark runs imports JAX or the JAX package ``fxtpu``
(top-level names compared whole: the program ``fxtpu_torch`` begins with
``fxtpu``), and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

from fxbench import run
from fxbench.cells import HERE

FORBIDDEN = {"jax", "jaxlib", "flax", "fxtpu"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "fxtpu_torch" not in imported_tops(path)


def test_the_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys
    import types
    assert "fxtpu_torch" not in run.FORBIDDEN
    monkeypatch.setitem(sys.modules, "fxtpu.config",
                        types.ModuleType("fxtpu.config"))
    assert run.forbidden_modules() == ["fxtpu"]
