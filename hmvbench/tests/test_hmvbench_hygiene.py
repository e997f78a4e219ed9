"""What the benchmark may import: nothing of JAX or of the JAX package,
anywhere under hmvbench/, and nothing of the program in its reference. Top
level names are compared whole: the program's name, handmvnet_tpu_torch,
begins with the JAX package's."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

HMVBENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "handmvnet_tpu"}


def imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


SOURCES = sorted(HMVBENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HMVBENCH)))
def test_no_jax_anywhere(path):
    assert not imported_roots(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HMVBENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    roots = imported_roots(path)
    assert "handmvnet_tpu_torch" not in roots
    assert roots <= {"__future__", "math", "numpy", "torch", "hmvbench"}


def test_the_harness_forbids_the_same_names():
    from hmvbench import harness
    assert set(harness.FORBIDDEN) == FORBIDDEN


def test_a_run_refuses_a_loaded_jax_package(monkeypatch):
    import sys
    import types
    from hmvbench import harness
    monkeypatch.setitem(sys.modules, "handmvnet_tpu_torch_probe", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "handmvnet_tpu.models", types.ModuleType("y"))
    assert harness.forbidden_modules() == ["handmvnet_tpu"]
