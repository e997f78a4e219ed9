"""The port stands alone: no file of handmvnet_tpu_torch/, and not
chip_smoke.py, imports jax, flax or the JAX package."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "handmvnet_tpu"}
PORT_FILES = sorted((ROOT / "handmvnet_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            roots |= {a.value.split(".")[0] for a in node.args[:1]
                      if isinstance(a, ast.Constant) and isinstance(a.value, str)}
    return roots


def test_port_has_files():
    assert len(PORT_FILES) > 15
    assert all(p.exists() for p in PORT_FILES)
    parallel = {p.name for p in PORT_FILES if p.parent.name == "parallel"}
    assert parallel == {"__init__.py", "mesh.py", "view_parallel.py"}
    assert ROOT / "handmvnet_tpu_torch" / "export.py" in PORT_FILES
    assert ROOT / "handmvnet_tpu_torch" / "models" / "backbones" / "hourglass.py" in PORT_FILES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = _imported_roots(path) & FORBIDDEN
    assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_checker_sees_the_forbidden_forms(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy\nfrom flax import linen\n"
                     "def f():\n    from handmvnet_tpu.ops import x\n"
                     "import handmvnet_tpu_torch.ops\n")
    assert _imported_roots(probe) & FORBIDDEN == {"jax", "flax", "handmvnet_tpu"}
