"""No module under benchmark/ imports JAX or the JAX package, and the
plain reference imports nothing of the port (top-level names compared
whole: the port's name begins with the JAX package's)."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "monoorbslam3_tpu"}


def imported(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(ROOT.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "monoorbslam3_tpu_torch" not in imported(path)
    assert "benchmark" not in imported(path)  # only its own modules, relatively


def test_the_walk_sees_an_import():
    assert "monoorbslam3_tpu_torch" in imported(ROOT / "drivers" / "stream.py")
