"""PyTorch port: no module of `monoorbslam3_tpu_torch/`, nor `chip_smoke.py`,
imports `jax` or anything of the JAX package `monoorbslam3_tpu`.

The port keeps its own copy of whatever it needs, also of modules of the
JAX package that do not import JAX themselves. Only the tests import both.
Each file is parsed with `ast` (every `import` and `from ... import`,
wherever it stands, and `importlib.import_module` / `__import__` calls with
a literal name), so an import inside a function is found too.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FILES = sorted(p.relative_to(ROOT).as_posix()
               for p in (ROOT / "monoorbslam3_tpu_torch").rglob("*.py")) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "monoorbslam3_tpu")


def _forbidden(name):
    return name is not None and name.split(".")[0] in FORBIDDEN


def imported_names(source):
    """Every module name a source imports, absolute names only."""
    names = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)):
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if called in ("import_module", "__import__"):
                names.append(node.args[0].value)
    return names


def test_port_has_files():
    assert len(FILES) > 20 and "monoorbslam3_tpu_torch/ops/cuda_lib.py" in FILES


@pytest.mark.parametrize("path", FILES)
def test_no_jax_import(path):
    bad = [n for n in imported_names((ROOT / path).read_text()) if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_walk_finds_imports():
    """The walk sees imports inside functions, `from` imports, and
    importlib calls, and does not mistake the port's own package."""
    src = ("import numpy\n"
           "def f():\n"
           "    from monoorbslam3_tpu.utils import lie\n"
           "    import jax.numpy as jnp\n"
           "    import importlib; importlib.import_module('jaxlib.xla')\n"
           "    from monoorbslam3_tpu_torch.utils import lie as tl\n"
           "    from . import sibling\n")
    assert sorted(n for n in imported_names(src) if _forbidden(n)) == [
        "jax.numpy", "jaxlib.xla", "monoorbslam3_tpu.utils"]
