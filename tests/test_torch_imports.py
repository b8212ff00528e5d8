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


# experiments/port_lockstep_jax.py runs each package in a process of its
# own: every part of it but the JAX half's function runs the port's half
LOCKSTEP = "experiments/port_lockstep_jax.py"
LOCKSTEP_JAX_HALF = ("run_jax",)


def test_lockstep_port_half_imports_no_jax():
    """The lock-step harness's port half (its module level and every
    function but `run_jax`) imports nothing of JAX, and importing the
    module loads none of it (beyond what the interpreter had loaded); its
    JAX half does import the JAX package."""
    import subprocess
    import sys

    tree = ast.parse((ROOT / LOCKSTEP).read_text())
    halves = {True: [], False: []}
    for node in tree.body:
        jax_half = isinstance(node, ast.FunctionDef) and node.name in LOCKSTEP_JAX_HALF
        halves[jax_half] += imported_names(ast.unparse(node))
    assert not [n for n in halves[False] if _forbidden(n)]
    assert any(_forbidden(n) for n in halves[True])
    code = ("import sys; before = set(sys.modules); import experiments.port_lockstep_jax; "
            "print(sorted(m for m in set(sys.modules) - before "
            f"if m.split('.')[0] in {FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         check=True)
    assert out.stdout.strip() == "[]", out.stdout
