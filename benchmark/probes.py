"""The benchmark's hooks into the port: wrappers around the calls into
each layer, installed at run time from the benchmark's own files.

- `Patches.wrap_function` replaces a module-level function of the port in
  every module of the package that holds it (a function imported by name
  lives in each importer's namespace), and `Patches.undo` puts it back;
- `Recorder` keeps what the wrappers saw: the shapes of the hand kernels'
  launches while tracing (for the rooflines), and the inputs and outputs
  of the calls sampled for the correctness check, cloned when made.
"""

from __future__ import annotations

import sys

import torch

PACKAGE = "monoorbslam3_tpu_torch"


class Patches:
    """The wrappers a run installed, undone by `undo` (or on leaving a
    `with` block), so that a process can run the harness again."""

    def __init__(self):
        self._done = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.undo()

    def undo(self):
        for owner, attr, old in reversed(self._done):
            setattr(owner, attr, old)
        self._done.clear()

    def set(self, owner, attr, new):
        self._done.append((owner, attr, getattr(owner, attr)))
        setattr(owner, attr, new)

    def wrap_function(self, orig, make_wrapper) -> int:
        """Replace `orig` by `make_wrapper(orig)` wherever a module of the
        port holds it; returns how many places held it."""
        wrapper = make_wrapper(orig)
        n = 0
        for name, mod in list(sys.modules.items()):
            if mod is None or not (name == PACKAGE or name.startswith(PACKAGE + ".")):
                continue
            for attr, val in list(vars(mod).items()):
                if val is orig:
                    self.set(mod, attr, wrapper)
                    n += 1
        if n == 0:
            raise RuntimeError(f"the port holds no {getattr(orig, '__name__', orig)!r}")
        return n


def clone(tree):
    """Tensors (nested in tuples, named tuples, lists and dicts) cloned;
    anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone(v) for v in tree)
    return tree


class Recorder:
    """What the wrappers saw. `tracing` turns on the shape log,
    `sampling` the capture of calls for the check."""

    def __init__(self):
        self.tracing = False
        self.sampling = False
        self.shapes: dict[str, list] = {}
        self.calls: dict[str, list] = {}

    def shape(self, kernel: str, dims: tuple):
        if self.tracing:
            self.shapes.setdefault(kernel, []).append(dims)

    def keep(self, name: str, args, kwargs, out, limit: int):
        got = self.calls.setdefault(name, [])
        if len(got) < limit:
            got.append((clone(args), clone(kwargs), clone(out)))
