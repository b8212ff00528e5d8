"""The port's default device: the CUDA card.

The public entry points (`OrbExtractor`, `Pinhole.create`,
`bench_window.build_problem`, the functions of `convert`) default to
`CARD`. On a host without a card they raise: they never fall back to the
CPU. CPU callers (the tests, the CPU rehearsals) pass `device="cpu"`.
"""

from __future__ import annotations

import torch

CARD = torch.device("cuda")


def resolve(device) -> torch.device:
    """`device` as a torch.device; raises when it names CUDA on a host
    without a card."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev}: no CUDA card on this host "
                           "(pass device='cpu' to run on the CPU)")
    return dev


_CONSTANTS: dict = {}


def constant(key, device, make) -> torch.Tensor:
    """The constant array `make()` returns, on `device`, uploaded once per
    (key, device): an upload from pageable memory waits for the device's
    queue, so a per-frame upload would stall every frame."""
    k = (key, torch.device(device))
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = torch.as_tensor(make(), device=device)
    return t
