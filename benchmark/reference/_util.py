"""Device helpers of the frozen reference (no import of the program)."""

from __future__ import annotations

import torch

CARD = torch.device("cuda")


def resolve(device) -> torch.device:
    return torch.device(device)


_CONSTANTS: dict = {}


def constant(key, device, make) -> torch.Tensor:
    """The constant array `make()` returns, on `device`, made once per
    (key, device)."""
    k = (key, torch.device(device))
    t = _CONSTANTS.get(k)
    if t is None:
        t = _CONSTANTS[k] = torch.as_tensor(make(), device=device)
    return t
