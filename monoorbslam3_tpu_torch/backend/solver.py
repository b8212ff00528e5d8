"""Closed-form small SPD inverses (counterpart of the `inv3x3`,
`_inv_spd_block` and `inv_spd6` of `monoorbslam3_tpu/backend/solver.py`;
the Schur BA joins with the mapper slice)."""

from __future__ import annotations

import torch


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], -1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], -1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], -1),
    ], -2)
    return adj * inv_det[..., None, None]


def _inv_spd_block(M: torch.Tensor, n1: int, inv_a, inv_s) -> torch.Tensor:
    """Blockwise SPD inverse via the Schur complement:
    [[A, B], [B^T, D]]^-1 with A (n1 x n1) inverted by `inv_a` and
    S = D - B^T A^-1 B inverted by `inv_s`."""
    A = M[..., :n1, :n1]
    B = M[..., :n1, n1:]
    D = M[..., n1:, n1:]
    Ai = inv_a(A)
    AiB = Ai @ B
    S = D - B.transpose(-1, -2) @ AiB
    Si = inv_s(S)
    TR = -AiB @ Si
    TL = Ai - TR @ AiB.transpose(-1, -2)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([TR.transpose(-1, -2), Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inv_spd6(M: torch.Tensor) -> torch.Tensor:
    return _inv_spd_block(M, 3, inv3x3, inv3x3)
