"""Two-view geometry (counterpart of `monoorbslam3_tpu/ops/twoview.py`).

This slice ports `triangulate_dlt`, which the mapper's triangulation
search runs; `reconstruct_two_views` (the RANSAC bootstrap) comes with the
tracking state machine.
"""

from __future__ import annotations

import torch


def _det3_rows(M: torch.Tensor) -> torch.Tensor:
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            + M[..., 0, 1] * (M[..., 1, 2] * M[..., 2, 0] - M[..., 1, 0] * M[..., 2, 2])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def triangulate_dlt(P1, P2, xy1, xy2):
    """Batched linear triangulation (reference Triangulate, .cpp:689-705).

    P1, P2: [3, 4] (or broadcastable leading dims); xy1, xy2: [..., 2].
    Returns [..., 3] points: the inhomogeneous DLT (w = 1 gauge) solved
    from its 3x3 normal equations in closed form (Cramer), with the
    determinant guarded at 1e-20."""
    rows = [
        xy1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        xy1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        xy2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        xy2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)  # [..., 4, 4]
    A1 = A[..., :3]
    a4 = A[..., 3]
    M = torch.einsum("...ri,...rj->...ij", A1, A1)
    b = -torch.einsum("...ri,...r->...i", A1, a4)
    det = _det3_rows(M)
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)

    def cram(col):
        Mi = M.clone()
        Mi[..., :, col] = b
        return _det3_rows(Mi) / det

    return torch.stack([cram(0), cram(1), cram(2)], dim=-1)
