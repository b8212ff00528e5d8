"""SO(3) helpers, batched over leading axes (counterpart of
`monoorbslam3_tpu/utils/lie.py`; this slice needs `hat` and `exp_so3`)."""

from __future__ import annotations

import torch

_EPS2 = 1e-12  # squared-angle threshold below which Taylor branches kick in


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zero, -wz, wy], dim=-1),
            torch.stack([wz, zero, -wx], dim=-1),
            torch.stack([-wy, wx, zero], dim=-1),
        ],
        dim=-2,
    )


def exp_jr_coeffs(w: torch.Tensor):
    """Rodrigues coefficients (A, B, C) of w, each [...]:
    exp(w) = I + A hat(w) + B hat(w)^2 ; Jr(w) = I - B hat(w) + C hat(w)^2."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS2
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(safe_t2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - sin_t) / (safe_t2 * theta))
    return A, B, C


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map, [..., 3] -> [..., 3, 3]."""
    A, B, _ = exp_jr_coeffs(w)
    W = hat(w)
    W2 = W @ W
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2
