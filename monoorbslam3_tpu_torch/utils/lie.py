"""SO(3) helpers, batched over leading axes (counterpart of
`monoorbslam3_tpu/utils/lie.py`): hat/vee, the exponential and logarithm
maps, the right Jacobian and its inverse, and rotation normalization."""

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


def vee(W: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] skew -> [..., 3]."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _theta_terms(w: torch.Tensor):
    """(theta2, safe_theta, small_mask) for the angle-dependent coefficients."""
    theta2 = torch.sum(w * w, dim=-1)
    small = theta2 < _EPS2
    safe_theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    return theta2, safe_theta, small


def exp_jr_coeffs(w: torch.Tensor):
    """Rodrigues coefficients (A, B, C) of w, each [...]:
    exp(w) = I + A hat(w) + B hat(w)^2 ; Jr(w) = I - B hat(w) + C hat(w)^2."""
    theta2, theta, small = _theta_terms(w)
    safe_t2 = torch.where(small, torch.ones_like(theta2), theta2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    A = torch.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    B = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - cos_t) / safe_t2)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - sin_t) / (safe_t2 * theta))
    return A, B, C


def inv_jr_coeff(w: torch.Tensor) -> torch.Tensor:
    """D(w) [...] with Jr(w)^-1 = I + 0.5 hat(w) + D hat(w)^2."""
    theta2, theta, small = _theta_terms(w)
    one = torch.ones_like(theta2)
    safe_t2 = torch.where(small, one, theta2)
    sin_t, cos_t = torch.sin(theta), torch.cos(theta)
    return torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / safe_t2 - (1.0 + cos_t) / torch.where(small, one, 2.0 * theta * sin_t),
    )


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map, [..., 3] -> [..., 3, 3]."""
    A, B, _ = exp_jr_coeffs(w)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * W2


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map, [..., 3, 3] -> [..., 3]: the trace formula with a
    small-angle branch; near theta = pi the axis comes from the diagonal."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(torch.clamp(cos_t, -1.0 + 1e-7, 1.0 - 1e-7))
    w_asym = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis

    small = cos_t > 1.0 - 1e-7
    near_pi = cos_t < -1.0 + 5e-7

    sin_t = torch.sin(theta)
    factor_small = 0.5 + (3.0 - tr) / 24.0  # theta / (2 sin theta), Taylor
    factor = torch.where(small, factor_small,
                         theta / torch.where(small, torch.ones_like(sin_t), 2.0 * sin_t))
    w_generic = factor[..., None] * w_asym

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, 0.0, 1.0))
    sign = torch.where(w_asym >= 0.0, 1.0, -1.0)
    w_pi = theta[..., None] * axis * sign
    return torch.where(near_pi[..., None], w_pi, w_generic)


def right_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(w): [..., 3] -> [..., 3, 3]."""
    _, B, C = exp_jr_coeffs(w)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) - B[..., None, None] * W + C[..., None, None] * W2


def inv_right_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian Jr(w)^-1: [..., 3] -> [..., 3, 3]."""
    D = inv_jr_coeff(w)
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + 0.5 * W + D[..., None, None] * W2


def normalize_rotation(R: torch.Tensor) -> torch.Tensor:
    """Project a near-rotation onto SO(3) via SVD, flipping the last column
    of U when the product lands on a reflection."""
    U, _, Vt = torch.linalg.svd(R)
    det = torch.linalg.det(U @ Vt)
    flip = torch.ones_like(U)
    flip[..., :, 2] = torch.where(det < 0.0, -1.0, 1.0)[..., None]
    return (U * flip) @ Vt
