"""Residual library, visual part (counterpart of
`monoorbslam3_tpu/backend/residuals.py`).

State conventions (CameraImuPose, G2oTypes.cpp:10-25): body state R_wb,
t_wb, v, bg, ba; camera pose R_cw = R_cb R_wb^T, t_cw = t_cb - R_cw t_wb;
right-multiplicative 15-dim tangent [dphi, dt, dv, dbg, dba]. The inertial
residuals and `PreintEdge.from_preintegrated` join with the IMU slice;
`PreintEdge` is here as the plain record the pose LM's signature takes.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import lie


class KfState(NamedTuple):
    """Batched keyframe (or frame) state [..., ...]."""

    R_wb: torch.Tensor  # [..., 3, 3]
    t_wb: torch.Tensor  # [..., 3]
    v: torch.Tensor  # [..., 3]
    bg: torch.Tensor  # [..., 3]
    ba: torch.Tensor  # [..., 3]

    @staticmethod
    def zeros(batch=(), device="cpu"):
        z = torch.zeros((*batch, 3), dtype=torch.float32, device=device)
        eye = torch.eye(3, dtype=torch.float32, device=device).expand(*batch, 3, 3)
        return KfState(eye.clone(), z, z.clone(), z.clone(), z.clone())

    def map(self, fn) -> "KfState":
        return KfState(*(fn(a) for a in self))


def retract_kf(s: KfState, dx: torch.Tensor) -> KfState:
    """Right-multiplicative 15-dim retraction (CameraImuPose::update), with
    one Newton polar step R <- R (3I - R^T R)/2 that pins the rotation to
    SO(3) (load-bearing: see the JAX docstring)."""
    dphi, dt, dv, dbg, dba = dx[..., 0:3], dx[..., 3:6], dx[..., 6:9], dx[..., 9:12], dx[..., 12:15]
    R = s.R_wb @ lie.exp_so3(dphi)
    RtR = torch.einsum("...ji,...jk->...ik", R, R)
    R = 0.5 * (3.0 * R - torch.einsum("...ij,...jk->...ik", R, RtR))
    t = s.t_wb + torch.einsum("...ij,...j->...i", s.R_wb, dt)
    return KfState(R, t, s.v + dv, s.bg + dbg, s.ba + dba)


def camera_pose(s: KfState, R_cb, t_cb):
    """Body state -> (R_cw, t_cw)."""
    R_cw = R_cb @ s.R_wb.transpose(-1, -2)
    t_cw = t_cb - torch.einsum("...ij,...j->...i", R_cw, s.t_wb)
    return R_cw, t_cw


def reprojection_residual(s: KfState, p_w, uv, camera, R_cb, t_cb):
    """Monocular reprojection residual [..., 2] (EdgeMono,
    G2oTypes.cpp:59-69): project(R_cw p_w + t_cw) - uv."""
    R_cw, t_cw = camera_pose(s, R_cb, t_cb)
    pc = torch.einsum("...ij,...j->...i", R_cw, p_w) + t_cw
    return camera.project(pc) - uv


def point_depth(s: KfState, p_w, R_cb, t_cb):
    R_cw, t_cw = camera_pose(s, R_cb, t_cb)
    pc = torch.einsum("...ij,...j->...i", R_cw, p_w) + t_cw
    return pc[..., 2]


class PreintEdge(NamedTuple):
    """Per-edge preintegration data (the record of the JAX package)."""

    dR: torch.Tensor  # [..., 3, 3]
    dV: torch.Tensor
    dP: torch.Tensor
    JRg: torch.Tensor
    JVg: torch.Tensor
    JVa: torch.Tensor
    JPg: torch.Tensor
    JPa: torch.Tensor
    bg0: torch.Tensor  # linearization biases
    ba0: torch.Tensor
    dt: torch.Tensor  # [...]
    L_inv: torch.Tensor  # [..., 9, 9] inverse Cholesky factor (whitener)


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS Huber weight for squared error chi2 with threshold delta^2."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-20)))


def huber_cost(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """Huber rho(chi2) (g2o RobustKernelHuber convention)."""
    d = float(np.sqrt(np.float32(delta2)))
    e = torch.sqrt(torch.clamp(chi2, min=0.0))
    return torch.where(chi2 <= delta2, chi2, 2.0 * d * e - delta2)
