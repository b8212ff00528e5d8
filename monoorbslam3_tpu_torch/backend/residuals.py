"""Residual library (counterpart of `monoorbslam3_tpu/backend/residuals.py`):
the visual reprojection residual, the inertial preintegration residual,
the bias random walk and the diagonal prior.

State conventions (CameraImuPose, G2oTypes.cpp:10-25): body state R_wb,
t_wb, v, bg, ba; camera pose R_cw = R_cb R_wb^T, t_cw = t_cb - R_cw t_wb;
right-multiplicative 15-dim tangent [dphi, dt, dv, dbg, dba].
`PreintEdge.from_preintegrated` joins with the IMU preintegration slice.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..models.imu import GRAVITY_VALUE
from ..utils import lie

G_I = np.array([0.0, 0.0, -GRAVITY_VALUE], np.float32)


def gravity(device) -> torch.Tensor:
    """G_I as a float32 tensor, made on the device by kernels alone (a copy
    from host memory, or an element assignment, waits for the device's
    queue)."""
    axis = torch.arange(3, device=device) == 2
    return axis.to(torch.float32) * float(G_I[2])


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

    def corrected(self, bg: torch.Tensor, ba: torch.Tensor):
        """First-order bias-corrected deltas (Imu.cpp:182-204)."""
        dbg = bg - self.bg0
        dba = ba - self.ba0
        mv = lambda M, x: torch.einsum("...ij,...j->...i", M, x)
        dR = self.dR @ lie.exp_so3(mv(self.JRg, dbg))
        dV = self.dV + mv(self.JVg, dbg) + mv(self.JVa, dba)
        dP = self.dP + mv(self.JPg, dbg) + mv(self.JPa, dba)
        return dR, dV, dP


def inertial_residual(s1: KfState, s2: KfState, edge: PreintEdge,
                      whiten: bool = True) -> torch.Tensor:
    """9-D preintegration residual between consecutive states (EdgeInertial,
    G2oTypes.cpp:358-445), whitened by the covariance Cholesky."""
    dR, dV, dP = edge.corrected(s1.bg, s1.ba)
    Rb1w = s1.R_wb.transpose(-1, -2)
    dt = edge.dt[..., None]
    g = gravity(dt.device)
    er = lie.log_so3(dR.transpose(-1, -2) @ Rb1w @ s2.R_wb)
    ev = torch.einsum("...ij,...j->...i", Rb1w, s2.v - s1.v - g * dt) - dV
    ep = torch.einsum("...ij,...j->...i", Rb1w,
                      s2.t_wb - s1.t_wb - s1.v * dt - 0.5 * g * dt * dt) - dP
    r = torch.cat([er, ev, ep], dim=-1)
    if whiten:
        r = torch.einsum("...ij,...j->...i", edge.L_inv, r)
    return r


def bias_walk_residual(s1: KfState, s2: KfState,
                       inv_sigma_walk: torch.Tensor) -> torch.Tensor:
    """6-D random-walk residual between consecutive KFs (EdgeBiasWalk,
    G2oTypes.h:452-483), pre-whitened by the walk stddev."""
    return torch.cat([s2.bg - s1.bg, s2.ba - s1.ba], dim=-1) * inv_sigma_walk


def prior_residual(x: torch.Tensor, x0: torch.Tensor,
                   inv_sigma: torch.Tensor) -> torch.Tensor:
    """Whitened prior (EdgePriori3D, G2oTypes.h:324-343)."""
    return (x - x0) * inv_sigma


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS Huber weight for squared error chi2 with threshold delta^2."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-20)))


def huber_cost(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """Huber rho(chi2) (g2o RobustKernelHuber convention)."""
    d = float(np.sqrt(np.float32(delta2)))
    e = torch.sqrt(torch.clamp(chi2, min=0.0))
    return torch.where(chi2 <= delta2, chi2, 2.0 * d * e - delta2)
