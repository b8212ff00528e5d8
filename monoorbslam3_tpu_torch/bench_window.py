"""The local-BA bench window (counterpart of `build_problem` in `bench.py`).

The reference's local-BA shape (Optimize.cpp:1064-1310): a sliding window
of 24 optimized + 8 fixed keyframes along an arc, 2048 landmarks in front,
192 observations per keyframe (6144 in all), inertial edges with the
identity preintegration between consecutive keyframes, and bias-walk
edges. The same `np.random.default_rng(seed)` draws are made in the same
order as `bench.py`, so both packages build the same problem up to float32
rounding. Observation rows are grouped per keyframe (obs_kf[o] == o //
obs_per_kf), so `schur_ba(..., grouped_obs=obs_per_kf)` applies.
"""

from __future__ import annotations

import numpy as np
import torch

from .backend import residuals as res
from .backend.residuals import KfState, PreintEdge
from .backend.solver import BAProblem
from .models.camera import Pinhole
from .utils import lie
from .utils.device import CARD, resolve

CAM = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=752, height=480)


def build_problem(n_kf=32, n_fixed=8, n_pts=2048, obs_per_kf=192, seed=0,
                  device=CARD):
    """Returns (BAProblem, Pinhole) on `device`; the body-to-camera
    transform of the window is the identity."""
    device = resolve(device)
    rng = np.random.default_rng(seed)
    f32 = dict(dtype=torch.float32, device=device)
    cam = Pinhole.create(**CAM, device=device)

    rng.uniform(0.2, 0.3, n_kf)  # keyframe times: drawn (and unused) as in bench.py
    w = torch.zeros((n_kf, 3), **f32)
    w[:, 1] = 0.02 * torch.arange(n_kf, **f32)
    R_gt = lie.exp_so3(w)
    t_gt = torch.as_tensor(np.stack([np.array([0.3 * k, 0.02 * k, 0.05 * np.sin(k)], np.float32)
                                     for k in range(n_kf)]), **f32)
    v_gt = torch.as_tensor(rng.normal(0, 0.5, (n_kf, 3)).astype(np.float32), **f32)
    z = torch.zeros((n_kf, 3), **f32)
    kf_gt = KfState(R_gt, t_gt, v_gt, z, z.clone())
    pts = np.stack([
        rng.uniform(-6, 6 + 0.3 * n_kf, n_pts),
        rng.uniform(-4, 4, n_pts),
        rng.uniform(6, 14, n_pts),
    ], -1).astype(np.float32)

    O = n_kf * obs_per_kf
    obs_kf = np.repeat(np.arange(n_kf, dtype=np.int64), obs_per_kf)
    obs_pt = rng.integers(0, n_pts, O).astype(np.int64)
    obs_kf_t = torch.as_tensor(obs_kf, device=device)
    obs_pt_t = torch.as_tensor(obs_pt, device=device)
    s_o = kf_gt.map(lambda a: a[obs_kf_t])
    uv = res.reprojection_residual(
        s_o, torch.as_tensor(pts, **f32)[obs_pt_t], torch.zeros((O, 2), **f32),
        cam, torch.eye(3, **f32), torch.zeros(3, **f32))
    uv = uv + torch.as_tensor(rng.normal(0, 0.4, (O, 2)).astype(np.float32), **f32)
    valid = torch.isfinite(uv).all(1) & (torch.abs(uv[:, 0] - 376) < 2000)

    dof = np.zeros((n_kf, 15), np.float32)
    dof[:-n_fixed] = 1.0
    dof_t = torch.as_tensor(dof, **f32)

    E = n_kf - 1
    z3 = torch.zeros((E, 3), **f32)
    z33 = torch.zeros((E, 3, 3), **f32)
    edge = PreintEdge(
        dR=torch.eye(3, **f32).expand(E, 3, 3).clone(), dV=z3, dP=z3.clone(),
        JRg=z33, JVg=z33.clone(), JVa=z33.clone(), JPg=z33.clone(), JPa=z33.clone(),
        bg0=z3.clone(), ba0=z3.clone(), dt=torch.full((E,), 0.25, **f32),
        L_inv=torch.eye(9, **f32).expand(E, 9, 9).clone(),
    )
    # perturb the optimized states so the iterations do real work
    dx = torch.as_tensor(rng.normal(0, 0.01, (n_kf, 15)).astype(np.float32) * dof, **f32)
    kf0 = res.retract_kf(kf_gt, dx)
    points0 = pts + rng.normal(0, 0.02, pts.shape).astype(np.float32)

    problem = BAProblem(
        kf=kf0, kf_dof=dof_t,
        points=torch.as_tensor(points0, **f32),
        pt_active=torch.ones(n_pts, dtype=torch.bool, device=device),
        obs_kf=obs_kf_t, obs_pt=obs_pt_t, obs_uv=uv,
        obs_inv_sigma2=torch.ones(O, **f32), obs_valid=valid,
        ie_i=torch.arange(E, device=device),
        ie_j=torch.arange(1, E + 1, device=device),
        ie_edge=edge, ie_valid=torch.ones(E, dtype=torch.bool, device=device),
        walk_inv_sigma=torch.full((E, 6), 30.0, **f32),
        walk_valid=torch.ones(E, dtype=torch.bool, device=device),
        prior_inv_sigma=torch.zeros((n_kf, 15), **f32), prior_ref=kf0,
    )
    return problem, cam
