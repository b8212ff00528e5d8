"""Frame pose optimization, visual branch (counterpart of
`_pose_optimize_impl` and `_identity_edge` in
`monoorbslam3_tpu/backend/problems.py`).

The reference's 4x10 frame LM (Optimize.cpp:444-545) as the JAX package
runs it: a deferred-accept, parallel-lambda LM whose carry holds the
incumbent plus the previous step's trial states at 4 dampings, with
per-round chi2 inlier re-classification. Every step stays on the device:
the winner is picked by a tensor index, the damping update is a
`torch.where`, and nothing is read back to the host.
"""

from __future__ import annotations

import torch

from ..utils import lie
from . import residuals as res
from . import solver
from .residuals import KfState, PreintEdge
from .solver import _take

CHI2_MONO = 5.991
# frame-level association gate (see the JAX module for why it is looser
# than the BA threshold)
CHI2_FRAME_DROP = 16.0
LAMBDA_FACTORS = (0.03, 1.0, 30.0, 900.0)


def _pose_optimize_impl(
    state0: KfState,
    pts, uv, inv_sigma2, valid,
    camera, R_cb, t_cb,
    edge: PreintEdge, last_state: KfState, edge_valid,
    prior_ref: KfState, prior_inv_sigma,
    n_rounds: int = 2, n_iters: int = 10,
    use_inertial: bool = False, use_prior: bool = False,
):
    """Visual frame LM with per-round chi2 inlier re-classification.

    Returns (state, inlier [N] bool). Only the visual branch is ported:
    `use_inertial` or `use_prior` raises NotImplementedError (the inertial
    tail comes with the IMU slice)."""
    if use_inertial or use_prior:
        raise NotImplementedError(
            "_pose_optimize_impl: only the visual branch is ported "
            "(use_inertial=False, use_prior=False)")
    del edge, last_state, edge_valid, prior_ref, prior_inv_sigma
    dev = pts.device
    lam_factors = torch.tensor(LAMBDA_FACTORS, dtype=torch.float32, device=dev)
    C = 1 + lam_factors.shape[0]

    def chi2_of(s):
        r = res.reprojection_residual(s, pts, uv, camera, R_cb, t_cb)
        depth_ok = res.point_depth(s, pts, R_cb, t_cb) > 0.05
        return torch.sum(r * r, dim=-1) * inv_sigma2, depth_ok

    def vis_linearize_b(s: KfState, w_vis):
        """Batched-over-candidates visual linearize: residual, compact 6-col
        pose Jacobian, IRLS weight, robust cost."""
        p_b = torch.einsum("cnj,cji->cni", pts[None] - s.t_wb[:, None], s.R_wb)
        p_c = torch.einsum("cni,ji->cnj", p_b, R_cb) + t_cb
        r = camera.project(p_c) - uv[None]  # [C, N, 2]
        Jp = camera.proj_jacobian(p_c)  # [C, N, 2, 3]
        JpR = torch.einsum("cnij,jk->cnik", Jp, R_cb)
        Jc = torch.cat([
            torch.einsum("cnij,cnjk->cnik", JpR, lie.hat(p_b)),
            -JpR,
        ], dim=-1)  # [C, N, 2, 6]
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2  # [C, N]
        w = w_vis[None] * res.huber_weight(chi2, CHI2_MONO)
        cost = torch.sum(
            torch.where(w_vis[None] > 0, res.huber_cost(chi2, CHI2_MONO),
                        torch.zeros_like(chi2)), dim=-1)  # [C]
        return r, Jc, w, cost

    def run_round(state, inlier, lm_steps):
        w_vis = inlier.to(torch.float32) * inv_sigma2
        cands = state.map(lambda a: a[None].expand(C, *a.shape))
        lam = torch.tensor(1e-3, dtype=torch.float32, device=dev)
        for _ in range(lm_steps):
            r, Jc, w, cost = vis_linearize_b(cands, w_vis)
            i = torch.argmin(cost)  # incumbent is candidate 0: monotone
            s = cands.map(lambda a: _take(a, i))
            JcW = Jc * w[:, :, None, None]
            H = _take(torch.einsum("cnik,cnil->ckl", JcW, Jc), i)  # [6, 6]
            g = _take(torch.einsum("cnik,cni->ck", JcW, r), i)
            lam = torch.where(
                i == 0, torch.clamp(lam * 100.0, max=1e5),
                torch.clamp(lam * _take(lam_factors, torch.clamp(i - 1, min=0)) * 0.5,
                            1e-7, 1e5))
            D = torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
            lams = lam * lam_factors
            Hs = H[None] + lams[:, None, None] * D[None]
            # closed-form nested-Schur SPD solve on the Jacobi-scaled system
            d6 = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(Hs, dim1=-2, dim2=-1)),
                                        min=1e-12))
            Hn = Hs / (d6[..., :, None] * d6[..., None, :])
            steps = -(solver.inv_spd6(Hn) @ (g / d6)[..., None]).squeeze(-1) / d6
            steps15 = torch.nn.functional.pad(steps, (0, 9))
            trials = res.retract_kf(s.map(lambda a: a[None].expand(steps15.shape[0], *a.shape)),
                                    steps15)
            cands = KfState(*(torch.cat([a[None], b]) for a, b in zip(s, trials)))
        # the incumbent (candidate 0) is the best costed state; the final
        # step's trials were never costed and are discarded
        new_state = cands.map(lambda a: a[0])
        chi2, depth_ok = chi2_of(new_state)
        return new_state, valid & (chi2 < CHI2_FRAME_DROP) & depth_ok

    _, depth_ok = chi2_of(state0)
    inlier = valid & depth_ok
    state = state0
    # 4 dampings per step, so fewer steps than the reference's 10; +1 because
    # the first deferred-accept step only seeds the candidate bank
    lm_steps = max(3, n_iters * 2 // 5) + 1
    for _ in range(n_rounds):
        state, inlier = run_round(state, inlier, lm_steps)
    return state, inlier


def _identity_edge(device) -> PreintEdge:
    f32 = dict(dtype=torch.float32, device=device)
    z3 = torch.zeros(3, **f32)
    z33 = torch.zeros((3, 3), **f32)
    return PreintEdge(
        dR=torch.eye(3, **f32), dV=z3, dP=z3.clone(),
        JRg=z33, JVg=z33.clone(), JVa=z33.clone(), JPg=z33.clone(), JPa=z33.clone(),
        bg0=z3.clone(), ba0=z3.clone(), dt=torch.tensor(1.0, **f32),
        L_inv=torch.eye(9, **f32),
    )
