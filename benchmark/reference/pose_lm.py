"""The frame LM, frozen as the port had it when the benchmark was written
(`backend/problems._pose_optimize_impl` and `_tail_linearize`): the
tracker's pose solve, the plain version the benchmark holds it to.
Imports nothing of the port.
"""

from __future__ import annotations

import torch

from . import lie
from . import residuals as res
from . import solver
from .residuals import KfState, PreintEdge
from .solver import _take, inertial_blocks

CHI2_MONO = 5.991
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
    """Frame LM with per-round chi2 inlier re-classification: visual, plus
    the whitened inertial residual to `last_state` through `edge` (scaled
    by `edge_valid`) with `use_inertial`, plus the prior
    ((v, bg, ba) - prior_ref's) * prior_inv_sigma [9] with `use_prior`.

    Returns (state, inlier [N] bool)."""
    visual_only = not (use_inertial or use_prior)
    dev = pts.device
    # the damping factors, made on the device by a fill and selects (a
    # copy of host values would wait for the device's queue)
    k = torch.arange(len(LAMBDA_FACTORS), device=dev)
    lam_factors = torch.full((len(LAMBDA_FACTORS),), LAMBDA_FACTORS[-1],
                             dtype=torch.float32, device=dev)
    for j, f in enumerate(LAMBDA_FACTORS[:-1]):
        lam_factors = torch.where(k == j, f, lam_factors)
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
        lam = torch.full((), 1e-3, dtype=torch.float32, device=dev)
        for _ in range(lm_steps):
            r, Jc, w, cost = vis_linearize_b(cands, w_vis)
            if not visual_only:
                r_t, J_t = _tail_linearize(cands, edge, last_state, edge_valid, prior_ref,
                                           prior_inv_sigma, use_inertial, use_prior)
                cost = cost + torch.sum(r_t * r_t, dim=-1)
            i = torch.argmin(cost)  # incumbent is candidate 0: monotone
            s = cands.map(lambda a: _take(a, i))
            JcW = Jc * w[:, :, None, None]
            H = _take(torch.einsum("cnik,cnil->ckl", JcW, Jc), i)  # [6, 6]
            g = _take(torch.einsum("cnik,cni->ck", JcW, r), i)
            if not visual_only:
                Jt_i, rt_i = _take(J_t, i), _take(r_t, i)
                H = torch.nn.functional.pad(H, (0, 9, 0, 9)) + Jt_i.T @ Jt_i
                g = torch.nn.functional.pad(g, (0, 9)) + Jt_i.T @ rt_i
            lam = torch.where(
                i == 0, torch.clamp(lam * 100.0, max=1e5),
                torch.clamp(lam * _take(lam_factors, torch.clamp(i - 1, min=0)) * 0.5,
                            1e-7, 1e5))
            D = torch.diag(torch.clamp(torch.diagonal(H), min=1e-8))
            lams = lam * lam_factors
            Hs = H[None] + lams[:, None, None] * D[None]
            # closed-form nested-Schur SPD solve on the Jacobi-scaled system
            if visual_only:
                d6 = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(Hs, dim1=-2, dim2=-1)),
                                            min=1e-12))
                Hn = Hs / (d6[..., :, None] * d6[..., None, :])
                steps = -(solver.inv_spd6(Hn) @ (g / d6)[..., None]).squeeze(-1) / d6
                steps15 = torch.nn.functional.pad(steps, (0, 9))
            else:
                steps15 = -solver.solve_spd15_jacobi(Hs, g.expand(lams.shape[0], 15))
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


def _tail_linearize(s: KfState, edge: PreintEdge, last_state: KfState, edge_valid,
                    prior_ref: KfState, prior_inv_sigma, use_inertial: bool,
                    use_prior: bool):
    """The frame LM's inertial-to-last-KF and prior residuals [C, R] and
    their Jacobians [C, R, 15] with respect to a fresh tangent at each of
    the C states `s` (R <= 18). The JAX package takes the Jacobian with
    jacfwd; here it is the closed form: the inertial edge's J2 block
    (`solver.inertial_blocks` with s1 = last_state) and
    diag(prior_inv_sigma) on dims 6:15."""
    n = s.R_wb.shape[0]
    rs, Js = [], []
    if use_inertial:
        s1 = last_state.map(lambda a: a[None].expand(n, *a.shape))
        e = PreintEdge(*(a[None].expand(n, *a.shape) for a in edge))
        r, J = inertial_blocks(s1, s, e, with_J1=False)
        rs.append(r * edge_valid)
        Js.append(J * edge_valid)
    if use_prior:
        x = torch.cat([s.v, s.bg, s.ba], dim=-1)
        x0 = torch.cat([prior_ref.v, prior_ref.bg, prior_ref.ba])
        rs.append((x - x0) * prior_inv_sigma)
        Js.append(torch.nn.functional.pad(torch.diag(prior_inv_sigma), (6, 0))
                  .expand(n, 9, 15))
    return torch.cat(rs, dim=-1), torch.cat(Js, dim=-2)


