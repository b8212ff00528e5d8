# A frozen copy of `backend/solver.py` as the port had it when the benchmark
# was written: the plain version the benchmark holds the timed path to.
# It imports nothing of the port; edit it only to follow a change of the
# semantics the configuration states.
"""Levenberg-Marquardt Schur-complement bundle adjustment and the closed-form
small SPD inverses (counterpart of `monoorbslam3_tpu/backend/solver.py`).

`schur_ba` is the structured visual-inertial BA of the mapper: landmarks
are eliminated with batched 3x3 blocks, the reduced camera system (K*15
dims) is Jacobi-scaled and solved densely by `ops/chol_pallas.chol_solve`
(the hand Cholesky kernel K4 on a CUDA tensor). Shapes are fixed and
validity rides in masks, as in the JAX package.

The LM loop is a Python loop over `n_iters` whose accept/reject decisions
are `torch.where` selects on device tensors: nothing inside `schur_ba`
reads a value back to the host or copies one from it (constants are made
on the device by fills). The caller brings the result home with one
`utils/fetch.fetch`.

Scatter-adds with repeated indices (the inertial and walk blocks of
consecutive keyframes) are one-hot matmuls here, as the JAX package writes
its observation sums: a matmul has a fixed summation order on every
device, where `index_put_(accumulate=True)` on a CUDA tensor may use float
atomics whose order changes from run to run.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .match import chol_solve_plain as chol_solve
from . import lie
from . import residuals as res
from .residuals import KfState, PreintEdge

CHI2_MONO = 5.991  # 2-DoF 95% gate (Optimize.cpp poseOptimize chi2)

# damping candidates of the parallel-lambda LM, relative to the carried
# lambda (solver.py:41 of the JAX package)
LAM_GRID = (0.3, 3.0)


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. K keyframes, P points, O observations,
    E inertial edges."""

    kf: KfState  # [K]
    kf_dof: torch.Tensor  # [K, 15] float 0/1 per-dim free mask
    points: torch.Tensor  # [P, 3]
    pt_active: torch.Tensor  # [P] bool (False = fixed or padding)
    obs_kf: torch.Tensor  # [O] int64
    obs_pt: torch.Tensor  # [O] int64
    obs_uv: torch.Tensor  # [O, 2]
    obs_inv_sigma2: torch.Tensor  # [O]
    obs_valid: torch.Tensor  # [O] bool
    ie_i: torch.Tensor  # [E] int64
    ie_j: torch.Tensor  # [E] int64
    ie_edge: PreintEdge  # [E]
    ie_valid: torch.Tensor  # [E] bool
    walk_inv_sigma: torch.Tensor  # [E, 6]
    walk_valid: torch.Tensor  # [E] bool
    prior_inv_sigma: torch.Tensor  # [K, 15] diag prior weights (0 = no prior)
    prior_ref: KfState  # [K] prior center


def _gather_kf(kf: KfState, idx) -> KfState:
    return kf.map(lambda a: a[idx])


# ---------------------------------------------------------------------------
# closed-form small SPD inverses
# ---------------------------------------------------------------------------


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


def inv_spd9(M: torch.Tensor) -> torch.Tensor:
    return _inv_spd_block(M, 3, inv3x3, inv_spd6)


def inv_spd15(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 15x15 SPD inverse (nested 3x3 Schur blocks);
    callers Jacobi-normalize first for f32 conditioning."""
    return _inv_spd_block(M, 6, inv_spd6, inv_spd9)


def inv_spd_blocks15(M: torch.Tensor, kb: int) -> torch.Tensor:
    """SPD inverse of a [..., 15*kb, 15*kb] matrix by recursing the
    blockwise Schur identity down to closed-form 15-dim blocks. On no live
    path: on visual-inertial reduced camera systems f32 conditioning
    defeats it (velocity errors 3x the Cholesky path's), which is why
    schur_ba solves through K4. Callers Jacobi-normalize and damp first."""
    if kb == 1:
        return inv_spd15(M)
    k1 = (kb + 1) // 2
    return _inv_spd_block(M, 15 * k1, lambda A: inv_spd_blocks15(A, k1),
                          lambda S: inv_spd_blocks15(S, kb - k1))


def solve_spd15_jacobi(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """x = H^-1 g for batched damped-SPD 15x15 systems, with Jacobi
    pre/post-scaling for f32 robustness."""
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(H, dim1=-2, dim2=-1)), min=1e-12))
    Hn = H / (d[..., :, None] * d[..., None, :])
    return (inv_spd15(Hn) @ (g / d)[..., None]).squeeze(-1) / d


# ---------------------------------------------------------------------------
# residuals and linearizations
# ---------------------------------------------------------------------------


def _vis_residuals(problem: BAProblem, camera, R_cb, t_cb, huber_delta2,
                   valid_override=None):
    """Residual-only evaluation for the LM cost checks. `valid_override`
    costs THIS observation set instead of the state-dependent depth gate
    (see the JAX docstring: a step that flings points behind the cameras
    must not drop their observations from the cost)."""
    s_o = _gather_kf(problem.kf, problem.obs_kf)
    p_o = problem.points[problem.obs_pt]
    r0 = res.reprojection_residual(s_o, p_o, problem.obs_uv, camera, R_cb, t_cb)
    depth = res.point_depth(s_o, p_o, R_cb, t_cb)
    if valid_override is None:
        valid = problem.obs_valid & (depth > 0.05)
    else:
        valid = valid_override
    chi2 = torch.sum(r0 * r0, dim=-1) * problem.obs_inv_sigma2
    chi2 = torch.where(torch.isfinite(chi2) & (depth > 1e-4), chi2,
                       torch.full_like(chi2, 1e12))
    cost = torch.sum(torch.where(valid, res.huber_cost(chi2, huber_delta2),
                                 torch.zeros_like(chi2)))
    return chi2, cost


def _vis_linearize(problem: BAProblem, camera, R_cb, t_cb, huber_delta2):
    """Per-observation residual + analytic Jacobians at the current state:
    r0 [O, 2], compact pose Jacobian Jc [O, 2, 6] (dphi, dt), landmark
    Jacobian Jl [O, 2, 3], IRLS weight w [O], chi2 [O], robust cost."""
    s_o = _gather_kf(problem.kf, problem.obs_kf)
    p_o = problem.points[problem.obs_pt]

    p_b = torch.einsum("oji,oj->oi", s_o.R_wb, p_o - s_o.t_wb)  # R_wb^T (p - t)
    p_c = p_b @ R_cb.T + t_cb
    r0 = camera.project(p_c) - problem.obs_uv

    Jproj = camera.proj_jacobian(p_c)  # [O, 2, 3]
    Jproj_Rcb = torch.einsum("oij,jk->oik", Jproj, R_cb)
    Jc = torch.cat([
        torch.einsum("oij,ojk->oik", Jproj_Rcb, lie.hat(p_b)),
        -Jproj_Rcb,
    ], dim=-1)
    R_cw = torch.einsum("ij,okj->oik", R_cb, s_o.R_wb)
    Jl = torch.einsum("oij,ojk->oik", Jproj, R_cw)

    depth = res.point_depth(s_o, p_o, R_cb, t_cb)
    base_valid = problem.obs_valid & (depth > 0.05)
    chi2 = torch.sum(r0 * r0, dim=-1) * problem.obs_inv_sigma2
    w = (base_valid.to(torch.float32) * problem.obs_inv_sigma2
         * res.huber_weight(chi2, huber_delta2))
    cost = torch.sum(torch.where(base_valid, res.huber_cost(chi2, huber_delta2),
                                 torch.zeros_like(chi2)))
    return r0, Jc, Jl, w, chi2, cost


def _inertial_linearize(problem: BAProblem):
    """Analytic Jacobians of the whitened 9-D preintegration residual with
    respect to the 15-dim tangent of each endpoint (EdgeInertial::
    linearizeOplus, G2oTypes.cpp:358-445), batched over edges. Returns
    (r [E, 9], J1 [E, 9, 15], J2 [E, 9, 15], w [E], cost)."""
    s1 = _gather_kf(problem.kf, problem.ie_i)
    s2 = _gather_kf(problem.kf, problem.ie_j)
    r0, J1, J2 = inertial_blocks(s1, s2, problem.ie_edge)
    w = problem.ie_valid.to(torch.float32)
    cost = torch.sum(w * torch.sum(r0 * r0, dim=-1))
    return r0, J1, J2, w, cost


def inertial_blocks(s1: KfState, s2: KfState, e: PreintEdge, with_J1: bool = True):
    """The whitened residual r [E, 9] and its Jacobians J1, J2 [E, 9, 15]
    with respect to s1's and s2's tangents, for states and edges batched
    over one leading axis E. Without `with_J1` only (r, J2) come back: the
    frame LM's inertial tail, whose s1 (the last keyframe) is fixed."""
    E = s1.R_wb.shape[0]
    dev = s1.v.device
    g = res.gravity(dev)
    mv = lambda M, x: torch.einsum("...ij,...j->...i", M, x)

    dbg = s1.bg - e.bg0
    dba = s1.ba - e.ba0
    Rb1w = s1.R_wb.transpose(-1, -2)
    dt = e.dt[..., None]

    jrg_dbg = mv(e.JRg, dbg)
    dV = e.dV + mv(e.JVg, dbg) + mv(e.JVa, dba)
    dP = e.dP + mv(e.JPg, dbg) + mv(e.JPa, dba)
    ev_arg = mv(Rb1w, s2.v - s1.v - g * dt)
    ep_arg = mv(Rb1w, s2.t_wb - s1.t_wb - s1.v * dt - 0.5 * g * dt * dt)

    R2 = s2.R_wb
    M = Rb1w @ R2  # R1^T R2
    dRtM = (e.dR.transpose(-1, -2) @ Rb1w) @ R2  # dR^T R1^T R2
    Wg = lie.hat(jrg_dbg)
    W2g = Wg @ Wg
    Ag, Bg, Cg = lie.exp_jr_coeffs(jrg_dbg)
    eye3 = torch.eye(3, dtype=torch.float32, device=dev).expand(E, 3, 3)
    expg = eye3 + Ag[..., None, None] * Wg + Bg[..., None, None] * W2g
    eR = expg.transpose(-1, -2) @ dRtM
    er = lie.log_so3(eR)
    ev = ev_arg - dV
    ep = ep_arg - dP
    We = lie.hat(er)
    De = lie.inv_jr_coeff(er)
    invJr = eye3 + 0.5 * We + De[..., None, None] * (We @ We)

    Z3 = torch.zeros((E, 3, 3), dtype=torch.float32, device=dev)
    J2 = torch.cat([
        torch.cat([invJr, Z3, Z3, Z3, Z3], -1),
        torch.cat([Z3, Z3, Rb1w, Z3, Z3], -1),
        torch.cat([Z3, M, Z3, Z3, Z3], -1),
    ], -2)
    r9 = torch.cat([er, ev, ep], -1)
    if not with_J1:
        Wt = e.L_inv @ torch.cat([r9[..., None], J2], -1)
        return Wt[..., 0], Wt[..., 1:16]

    Jrg = eye3 - Bg[..., None, None] * Wg + Cg[..., None, None] * W2g
    P = Jrg @ e.JRg
    Q = eR.transpose(-1, -2) @ P
    der_dbg = -invJr @ Q
    mijR21 = -invJr @ M.transpose(-1, -2)
    J1 = torch.cat([
        torch.cat([mijR21, Z3, Z3, der_dbg, Z3], -1),
        torch.cat([lie.hat(ev_arg), Z3, -Rb1w, -e.JVg, -e.JVa], -1),
        torch.cat([lie.hat(ep_arg), -eye3, -Rb1w * dt[..., None], -e.JPg, -e.JPa], -1),
    ], -2)
    # whiten the residual and both Jacobians in one product: [E,9,9]@[E,9,31]
    Wt = e.L_inv @ torch.cat([r9[..., None], J1, J2], -1)
    return Wt[..., 0], Wt[..., 1:16], Wt[..., 16:31]


def _walk_linearize(problem: BAProblem):
    s1 = _gather_kf(problem.kf, problem.ie_i)
    s2 = _gather_kf(problem.kf, problem.ie_j)
    r0 = res.bias_walk_residual(s1, s2, problem.walk_inv_sigma)  # [E, 6]
    E = r0.shape[0]
    dev = r0.device
    blk = problem.walk_inv_sigma[:, :, None] * torch.eye(6, dtype=torch.float32, device=dev)
    J1 = torch.zeros((E, 6, 15), dtype=torch.float32, device=dev)
    J2 = torch.zeros((E, 6, 15), dtype=torch.float32, device=dev)
    J1[:, :, 9:15] = -blk
    J2[:, :, 9:15] = blk
    w = problem.walk_valid.to(torch.float32)
    cost = torch.sum(w * torch.sum(r0 * r0, dim=-1))
    return r0, J1, J2, w, cost


def _prior_linearize(problem: BAProblem):
    """Diagonal priors on the euclidean dims (v, bg, ba) of each KF."""
    x = torch.cat([problem.kf.v, problem.kf.bg, problem.kf.ba], dim=-1)  # [K, 9]
    x0 = torch.cat([problem.prior_ref.v, problem.prior_ref.bg, problem.prior_ref.ba], dim=-1)
    inv_sigma = problem.prior_inv_sigma[:, 6:15]
    r = res.prior_residual(x, x0, inv_sigma)
    return r, inv_sigma, torch.sum(r * r)


def _total_cost(problem: BAProblem, camera, R_cb, t_cb, huber_delta2,
                valid_override=None):
    _, c_vis = _vis_residuals(problem, camera, R_cb, t_cb, huber_delta2, valid_override)
    s1 = _gather_kf(problem.kf, problem.ie_i)
    s2 = _gather_kf(problem.kf, problem.ie_j)
    r_e = res.inertial_residual(s1, s2, problem.ie_edge)
    c_ie = torch.sum(problem.ie_valid.to(torch.float32) * torch.sum(r_e * r_e, -1))
    r_w = res.bias_walk_residual(s1, s2, problem.walk_inv_sigma)
    c_walk = torch.sum(problem.walk_valid.to(torch.float32) * torch.sum(r_w * r_w, -1))
    _, _, c_prior = _prior_linearize(problem)
    return c_vis + c_ie + c_walk + c_prior


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """[R] indices -> [R, n] float32 one-hot rows."""
    return (idx[:, None] == torch.arange(n, device=idx.device)[None, :]).to(torch.float32)


def _scatter_edge_blocks(Hcc, b_c, ie_i, ie_j, families):
    """Accumulate binary-edge Gauss-Newton blocks into the dense camera
    Hessian Hcc [K, K, 15, 15] and gradient b_c [K, 15].

    families: iterable of (r [E,R], Ja [E,R,15], Jb [E,R,15], w [E]). The
    sums over repeated (i, j) pairs are one-hot matmuls (fixed order, see
    the module docstring)."""
    K = Hcc.shape[0]
    rows_a, rows_b, Hv, bv = [], [], [], []
    for (rr, Ja, Jb, ww) in families:
        JaW = Ja * ww[:, None, None]
        JbW = Jb * ww[:, None, None]
        L = torch.stack([JaW, JaW, JbW, JbW])  # [4, E, R, 15]
        Rj = torch.stack([Ja, Jb, Ja, Jb])
        Hv.append(torch.einsum("feik,feil->fekl", L, Rj).reshape(-1, 15, 15))
        bv.append(-torch.einsum("feik,ei->fek", torch.stack([JaW, JbW]), rr).reshape(-1, 15))
        rows_a.extend([ie_i, ie_i, ie_j, ie_j])
        rows_b.extend([ie_i, ie_j, ie_i, ie_j])
    slot = torch.cat(rows_a) * K + torch.cat(rows_b)
    Hadd = _one_hot(slot, K * K).T @ torch.cat(Hv).reshape(-1, 225)
    idx_g = torch.cat([ie_i, ie_j] * len(families))
    badd = _one_hot(idx_g, K).T @ torch.cat(bv)
    return Hcc + Hadd.reshape(K, K, 15, 15), b_c + badd


def _retract_problem(problem: BAProblem, dx_c, dx_l) -> BAProblem:
    kf = res.retract_kf(problem.kf, dx_c * problem.kf_dof)
    pts = problem.points + dx_l * problem.pt_active[:, None]
    return problem._replace(kf=kf, points=pts)


def _select(cond: torch.Tensor, a, b):
    """torch.where over a KfState or a tensor, with a 0-d condition."""
    if isinstance(a, KfState):
        return KfState(*(torch.where(cond, x, y) for x, y in zip(a, b)))
    return torch.where(cond, a, b)


def _take(a: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """a[i] for a 0-d index tensor, without a host read of i."""
    return a.index_select(0, i.reshape(1)).squeeze(0)


# ---------------------------------------------------------------------------
# Schur-complement bundle adjustment
# ---------------------------------------------------------------------------


def schur_ba(problem: BAProblem, camera, R_cb, t_cb,
             n_iters: int = 10, huber_delta2: float = CHI2_MONO,
             lambda0: float = 1e-4, deferred: bool = True,
             grouped_obs: int = 0):
    """Visual-inertial BA with landmark Schur elimination.

    Returns (kf [K] KfState, points [P, 3], info dict of device tensors:
    cost0, cost, cost_hist [n_iters], obs_chi2 [O]).

    `deferred=True` is the zero-cost-pass LM: one damping per iteration,
    accepted or rejected by the NEXT iteration's linearization cost.
    `deferred=False` solves the reduced system at the G = len(LAM_GRID)
    dampings in one batched solve, costs each candidate and keeps the best.

    `grouped_obs=opk` declares that the observation axis is K contiguous
    per-keyframe blocks of `opk` rows (obs_kf[o] == o // opk); the
    assembly then forms the pose-landmark coupling with a K-batched
    [opk, P] x [opk, 18] product instead of the [O, K*18] one-hot expansion."""
    K = problem.kf_dof.shape[0]
    P = problem.points.shape[0]
    dev = problem.points.device
    f32 = dict(dtype=torch.float32, device=dev)
    dof = problem.kf_dof.reshape(-1)
    eye3 = torch.eye(3, **f32)
    lam_grid = torch.stack([torch.full((), g, **f32) for g in LAM_GRID])
    G = lam_grid.shape[0]

    # one-hot observation incidences, hoisted out of the LM loop (the
    # index sets are constant across iterations)
    Ep = _one_hot(problem.obs_pt, P)  # [O, P]
    if not grouped_obs:
        Ek = _one_hot(problem.obs_kf, K)  # [O, K]
        EkpT = torch.cat([Ek, Ep], 1).T.contiguous()  # [K+P, O]
    else:
        Ep_k = Ep.reshape(K, grouped_obs, P).transpose(1, 2).contiguous()  # [K, P, opk]

    def linearize_assemble(pb: BAProblem):
        r_v, Jc, Jl, w_v, _, c_vis = _vis_linearize(pb, camera, R_cb, t_cb, huber_delta2)
        r_e, J1, J2, w_e, c_ie = _inertial_linearize(pb)
        r_w, Jw1, Jw2, w_w, c_walk = _walk_linearize(pb)
        r_p, pr_inv_sigma, c_prior = _prior_linearize(pb)
        cost_here = c_vis + c_ie + c_walk + c_prior
        O = r_v.shape[0]

        # one augmented product B = (w Ja)^T Ja with Ja = [Jc | Jl | -r]: its
        # sub-blocks are Hc, Hll, W, bc and bl at once
        Ja = torch.cat([Jc, Jl, -r_v[:, :, None]], -1)  # [O, 2, 10]
        B = torch.einsum("oik,oil->okl", Ja * w_v[:, None, None], Ja)
        W_o = B[:, :6, 6:9]  # [O, 6, 3]
        if grouped_obs:
            camk = torch.cat([
                B[:, :6, :6].reshape(O, 36),
                B[:, :6, 9:10].reshape(O, 6),
            ], -1).reshape(K, grouped_obs, 42).sum(1)
            SUMP = Ep.T @ torch.cat([B[:, 6:9, 6:9].reshape(O, 9),
                                     B[:, 6:9, 9:10].reshape(O, 3)], -1)  # [P, 12]
            Hll = SUMP[:, :9].reshape(P, 3, 3)
            b_l = SUMP[:, 9:12]
            W_kp = torch.bmm(Ep_k, W_o.reshape(K, grouped_obs, 18))  # [K, P, 18]
            W_p = W_kp.transpose(0, 1).reshape(P, K * 6, 3)
        else:
            cols = torch.cat([
                B[:, :6, :6].reshape(O, 36),  # Hc
                B[:, :6, 9:10].reshape(O, 6),  # bc = -(w Jc)^T r
                B[:, 6:9, 6:9].reshape(O, 9),  # Hll
                B[:, 6:9, 9:10].reshape(O, 3),  # bl
                (Ek[:, :, None] * W_o.reshape(O, 1, 18)).reshape(O, K * 18),
            ], -1)  # [O, 54 + K*18]
            SUM = EkpT @ cols  # [K+P, 54+K*18]
            camk = SUM[:K, :42]
            Hll = SUM[K:, 42:51].reshape(P, 3, 3)
            b_l = SUM[K:, 51:54]
            W_p = SUM[K:, 54:].reshape(P, K * 6, 3)

        ar = torch.arange(K, device=dev)
        Hcc = torch.zeros((K, K, 15, 15), **f32)
        Hcc[ar, ar, :6, :6] = camk[:, :36].reshape(K, 6, 6)
        b_c = torch.zeros((K, 15), **f32)
        b_c[:, :6] = camk[:, 36:]

        Hcc, b_c = _scatter_edge_blocks(
            Hcc, b_c, pb.ie_i, pb.ie_j,
            ((r_e, J1, J2, w_e), (r_w, Jw1, Jw2, w_w)))

        # priors (euclidean dims 6:15)
        pr_full = torch.zeros((K, 15), **f32)
        pr_full[:, 6:15] = pr_inv_sigma * pr_inv_sigma
        Hcc[ar, ar] = Hcc[ar, ar] + torch.diag_embed(pr_full)
        b_c[:, 6:15] = b_c[:, 6:15] - pr_inv_sigma * r_p

        # Schur elimination of landmarks (6-dim pose blocks only), with a
        # lambda-independent landmark damping
        Hll_d = (Hll + 1e-6 * eye3[None]
                 + 1e-3 * torch.diag_embed(torch.clamp(
                     torch.diagonal(Hll, dim1=-2, dim2=-1), min=1e-8)))
        Hll_inv = inv3x3(Hll_d)

        Y_p = torch.einsum("pkv,pvw->pkw", W_p, Hll_inv)  # [P, K*6, 3]
        # S6 = sum over (p, v) of Y_p W_p^T: one [K*6, P*3] x [P*3, K*6] product
        Y2 = Y_p.transpose(0, 1).reshape(K * 6, P * 3)
        W2 = W_p.transpose(0, 1).reshape(K * 6, P * 3)
        S6 = Y2 @ W2.T
        b6 = Y2 @ b_l.reshape(P * 3)

        S = Hcc.clone()
        S[:, :, :6, :6] = S[:, :, :6, :6] - S6.reshape(K, 6, K, 6).permute(0, 2, 1, 3)
        b = b_c.clone()
        b[:, :6] = b[:, :6] - b6.reshape(K, 6)

        # DOF masking on the reduced system (fixed KFs get unit diagonal)
        Sm = S.permute(0, 2, 1, 3).reshape(K * 15, K * 15)
        Sm = Sm * dof[:, None] * dof[None, :] + torch.diag(1.0 - dof)
        bm = b.reshape(-1) * dof
        return Sm, bm, W_p, Hll_inv, b_l, cost_here, w_v > 0

    def solve_reduced(Sm, bm, lams):
        """Damped, Jacobi-scaled SPD solve at each damping of `lams` [G]:
        one batched `chol_solve` -> [G, K, 15]."""
        diag = torch.clamp(torch.diagonal(Sm), min=1e-8)
        Sd = Sm[None] + torch.diag_embed(lams[:, None] * diag[None])
        d = torch.sqrt(torch.clamp(torch.diagonal(Sd, dim1=-2, dim2=-1), min=1e-12))
        Sd_n = Sd / d[:, :, None] / d[:, None, :]
        return (chol_solve(Sd_n, bm[None] / d) / d).reshape(-1, K, 15)

    def landmark_step(W_p, Hll_inv, b_l, dxc):
        """Back-substituted landmark updates for camera steps dxc [G, K, 15]."""
        acc = torch.einsum("pkv,ck->cpv", W_p, dxc[:, :, :6].reshape(-1, K * 6))
        return torch.einsum("pvw,cpw->cpv", Hll_inv, b_l[None] - acc)

    kf, pts = problem.kf, problem.points
    cost_hist, cost_lin_hist = [], []
    if deferred:
        kf_b, pts_b = kf, pts
        cost_b = torch.full((), float("inf"), **f32)
        lam = torch.full((), lambda0, **f32)
        for _ in range(n_iters):
            Sm, bm, W_p, Hll_inv, b_l, cost_lin, _ = linearize_assemble(
                problem._replace(kf=kf, points=pts))
            # NaN-robust: a diverged step (cost_lin NaN) must reject
            worse = torch.logical_not(cost_lin <= cost_b)
            lam = torch.where(worse, torch.clamp(lam * 16.0, max=1e6),
                              torch.clamp(lam * 0.33, min=1e-9))
            kf_keep = _select(worse, kf_b, kf)
            pts_keep = torch.where(worse, pts_b, pts)
            cost_keep = torch.where(worse, cost_b, cost_lin)
            dxc = solve_reduced(Sm, bm, lam[None])
            dxl = landmark_step(W_p, Hll_inv, b_l, dxc)[0]
            kf_new = res.retract_kf(kf, dxc[0] * problem.kf_dof)
            pts_new = pts + dxl * problem.pt_active[:, None]
            kf = _select(worse, kf_b, kf_new)
            pts = torch.where(worse, pts_b, pts_new)
            kf_b, pts_b, cost_b = kf_keep, pts_keep, cost_keep
            cost_hist.append(cost_keep)
            cost_lin_hist.append(cost_lin)
        # the last tentative step was never costed: cost it once and keep
        # the better state
        cost_t = _total_cost(problem._replace(kf=kf, points=pts),
                             camera, R_cb, t_cb, huber_delta2)
        worse = torch.logical_not(cost_t <= cost_b)
        kf = _select(worse, kf_b, kf)
        pts = torch.where(worse, pts_b, pts)
        cost = torch.minimum(cost_t, cost_b)
    else:
        lam = torch.full((), lambda0, **f32)
        cost = torch.full((), float("inf"), **f32)
        for _ in range(n_iters):
            Sm, bm, W_p, Hll_inv, b_l, cost_lin, vmask = linearize_assemble(
                problem._replace(kf=kf, points=pts))
            lams = lam * lam_grid
            dxc = solve_reduced(Sm, bm, lams)  # [G, K, 15]
            dxl = landmark_step(W_p, Hll_inv, b_l, dxc)  # [G, P, 3]
            cands = [(res.retract_kf(kf, dxc[c] * problem.kf_dof),
                      pts + dxl[c] * problem.pt_active[:, None]) for c in range(G)]
            costs = torch.stack([
                _total_cost(problem._replace(kf=k_, points=p_), camera, R_cb, t_cb,
                            huber_delta2, valid_override=vmask)
                for k_, p_ in cands])
            i = torch.argmin(costs)
            best = _take(costs, i)
            improved = best < cost_lin
            kf_c = KfState(*(_take(torch.stack(xs), i)
                             for xs in zip(*(k_ for k_, _ in cands))))
            pts_c = _take(torch.stack([p_ for _, p_ in cands]), i)
            kf = _select(improved, kf_c, kf)
            pts = torch.where(improved, pts_c, pts)
            lam = torch.where(improved, torch.clamp(_take(lams, i), 1e-9, 1e4),
                              torch.clamp(lam * 25.0, max=1e8))
            cost = torch.where(improved, best, cost_lin)
            cost_hist.append(cost)
            cost_lin_hist.append(cost_lin)

    pb = problem._replace(kf=kf, points=pts)
    _, _, _, _, chi2, _ = _vis_linearize(pb, camera, R_cb, t_cb, huber_delta2)
    return pb.kf, pb.points, {
        "cost0": cost_lin_hist[0],
        "cost": cost,
        "cost_hist": torch.stack(cost_hist),
        "obs_chi2": chi2,
    }
