"""Distributed Schur-complement bundle adjustment over a device mesh
(counterpart of `monoorbslam3_tpu/parallel/sharded_ba.py`).

Layout (one mesh axis, "dp"):
- landmarks and their observations are split by point between the ranks
  (`shard_problem_by_point` groups each point's observations into its
  rank's block, on the host);
- each rank linearizes its observations and eliminates its landmarks: the
  Hessian blocks Hll, their inverses and the pose-landmark coupling W are
  local;
- the reduced camera system S = Hcc - sum_p Y_p W_p^T, its right-hand side
  b and the linearization cost are summed over the ranks by one
  `all_reduce` an iteration (the JAX package's three `psum`s,
  `sharded_ba.py:86-88`; here packed into one buffer);
- the small dense solve (D = 15 K) runs on every rank, Jacobi-scaled
  through `ops/chol_pallas.chol_solve` (K4 on a CUDA tensor), as the
  port's `solver.schur_ba` solves it; the landmark back-substitution is
  local again.

The LM is the deferred single-damping loop of `solver.schur_ba`
(`deferred=True`): the next iteration's all-reduced linearization cost
accepts or rejects a step, so an iteration makes one collective. After the
loop one more `all_reduce` prices the last step, and one gathers the
points.

**Process model.** A JAX mesh is driven by one controller that holds the
whole problem. A torch mesh has one process per rank: every rank calls
`sharded_schur_ba` with the whole (sharded) problem, takes its own point
block and rebases its observations' point indices, and every rank returns
the same states and the same points. A `System(mesh=)` in a group of
several ranks therefore runs the tracker on every rank, replicated, and
splits only the window BA's landmark work. Nothing in the solve reads a
value back to the host.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..backend import residuals as res
from ..backend.solver import (CHI2_MONO, BAProblem, _gather_kf, _inertial_linearize, _one_hot,
                              _prior_linearize, _scatter_edge_blocks, _select, _vis_linearize,
                              _vis_residuals, _walk_linearize, inv3x3)
from ..ops.chol_pallas import chol_solve
from .multihost import mesh_axis

_OBS_FIELDS = ("obs_kf", "obs_pt", "obs_uv", "obs_inv_sigma2", "obs_valid")


def shard_order(obs_pt: np.ndarray, obs_valid: np.ndarray, n_points: int, n_shards: int):
    """Host-side regrouping of the observations by point shard: (order [O'],
    keep [O']) with O' = n_shards blocks of equal capacity (the worst
    shard's count rounded up to 8, at least 8; no observation is dropped).
    Slot s * cap + i holds the i-th valid observation of shard s; empty
    slots point at observation 0 and are masked by `keep`."""
    if n_points % n_shards:
        raise ValueError(f"pad the point capacity {n_points} to a multiple of {n_shards}")
    per_pt = n_points // n_shards
    obs_pt = np.asarray(obs_pt)
    obs_valid = np.asarray(obs_valid, bool)
    shard_of_pt = obs_pt // per_pt
    counts = np.bincount(shard_of_pt[obs_valid], minlength=n_shards)
    per_obs = max(8, int(-(-counts.max() // 8) * 8))
    order = np.zeros(per_obs * n_shards, np.int64)
    keep = np.zeros(per_obs * n_shards, bool)
    fill = [0] * n_shards
    for o in np.nonzero(obs_valid)[0]:
        s = int(shard_of_pt[o])
        slot = s * per_obs + fill[s]
        order[slot] = o
        keep[slot] = True
        fill[s] += 1
    return order, keep


def apply_order(problem: BAProblem, order, keep) -> BAProblem:
    """The problem with its observations taken in `order` and masked by
    `keep` (numpy arrays for a host problem, tensors on its device for a
    device problem; host arrays are uploaded for a device problem)."""
    if isinstance(problem.obs_valid, torch.Tensor):
        dev = problem.obs_valid.device
        order, keep = torch.as_tensor(order, device=dev), torch.as_tensor(keep, device=dev)
    obs = {f: getattr(problem, f)[order] for f in _OBS_FIELDS}
    obs["obs_valid"] = obs["obs_valid"] & keep
    return problem._replace(**obs)


def shard_problem_by_point(problem: BAProblem, n_shards: int):
    """Regroups a problem's observations so that each point's land in its
    shard's block (`shard_order`, on the host: a device problem's indices
    are read back once). Returns (problem, 0): the
    count of dropped observations, 0 by construction, as the JAX package
    returns it."""
    host = lambda x: x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    order, keep = shard_order(host(problem.obs_pt), host(problem.obs_valid),
                              problem.points.shape[0], n_shards)
    return apply_order(problem, order, keep), 0


def sharded_schur_ba(problem: BAProblem, camera, R_cb, t_cb, mesh, n_iters: int = 8,
                     huber_delta2: float = CHI2_MONO, lambda0: float = 1e-4):
    """Distributed LM bundle adjustment over the mesh's "dp" axis. Every
    rank passes the same `problem`, grouped by `shard_problem_by_point` and
    on its device. Returns (kf, points, info) as `solver.schur_ba` does
    (info: cost0, cost, cost_hist), the same on every rank."""
    group, shard, n_shards = mesh_axis(mesh, "dp")
    K = problem.kf_dof.shape[0]
    P_total = problem.points.shape[0]
    O_total = problem.obs_kf.shape[0]
    per_pt, per_obs = P_total // n_shards, O_total // n_shards
    dev = problem.points.device
    f32 = dict(dtype=torch.float32, device=dev)
    on0 = 1.0 if shard == 0 else 0.0  # camera-only terms counted once
    pts_sl = slice(shard * per_pt, (shard + 1) * per_pt)
    obs_sl = slice(shard * per_obs, (shard + 1) * per_obs)
    local = {f: getattr(problem, f)[obs_sl] for f in _OBS_FIELDS}
    # an empty slot of the block points at observation 0 (masked by
    # obs_valid), whose point may lie in another shard: clamped into this
    # shard, as the JAX package's gathers clamp an index out of range
    local["obs_pt"] = torch.clamp(local["obs_pt"] - shard * per_pt, 0, per_pt - 1)
    pb0 = problem._replace(points=problem.points[pts_sl], pt_active=problem.pt_active[pts_sl],
                           **local)
    Pl = per_pt
    dof = pb0.kf_dof.reshape(-1)
    eye3 = torch.eye(3, **f32)
    ar = torch.arange(K, device=dev)
    Ek = _one_hot(pb0.obs_kf, K)
    EkpT = torch.cat([Ek, _one_hot(pb0.obs_pt, Pl)], 1).T.contiguous()  # [K+Pl, Ol]

    def camera_costs(pb):
        """The inertial, walk and prior costs (camera-only terms)."""
        s1 = _gather_kf(pb.kf, pb.ie_i)
        s2 = _gather_kf(pb.kf, pb.ie_j)
        r_e = res.inertial_residual(s1, s2, pb.ie_edge)
        c_ie = torch.sum(pb.ie_valid.to(torch.float32) * torch.sum(r_e * r_e, -1))
        r_w = res.bias_walk_residual(s1, s2, pb.walk_inv_sigma)
        c_walk = torch.sum(pb.walk_valid.to(torch.float32) * torch.sum(r_w * r_w, -1))
        return c_ie + c_walk + _prior_linearize(pb)[2]

    def linearize_assemble(kf, pts):
        pb = pb0._replace(kf=kf, points=pts)
        r_v, Jc, Jl, w_v, _, c_vis = _vis_linearize(pb, camera, R_cb, t_cb, huber_delta2)
        Ol = r_v.shape[0]
        # one augmented product (mirrors solver.schur_ba's flat layout)
        Ja = torch.cat([Jc, Jl, -r_v[:, :, None]], -1)  # [Ol, 2, 10]
        B = torch.einsum("oik,oil->okl", Ja * w_v[:, None, None], Ja)
        W_o = B[:, :6, 6:9]
        cols = torch.cat([
            B[:, :6, :6].reshape(Ol, 36),
            B[:, :6, 9:10].reshape(Ol, 6),
            B[:, 6:9, 6:9].reshape(Ol, 9),
            B[:, 6:9, 9:10].reshape(Ol, 3),
            (Ek[:, :, None] * W_o.reshape(Ol, 1, 18)).reshape(Ol, K * 18),
        ], -1)
        SUM = EkpT @ cols
        camk = SUM[:K, :42]
        Hll = SUM[K:, 42:51].reshape(Pl, 3, 3)
        b_l = SUM[K:, 51:54]
        W_p = SUM[K:, 54:].reshape(Pl, K * 6, 3)
        Hcc = torch.zeros((K, K, 15, 15), **f32)
        Hcc[ar, ar, :6, :6] = camk[:, :36].reshape(K, 6, 6)
        b_c = torch.zeros((K, 15), **f32)
        b_c[:, :6] = camk[:, 36:]

        # the inertial, walk and prior blocks touch only cameras: weighted
        # by on0 so that the sum over the ranks counts them once
        r_e, J1, J2, w_e, c_ie = _inertial_linearize(pb)
        r_w, Jw1, Jw2, w_w, c_walk = _walk_linearize(pb)
        r_p, pr_inv_sigma, c_prior = _prior_linearize(pb)
        Hcc, b_c = _scatter_edge_blocks(Hcc, b_c, pb.ie_i, pb.ie_j,
                                        ((r_e, J1, J2, w_e * on0), (r_w, Jw1, Jw2, w_w * on0)))
        pr_full = torch.zeros((K, 15), **f32)
        pr_full[:, 6:15] = pr_inv_sigma * pr_inv_sigma * on0
        Hcc[ar, ar] = Hcc[ar, ar] + torch.diag_embed(pr_full)
        b_c[:, 6:15] = b_c[:, 6:15] - pr_inv_sigma * r_p * on0

        # local landmark elimination (lambda-independent damping)
        Hll_d = (Hll + 1e-6 * eye3[None]
                 + 1e-3 * torch.diag_embed(torch.clamp(torch.diagonal(Hll, dim1=-2, dim2=-1),
                                                       min=1e-8)))
        Hll_inv = inv3x3(Hll_d)
        Y_p = torch.einsum("pkv,pvw->pkw", W_p, Hll_inv)
        Y2 = Y_p.transpose(0, 1).reshape(K * 6, Pl * 3)
        W2 = W_p.transpose(0, 1).reshape(K * 6, Pl * 3)
        S6 = Y2 @ W2.T
        b6 = Y2 @ b_l.reshape(Pl * 3)
        S_local = Hcc.clone()
        S_local[:, :, :6, :6] = S_local[:, :, :6, :6] - S6.reshape(K, 6, K, 6).permute(0, 2, 1, 3)
        b_local = b_c.clone()
        b_local[:, :6] = b_local[:, :6] - b6.reshape(K, 6)
        c_local = c_vis + (c_ie + c_walk + c_prior) * on0

        # the distributed reduction: S, b and the cost in one all_reduce
        packed = torch.cat([S_local.reshape(-1), b_local.reshape(-1), c_local.reshape(1)])
        dist.all_reduce(packed, group=group)
        S = packed[:K * K * 225].reshape(K, K, 15, 15)
        b = packed[K * K * 225:-1].reshape(K, 15)
        Sm = S.permute(0, 2, 1, 3).reshape(K * 15, K * 15)
        Sm = Sm * dof[:, None] * dof[None, :] + torch.diag(1.0 - dof)
        bm = b.reshape(-1) * dof
        return Sm, bm, W_p, Hll_inv, b_l, packed[-1]

    def solve_reduced(Sm, bm, lam):
        """The damped, Jacobi-scaled reduced solve (K4 on the card)."""
        diag = torch.clamp(torch.diagonal(Sm), min=1e-8)
        Sd = Sm + torch.diag(lam * diag)
        d = torch.sqrt(torch.clamp(torch.diagonal(Sd), min=1e-12))
        Sd_n = Sd / d[:, None] / d[None, :]
        return (chol_solve(Sd_n[None], (bm / d)[None])[0] / d).reshape(K, 15)

    kf, pts = pb0.kf, pb0.points
    kf_b, pts_b = kf, pts
    # no standalone initial cost: iteration 1's linearization prices the
    # start (the accept test compares costs of one code path; see the JAX
    # module)
    cost_b = torch.full((), float("inf"), **f32)
    lam = torch.full((), lambda0, **f32)
    hist, hist_lin = [], []
    for _ in range(n_iters):
        Sm, bm, W_p, Hll_inv, b_l, cost_lin = linearize_assemble(kf, pts)
        worse = torch.logical_not(cost_lin <= cost_b)  # NaN-robust
        lam = torch.where(worse, torch.clamp(lam * 16.0, max=1e6),
                          torch.clamp(lam * 0.33, min=1e-9))
        kf_keep = _select(worse, kf_b, kf)
        pts_keep = torch.where(worse, pts_b, pts)
        cost_keep = torch.where(worse, cost_b, cost_lin)
        dxc = solve_reduced(Sm, bm, lam)
        acc = torch.einsum("pkv,k->pv", W_p, dxc[:, :6].reshape(K * 6))
        dxl = torch.einsum("pvw,pw->pv", Hll_inv, b_l - acc)
        kf_new = res.retract_kf(kf, dxc * pb0.kf_dof)
        pts_new = pts + dxl * pb0.pt_active[:, None]
        kf = _select(worse, kf_b, kf_new)
        pts = torch.where(worse, pts_b, pts_new)
        kf_b, pts_b, cost_b = kf_keep, pts_keep, cost_keep
        hist.append(cost_keep)
        hist_lin.append(cost_lin)
    # the last tentative step was never priced: cost it once, keep the better
    pb = pb0._replace(kf=kf, points=pts)
    cost_t = _vis_residuals(pb, camera, R_cb, t_cb, huber_delta2)[1] + camera_costs(pb) * on0
    dist.all_reduce(cost_t, group=group)
    worse = torch.logical_not(cost_t <= cost_b)
    kf = _select(worse, kf_b, kf)
    pts = torch.where(worse, pts_b, pts)
    cost = torch.minimum(cost_t, cost_b)
    # every rank gets every point block (zeros elsewhere add exactly)
    pts_all = torch.zeros((P_total, 3), **f32)
    pts_all[pts_sl] = pts
    dist.all_reduce(pts_all, group=group)
    return kf, pts_all, {"cost0": hist_lin[0], "cost": cost, "cost_hist": torch.stack(hist)}
