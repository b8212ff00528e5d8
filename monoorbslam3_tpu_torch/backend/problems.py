"""The solver entry points (counterpart of
`monoorbslam3_tpu/backend/problems.py`): the frame pose LM and the
`Problems` façade over the map store.

Mapping to the reference's problems (modules/Backend/Optimize.cpp):

- pose_optimize            <- Optimize::poseOptimize (:444-545)
- pose_full_optimize       <- poseFullOptimize (:610-764) / poseInertialOptimize
- initial_optimize         <- initialOptimize (:17-91)
- local_bundle_adjustment  <- localBundleAdjustment (:766-951)
- local_full_bundle_adjustment <- localFullBundleAdjustment (:1064-1310)
- local_inertial_bundle_adjustment <- localInertialBundleAdjustment (:953-1062)
- inertial_optimize        <- inertialOptimize (:93-205)
- gravity_optimize         <- gravityOptimize (:207-237)
- full_inertial_optimize   <- fullInertialOptimize (:239-442)

The frame LM (`_pose_optimize_impl`) is the reference's 4x10 loop as the
JAX package runs it: a deferred-accept, parallel-lambda LM whose carry
holds the incumbent plus the previous step's trial states at 4 dampings,
with per-round chi2 inlier re-classification; visual only (6 dims), or
with an inertial edge to the last keyframe and/or a prior on (v, bg, ba)
(15 dims). Every step stays on the device: the winner is picked by a
tensor index, the damping update is a `torch.where`, constants are made by
fills, and nothing is read back to the host.

A window BA is assembled from the MapStore on the host in numpy, with the
JAX package's rules and arithmetic (the host problem is the same bits),
uploaded once as three pinned buffers, solved by `solver.schur_ba` on the
device (K4 for the reduced system) and brought back with one fetch; an
inertial window preintegrates its edges on the device first, all windows
in one tree (`preintegrate_tree_batch`), and fetches them once, as the JAX
package does. The inertial initialization runs on the host in float64.
"""

from __future__ import annotations

import logging
from contextlib import nullcontext

import numpy as np
import torch

from ..models.imu import ImuBuffer, ImuCalib, preintegrate_tree_batch
from ..ops import cuda_lib
from ..ops.chol_pallas import chol_solve
from ..utils import lie
from ..utils.device import CARD, resolve
from ..utils.fetch import SyncCounter, fetch
from . import residuals as res
from . import solver
from .residuals import KfState, PreintEdge
from .solver import (BAProblem, _inertial_linearize, _take, _vis_residuals,
                     _walk_linearize, inertial_blocks, schur_ba)

log = logging.getLogger("monoorbslam3_tpu_torch.backend")

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


def _identity_edge(device) -> PreintEdge:
    f32 = dict(dtype=torch.float32, device=device)
    z3 = torch.zeros(3, **f32)
    z33 = torch.zeros((3, 3), **f32)
    return PreintEdge(
        dR=torch.eye(3, **f32), dV=z3, dP=z3.clone(),
        JRg=z33, JVg=z33.clone(), JVa=z33.clone(), JPg=z33.clone(), JPa=z33.clone(),
        bg0=z3.clone(), ba0=z3.clone(), dt=torch.ones((), **f32),
        L_inv=torch.eye(9, **f32),
    )


def whiten(pre) -> PreintEdge:
    """A preintegrated window -> its whitened inertial edge (the JAX
    package's `Problems._whiten_batch`, a jit of
    `PreintEdge.from_preintegrated`)."""
    return PreintEdge.from_preintegrated(pre)


# ---------------------------------------------------------------------------
# The Problems façade
# ---------------------------------------------------------------------------


class Problems:
    """Solver façade bound to a camera + IMU calibration on one device (the
    role of the reference's `Optimize` static class and its g2o setup).

    Capacities and their defaults are the JAX package's: the regular window
    BAs solve local_k keyframes, local_p points and local_o observations;
    the full polish's large grouped problem full_k, full_p and full_opk
    observation rows a keyframe; imu_cap samples a preintegration window.
    `full_polish_mode` picks the polish above local_k keyframes ("hybrid",
    the default, "recent", "capped", "grouped", "grouped_nomerge", "off";
    the JAX docstring gives the measurements behind each), and
    `window_layout` the observation layout of the regular windows ("flat",
    the default, or "grouped").

    `device` is the card unless the caller names another; the camera and
    the calibration must live on it. `syncs` counts the blocking reads of
    every call: one per visual window BA, two per inertial one (the edges,
    then the solve), one per frame LM.

    `mesh`: a `torch.distributed` DeviceMesh with a "dp" dimension, of the
    façade's device type. With one, every window BA goes through the
    sharded solver (`_solve_sharded`, `parallel/sharded_ba.py`: landmarks
    and observations split by point over the ranks, the reduced camera
    system all-reduced); every rank of the mesh must make the same calls
    with the same store (one process per rank, see that module)."""

    INIT_MAX_REL_SIGMA = 0.08  # scale-acceptance gate of the inertial init

    def __init__(self, camera, calib: ImuCalib,
                 local_k: int = 32, local_p: int = 2048, local_o: int = 6144,
                 imu_cap: int = 512, mesh=None,
                 full_k: int = 96, full_p: int = 4096, full_opk: int = 192,
                 full_polish_mode: str = "hybrid",
                 window_layout: str = "flat", device=CARD):
        self.device = resolve(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"Problems: a {mesh.device_type} mesh for a façade on {self.device}")
        self.mesh = mesh
        for name, dev in (("camera", camera.device), ("calib", calib.cov_noise.device)):
            if dev.type != self.device.type:
                raise ValueError(f"Problems: the {name} lies on {dev}, not on {self.device}")
        self.camera = camera
        self.calib = calib
        self.local_k, self.local_p, self.local_o = local_k, local_p, local_o
        self.full_k, self.full_p, self.full_opk = full_k, full_p, full_opk
        self.full_polish_mode = full_polish_mode
        self.window_layout = window_layout
        self.imu_cap = imu_cap
        self.syncs = SyncCounter()
        # host copies of the calibration constants the host assembly reads
        # (float32, as the JAX package's arrays read on the host)
        self._cov_walk = calib.cov_walk.cpu().numpy()
        self._t_bc = calib.t_bc.cpu().numpy()

    def _up(self, x, dtype=torch.float32) -> torch.Tensor:
        """A host array (or a tensor) as a tensor on the façade's device."""
        if isinstance(x, torch.Tensor):
            return x.to(self.device, dtype)
        return _upload_arrays([np.asarray(x)], self.device)[0].to(dtype)

    # -- frame optimize -------------------------------------------------

    def pose_optimize(self, state0: KfState, pts, uv, inv_sigma2, valid):
        """Visual-only frame pose (poseOptimize). Returns (state, inliers)
        as numpy, with one fetch."""
        dev = self.device
        z = KfState.zeros(device=dev)
        out = _pose_optimize_impl(
            KfState(*(self._up(a) for a in state0)), self._up(pts), self._up(uv),
            self._up(inv_sigma2), self._up(valid, torch.bool), self.camera,
            self.calib.R_cb, self.calib.t_cb, _identity_edge(dev), z,
            torch.zeros((), dtype=torch.float32, device=dev), z,
            torch.zeros(9, dtype=torch.float32, device=dev),
            use_inertial=False, use_prior=False)
        state, inlier = fetch(out, self.syncs)
        return KfState(*state), inlier

    def pose_full_optimize(self, state0: KfState, pts, uv, inv_sigma2, valid,
                           last_state: KfState, pre, prior_inv_sigma=None,
                           prior_ref: KfState | None = None):
        """Frame pose+velocity+bias tied to the last KF through the inertial
        edge of the preintegrated window `pre` (poseFullOptimize)."""
        dev = self.device
        edge = whiten(pre)
        use_prior = prior_inv_sigma is not None
        state0 = KfState(*(self._up(a) for a in state0))
        prior_ref = state0 if prior_ref is None else KfState(*(self._up(a) for a in prior_ref))
        pis = (self._up(prior_inv_sigma) if use_prior
               else torch.zeros(9, dtype=torch.float32, device=dev))
        out = _pose_optimize_impl(
            state0, self._up(pts), self._up(uv), self._up(inv_sigma2),
            self._up(valid, torch.bool), self.camera, self.calib.R_cb, self.calib.t_cb,
            edge, KfState(*(self._up(a) for a in last_state)),
            torch.ones((), dtype=torch.float32, device=dev), prior_ref, pis,
            use_inertial=True, use_prior=use_prior)
        state, inlier = fetch(out, self.syncs)
        return KfState(*state), inlier

    # -- BA problems ----------------------------------------------------

    def _batch_edges(self, store, ordered_ids, cap: int | None = None, bufs=None):
        """Preintegrate the KF->KF IMU windows of consecutive ids on the
        device, all in one tree, whiten them, and bring them to the host
        with one fetch. The edge axis is padded to `cap` (at least the next
        multiple of 16, the JAX package's buckets); padded rows
        preintegrate zero samples (identity delta, dt 0) and are masked by
        the callers' edge validity. Returns a PreintEdge of numpy arrays
        with a leading axis >= E, or None without an edge."""
        E = len(ordered_ids) - 1
        if E <= 0:
            return None
        cap = max(cap or 0, -(-E // 16) * 16)
        g = np.zeros((cap, self.imu_cap, 3), np.float32)
        a = np.zeros((cap, self.imu_cap, 3), np.float32)
        d = np.zeros((cap, self.imu_cap), np.float32)
        m = np.zeros((cap, self.imu_cap), np.float32)
        bg = np.zeros((cap, 3), np.float32)
        ba = np.zeros((cap, 3), np.float32)
        for e in range(E):
            k = ordered_ids[e]
            buf = bufs[e] if bufs is not None else store.kf_imu.get(k)
            if buf is None or buf.n == 0:
                continue
            if buf.n > self.imu_cap:
                # merged windows can exceed the capacity; truncation would
                # leave an edge covering less time than its keyframe gap
                log.info("preintegration window %d samples > cap %d: "
                         "time-weighted decimation", buf.n, self.imu_cap)
                buf = buf.decimated(self.imu_cap)
            g[e], a[e], d[e], m[e] = buf.padded(self.imu_cap)
            bg[e] = store.kf_bg[k]
            ba[e] = store.kf_ba[k]
        pre = preintegrate_tree_batch(*_upload_arrays([g, a, d, m, bg, ba], self.device),
                                      self.calib)
        return fetch(whiten(pre), self.syncs)

    def build_window_problem(self, store, opt_ids, fixed_ids,
                             inertial=False, opt_points=True,
                             pose_dofs=True, vb_dofs=False,
                             priors=False, caps=None, grouped=False,
                             edge_bufs=None, fixed_vb_free=False):
        """Assemble a fixed-capacity BAProblem from a MapStore window and
        upload it. Returns (problem on the device, ids, pids, obs_meta);
        see `_host_window_problem` for the rules."""
        host, ids, pids, obs_meta = self._host_window_problem(
            store, opt_ids, fixed_ids, inertial=inertial, opt_points=opt_points,
            pose_dofs=pose_dofs, vb_dofs=vb_dofs, priors=priors, caps=caps,
            grouped=grouped, edge_bufs=edge_bufs, fixed_vb_free=fixed_vb_free)
        return _upload_problem(host, self.device), ids, pids, obs_meta

    def _host_window_problem(self, store, opt_ids, fixed_ids,
                             inertial=False, opt_points=True,
                             pose_dofs=True, vb_dofs=False,
                             priors=False, caps=None, grouped=False,
                             edge_bufs=None, fixed_vb_free=False):
        """The window's BAProblem as numpy arrays (the JAX package's
        `build_window_problem`, rule for rule).

        caps: optional (K, P, O) capacity override (default local_*).
        grouped: lay observations out as K contiguous per-KF blocks of
          O // K rows (schur_ba's grouped_obs layout): subsampling then
          happens per KF instead of across the concatenation.
        edge_bufs: optional ImuBuffers for the consecutive pairs of the
          time-ordered window (len == n_ids - 1), used by the full polish
          to keep a connected inertial chain across stride-skipped
          keyframes (preintegration composes exactly, Imu.cpp:157-172);
          the true-successor check is skipped for them."""
        K, P, O = caps if caps is not None else (self.local_k, self.local_p, self.local_o)
        ids_all = list(opt_ids) + [k for k in fixed_ids if k not in opt_ids]
        ids = ids_all[:K]
        if len(ids_all) > K:
            log.warning("window BA: KF capacity %d reached, dropping %d "
                        "anchor keyframes", K, len(ids_all) - K)
        slot = {k: i for i, k in enumerate(ids)}
        nk = len(ids)

        R, t, v, bg, ba = store.keyframe_states(ids)
        kf = KfState(*(np.concatenate([x, _pad_kf(x, K - nk)]) for x in (R, t, v, bg, ba)))

        dof = np.zeros((K, 15), np.float32)
        for i, k in enumerate(ids):
            if k in set(opt_ids):
                if pose_dofs:
                    dof[i, :6] = 1.0
                if vb_dofs:
                    dof[i, 6:15] = 1.0
            elif vb_dofs and fixed_vb_free:
                # anchors pin the gauge, which lives in the pose dims alone:
                # velocity and bias stay free (the JAX docstring measures
                # what a frozen anchor velocity cost)
                dof[i, 6:15] = 1.0

        # points observed by the window
        feat_pt = store.kf_feat_pt[np.asarray(ids)]
        pids = np.unique(feat_pt[feat_pt >= 0])
        pids = pids[store.pt_valid[pids]]
        if len(pids) > P:
            # keep the best-observed points; the drop is logged
            log.warning("window BA: point capacity %d reached, subsampling "
                        "%d of %d window points by observation count",
                        P, P, len(pids))
            order = np.argsort(-store.pt_n_obs[pids])
            pids = pids[order[:P]]
        np_pts = len(pids)
        pt_slot = np.full(store.max_pt, -1, np.int64)
        pt_slot[pids] = np.arange(np_pts)

        points = np.zeros((P, 3), np.float32)
        points[:np_pts] = store.pt_xyz[pids]
        pt_active = np.zeros(P, bool)
        pt_active[:np_pts] = bool(opt_points)

        # observations: all (window KF, point) pairs
        o_kf = np.zeros(O, np.int32)
        o_pt = np.zeros(O, np.int32)
        o_uv = np.zeros((O, 2), np.float32)
        o_is2 = np.ones(O, np.float32)
        o_val = np.zeros(O, bool)
        if grouped:
            # per-KF contiguous blocks of opk rows: obs_kf is the implied
            # o // opk pattern, padding rows masked
            opk = O // K
            o_kf[:] = np.repeat(np.arange(K, dtype=np.int32), opk)
            n_drop = n_tot = 0
            for i, k in enumerate(ids):
                fsel = np.nonzero(feat_pt[i] >= 0)[0]
                psel = feat_pt[i][fsel]
                keep = pt_slot[psel] >= 0
                fsel, psel = fsel[keep], psel[keep]
                n_tot += len(fsel)
                if len(fsel) > opk:
                    # stratified stride subsample within the keyframe
                    n_drop += len(fsel) - opk
                    sub = np.unique(np.round(
                        np.linspace(0, len(fsel) - 1, opk)).astype(np.int64))
                    fsel, psel = fsel[sub], psel[sub]
                sl = slice(i * opk, i * opk + len(fsel))
                o_pt[sl] = pt_slot[psel]
                o_uv[sl] = store.kf_feat_xy[k, fsel]
                o_is2[sl] = 1.0 / store.kf_feat_sigma2[k, fsel]
                o_val[sl] = True
            if n_drop:
                log.warning("window BA (grouped): per-KF obs capacity %d "
                            "reached, subsampled %d of %d observations",
                            opk, n_drop, n_tot)
            slot_idx = np.nonzero(o_val)[0]
            obs_meta = (o_kf[slot_idx].copy(), o_pt[slot_idx].copy(), slot_idx)
        else:
            obs_kf, obs_pt, obs_uv, obs_is2 = [], [], [], []
            for i, k in enumerate(ids):
                fsel = np.nonzero(feat_pt[i] >= 0)[0]
                psel = feat_pt[i][fsel]
                keep = pt_slot[psel] >= 0
                fsel, psel = fsel[keep], psel[keep]
                obs_kf.append(np.full(len(fsel), i, np.int32))
                obs_pt.append(pt_slot[psel].astype(np.int32))
                obs_uv.append(store.kf_feat_xy[k, fsel])
                obs_is2.append(1.0 / store.kf_feat_sigma2[k, fsel])
            obs_kf = np.concatenate(obs_kf) if obs_kf else np.zeros(0, np.int32)
            obs_pt = np.concatenate(obs_pt) if obs_pt else np.zeros(0, np.int32)
            obs_uv = np.concatenate(obs_uv) if obs_uv else np.zeros((0, 2), np.float32)
            obs_is2 = np.concatenate(obs_is2) if obs_is2 else np.zeros(0, np.float32)
            if len(obs_kf) > O:
                # stratified stride subsample across the concatenated
                # per-KF blocks: a tail truncation would drop the fixed
                # anchors' observations first (they come last) and cut the
                # window loose from the old map
                log.warning("window BA: observation capacity %d reached, "
                            "stride-subsampling %d of %d observations",
                            O, len(obs_kf) - O, len(obs_kf))
                keep = np.unique(np.round(
                    np.linspace(0, len(obs_kf) - 1, O)).astype(np.int64))
                obs_kf = obs_kf[keep]
                obs_pt = obs_pt[keep]
                obs_uv = obs_uv[keep]
                obs_is2 = obs_is2[keep]
            no = min(len(obs_kf), O)
            obs_meta = (obs_kf[:no].copy(), obs_pt[:no].copy(), np.arange(no, dtype=np.int64))
            o_kf[:no] = obs_kf[:no]
            o_pt[:no] = obs_pt[:no]
            o_uv[:no] = obs_uv[:no]
            o_is2[:no] = obs_is2[:no]
            o_val[:no] = True

        # inertial edges between consecutive window ids in time order
        E = K - 1
        ie_i = np.zeros(E, np.int32)
        ie_j = np.zeros(E, np.int32)
        ie_valid = np.zeros(E, bool)
        walk_inv = np.zeros((E, 6), np.float32)
        walk_valid = np.zeros(E, bool)
        edge = _identity_edge_batch(E)
        if inertial and nk >= 2:
            ordered = sorted(ids, key=lambda k: store.kf_time[k])
            real = self._batch_edges(store, ordered, cap=E, bufs=edge_bufs)
            ne = min(len(ordered) - 1, E)
            # an inertial edge only joins a KF and its true successor
            # (kf_imu[k] integrates k -> the next KF at creation, culling
            # merges keep that); covisibility anchors can leave time gaps
            order_all = store.keyframe_ids()
            succ = {order_all[i]: order_all[i + 1] for i in range(len(order_all) - 1)}
            opt_set_ie = set(opt_ids)
            for e in range(ne):
                ie_i[e] = slot[ordered[e]]
                ie_j[e] = slot[ordered[e + 1]]
                if edge_bufs is not None:
                    # merged windows compose across skipped KFs: valid
                    # whenever they hold samples
                    has_imu = e < len(edge_bufs) and edge_bufs[e].n > 0
                    is_succ = True
                else:
                    has_imu = (store.kf_imu.get(ordered[e]) is not None
                               and store.kf_imu[ordered[e]].n > 0)
                    is_succ = succ.get(ordered[e]) == ordered[e + 1]
                # an edge between two fixed anchors has no degrees of
                # freedom: it adds a constant (often huge) to every cost
                ie_valid[e] = (has_imu and is_succ
                               and (ordered[e] in opt_set_ie or ordered[e + 1] in opt_set_ie))
                dtw = max(store.kf_time[ordered[e + 1]] - store.kf_time[ordered[e]], 1e-3)
                freq = self.calib.freq
                wg = np.sqrt(self._cov_walk[0] * freq * dtw)
                wa = np.sqrt(self._cov_walk[3] * freq * dtw)
                walk_inv[e, :3] = 1.0 / max(wg, 1e-9)
                walk_inv[e, 3:] = 1.0 / max(wa, 1e-9)
                walk_valid[e] = ie_valid[e]
            if ne > 0:
                edge = PreintEdge(*(np.concatenate([r[:ne], f[ne:]], axis=0)
                                    for f, r in zip(edge, real)))

        prior_inv_sigma = np.zeros((K, 15), np.float32)
        if priors:
            # the velocity/bias prior pins only the oldest optimized KF, the
            # sliding window's border (Optimize.cpp:1176-1191 `if (i == 0)`)
            opt_set = set(opt_ids)
            opt_sorted = sorted((k for k in ids if k in opt_set), key=lambda k: store.kf_time[k])
            if opt_sorted:
                i0 = ids.index(opt_sorted[0])
                prior_inv_sigma[i0, 6:15] = store.kf_prior_inv_sigma[opt_sorted[0]]

        problem = BAProblem(
            kf=kf, kf_dof=dof, points=points, pt_active=pt_active,
            obs_kf=o_kf, obs_pt=o_pt, obs_uv=o_uv, obs_inv_sigma2=o_is2, obs_valid=o_val,
            ie_i=ie_i, ie_j=ie_j, ie_edge=edge, ie_valid=ie_valid,
            walk_inv_sigma=walk_inv, walk_valid=walk_valid,
            prior_inv_sigma=prior_inv_sigma, prior_ref=kf)
        return problem, ids, pids, obs_meta

    def run_window_ba(self, store, opt_ids, fixed_ids, n_iters=8,
                      inertial=False, vb_dofs=False, priors=False,
                      opt_points=True, pose_dofs=True,
                      remove_outliers=True, lock=None,
                      caps=None, grouped=None, edge_bufs=None,
                      fixed_vb_free=False):
        """Build, solve and write back a window BA. Returns an info dict.

        `lock` (the map_update_mutex analog) is held while reading the
        store into the problem and while writing the result back; the
        device solve between them runs unlocked (Optimize.cpp:925,1264).
        The solve's whole result (states, points, every diagnostic) comes
        to the host with one fetch."""
        lock = lock if lock is not None else nullcontext()
        if grouped is None:
            K_, _, O_ = caps if caps is not None else (self.local_k, self.local_p, self.local_o)
            grouped = self.window_layout == "grouped" and O_ % K_ == 0
        with lock:
            host, ids, pids, (obs_kf_l, obs_pt_l, obs_slot) = self._host_window_problem(
                store, opt_ids, fixed_ids, inertial=inertial, opt_points=opt_points,
                pose_dofs=pose_dofs, vb_dofs=vb_dofs, priors=priors, caps=caps,
                grouped=grouped, edge_bufs=edge_bufs, fixed_vb_free=fixed_vb_free)
        problem = _upload_problem(host, self.device)
        if self.mesh is not None:
            kf, pts, info = self._solve_sharded(problem, host, n_iters)
        else:
            K_cap = host.kf_dof.shape[0]
            opk = host.obs_kf.shape[0] // K_cap if grouped else 0
            kf, pts, info = schur_ba(problem, self.camera, self.calib.R_cb, self.calib.t_cb,
                                     n_iters=n_iters, grouped_obs=opk)
        kf, pts, info = fetch((kf, pts, info), self.syncs)
        kf = KfState(*kf)
        n_ie = int(host.ie_valid.sum())
        if float(info["cost0"]) > 1e6:
            self._log_pathological_start(problem, host, info, ids, n_ie)
        with lock:
            out = self._write_back_ba(
                store, kf, pts, info, ids, pids, obs_kf_l, obs_pt_l,
                opt_ids, opt_points, vb_dofs, remove_outliers, obs_slot=obs_slot)
        out["n_ie"] = n_ie
        out["pids"] = pids  # solved point ids (callers propagate the rest)
        return out

    def _solve_sharded(self, problem, host, n_iters):
        """A window BA on the mesh: the observations regrouped by point
        shard (the order worked out from the host problem, applied to the
        device problem), the distributed LM (`sharded_schur_ba`), then the
        per-observation chi2 of the outlier test priced on the original
        observation order (point sharding keeps the point order, so the
        solved states and points drop into the original problem), as the
        JAX package does (problems.py:689-720). Nothing is read back."""
        from ..parallel.multihost import mesh_axis
        from ..parallel.sharded_ba import apply_order, shard_order, sharded_schur_ba

        n = mesh_axis(self.mesh, "dp")[2]
        order, keep = _upload_arrays(shard_order(host.obs_pt, host.obs_valid,
                                                 host.points.shape[0], n), self.device)
        kf, pts, info = sharded_schur_ba(apply_order(problem, order, keep), self.camera,
                                         self.calib.R_cb, self.calib.t_cb, self.mesh,
                                         n_iters=n_iters)
        chi2, _ = _vis_residuals(problem._replace(kf=kf, points=pts), self.camera,
                                 self.calib.R_cb, self.calib.t_cb, CHI2_MONO)
        return kf, pts, dict(info, obs_chi2=chi2)

    def _log_pathological_start(self, problem, host, info, ids, n_ie):
        """A window should never start this inconsistent: split the start
        cost by residual family (one more fetch) so the offending family
        and edge are visible in the log."""
        _, c_vis = _vis_residuals(problem, self.camera, self.calib.R_cb, self.calib.t_cb,
                                  solver.CHI2_MONO)
        r_ie, *_, c_ie = _inertial_linearize(problem)
        r_w, *_, c_walk = _walk_linearize(problem)
        c_vis, c_ie, c_walk, e2, w2 = fetch(
            (c_vis, c_ie, c_walk, torch.sum(r_ie * r_ie, -1), torch.sum(r_w * r_w, -1)),
            self.syncs)
        per_edge = e2 * np.asarray(host.ie_valid, np.float32)
        per_walk = w2 * np.asarray(host.walk_valid, np.float32)
        e_bad = int(per_edge.argmax())
        i_s, j_s = int(host.ie_i[e_bad]), int(host.ie_j[e_bad])
        log.warning(
            "window BA: pathological start cost %.3g (vis %.3g, inertial %.3g, "
            "walk %.3g; %d ie edges; worst edge kf[%d]->kf[%d] ie %.3g walk %.3g "
            "dt %.2f opt=%d,%d)",
            float(info["cost0"]), float(c_vis), float(c_ie), float(c_walk), n_ie,
            ids[i_s], ids[j_s], float(per_edge[e_bad]), float(per_walk[e_bad]),
            float(host.ie_edge.dt[e_bad]), int(host.kf_dof[i_s, 0] > 0),
            int(host.kf_dof[j_s, 0] > 0))

    def _write_back_ba(self, store, kf, pts, info, ids, pids, obs_kf_l,
                       obs_pt_l, opt_ids, opt_points, vb_dofs,
                       remove_outliers, obs_slot=None):
        R, t, v, bg, ba = kf
        opt_set = set(opt_ids)
        for i, k in enumerate(ids):
            if k in opt_set:
                store.kf_R[k] = _renormalize(R[i])
                store.kf_t[k] = t[i]
                if vb_dofs:
                    store.kf_v[k] = v[i]
                    store.kf_bg[k] = bg[i]
                    store.kf_ba[k] = ba[i]
        if opt_points:
            store.pt_xyz[pids] = np.asarray(pts)[: len(pids)]
        # outlier observation removal (chi2 > 5.991; Optimize.cpp:912-927)
        n_out = 0
        if remove_outliers:
            chi2_all = np.asarray(info["obs_chi2"])
            if obs_slot is None:
                obs_slot = np.arange(len(obs_kf_l))
            chi2 = chi2_all[obs_slot]
            bad = np.nonzero(chi2 > CHI2_MONO)[0]
            for o in bad:
                k = ids[obs_kf_l[o]]
                p = int(pids[obs_pt_l[o]])
                store.remove_observation(p, k)
                n_out += 1
        store.version += 1
        return {"cost0": float(info["cost0"]), "cost": float(info["cost"]),
                "n_outliers": n_out, "ids": ids, "n_points": len(pids)}

    # -- named problems --------------------------------------------------

    def initial_optimize(self, store, kf_ids, n_iters=20):
        """2-KF + points BA after two-view init (initialOptimize)."""
        return self.run_window_ba(store, opt_ids=[kf_ids[1]], fixed_ids=[kf_ids[0]],
                                  n_iters=n_iters, remove_outliers=False)

    def local_bundle_adjustment(self, store, center_kf, window=10, n_iters=8, lock=None):
        """Covisibility-window visual BA with fixed anchors
        (localBundleAdjustment, Optimize.cpp:766-951): the window is the
        covisibility neighbourhood of the current KF, the anchors every
        other KF covisible with it (capped)."""
        opt_ids = [center_kf] + store.covisible_keyframes(center_kf, top=window - 1)
        opt_set = set(opt_ids)
        fixed = []
        for k in opt_ids:
            for j in store.covisible_keyframes(k, top=10):
                if j not in opt_set and j not in fixed:
                    fixed.append(j)
        if not fixed:
            # young map: anchor the oldest window KFs to pin the gauge
            by_time = sorted(opt_ids, key=lambda k: store.kf_time[k])
            if len(by_time) > 2:
                fixed = by_time[:2]
            else:
                fixed = by_time[:1]
            opt_ids = [k for k in opt_ids if k not in fixed]
        return self.run_window_ba(store, opt_ids, fixed[: self.local_k // 2],
                                  n_iters=n_iters, lock=lock)

    def _covisible_anchors(self, store, opt_ids, cap: int):
        """Fixed anchors for a sliding window: the out-of-window KFs that
        observe the window's points, ranked by shared observations (the
        reference fixes every observer, <= 150, Optimize.cpp:1095)."""
        window = set(opt_ids)
        feat_pt = store.kf_feat_pt[np.asarray(list(opt_ids), np.int32)]
        pids = np.unique(feat_pt[feat_pt >= 0])
        pids = pids[store.pt_valid[pids]]
        if len(pids) == 0:
            older = [k for k in store.keyframe_ids() if k not in window]
            return older[-cap:]
        obs = store.pt_obs_kf[pids].reshape(-1)
        obs = obs[obs >= 0]
        counts = np.bincount(obs, minlength=store.max_kf)
        for k in window:
            counts[k] = 0
        anchors = np.argsort(-counts)[:cap]
        return [int(k) for k in anchors if counts[k] > 0]

    def local_full_bundle_adjustment(self, store, window=10, n_iters=8, lock=None):
        """Sliding-window visual-inertial BA (localFullBundleAdjustment);
        the anchors fill the rest of the KF capacity."""
        opt_ids = store.recent_keyframes(window)
        fixed = self._covisible_anchors(store, opt_ids, cap=max(5, self.local_k - len(opt_ids)))
        return self.run_window_ba(store, opt_ids, fixed, n_iters=n_iters,
                                  inertial=True, vb_dofs=True, priors=True, lock=lock)

    def local_inertial_bundle_adjustment(self, store, window=10, n_iters=8, lock=None):
        """Velocity/bias-only sliding window (localInertialBundleAdjustment)."""
        opt_ids = store.recent_keyframes(window)
        fixed = [k for k in store.keyframe_ids() if k not in opt_ids][-3:]
        return self.run_window_ba(store, opt_ids, fixed, n_iters=n_iters,
                                  inertial=True, vb_dofs=True, priors=True,
                                  pose_dofs=False, opt_points=False, lock=lock)

    def warm_solvers(self):
        """Build `csrc/` and launch each K4 route once at the façade's
        capacities (D = 15 local_k and 15 full_k; under a mesh the first
        only, as the JAX package skips the full polish's shape there,
        problems.py:882), so that the first timed window BA is not the
        first launch. Eager torch compiles nothing else; off the card this
        does nothing."""
        if self.device.type != "cuda":
            return
        cuda_lib.build()
        cuda_lib.lib()
        for K in (self.local_k,) if self.mesh is not None else (self.local_k, self.full_k):
            D = 15 * K
            chol_solve(torch.eye(D, dtype=torch.float32, device=self.device)[None],
                       torch.ones((1, D), dtype=torch.float32, device=self.device))
        torch.cuda.synchronize(self.device)

    def full_inertial_optimize(self, store, n_iters=12):
        """Full VI-BA over all KFs + points (fullInertialOptimize,
        Optimize.cpp:239-442).

        Sessions within `local_k` KFs solve the regular window shape. Larger
        sessions take the large grouped problem (full_k/full_p/full_opk):
        up to full_k KFs every keyframe enters directly; beyond, the newest
        half stays and the older history is stride-subsampled with the IMU
        windows merged across the skipped keyframes, and the skipped
        keyframes then take their nearest selected neighbour's SE(3)
        correction. `full_polish_mode` selects among the JAX package's
        arms above local_k (see the JAX docstring for their records)."""
        ids = store.keyframe_ids()
        if len(ids) <= self.local_k:
            opt_ids = ids[1:]  # anchor the first KF
            snap = {k: (store.kf_R[k].copy(), store.kf_t[k].copy()) for k in ids}
            out = self.run_window_ba(store, opt_ids, [ids[0]], n_iters=n_iters,
                                     inertial=True, vb_dofs=True, priors=True,
                                     fixed_vb_free=True)
            if out is not None:
                self._propagate_point_correction(store, snap, out.get("pids"))
            return out
        if self.full_polish_mode == "off":
            return None
        if self.full_polish_mode == "recent" and len(ids) > self.full_k:
            # the grouped machinery over the newest full_k keyframes only,
            # anchored on the window's oldest member
            sel = ids[-self.full_k:]
            snap = {k: (store.kf_R[k].copy(), store.kf_t[k].copy()) for k in ids}
            out = self.run_window_ba(
                store, sel[1:], [sel[0]], n_iters=n_iters, inertial=True,
                vb_dofs=True, priors=True, fixed_vb_free=True,
                caps=(self.full_k, self.full_p, self.full_k * self.full_opk), grouped=True)
            if out is not None:
                self._propagate_point_correction(store, snap, out.get("pids"))
            return out
        if self.full_polish_mode == "capped" or (
                self.full_polish_mode == "hybrid" and len(ids) > self.full_k):
            # local_k-capped stride subsample; skipped pairs lose their
            # inertial edge
            K = self.local_k
            n_recent = max(K // 2, 4)
            old, recent = ids[:-n_recent], ids[-n_recent:]
            keep = np.unique(np.round(
                np.linspace(0, len(old) - 1, K - n_recent)).astype(np.int64))
            sub = [old[i] for i in keep] + recent
            return self.run_window_ba(store, sub[1:], [sub[0]], n_iters=n_iters,
                                      inertial=True, vb_dofs=True, priors=True,
                                      fixed_vb_free=True)
        K = self.full_k
        sel = ids
        if len(ids) > K:
            n_recent = K // 2
            old, recent = ids[:-n_recent], ids[-n_recent:]
            keep = np.unique(np.round(
                np.linspace(0, len(old) - 1, K - n_recent)).astype(np.int64))
            sel = [old[i] for i in keep] + recent
            log.info("full inertial BA: %d KFs exceed capacity %d, "
                     "stride-subsampling the %d oldest (merged IMU edges)",
                     len(ids), K, len(old))
        # grouped_nomerge: the big grouped problem without merged edges
        bufs = (None if self.full_polish_mode == "grouped_nomerge"
                else self._merged_windows(store, sel))
        # snapshot every keyframe pose: the corrections of skipped KFs and
        # of the points the problem could not include come from old-vs-new
        snap = {k: (store.kf_R[k].copy(), store.kf_t[k].copy()) for k in ids}
        out = self.run_window_ba(
            store, sel[1:], [sel[0]], n_iters=n_iters, inertial=True,
            vb_dofs=True, priors=True, fixed_vb_free=True,
            caps=(K, self.full_p, K * self.full_opk), grouped=True, edge_bufs=bufs)
        if len(sel) < len(ids):
            self._propagate_polish_correction(store, ids, sel, snap)
        self._propagate_point_correction(store, snap, out.get("pids"))
        return out

    def _propagate_polish_correction(self, store, ids, sel, snap):
        """Apply each skipped KF's nearest selected neighbour's pose
        correction (T_new T_old^-1, left-multiplied), so the subsampled
        polish leaves a consistent chain."""
        sel_set = set(sel)
        sel_times = np.asarray([store.kf_time[k] for k in sel])
        for k in ids:
            if k in sel_set:
                continue
            tk = store.kf_time[k]
            j = int(np.searchsorted(sel_times, tk))
            cand = [c for c in (j - 1, j) if 0 <= c < len(sel)]
            j = min(cand, key=lambda c: abs(sel_times[c] - tk))
            nb = sel[j]
            R_old, t_old = snap[nb]
            R_new, t_new = store.kf_R[nb], store.kf_t[nb]
            R_c = R_new @ R_old.T
            store.kf_R[k] = _renormalize(R_c @ store.kf_R[k])
            store.kf_t[k] = R_c @ (store.kf_t[k] - t_old) + t_new
            store.kf_v[k] = R_c @ store.kf_v[k]
            store.kf_bg[k] = store.kf_bg[nb].copy()
            store.kf_ba[k] = store.kf_ba[nb].copy()

    def _propagate_point_correction(self, store, snap, solved_pids):
        """Move every valid map point the capacity-bounded polish could not
        include by its reference (first-observer) keyframe's SE(3)
        correction, as the reference's all-points polish would have
        (Optimize.cpp:239-442)."""
        pids_all = np.nonzero(store.pt_valid)[0]
        if solved_pids is not None and len(solved_pids):
            stale = pids_all[~np.isin(pids_all, solved_pids)]
        else:
            stale = pids_all
        if len(stale) == 0:
            return
        refk = store.pt_obs_kf[stale, 0]
        ok = refk >= 0
        stale, refk = stale[ok], refk[ok]
        kf_ids = np.unique(refk)
        R_c = np.zeros((store.max_kf, 3, 3), np.float32)
        t_o = np.zeros((store.max_kf, 3), np.float32)
        t_n = np.zeros((store.max_kf, 3), np.float32)
        has = np.zeros(store.max_kf, bool)
        for k in kf_ids:
            if k not in snap:
                continue
            R_old, t_old = snap[k]
            R_c[k] = store.kf_R[k] @ R_old.T
            t_o[k], t_n[k] = t_old, store.kf_t[k]
            has[k] = True
        use = has[refk]
        stale, refk = stale[use], refk[use]
        x = store.pt_xyz[stale]
        store.pt_xyz[stale] = np.einsum("pij,pj->pi", R_c[refk], x - t_o[refk]) + t_n[refk]

    # -- inertial initialization ----------------------------------------

    def inertial_optimize(self, store, prior_g=1e6, prior_a=1e12, n_iters=60,
                          with_scale=True, min_edge_dt=0.2, defer_above=None):
        """Vision-fixed inertial-only init (inertialOptimize): per-KF
        velocities, shared bg/ba, gravity direction R_wg and the scale,
        with bias priors. Returns {R_wg, scale, bg, ba, cost0, cost,
        scale_sigma_rel} and writes velocities and biases into the store,
        or None when the scale is not yet observable (relative sigma above
        INIT_MAX_REL_SIGMA, or `defer_above`).

        The edges are preintegrated on the device (one fetch); the solve
        runs on the host in float64 (`_inertial_init_host`): the whitened
        normal equations condition at ~1e10, far beyond float32. The chain
        is subsampled to edges of >= min_edge_dt seconds, merging the IMU
        windows across skipped KFs; skipped KFs take interpolated
        velocities."""
        ids_all = store.keyframe_ids()
        if len(ids_all) < 3:
            return None
        span = store.kf_time[ids_all[-1]] - store.kf_time[ids_all[0]]
        min_edge_dt = max(min_edge_dt, span / 64.0)
        ids = [ids_all[0]]
        for k in ids_all[1:]:
            if store.kf_time[k] - store.kf_time[ids[-1]] >= min_edge_dt:
                ids.append(k)
        if ids[-1] != ids_all[-1]:
            tail_dt = store.kf_time[ids_all[-1]] - store.kf_time[ids[-1]]
            if tail_dt < 0.5 * min_edge_dt and len(ids) > 1:
                ids[-1] = ids_all[-1]
            else:
                ids.append(ids_all[-1])
        K = len(ids)
        if K < 3:
            ids = ids_all
            K = len(ids)
        bufs = self._merged_windows(store, ids)
        R, t, v, _, _ = store.keyframe_states(ids)
        edge = PreintEdge(*(np.asarray(a[: K - 1], np.float64)
                            for a in self._batch_edges(store, ids, cap=K - 1, bufs=bufs)))
        gate = self.INIT_MAX_REL_SIGMA if defer_above is None else defer_above
        out = _inertial_init_host(
            np.asarray(R, np.float64), np.asarray(t, np.float64),
            edge, prior_g, prior_a, with_scale=with_scale, n_iters=n_iters,
            t_bc=np.asarray(self._t_bc, np.float64),
            skip_lm_above=(gate if with_scale else None))
        if with_scale and out["scale_sigma_rel"] > gate:
            # an accepted marginal scale permanently shears the map gauge:
            # defer until more trajectory makes it observable
            log.warning("inertial alignment deferred: scale not observable "
                        "enough (relative sigma %.3f > %.2f, estimate %.3f,"
                        " span %.1f s)", out["scale_sigma_rel"], gate,
                        out["scale"], store.kf_time[ids[-1]] - store.kf_time[ids[0]])
            return None
        R_wg = out["R_wg"].astype(np.float32)
        scale = float(out["scale"])
        bg = out["bg"].astype(np.float32)
        ba = out["ba"].astype(np.float32)
        vels = out["v"].astype(np.float32)
        # velocities: solved KFs directly, skipped KFs by time interpolation
        t_sel = np.asarray([store.kf_time[k] for k in ids])
        for k in ids_all:
            store.kf_bg[k] = bg
            store.kf_ba[k] = ba
        for i, k in enumerate(ids):
            store.kf_v[k] = vels[i]
        skipped = [k for k in ids_all if k not in set(ids)]
        for k in skipped:
            tk = store.kf_time[k]
            j = int(np.searchsorted(t_sel, tk))
            j = min(max(j, 1), K - 1)
            w = (tk - t_sel[j - 1]) / max(t_sel[j] - t_sel[j - 1], 1e-9)
            store.kf_v[k] = (1.0 - w) * vels[j - 1] + w * vels[j]
        return {"R_wg": R_wg, "scale": scale, "bg": bg, "ba": ba,
                "cost0": float(out["cost0"]), "cost": float(out["cost"]),
                "scale_sigma_rel": float(out.get("scale_sigma_rel", 0.0))}

    def _merged_windows(self, store, sel_ids):
        """Concatenated raw IMU windows between consecutive selected KFs
        (composing across the skipped ones: the MergeNext primitive,
        Imu.cpp:157-172)."""
        order = store.keyframe_ids()
        pos = {k: i for i, k in enumerate(order)}
        bufs = []
        for a, b in zip(sel_ids[:-1], sel_ids[1:]):
            buf = ImuBuffer()
            for k in order[pos[a]:pos[b]]:
                src = store.kf_imu.get(k)
                if src is not None:
                    buf.extend(src)
            bufs.append(buf)
        return bufs

    def gravity_optimize(self, store, n_iters=30):
        """Gravity-direction-only refinement (gravityOptimize)."""
        return self.inertial_optimize(store, prior_g=1e8, prior_a=1e12,
                                      n_iters=n_iters, with_scale=False)
# ---------------------------------------------------------------------------
# inertial init host core (f64)
# ---------------------------------------------------------------------------


def _np_exp_so3(w: np.ndarray) -> np.ndarray:
    th = float(np.linalg.norm(w))
    W = np.array([[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]])
    if th < 1e-10:
        return np.eye(3) + W
    return (np.eye(3) + np.sin(th) / th * W
            + (1.0 - np.cos(th)) / th**2 * (W @ W))


def _np_log_so3(R: np.ndarray) -> np.ndarray:
    w = 0.5 * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    s = np.linalg.norm(w)
    if s < 1e-10:
        return w
    th = np.arctan2(s, c)
    return w * (th / s)


def _gravity_r_wg0(g_dir: np.ndarray) -> np.ndarray:
    """Rotation taking (0,0,-1) onto the given gravity direction."""
    g_i = np.array([0.0, 0.0, -1.0])
    axis = np.cross(g_i, g_dir)
    s_norm = np.linalg.norm(axis)
    if s_norm < 1e-9:
        return np.eye(3) if g_dir[2] < 0 else _np_exp_so3(np.array([np.pi, 0, 0]))
    return _np_exp_so3(axis / s_norm * np.arctan2(s_norm, float(g_i @ g_dir)))


def _inertial_init_host(R_wb, t_wb, edge: PreintEdge, prior_g, prior_a,
                        with_scale: bool, n_iters: int = 60, t_bc=None,
                        skip_lm_above=None):
    """f64 host LM for the vision-fixed inertial init (EdgeInertialGS
    residuals, G2oTypes.cpp:71-163), seeded by the CLOSED-FORM linear
    visual-inertial alignment: with rotations fixed, the preintegration
    equations are exactly linear in {metric velocities, gravity vector,
    scale}, so one least-squares solve lands next to the optimum and the
    LM only refines biases + renormalizes |g| to 9.8. All math is numpy
    f64 — see inertial_optimize for why this cannot run in f32.

    THE LEVER ARM IS MODELED EXPLICITLY: the stored body positions carry
    the METRIC camera-IMU lever (t_wb = c_visual + R_wb t_bc — the same
    convention MapStore.apply_scale_rotation preserves), so only the
    camera-center part may be multiplied by the scale. Scaling t_wb
    directly injects (s-1)(R_{i+1}-R_i) t_bc per edge — an error that is
    ~|Delta yaw| * |t_bc| * s while the gravity signal is ~0.5 g dt^2, so
    its RELATIVE size grows as 1/dt: with the idle-mapper KF cadence
    (0.1-0.15 s edges) it reached ~10% per edge and the whitened optimum
    moved to scale 2.6 where the data demand 7.0 (circle-image world).

    Velocities are returned in the VISUAL (map) scale, matching the
    EdgeInertialGS parametrization and MapStore.apply_scale_rotation's
    `v *= scale` gauge rewrite."""
    K = R_wb.shape[0]
    E = K - 1
    if t_bc is None:
        t_bc = np.zeros(3)
    Rs = R_wb
    # visual-scale camera centers + per-edge metric lever displacement
    ps = t_wb - np.einsum("kij,j->ki", R_wb, t_bc)
    lever = np.einsum("kij,j->ki", R_wb[1:] - R_wb[:-1], t_bc)  # [E, 3] metric
    dR_m, dV_m, dP_m = edge.dR, edge.dV, edge.dP
    dts = edge.dt
    L_inv = edge.L_inv

    # --- gyro-bias seed from rotation residuals ----------------------
    # er(bg) ~= log(dR^T R1^T R2) - JRg (bg - bg0); rotation-only, so it
    # decouples from v/g/s and keeps the bias signal out of the empirical
    # whitening floor below.
    Ag_rows = [edge.JRg[i] for i in range(E)]
    bg_rows = [_np_log_so3(dR_m[i].T @ Rs[i].T @ Rs[i + 1])
               + edge.JRg[i] @ edge.bg0[i] for i in range(E)]
    bg_seed, *_ = np.linalg.lstsq(np.concatenate(Ag_rows),
                                  np.concatenate(bg_rows), rcond=None)
    if not np.isfinite(bg_seed).all() or np.linalg.norm(bg_seed) > 0.5:
        bg_seed = np.zeros(3)

    # --- linear alignment seed (bias-corrected edges) -----------------
    # Two passes: a FREE-gravity solve for the direction, then fixed-point
    # iterations with |g| CONSTRAINED to 9.8 on the gravity-sphere tangent.
    # The constraint is load-bearing for the scale: on low-excitation data
    # the p-rows are dominated by 0.5 g dt^2, so a free |g| absorbs a wrong
    # scale almost perfectly (measured on the circle-image world: free
    # solve s=2.61 with |g|=9.66 vs constrained s=5.56, true 7.0 — the
    # VINS-Mono-style alignment refinement).
    G_NORM = 9.8

    def _align_rows(g_base=None, tangent=None):
        gcols = 3 if tangent is None else 2
        ncols = 3 * K + gcols + (1 if with_scale else 0)
        A_rows, b_rows = [], []
        for i in range(E):
            Rt = Rs[i].T
            dt = float(dts[i])
            db_g = bg_seed - edge.bg0[i]
            dV_c = dV_m[i] + edge.JVg[i] @ db_g
            dP_c = dP_m[i] + edge.JPg[i] @ db_g
            dp_vis = Rt @ (ps[i + 1] - ps[i])
            dp_lever = Rt @ lever[i]  # metric, scale-independent
            rowP = np.zeros((3, ncols))
            rhsP = dP_c - dp_lever
            rowP[:, 3 * i : 3 * i + 3] = -Rt * dt
            if tangent is None:
                rowP[:, 3 * K : 3 * K + 3] = -0.5 * dt * dt * Rt
            else:
                rowP[:, 3 * K : 3 * K + 2] = -0.5 * dt * dt * (Rt @ tangent)
                rhsP = rhsP + 0.5 * dt * dt * (Rt @ g_base)
            if with_scale:
                rowP[:, -1] = dp_vis
            else:
                rhsP = rhsP - dp_vis
            A_rows.append(rowP)
            b_rows.append(rhsP)
            rowV = np.zeros((3, ncols))
            rhsV = dV_c.copy()
            rowV[:, 3 * i : 3 * i + 3] = -Rt
            rowV[:, 3 * (i + 1) : 3 * (i + 1) + 3] = Rt
            if tangent is None:
                rowV[:, 3 * K : 3 * K + 3] = -dt * Rt
            else:
                rowV[:, 3 * K : 3 * K + 2] = -dt * (Rt @ tangent)
                rhsV = rhsV + dt * (Rt @ g_base)
            A_rows.append(rowV)
            b_rows.append(rhsV)
        return np.concatenate(A_rows), np.concatenate(b_rows)

    def _align_rows_inv(g_base=None, tangent=None, inv_s_prev=1.0):
        """INVERSE-regression alignment (errors-in-variables fix): the
        noisy measured quantity — the visual displacement dp_vis — sits on
        the RESPONSE side, and the clean IMU/gravity terms regress 1/s.
        With dp_vis as a regressor column (the textbook VINS form used by
        _align_rows) its noise attenuates the scale estimate toward zero:
        measured on the corridor world the estimate plateaued ~20% low
        (14-16 against a true 19.8) no matter how much data accrued, and
        the accepted under-scale permanently sheared the map. Unknowns:
        [v_visual(3K), w(3) | theta(2), inv_s]; with gravity free, w =
        inv_s * g is solved as one combined column block (still linear);
        constrained passes substitute w = G_NORM*(inv_s*ghat +
        inv_s_prev*Tn theta) (Gauss-Seidel on the bilinear term)."""
        gcols = 3 if tangent is None else 2
        ncols = 3 * K + gcols + (0 if tangent is None else 1)
        A_rows, b_rows = [], []
        for i in range(E):
            Rt = Rs[i].T
            dt = float(dts[i])
            db_g = bg_seed - edge.bg0[i]
            dV_c = dV_m[i] + edge.JVg[i] @ db_g
            dP_c = dP_m[i] + edge.JPg[i] @ db_g
            dp_vis = Rt @ (ps[i + 1] - ps[i])
            dp_lever = Rt @ lever[i]  # metric, scale-independent
            rowP = np.zeros((3, ncols))
            rowP[:, 3 * i : 3 * i + 3] = Rt * dt
            if tangent is None:
                # free pass: w = inv_s * g is its own column block, and
                # inv_s rides implicitly inside it; the inv_s-scaled IMU
                # term is approximated with inv_s_prev (refined by the
                # constrained passes)
                rowP[:, 3 * K : 3 * K + 3] = 0.5 * dt * dt * Rt
                rhsP = dp_vis - inv_s_prev * (dP_c - dp_lever)
            else:
                rowP[:, 3 * K : 3 * K + 2] = (
                    0.5 * dt * dt * G_NORM * inv_s_prev * (Rt @ tangent))
                rowP[:, -1] = (0.5 * dt * dt * G_NORM * (Rt @ g_base)
                               + dP_c - dp_lever)
                rhsP = dp_vis
            A_rows.append(rowP)
            b_rows.append(rhsP)
            rowV = np.zeros((3, ncols))
            rowV[:, 3 * i : 3 * i + 3] = -Rt
            rowV[:, 3 * (i + 1) : 3 * (i + 1) + 3] = Rt
            if tangent is None:
                rowV[:, 3 * K : 3 * K + 3] = -dt * Rt
                rhsV = inv_s_prev * dV_c
            else:
                rowV[:, 3 * K : 3 * K + 2] = (
                    -dt * G_NORM * inv_s_prev * (Rt @ tangent))
                rowV[:, -1] = -(dt * G_NORM * (Rt @ g_base) + dV_c)
                rhsV = np.zeros(3)
            A_rows.append(rowV)
            b_rows.append(rhsV)
        return np.concatenate(A_rows), np.concatenate(b_rows)

    scale_sigma_rel = 0.0
    if with_scale:
        # free-gravity inverse pass for the direction (iterate once on the
        # implicit inv_s), then constrained passes for {v, theta, inv_s}
        inv_s = 1.0
        g_lin = np.zeros(3)
        x_lin = np.zeros(3 * K + 3)
        for _ in range(2):
            A, b = _align_rows_inv(inv_s_prev=inv_s)
            x_f, *_ = np.linalg.lstsq(A, b, rcond=None)
            if not np.isfinite(x_f).all():
                break
            w = x_f[3 * K : 3 * K + 3]
            if np.linalg.norm(w) < 1e-9:
                break
            inv_s_new = float(np.linalg.norm(w)) / G_NORM
            g_lin = w / max(inv_s_new, 1e-12)
            inv_s = inv_s_new
            x_lin = x_f
        if np.isfinite(g_lin).all() and np.linalg.norm(g_lin) > 1.0:
            for _ in range(3):
                ghat = g_lin / np.linalg.norm(g_lin)
                a0 = (np.array([1.0, 0.0, 0.0]) if abs(ghat[0]) < 0.9
                      else np.array([0.0, 1.0, 0.0]))
                b1 = np.cross(ghat, a0)
                b1 /= np.linalg.norm(b1)
                b2 = np.cross(ghat, b1)
                Tn = np.stack([b1, b2], axis=1)
                A, b = _align_rows_inv(g_base=ghat, tangent=Tn,
                                       inv_s_prev=inv_s)
                x_c, *_ = np.linalg.lstsq(A, b, rcond=None)
                if not np.isfinite(x_c).all() or x_c[-1] <= 1e-9:
                    break
                inv_s = float(x_c[-1])
                g_new = G_NORM * (ghat + Tn @ x_c[3 * K : 3 * K + 2])
                g_lin = G_NORM * g_new / np.linalg.norm(g_new)
                x_lin = x_c
            # scale observability: posterior std of inv_s from the final
            # constrained system. Under constant-velocity motion (the
            # vehicle/KITTI regime) the accelerometer sees only gravity,
            # the inv_s column is near-null, and lstsq extrapolates
            # garbage — callers defer the init on a large relative sigma.
            resid = A @ x_lin - b
            dof_n = max(len(b) - A.shape[1], 1)
            resid_var = float(resid @ resid) / dof_n
            try:
                cov_ss = float(np.linalg.inv(A.T @ A)[-1, -1]) * resid_var
                scale_sigma_rel = float(
                    np.sqrt(max(cov_ss, 0.0)) / max(abs(inv_s), 1e-12))
            except np.linalg.LinAlgError:
                scale_sigma_rel = np.inf
        s_seed = 1.0 / inv_s if inv_s > 1e-9 else np.inf
        v_metric = x_lin[: 3 * K].reshape(K, 3) * (
            s_seed if np.isfinite(s_seed) else 0.0)
    else:
        A, b = _align_rows()
        x_lin, *_ = np.linalg.lstsq(A, b, rcond=None)
        g_lin = x_lin[3 * K : 3 * K + 3]
        if np.isfinite(g_lin).all() and np.linalg.norm(g_lin) > 1.0:
            for _ in range(3):
                ghat = g_lin / np.linalg.norm(g_lin)
                a0 = (np.array([1.0, 0.0, 0.0]) if abs(ghat[0]) < 0.9
                      else np.array([0.0, 1.0, 0.0]))
                b1 = np.cross(ghat, a0)
                b1 /= np.linalg.norm(b1)
                b2 = np.cross(ghat, b1)
                Tn = np.stack([b1, b2], axis=1)
                A, b = _align_rows(g_base=G_NORM * ghat, tangent=Tn)
                x_c, *_ = np.linalg.lstsq(A, b, rcond=None)
                if not np.isfinite(x_c).all():
                    break
                g_new = G_NORM * ghat + Tn @ x_c[3 * K : 3 * K + 2]
                g_lin = G_NORM * g_new / np.linalg.norm(g_new)
                x_lin = x_c
        s_seed = 1.0
        v_metric = x_lin[: 3 * K].reshape(K, 3)
    if (not np.isfinite(s_seed) or s_seed < 1e-3
            or not np.isfinite(g_lin).all()
            or np.linalg.norm(g_lin) < 1.0):
        # degenerate geometry: fall back to the reference's dV-sum gravity
        # heuristic (LocalMapping.cpp:391-407) and a unit scale
        s_seed = 1.0
        dV_sum = dV_m.sum(axis=0)
        g_lin = -dV_sum / max(np.linalg.norm(dV_sum), 1e-9) * 9.8
        v_metric = np.zeros((K, 3))
    R_wg0 = _gravity_r_wg0(g_lin / np.linalg.norm(g_lin))
    if (with_scale and skip_lm_above is not None
            and scale_sigma_rel > skip_lm_above):
        # the caller will defer on this sigma anyway: skip the (host-LM)
        # refinement — the init is retried at EVERY new keyframe, and the
        # 60-iteration forward-difference LM is the expensive part
        return {"v": v_metric / max(s_seed, 1e-9), "bg": bg_seed,
                "ba": np.zeros(3), "R_wg": R_wg0, "scale": s_seed,
                "cost0": float("nan"), "cost": float("nan"),
                "scale_sigma_rel": scale_sigma_rel}
    ls0 = np.log(s_seed)

    # --- f64 LM refine over [v_vis(3K), bg(3), ba(3), theta(2)] --------
    # The LOG-SCALE IS FROZEN at the linear seed: the LM objective has s
    # multiplying the noisy visual displacements, i.e. the same errors-in-
    # variables structure the inverse-regression seed was built to avoid —
    # letting the LM move ls drags the unbiased seed back toward the
    # attenuated optimum (measured on the corridor: seed 17.9 -> LM 16.3
    # against a true 19.8). Biases, velocities and the gravity tangent
    # stay free; they are what the LM is for.
    G_vec = np.array([0.0, 0.0, -9.8])
    sp_g, sp_a = np.sqrt(prior_g), np.sqrt(prior_a)
    dim = 3 * K + 8
    bg0_e, ba0_e = edge.bg0, edge.ba0
    JRg, JVg, JVa = edge.JRg, edge.JVg, edge.JVa
    JPg, JPa = edge.JPg, edge.JPa

    def unpack(x):
        v = x[: 3 * K].reshape(K, 3)
        bg = x[3 * K : 3 * K + 3]
        ba = x[3 * K + 3 : 3 * K + 6]
        theta = x[3 * K + 6 : 3 * K + 8]
        return v, bg, ba, theta, 0.0  # ls frozen at the seed (see above)

    def residual(x, L_w, ls_base=0.0):
        v, bg, ba, theta, ls = unpack(x)
        s = np.exp(ls + ls_base)
        R_wg = R_wg0 @ _np_exp_so3(np.array([theta[0], theta[1], 0.0]))
        g = R_wg @ G_vec
        out = np.empty(9 * E + 6)
        for i in range(E):
            db_g = bg - bg0_e[i]
            db_a = ba - ba0_e[i]
            dR_c = dR_m[i] @ _np_exp_so3(JRg[i] @ db_g)
            dV_c = dV_m[i] + JVg[i] @ db_g + JVa[i] @ db_a
            dP_c = dP_m[i] + JPg[i] @ db_g + JPa[i] @ db_a
            Rt = Rs[i].T
            dt = float(dts[i])
            er = _np_log_so3(dR_c.T @ Rt @ Rs[i + 1])
            ev = Rt @ (s * (v[i + 1] - v[i]) - g * dt) - dV_c
            ep = Rt @ (s * (ps[i + 1] - ps[i] - v[i] * dt)
                       + lever[i] - 0.5 * g * dt * dt) - dP_c
            out[9 * i : 9 * i + 9] = L_w[i] @ np.concatenate([er, ev, ep])
        out[9 * E : 9 * E + 3] = sp_g * bg
        out[9 * E + 3 :] = sp_a * ba
        return out

    x = np.zeros(dim)
    x[: 3 * K] = (v_metric / s_seed).reshape(-1)
    x[3 * K : 3 * K + 3] = bg_seed

    # s = exp(ls0) fixed: rebase by adding ls0 inside the residual's scale
    def residual_rebased(x, L_w):
        return residual(x, L_w, ls_base=ls0 if with_scale else 0.0)

    # Empirical whitening floor: the IMU-only information treats visual KF
    # pose noise (mm-level in metric once scaled) as hundreds of sigma —
    # the whitened MAP optimum then trades true scale against a gravity
    # tilt (measured: scale off 2.5x with a perfect-shape visual map).
    # The linear-alignment residual IS the actual per-block error level,
    # so scale each 3-row block of L_inv down to put the seed at ~1 sigma;
    # clean data (whitened seed already <= 1 sigma) keeps the reference's
    # pure-IMU weighting (alpha = 1).
    w_seed = residual_rebased(x, L_inv)[: 9 * E].reshape(E, 9)
    L_eff = L_inv.copy()
    for b in range(3):
        rms = float(np.sqrt((w_seed[:, 3 * b : 3 * b + 3] ** 2).mean()))
        L_eff[:, 3 * b : 3 * b + 3, :] /= max(1.0, rms)

    r = residual_rebased(x, L_eff)
    cost0 = cost = float(r @ r)
    lam = 1e-4
    for _ in range(n_iters):
        # forward-difference Jacobian (dim <= ~100, E <= ~60: microseconds)
        J = np.empty((r.size, dim))
        h = 1e-7
        for j in range(dim):
            xj = x.copy()
            xj[j] += h
            J[:, j] = (residual_rebased(xj, L_eff) - r) / h
        H = J.T @ J
        grad = J.T @ r
        ok_step = False
        for _try in range(8):
            D = np.diag(np.maximum(np.diag(H), 1e-12))
            try:
                step = -np.linalg.solve(H + lam * D, grad)
            except np.linalg.LinAlgError:
                lam *= 10.0
                continue
            x_new = x + step
            r_new = residual_rebased(x_new, L_eff)
            c_new = float(r_new @ r_new)
            if c_new < cost:
                x, r, cost = x_new, r_new, c_new
                lam = max(lam * 0.3, 1e-12)
                ok_step = True
                break
            lam *= 10.0
        if not ok_step or (np.linalg.norm(step) < 1e-12):
            break

    v, bg, ba, theta, ls = unpack(x)
    s = float(np.exp(ls + (ls0 if with_scale else 0.0)))
    R_wg = R_wg0 @ _np_exp_so3(np.array([theta[0], theta[1], 0.0]))
    return {"v": v, "bg": bg, "ba": ba, "R_wg": R_wg, "scale": s,
            "cost0": cost0, "cost": cost,
            "scale_sigma_rel": scale_sigma_rel}



# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _identity_edge_batch(E: int) -> PreintEdge:
    """E identity edges as numpy (`_identity_edge` broadcast): the
    placeholders of a window's unused edge rows, made on the host."""
    f32 = np.float32
    z3 = np.zeros((E, 3), f32)
    z33 = np.zeros((E, 3, 3), f32)
    return PreintEdge(
        dR=np.tile(np.eye(3, dtype=f32), (E, 1, 1)), dV=z3, dP=z3.copy(),
        JRg=z33, JVg=z33.copy(), JVa=z33.copy(), JPg=z33.copy(), JPa=z33.copy(),
        bg0=z3.copy(), ba0=z3.copy(), dt=np.ones(E, f32),
        L_inv=np.tile(np.eye(9, dtype=f32), (E, 1, 1)))


def _pad_kf(x: np.ndarray, n: int) -> np.ndarray:
    if n <= 0:
        return np.zeros((0, *x.shape[1:]), x.dtype)
    if x.ndim == 3:  # rotations: pad with identity
        return np.tile(np.eye(3, dtype=x.dtype), (n, 1, 1))
    return np.zeros((n, *x.shape[1:]), x.dtype)


def _renormalize(R: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(R)
    out = U @ Vt
    if np.linalg.det(out) < 0:
        U[:, -1] *= -1
        out = U @ Vt
    return out.astype(np.float32)


def _upload_arrays(arrays, device: torch.device) -> list:
    """numpy arrays -> tensors on `device` with one copy per kind: float32,
    int64 (from any integer type) and bool arrays are each packed into one
    buffer, copied (to the card from pinned memory, without a host wait)
    and split into views, so a problem of many fields costs three copies,
    not one a field."""
    kinds = {"f": (np.float32, torch.float32), "i": (np.int64, torch.int64),
             "b": (np.uint8, torch.uint8)}
    groups = {k: [] for k in kinds}
    tags = []
    for a in arrays:
        a = np.asarray(a)
        kind = "b" if a.dtype == bool else ("i" if np.issubdtype(a.dtype, np.integer) else "f")
        tags.append((kind, len(groups[kind]), a.shape))
        groups[kind].append(a)
    flat = {}
    for kind, items in groups.items():
        if not items:
            continue
        np_t, _ = kinds[kind]
        buf = torch.from_numpy(np.concatenate([np.asarray(a, np_t).reshape(-1) for a in items]))
        if device.type == "cuda":
            buf = buf.pin_memory().to(device, non_blocking=True)
        sizes = [int(np.prod(a.shape)) for a in items]
        flat[kind] = torch.split(buf, sizes)
    out = []
    for kind, i, shape in tags:
        t = flat[kind][i].reshape(shape)
        out.append(t.view(torch.bool) if kind == "b" else t)
    return out


def upload_inputs(arrays, device: torch.device) -> list:
    """A stage's host inputs -> tensors on `device` (`_upload_arrays`: one
    pinned copy per kind, no host wait), uint32 descriptors as their int32
    view and every integer array as int32, the dtypes the stages take."""
    host = [np.asarray(a) for a in arrays]
    up = _upload_arrays([a.view(np.int32) if a.dtype == np.uint32 else a for a in host], device)
    return [t.to(torch.int32) if np.issubdtype(a.dtype, np.integer) else t
            for a, t in zip(host, up)]


def _upload_problem(host: BAProblem, device: torch.device) -> BAProblem:
    """A numpy BAProblem (prior_ref is its kf) -> the same problem on
    `device`, in three copies (`_upload_arrays`)."""
    fields = [f for f in BAProblem._fields if f not in ("kf", "ie_edge", "prior_ref")]
    arrays = list(host.kf) + list(host.ie_edge) + [getattr(host, f) for f in fields]
    up = _upload_arrays(arrays, device)
    kf = KfState(*up[:5])
    edge = PreintEdge(*up[5:17])
    return BAProblem(kf=kf, ie_edge=edge, prior_ref=kf, **dict(zip(fields, up[17:])))
