"""LocalMapping: keyframe processing, triangulation, culling, BA, IMU init
(counterpart of `monoorbslam3_tpu/frontend/local_mapping.py`).

The analog of the reference mapper thread (modules/Frontend/
LocalMapping.cpp:19-656) as an explicit `process(kf_id)` step, which the
tracker's keyframe hook drives (synchronously, as the JAX package's
System does by default). Stages map 1:1:

- process_new_keyframe   <- processNewKeyFrame (.cpp:88-115)
- cull_map_points        <- MapPointCulling (.cpp:117-144), with the
  graduation gate
- create_new_map_points  <- createNewMapPoints (.cpp:146-259): the epipolar
  search, DLT and acceptance gates fused into `_triangulate_pair_kernel`,
  dispatched for every neighbour, then ONE fetch
- fuse_neighbors         <- searchInNeighbors (.cpp:261-316): every
  `_fuse_project_kernel` dispatched, then ONE fetch
- the BA dispatch        <- .cpp:44-54 (the visual local BA before the IMU
  init, the visual-inertial window after), through `Problems`
- initialize_imu         <- initializeIMU (.cpp:374-482), priors 1e6/1e12,
  the scale < 0.1 abort
- refine_gravity         <- gravityRefinement (.cpp:484-504)
- cull_keyframes         <- KeyFrameCulling, 90% redundancy (.cpp:318-372)

Both searches rest on the dense Hamming block (`matching.hamming_matrix`,
the hand kernel K3 on a CUDA tensor) under `masked_nn_match`. Each
dispatch uploads its host inputs as one packed buffer per kind
(`problems.upload_inputs`); the mapper's fetches count on
`problems.syncs`. The async mapper and the reset archive belong to
`System`.
"""

from __future__ import annotations

import logging
from contextlib import nullcontext

import numpy as np
import torch

from .. import native
from ..backend.problems import upload_inputs
from ..ops import matching
from ..ops.twoview import triangulate_dlt
from ..utils import lie
from ..utils.fetch import fetch

log = logging.getLogger("monoorbslam3_tpu_torch.mapper")

IMU_NOT_INIT = 0
IMU_INITIALIZED = 1
IMU_FINISHED = 2


def _triangulate_pair_kernel(
    xy1, desc1, valid1, sigma2_1,
    xy2, desc2, valid2, sigma2_2,
    camera, R_cw1, t_cw1, R_cw2, t_cw2,
    group1=None, group2=None,
):
    """Match unmatched features of two KFs under an epipolar gate (and the
    shared-vocabulary-node gate when groups are given), triangulate, and
    apply the acceptance gates (LocalMapping.cpp:146-259): positive depth
    in both views, parallax cos < 0.9998, reprojection chi2 < 5.991 in
    both views, scale consistency and a finite point.

    Returns (match_idx [N1] int32 into KF2 (-1 = none), points [N1, 3]
    world, accept [N1] bool)."""
    R21 = R_cw2 @ R_cw1.T
    t21 = t_cw2 - R21 @ t_cw1
    E = lie.hat(t21) @ R21

    m1 = camera.back_project(xy1)  # [N1, 3] normalized (x/z, y/z, 1)
    m2 = camera.back_project(xy2)
    l2 = m1 @ E.T  # epipolar lines of KF1 rays in cam-2 normalized coords
    num = m2 @ E @ m1.T  # [N2, N1]
    # normalized-coord line distance scaled by the focal length ~= pixels
    f2 = 0.25 * (camera.fx + camera.fy) ** 2
    d2 = f2 * (num.T ** 2) / torch.clamp(l2[:, 0] ** 2 + l2[:, 1] ** 2, min=1e-12)[:, None]
    epi_ok = d2 < 3.84 * sigma2_2[None, :]

    pair_mask = valid1[:, None] & valid2[None, :] & epi_ok
    if group1 is not None and group2 is not None:
        pair_mask &= matching.node_gate(group1, group2)
    idx, _ = matching.masked_nn_match(
        matching.hamming_matrix(desc1, desc2), pair_mask,
        max_dist=matching.TH_LOW, ratio=0.9, mutual=True,
    )
    hit = idx >= 0
    safe_idx = torch.clamp(idx, min=0).long()
    xy2_m = xy2[safe_idx]

    P1 = torch.cat([R_cw1, t_cw1[:, None]], dim=1)  # normalized cameras
    P2 = torch.cat([R_cw2, t_cw2[:, None]], dim=1)
    X = triangulate_dlt(P1, P2, m1[:, :2] / m1[:, 2:],
                        (m2[:, :2] / m2[:, 2:])[safe_idx])  # world frame

    O1 = -R_cw1.T @ t_cw1
    O2 = -R_cw2.T @ t_cw2
    n1 = X - O1
    n2 = X - O2
    cos_par = torch.sum(n1 * n2, -1) / torch.clamp(
        torch.linalg.norm(n1, dim=-1) * torch.linalg.norm(n2, dim=-1), min=1e-12)
    pc1 = X @ R_cw1.T + t_cw1
    pc2 = X @ R_cw2.T + t_cw2
    z_ok = (pc1[:, 2] > 0.05) & (pc2[:, 2] > 0.05)

    def reproj(pc, xy, s2):
        uv = camera.project(pc)
        return torch.sum((uv - xy) ** 2, dim=-1) / s2

    e1 = reproj(pc1, xy1, sigma2_1)
    e2 = reproj(pc2, xy2_m, sigma2_2[safe_idx])

    # scale consistency: distance ratio within the octave band (.cpp:236-247)
    d_1 = torch.linalg.norm(n1, dim=-1)
    d_2 = torch.linalg.norm(n2, dim=-1)
    ratio = d_1 / torch.clamp(d_2, min=1e-9)
    s_ratio = torch.sqrt(sigma2_1 / torch.clamp(sigma2_2[safe_idx], min=1e-9))
    scale_ok = (ratio < s_ratio * 2.0) & (ratio * 2.0 > s_ratio / 1.0)

    accept = (hit & z_ok & (cos_par < 0.9998) & (e1 < 5.991) & (e2 < 5.991)
              & scale_ok & torch.all(torch.isfinite(X), dim=-1))
    return idx, X, accept


def _fuse_project_kernel(pt_xyz, pt_desc, pt_valid, xy, desc, valid, sigma2,
                         camera, R_cw, t_cw, radius_scale):
    """Project map points into a KF and find the best feature within
    `radius_scale` pixels (the Fuse projection search, ORBMatcher.cpp:
    524-592). Returns idx [P] int32 into the KF's features (-1 = none)."""
    del sigma2  # part of the JAX signature; the fuse gate does not read it
    pc = pt_xyz @ R_cw.T + t_cw
    z_ok = pc[:, 2] > 0.05
    uv = camera.project(pc)
    radius = torch.full((pt_xyz.shape[0],), float(radius_scale),
                        dtype=torch.float32, device=pt_xyz.device)
    mask = matching.projection_mask(uv, z_ok & pt_valid, xy, valid, radius)
    idx, _ = matching.masked_nn_match(
        matching.hamming_matrix(pt_desc, desc), mask,
        max_dist=matching.TH_LOW, ratio=1.0, mutual=False, use_ratio=False,
    )
    return idx


class LocalMapping:
    """The mapper on the device of `problems` (the card unless the caller
    built `Problems(..., device="cpu")`), with every knob and default of
    the JAX package's `LocalMapping`."""

    def __init__(self, store, problems, calib, tracking, config=None):
        self.store = store
        self.problems = problems
        self.calib = calib
        self.tracking = tracking
        self.device = problems.device
        self.syncs = problems.syncs
        cfg = config or {}
        self.imu_init_kfs = cfg.get("imu_init_kfs", 16)
        # minimum trajectory span before the inertial init fires (see the
        # JAX module for the measurement behind 2 s)
        self.imu_init_min_span = cfg.get("imu_init_min_span", 2.0)
        self.gravity_refine_delay = cfg.get("gravity_refine_delay", 3.0)
        # how long after the init a refinement may still apply a scale
        # correction (late corrections measure drift shear)
        self.scale_correct_window = cfg.get("scale_correct_window", 12.0)
        # periodic visual-inertial maintenance refinement; 0 disables
        self.vi_refine_interval = cfg.get("vi_refine_interval", 3.0)
        self.last_vi_refine = None
        self.triangulate_neighbors = cfg.get("triangulate_neighbors", 8)
        self.window = cfg.get("local_ba_window", 10)
        # graduation gate: cull points still at > 20% relative depth
        # uncertainty after the young-point window
        self.graduation_rel_sigma = cfg.get("graduation_rel_sigma", 0.2)
        self.scale_factors = cfg.get(
            "scale_factors", np.array([1.2**i for i in range(8)], np.float32))
        self.imu_state = IMU_NOT_INIT
        self.imu_init_time = None
        self.recent_points: list[tuple[int, int]] = []  # (pt_id, birth_kf_count)
        self.kf_counter = 0
        self.last_info = {}
        # the map_update_mutex analog; a synchronous mapper needs none
        self.map_lock = nullcontext()
        self._R_cb = calib.R_cb.cpu().numpy()
        self._t_cb = calib.t_cb.cpu().numpy()
        self._t_bc = calib.t_bc.cpu().numpy()

    # ------------------------------------------------------------------

    def process(self, k: int, initial: bool = False, light: bool = False):
        """One mapper step for a freshly inserted keyframe: the window BA
        first (the fresh KF's tracked pose is refined before it
        triangulates), then triangulation and fuse, then a 4-iteration
        polish when there are new points; then the inertial init, the
        gravity refinements and KF culling. light=True (the async drain
        mode) runs only the per-KF stages, plus one short visual BA before
        the IMU init. The JAX module gives the measurements behind both
        orders."""
        lock = self.map_lock
        self.kf_counter += 1
        with lock:
            self.process_new_keyframe(k)
            if initial:
                return
            self.cull_map_points()
        if light:
            with lock:
                self.create_new_map_points(k)
                self.fuse_neighbors(k)
            if self.imu_state == IMU_NOT_INIT and self.store.n_keyframes() >= 3:
                self.last_info = self.problems.local_bundle_adjustment(
                    self.store, k, window=self.window, n_iters=4, lock=lock)
            return

        def run_ba(n_iters):
            if self.store.n_keyframes() < 3:
                return {}
            if self.imu_state == IMU_NOT_INIT:
                return self.problems.local_bundle_adjustment(
                    self.store, k, window=self.window, n_iters=n_iters, lock=lock)
            return self.problems.local_full_bundle_adjustment(
                self.store, window=self.window, n_iters=n_iters, lock=lock)

        self.last_info = run_ba(8)
        with lock:
            n_new = self.create_new_map_points(k)
            self.fuse_neighbors(k)
        if n_new:
            self.last_info = run_ba(4)  # polish the freshly triangulated points

        # the monotonic KF id, not the live (culled) count (the reference
        # keys on KeyFrame::id, LocalMapping.cpp:57-60)
        if (self.imu_state == IMU_NOT_INIT
                and self.store.kf_created_total > self.imu_init_kfs
                and self._kf_span() >= self.imu_init_min_span):
            with lock:
                self.initialize_imu()
        elif (self.imu_state == IMU_INITIALIZED
              and self.imu_init_time is not None
              and self.store.kf_time[k] - self.imu_init_time > self.gravity_refine_delay):
            with lock:
                self.refine_gravity()
        elif (self.imu_state == IMU_FINISHED
              and self.vi_refine_interval > 0
              and self.last_vi_refine is not None
              and self.store.kf_time[k] - self.last_vi_refine > self.vi_refine_interval):
            # periodic maintenance refinement (the analog of ORB-SLAM3's
            # repeated VI full-BA passes after initialization)
            with lock:
                self.refine_gravity()

        with lock:
            self.cull_keyframes(k)

    # ------------------------------------------------------------------

    def process_new_keyframe(self, k: int):
        """Attach observations + refresh point stats (processNewKeyFrame)."""
        store = self.store
        pids = store.kf_feat_pt[k]
        pids = np.unique(pids[pids >= 0])
        store.update_point_stats(pids, self._R_cb, self._t_cb, self.scale_factors)

    def cull_map_points(self):
        """Found-ratio < 0.25 or under-observed young points
        (MapPointCulling), plus the graduation gate: a point leaving the
        young-point window whose along-ray depth uncertainty is still above
        `graduation_rel_sigma` of its depth (pt_max_dist stands in for z)."""
        store = self.store
        keep = []
        for pid, birth in self.recent_points:
            if not store.pt_valid[pid]:
                continue
            age = self.kf_counter - birth
            found_ratio = store.pt_found[pid] / max(store.pt_visible[pid], 1)
            if found_ratio < 0.25:
                store.remove_point(pid)
            elif age >= 2 and store.pt_n_obs[pid] <= 2:
                store.remove_point(pid)
            elif age >= 3:
                rel_sigma = store.pt_sigma_z[pid] / max(store.pt_max_dist[pid], 1e-6)
                if rel_sigma > self.graduation_rel_sigma:
                    store.remove_point(pid)
                continue  # graduated (or culled as geometric junk)
            else:
                keep.append((pid, birth))
        self.recent_points = keep

    def create_new_map_points(self, k: int):
        """Triangulate against the covisible KFs (createNewMapPoints): every
        neighbour's search dispatched (KF k's arrays uploaded once, each
        neighbour's in one buffer), then one fetch of all results."""
        store = self.store
        neighbors = store.covisible_keyframes(k, top=self.triangulate_neighbors)
        if not neighbors:
            neighbors = [j for j in store.recent_keyframes(3) if j != k]
        R_cw1, t_cw1 = store.kf_pose_cw(k, self._R_cb, self._t_cb)

        # unmatched features of KF k (a snapshot of the pre-round state; the
        # per-feature guards below keep double assignments out)
        free1 = store.kf_feat_valid[k] & (store.kf_feat_pt[k] < 0)
        n_new = 0
        side1 = None
        dispatched = []
        for j in neighbors:
            if j == k:
                continue
            # baseline check against the scene depth (LocalMapping.cpp:166-171)
            R_cw2, t_cw2 = store.kf_pose_cw(j, self._R_cb, self._t_cb)
            baseline = np.linalg.norm((-R_cw2.T @ t_cw2) - (-R_cw1.T @ t_cw1))
            med_depth = self._median_depth(j)
            if med_depth > 0 and baseline / med_depth < 0.01:
                continue
            if side1 is None:
                side1 = upload_inputs(
                    (store.kf_feat_xy[k], store.kf_feat_desc[k], free1, store.kf_feat_sigma2[k],
                     store.kf_feat_group[k], R_cw1.astype(np.float32), t_cw1.astype(np.float32)),
                    self.device)
            xy1, desc1, v1, s1, g1, R1, t1 = side1
            free2 = store.kf_feat_valid[j] & (store.kf_feat_pt[j] < 0)
            xy2, desc2, v2, s2, g2, R2, t2 = upload_inputs(
                (store.kf_feat_xy[j], store.kf_feat_desc[j], free2, store.kf_feat_sigma2[j],
                 store.kf_feat_group[j], R_cw2.astype(np.float32), t_cw2.astype(np.float32)),
                self.device)
            out = _triangulate_pair_kernel(xy1, desc1, v1, s1, xy2, desc2, v2, s2,
                                           self.problems.camera, R1, t1, R2, t2, g1, g2)
            dispatched.append((j, out))
        if not dispatched:
            return 0
        results = fetch([out for _, out in dispatched], self.syncs)
        for (j, _), (idx, X, accept) in zip(dispatched, results):
            for f1 in np.nonzero(accept)[0]:
                if store.kf_feat_pt[k, f1] >= 0:
                    continue  # matched by an earlier neighbour this round
                f2 = int(idx[f1])
                if store.kf_feat_pt[j, f2] >= 0:
                    continue
                p = store.add_point(X[f1], store.kf_feat_desc[k, f1], k)
                store.add_observation(p, k, int(f1))
                store.add_observation(p, j, f2)
                self.recent_points.append((p, self.kf_counter))
                n_new += 1
        if n_new:
            pids = store.kf_feat_pt[k]
            store.update_point_stats(np.unique(pids[pids >= 0]), self._R_cb, self._t_cb,
                                     self.scale_factors)
        return n_new

    def _dispatch_fuse(self, pids, j: int, radius: float = 4.0):
        """Dispatch the fuse projection search for KF j (no read): one
        upload of the points and KF j's features. Returns (ids, device
        idx) for `_apply_fuse` after the round's fetch."""
        store = self.store
        cap = store.n_feat
        P = np.zeros((cap, 3), np.float32)
        D = np.zeros((cap, 8), np.uint32)
        V = np.zeros(cap, bool)
        ids = np.full(cap, -1, np.int64)
        n = min(len(pids), cap)
        P[:n] = store.pt_xyz[pids[:n]]
        D[:n] = store.pt_desc[pids[:n]]
        V[:n] = store.pt_valid[pids[:n]]
        ids[:n] = pids[:n]
        R_cw, t_cw = store.kf_pose_cw(j, self._R_cb, self._t_cb)
        up = upload_inputs((P, D, V, store.kf_feat_xy[j], store.kf_feat_desc[j],
                            store.kf_feat_valid[j], store.kf_feat_sigma2[j],
                            R_cw.astype(np.float32), t_cw.astype(np.float32)), self.device)
        idx = _fuse_project_kernel(*up[:7], self.problems.camera, up[7], up[8], radius)
        return ids, idx

    def _apply_fuse(self, ids, idx, j: int):
        """Host-side application of one fuse result; the guards re-check the
        live store, so results from a pre-round snapshot stay safe."""
        store = self.store
        n_fused = 0
        for i in np.nonzero(idx >= 0)[0]:
            p = int(ids[i])
            if p < 0 or not store.pt_valid[p]:
                continue
            f = int(idx[i])
            q = int(store.kf_feat_pt[j, f])
            if q >= 0 and store.pt_valid[q]:
                if q != p:
                    # keep the better-observed point (MapPoint::replace)
                    if store.pt_n_obs[q] >= store.pt_n_obs[p]:
                        store.replace_point(p, q)
                    else:
                        store.replace_point(q, p)
                    n_fused += 1
            else:
                # never a second observation of p in KF j
                already = j in store.pt_obs_kf[p, : store.pt_n_obs[p]]
                if not already:
                    store.add_observation(p, j, f)
                    n_fused += 1
        return n_fused

    def fuse_neighbors(self, k: int):
        """Two-way fuse with the covisible neighbourhood (searchInNeighbors,
        LocalMapping.cpp:261-316): the new KF's points into each neighbour
        (the top-10 covisible plus each one's top-5, the reference's two
        hops), and the neighbours' points back into the new KF. Every
        search is dispatched first, then ONE fetch."""
        store = self.store
        first = store.covisible_keyframes(k, top=10)
        neighbors = list(first)
        seen = set(first) | {k}
        for j in first:
            for j2 in store.covisible_keyframes(j, top=5):
                if j2 not in seen:
                    seen.add(j2)
                    neighbors.append(j2)

        pids_k = store.kf_feat_pt[k]
        pids_k = np.unique(pids_k[pids_k >= 0])
        calls = []
        if len(pids_k):
            for j in neighbors:
                ids, idx = self._dispatch_fuse(pids_k, j)
                calls.append((ids, idx, j))

        # reverse: the union of the neighbours' points -> the current KF
        if neighbors:
            neigh_pts = store.kf_feat_pt[np.asarray(neighbors)]
            pids_n = np.unique(neigh_pts[neigh_pts >= 0])
            pids_n = pids_n[store.pt_valid[pids_n]]
            attached = set(pids_k.tolist())
            pids_n = np.asarray([p for p in pids_n if p not in attached], np.int64)
            if len(pids_n):
                ids, idx = self._dispatch_fuse(pids_n, k)
                calls.append((ids, idx, k))

        if not calls:
            return
        fetched = fetch([idx for _, idx, _ in calls], self.syncs)
        for (ids, _, j), idx in zip(calls, fetched):
            self._apply_fuse(ids, idx, j)

    def _kf_span(self) -> float:
        """Time span covered by the surviving keyframe set."""
        ids = self.store.keyframe_ids()
        if len(ids) < 2:
            return 0.0
        return float(self.store.kf_time[ids[-1]] - self.store.kf_time[ids[0]])

    def _median_depth(self, k: int) -> float:
        store = self.store
        pids = store.kf_feat_pt[k]
        pids = pids[pids >= 0]
        if len(pids) < 5:
            return -1.0
        R_cw, t_cw = store.kf_pose_cw(k, self._R_cb, self._t_cb)
        z = (store.pt_xyz[pids] @ R_cw.T + t_cw)[:, 2]
        return float(np.median(z))

    # ------------------------------------------------------------------
    # IMU initialization (LocalMapping.cpp:374-504)
    # ------------------------------------------------------------------

    def initialize_imu(self, prior_g=1e6, prior_a=1e12):
        store = self.store
        out = self.problems.inertial_optimize(store, prior_g=prior_g, prior_a=prior_a)
        if out is None:
            return False
        scale = out["scale"]
        if scale < 0.1:  # degenerate init (LocalMapping.cpp:435-439)
            return False
        log.warning("inertial init ACCEPTED: scale %.3f (rel sigma %.3f), cost %.1f -> %.1f, "
                    "%d KFs spanning %.1f s", scale, out.get("scale_sigma_rel", float("nan")),
                    out.get("cost0", float("nan")), out.get("cost", float("nan")),
                    store.n_keyframes(), self._kf_span())
        # gauge rewrite: gravity onto -z, scale to metric
        # (Map::applyScaleRotation + Tracking::updateFrameIMU)
        store.apply_scale_rotation(out["R_wg"].T, scale, t_bc=self._t_bc)
        self.imu_state = IMU_INITIALIZED
        self.imu_init_time = store.kf_time[store.keyframe_ids()[-1]]
        self.tracking.imu_ready = True
        self.problems.full_inertial_optimize(store)
        self.tracking.update_after_gauge_change()
        return True

    def refine_gravity(self):
        """gravityRefinement (.cpp:484-504), extended to the residual scale
        within the early post-init window (see the JAX module for the
        dead-band, the authority window and the confidence rule), then the
        full-chain VI polish."""
        store = self.store
        out = self.problems.inertial_optimize(store, prior_g=1e8, prior_a=1e12,
                                              with_scale=True)
        if out is None:
            # scale currently unobservable: refine the direction only
            out = self.problems.inertial_optimize(store, prior_g=1e8, prior_a=1e12,
                                                  with_scale=False)
        if out is not None:
            scale = out["scale"]
            sig_rel = out.get("scale_sigma_rel", np.inf)
            est = scale
            early = (self.imu_init_time is not None
                     and store.kf_time[store.keyframe_ids()[-1]] - self.imu_init_time
                     <= self.scale_correct_window)
            if abs(scale - 1.0) < 0.08:
                scale = 1.0  # dead-band: direction only (the reference's)
            elif not early:
                scale = 1.0
            elif not (0.5 < scale < 2.0) and not (sig_rel < 0.1 and 0.02 < scale < 50.0):
                scale = 1.0  # a big correction, but not confidently observed
            log.warning("VI refine: scale est %.3f (rel sigma %.3f) -> applied %.3f%s", est,
                        sig_rel, scale, "" if scale != 1.0 else " (direction-only)")
            store.apply_scale_rotation(out["R_wg"].T, scale, t_bc=self._t_bc)
            self.tracking.update_after_gauge_change()
            self.problems.full_inertial_optimize(store)
        self.imu_state = IMU_FINISHED
        ids = store.keyframe_ids()
        self.last_vi_refine = store.kf_time[ids[-1]] if ids else None

    # ------------------------------------------------------------------

    def cull_keyframes(self, current: int):
        """90% redundancy rule (KeyFrameCulling, LocalMapping.cpp:318-372)
        over the current KF's covisible neighbours, never while the map is
        young (< 8 KFs) or before the IMU init, never the 4 newest or the
        first KF."""
        store = self.store
        if store.n_keyframes() < 8:
            return
        if self.imu_state == IMU_NOT_INIT:
            return  # the inertial init needs the whole pre-init chain
        order = store.keyframe_ids()
        protect = set(store.recent_keyframes(4))
        candidates = [k for k in store.covisible_keyframes(current, top=30)
                      if k not in protect and k != order[0]]
        for k in candidates:
            if k == current:
                continue
            checked, redundant = native.redundancy_count(
                store.kf_feat_pt[k], store.kf_feat_level[k], store.pt_obs_kf,
                store.pt_obs_feat, store.pt_n_obs, store.kf_feat_level, k)
            if checked < 10:
                continue
            if redundant > 0.9 * checked:
                store.remove_keyframe(k)
