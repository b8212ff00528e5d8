"""Tracking: the per-frame frontend state machine (counterpart of
`monoorbslam3_tpu/frontend/tracking.py`).

The analog of the reference Tracking thread (modules/Frontend/
Tracking.cpp:69-713): monocular initialization through the two-view
bootstrap, IMU or motion-model pose prediction, coarse tracking (last
frame / last keyframe / reference keyframe), local-map tracking, the
5-state machine (Tracking.h:20-26) and the keyframe policy.

The host/device cut is the JAX package's: the state machine and every
candidate selection are host numpy over the map store; each compute stage
is one chain of device work with no host read inside. The two fused
stages (`_coarse_track_kernel`, `_local_track_kernel`) project the
candidates, run the gated match (K2) at the tight radius AND at the wide
radius, pick one of the two on the device with `torch.where` (the
reference's wide retry, Tracking.cpp:284-314), assemble the per-feature
problem and run the pose LM (visual, or with the inertial edge to the
last keyframe in the local stage). `Tracking` uploads each stage's host
inputs as one packed buffer per kind (`problems.upload_inputs`) and reads
the stage's result with one `utils.fetch.fetch`: one fetch at the frame's
start (features, both preintegrated windows, the IMU deltas), one per
coarse stage and one per local stage, as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from ..backend.problems import _identity_edge, _pose_optimize_impl, upload_inputs, whiten
from ..backend.residuals import KfState, gravity
from ..models.camera import _host_intrinsics, project_np
from ..models.imu import GRAVITY_W as G_W, ImuBuffer
from ..ops import matching
from ..ops.match_pallas import projected_match
from ..ops.twoview import draw_samples, reconstruct_two_views
from ..utils import prng
from ..utils.fetch import fetch
from .frame import Frame, make_frame


def ideal_pixels(camera, xy: torch.Tensor):
    """Keypoints [N, 2] -> (ideal pinhole pixels [N, 2], ray in front [N])
    for the bootstrap's H/F machinery: the identity for a pinhole (its
    keypoints are undistorted), the cv::fisheye::undistortPoints analog for
    KB4, whose stored keypoints stay distorted (Fisheye.cpp:119-139). KB4's
    rays are unit-depth, so a keypoint past 90 degrees from the axis maps
    through a negative tan(theta) to the opposite side, as in the JAX
    package."""
    c = _host_intrinsics(camera)
    r = camera.back_project(xy)
    z = torch.clamp(r[:, 2], min=1e-6)
    uv = torch.stack([c["fx"] * r[:, 0] / z + c["cx"], c["fy"] * r[:, 1] / z + c["cy"]], -1)
    return uv, r[:, 2] > 1e-6


def _predict_deltas(pre, bg, ba):
    """Bias-corrected (dR, dV, dP) of a preintegrated window at (bg, ba),
    on the window's device with no host read: the caller brings them home
    with the stage's one fetch."""
    return (pre.delta_rotation(bg), pre.delta_velocity(bg, ba),
            pre.delta_position(bg, ba))


def _predict_state_inertial(kf, dR, dV, dP, dt):
    """The frame's state predicted from its keyframe's through the IMU (the
    inertial branch of `Tracking._predict_state`), on the keyframe state's
    device with no host read: R = R0 dR, v = v0 + g dt + R0 dV,
    t = t0 + v0 dt + g dt^2 / 2 + R0 dP; the biases are the keyframe's."""
    g = gravity(dR.device)
    R = kf.R_wb @ dR
    v = kf.v + g * dt + kf.R_wb @ dV
    t = kf.t_wb + kf.v * dt + 0.5 * g * dt * dt + kf.R_wb @ dP
    return KfState(R, t, v, kf.bg, kf.ba)


def _project_points(R_wb, t_wb, R_cb, t_cb, xyz, camera):
    """Batched world->pixel projection + visibility."""
    R_cw = R_cb @ R_wb.T
    t_cw = t_cb - R_cw @ t_wb
    pc = xyz @ R_cw.T + t_cw
    uv = camera.project(pc)
    ok = (pc[:, 2] > 0.05) & camera.is_in_image(uv)
    return uv, ok


def _scatter_by_feature(idx, hit, n_feat, cand_xyz, cand_extra2):
    """Scatter per-candidate match results into per-feature problem rows.
    Mutual-NN matching guarantees each feature is hit by <= 1 candidate;
    unmatched candidates write the dropped overflow row n_feat."""
    P = cand_xyz.shape[0]
    dev = cand_xyz.device
    f_t = torch.where(hit, idx, torch.full_like(idx, n_feat)).long()
    pts = torch.zeros((n_feat + 1, 3), dtype=torch.float32, device=dev)
    pts[f_t] = cand_xyz
    extra2 = torch.zeros(n_feat + 1, dtype=torch.float32, device=dev)
    extra2[f_t] = cand_extra2
    vo = torch.zeros(n_feat + 1, dtype=torch.bool, device=dev)
    vo[f_t] = hit
    ci = torch.full((n_feat + 1,), -1, dtype=torch.int32, device=dev)
    ci[f_t] = torch.arange(P, dtype=torch.int32, device=dev)
    vo = vo[:n_feat]
    return (pts[:n_feat], extra2[:n_feat], vo,
            torch.where(vo, ci[:n_feat], torch.full_like(ci[:n_feat], -1)))


def _coarse_track_kernel(state0, cand_xyz, cand_desc, cand_valid, cand_ang,
                         cand_extra2, fr_xy, fr_desc, fr_valid, fr_angle,
                         fr_sigma2, camera, R_cb, t_cb, radius, retry_below,
                         use_rotation=True):
    """The coarse tracking stage: project, two-radius projection match (the
    wide pass selected on the device when the tight pass is weak), rotation-
    consistency filter, per-feature problem assembly, visual pose LM.

    Returns (state, cand_of_feature [N] i32, n_match, n_inliers)."""
    uv, ok = _project_points(state0.R_wb, state0.t_wb, R_cb, t_cb, cand_xyz, camera)
    va = ok & cand_valid

    def match_at(r):
        idx, _ = projected_match(
            cand_desc, fr_desc, uv_a=uv, xy_b=fr_xy, radius=r,
            valid_a=va, valid_b=fr_valid, max_dist=matching.TH_HIGH, ratio=0.9)
        if use_rotation:
            keep = matching.rotation_consistency_mask(
                cand_ang, fr_angle, torch.clamp(idx, min=0).long(), idx >= 0,
                min_keep_frac=0.5)
            idx = torch.where(keep, idx, torch.full_like(idx, -1))
        return idx

    idx1 = match_at(radius)
    idx2 = match_at(radius * 2.0)
    idx = torch.where(torch.sum(idx1 >= 0) < retry_below, idx2, idx1)
    n_match = torch.sum(idx >= 0)

    N = fr_xy.shape[0]
    pts, extra2, vo, ci = _scatter_by_feature(idx, idx >= 0, N, cand_xyz, cand_extra2)
    inv_s2 = 1.0 / (fr_sigma2 + extra2)
    z = KfState.zeros(device=cand_xyz.device)
    state, inlier = _pose_optimize_impl(
        state0, pts, fr_xy, inv_s2, vo, camera, R_cb, t_cb,
        _identity_edge(cand_xyz.device), z, 0.0, z, None,
        use_inertial=False, use_prior=False)
    inl = inlier & vo
    return state, torch.where(inl, ci, torch.full_like(ci, -1)), n_match, torch.sum(inl)


def _local_track_kernel(state0, cand_xyz, cand_desc, cand_valid, cand_normal,
                        cand_use_vcos, cand_extra2, radius, blockrow,
                        coarse_pts, coarse_inv_s2, coarse_valid,
                        fr_xy, fr_desc, fr_valid, fr_sigma2,
                        camera, R_cb, t_cb, t_bc, view_cos_gate, retry_min,
                        edge, last_state, edge_valid, use_inertial):
    """The local-map tracking stage: project, view-cos gate, two-radius match
    (the 2.5x wide pass selected on the device when the tight pass
    re-captures under half the in-view candidates), merge with the coarse
    associations, pose LM: visual, or with `use_inertial` the 15-dim LM
    with the whitened edge `edge` from `last_state` (the last keyframe's
    state) to the frame, scaled by `edge_valid`.

    blockrow[f] = candidate row of the point the coarse stage assigned to
    feature f (-1 none): the coarse association survives unless the local
    search re-matched that same point at a different feature.

    Returns (state, cand_of_feature, keep_coarse, cand_hit, n_inliers)."""
    uv, ok = _project_points(state0.R_wb, state0.t_wb, R_cb, t_cb, cand_xyz, camera)
    center = state0.t_wb + state0.R_wb @ t_bc
    vec = cand_xyz - center
    dist = torch.linalg.norm(vec, dim=1)
    ray = vec / torch.clamp(dist, min=1e-9)[:, None]
    view_cos = torch.sum(ray * cand_normal, dim=1)
    ok = ok & (~cand_use_vcos | (view_cos > view_cos_gate))
    va = ok & cand_valid

    def match_at(r):
        idx, _ = projected_match(
            cand_desc, fr_desc, uv_a=uv, xy_b=fr_xy, radius=r,
            valid_a=va, valid_b=fr_valid, max_dist=matching.TH_HIGH, ratio=0.8)
        return idx

    idx1 = match_at(radius)
    idx2 = match_at(radius * 2.5)
    thresh = torch.clamp(torch.sum(va) // 2, min=retry_min)
    idx = torch.where(torch.sum(idx1 >= 0) < thresh, idx2, idx1)
    hit = idx >= 0

    N = fr_xy.shape[0]
    lpts, lex2, lvo, lci = _scatter_by_feature(idx, hit, N, cand_xyz, cand_extra2)
    br = torch.clamp(blockrow, min=0).long()
    idx_br = idx[br]
    br_matched_elsewhere = ((blockrow >= 0) & (idx_br >= 0)
                            & (idx_br != torch.arange(N, dtype=idx.dtype, device=idx.device)))
    cvalid = coarse_valid & ~br_matched_elsewhere & ~lvo
    pts = torch.where(lvo[:, None], lpts, coarse_pts)
    vo = lvo | cvalid
    inv_s2 = torch.where(lvo, 1.0 / (fr_sigma2 + lex2), coarse_inv_s2)

    z = KfState.zeros(device=cand_xyz.device)
    state, inlier = _pose_optimize_impl(
        state0, pts, fr_xy, inv_s2, vo, camera, R_cb, t_cb,
        edge, last_state, edge_valid, z, None,
        use_inertial=use_inertial, use_prior=False)
    inl = inlier & vo
    return (state, torch.where(lvo & inl, lci, torch.full_like(lci, -1)), cvalid & inl,
            hit, torch.sum(inl))


def _rot_filter(angles_a, angles_b, match_idx, matched):
    """The tracker's rotation histogram for its descriptor searches: off
    when the 3 dominant bins cover under half the matches (no consistent
    signal; see `matching.rotation_consistency_mask`)."""
    return matching.rotation_consistency_mask(angles_a, angles_b, match_idx, matched,
                                              min_keep_frac=0.5)


def _shrink_frame(frame: Frame, priority: np.ndarray, cap: int) -> np.ndarray:
    """Reduce an oversized frame (the 2x initial extractor,
    Tracking.cpp:24) to the tracker/store feature capacity IN PLACE,
    keeping `priority` feature indices (the two-view inliers) first and
    filling with the remaining valid features in extractor order. Returns
    the old->new index map (-1 = dropped). No-op when already within
    capacity."""
    N = len(frame.xy)
    if N <= cap:
        return np.arange(N)
    pri = np.unique(np.asarray(priority, np.int64))
    pri = pri[frame.valid[pri]] if len(pri) else pri
    rest = np.setdiff1d(np.nonzero(frame.valid)[0], pri)
    keep = np.concatenate([pri, rest])[:cap].astype(np.int64)
    idx_map = np.full(N, -1, np.int64)
    idx_map[keep] = np.arange(len(keep))
    for name in ("xy", "level", "angle", "desc", "sigma2"):
        arr = getattr(frame, name)
        new = np.zeros((cap, *arr.shape[1:]), arr.dtype)
        new[: len(keep)] = arr[keep]
        setattr(frame, name, new)
    valid_new = np.zeros(cap, bool)
    valid_new[: len(keep)] = frame.valid[keep]
    frame.valid = valid_new
    if frame.group is not None:
        g = np.full(cap, -1, frame.group.dtype)
        g[: len(keep)] = frame.group[keep]
        frame.group = g
    frame.pt_ids = np.full(cap, -1, np.int64)
    frame._dev = None  # the device copy no longer matches
    return idx_map


def _rot_angle(M: np.ndarray) -> float:
    """Geodesic angle (radians) of a rotation matrix."""
    return float(np.arccos(np.clip((np.trace(M) - 1.0) / 2.0, -1.0, 1.0)))


def _orthonormalize(R: np.ndarray) -> np.ndarray:
    """Exact projection of a near-rotation onto SO(3) (host side, 3x3)."""
    U, _, Vt = np.linalg.svd(R.astype(np.float64))
    Rn = U @ Vt
    if np.linalg.det(Rn) < 0.0:
        Rn = (U * np.array([1.0, 1.0, -1.0])) @ Vt
    return Rn.astype(np.float32)


def _host_state(st) -> KfState:
    return KfState(*(np.asarray(a, np.float32) for a in st))


def _zero_state() -> KfState:
    z3 = np.zeros(3, np.float32)
    return KfState(np.eye(3, dtype=np.float32), z3, z3.copy(), z3.copy(), z3.copy())


# state machine (Tracking.h:20-26)
NO_IMAGE = 0
NOT_INITIALIZED = 1
OK = 2
RECENTLY_LOST = 3
LOST = 4


class Tracking:
    """The tracking state machine on the device of `problems` (the card
    unless the caller built `Problems(..., device="cpu")`); the camera and
    the calibration lie there too. Its fetches count on `problems.syncs`.
    Every knob and default of the JAX package's `Tracking`, plus `seed`,
    the JAX package's RANSAC key (`utils.prng`): a bootstrap draws the
    samples the JAX package's tracker of the same seed draws."""

    def __init__(self, camera, calib, store, problems, config=None):
        self.camera = camera
        self.calib = calib
        self.store = store
        self.problems = problems
        self.device = problems.device
        self.syncs = problems.syncs
        cfg = config or {}
        self.n_feat = cfg.get("n_features", 1024)
        self.init_min_features = cfg.get("init_min_features", 200)
        self.init_min_matches = cfg.get("init_min_matches", 80)
        self.min_track_inliers = cfg.get("min_track_inliers", 12)
        # keyframe policy (needNewKeyFrame, Tracking.cpp:539-576): the
        # reference's absolute thresholds (350 "many", 75 "weak") assume
        # ~1000 features a frame; the defaults scale with the capacity
        self.kf_tracked_ratio = cfg.get("kf_tracked_ratio", 0.9)
        self.kf_ref_ratio_many = cfg.get("kf_ref_ratio_many", 0.75)
        self.kf_many_inliers = cfg.get("kf_many_inliers", int(round(0.35 * self.n_feat)))
        self.kf_weak_inliers = cfg.get("kf_weak_inliers",
                                       max(40, int(round(0.075 * self.n_feat))))
        self.kf_max_frames = cfg.get("kf_max_frames", 10)
        self.kf_min_frames = cfg.get("kf_min_frames", 2)
        self.kf_max_interval = cfg.get("kf_max_interval", 0.5)
        self.kf_min_interval = cfg.get("kf_min_interval", 0.1)
        # minimum time between idle-mapper weak-trigger insertions (c1b;
        # see the JAX module for the measurement behind 0.25 s)
        self.kf_idle_interval = cfg.get("kf_idle_interval", 0.25)
        # below this inlier count the post-IMU-init tracker prefers
        # trackLastKeyFrame over trackLastFrame (Tracking.cpp:112-121)
        self.coarse_weak_inliers = cfg.get("coarse_weak_inliers",
                                           min(100, max(30, self.n_feat // 10)))
        self.rotation_check = cfg.get("rotation_check", True)
        # local-map view-angle gate (Frame::isInFrustum viewCos > 0.5,
        # Frame.cpp:129-166); <= -1 disables
        self.view_cos_gate = cfg.get("view_cos_gate", 0.5)
        self.local_pt_cap = cfg.get("local_pt_cap", 4096)
        self.lost_timeout = cfg.get("lost_timeout", 3.0)
        # initial-map conditioning gate, off by default (see the JAX module)
        self.init_max_rel_sigma = cfg.get("init_max_rel_sigma", None)
        # gyro-consistency gate (radians) on the fitted per-frame rotation
        self.gyro_gate = cfg.get("gyro_gate", np.radians(1.5))
        self.scale_factors = cfg.get(
            "scale_factors", np.array([1.2**i for i in range(8)], np.float32))

        # host copies of the calibration and the intrinsics (read once, here:
        # a read of a device tensor waits for the device's queue)
        _host_intrinsics(camera)
        self._R_cb = calib.R_cb.cpu().numpy()
        self._t_cb = calib.t_cb.cpu().numpy()
        self._t_bc = calib.t_bc.cpu().numpy()

        self.state = NO_IMAGE
        self.imu_ready = False
        self.last_frame: Frame | None = None
        self.init_frame: Frame | None = None
        self.ref_kf = -1
        self.last_kf_time = -1e9
        self.last_kf_id = -1
        self.kf_imu_buffer = ImuBuffer()  # samples since the last keyframe
        self.velocity_rel = None  # motion model: T_last->T_cur
        self.lost_since = None
        # set after a map gauge rewrite: the next frame's fitted rotation is
        # legitimately gyro-inconsistent, so the gyro guard skips one frame
        self._state_jump = False
        self.new_kf_callback = None  # receives each new KF id
        # mapper-idle and queue-capacity probes (None: a synchronous mapper,
        # always idle by construction)
        self.mapper_idle = None
        self.mapper_accepts = None
        self.frames_since_kf = 0
        self.kf_tracked_count = 1
        # IMU timeline anchor for the first frame after a checkpoint resume
        self.resume_prev_t: float | None = None
        self._imu_log: list = []  # rolling (t, gx..az) rows for init replay
        self._ransac_key = prng.prng_key(cfg.get("seed", 0))

    # ------------------------------------------------------------------
    # host <-> device
    # ------------------------------------------------------------------

    def _fetch(self, tree):
        return fetch(tree, self.syncs)

    def _frame_dev(self, frame: Frame) -> dict:
        """The frame's feature arrays on the device (xy, desc, valid,
        angle, sigma2): the extractor's tensors when the frame came from
        them, else one upload at first use."""
        if frame._dev is None:
            xy, desc, valid, angle, sigma2 = upload_inputs(
                (frame.xy, frame.desc, frame.valid, frame.angle, frame.sigma2), self.device)
            frame._dev = dict(xy=xy, desc=desc, valid=valid, angle=angle, sigma2=sigma2)
        return frame._dev

    # ------------------------------------------------------------------
    # main entry
    # ------------------------------------------------------------------

    def track_feats(self, t: float, feats: dict, imu: np.ndarray | None):
        """Full per-frame step from a feature dict (device tensors from
        `finish_features`, or host arrays): preintegrates both windows and
        the prediction deltas on the device, fetches everything in ONE
        read, builds the host Frame and runs the state machine. Returns
        (state, frame)."""
        # 1. preintegration bookkeeping (Tracking.cpp:90-91)
        frame_buf = ImuBuffer()
        prev_known = (self.last_frame.time if self.last_frame is not None
                      else self.resume_prev_t)
        self.resume_prev_t = None
        if imu is not None and len(imu) and prev_known is not None:
            prev_t = prev_known
            for row in imu:
                dt = max(float(row[0]) - prev_t, 0.0)
                prev_t = float(row[0])
                frame_buf.add(row[1:4], row[4:7], dt)
                self.kf_imu_buffer.add(row[1:4], row[4:7], dt)
                self._imu_log.append(np.asarray(row, np.float64))
            if len(self._imu_log) > 4000:
                self._imu_log = self._imu_log[-4000:]
        bg, ba = self._current_bias()
        pre_f = frame_buf.integrate(bg, ba, self.calib) if frame_buf.n else None
        pre_kf = (self.kf_imu_buffer.integrate(bg, ba, self.calib)
                  if self.kf_imu_buffer.n and self.last_kf_id >= 0 else None)
        deltas = _predict_deltas(pre_kf, pre_kf.bg, pre_kf.ba) if pre_kf is not None else None
        dev_feats = {k: feats[k] for k in ("xy", "desc", "valid", "angle", "sigma2")}
        on_device = all(isinstance(v, torch.Tensor) and v.device.type == self.device.type
                        for v in dev_feats.values())
        # the frame's one read: features + both windows + the deltas
        host, h_pre_f, h_pre_kf, h_deltas = self._fetch((dict(feats), pre_f, pre_kf, deltas))
        host["xy"] = np.asarray(host["xy"], np.float32)
        desc = np.asarray(host["desc"])
        host["desc"] = desc.view(np.uint32) if desc.dtype == np.int32 else desc.astype(np.uint32)
        frame = make_frame(t, host)
        frame.pre_from_frame = h_pre_f
        frame.pre_from_kf = h_pre_kf
        frame._pred_deltas = h_deltas
        frame._dev = dev_feats if on_device else None
        frame._pre_kf_dev = pre_kf

        if self.state in (NO_IMAGE, NOT_INITIALIZED):
            self._initialize(frame)
        elif self.state in (OK, RECENTLY_LOST):
            self._track_frame(frame)
        self.last_frame = frame
        return self.state, frame

    def track(self, frame: Frame, imu: np.ndarray | None):
        """Compatibility entry for callers that pre-build a host Frame."""
        state, new_frame = self.track_feats(frame.time, _feat_dict(frame), imu)
        frame.__dict__.update(new_frame.__dict__)
        return state

    def _current_bias(self):
        if self.last_kf_id >= 0:
            return self.store.kf_bg[self.last_kf_id], self.store.kf_ba[self.last_kf_id]
        return np.zeros(3, np.float32), np.zeros(3, np.float32)

    # ------------------------------------------------------------------
    # monocular initialization (Tracking.cpp:590-712)
    # ------------------------------------------------------------------

    def _initialize(self, frame: Frame):
        if frame.n_features < self.init_min_features:
            self.init_frame = None
            self.state = NOT_INITIALIZED
            return
        if self.init_frame is None:
            self.init_frame = frame
            self.state = NOT_INITIALIZED
            return

        f0, f1 = self.init_frame, frame
        d0, d1 = self._frame_dev(f0), self._frame_dev(f1)
        mask = matching.window_mask(d0["xy"], d1["xy"], d0["valid"], d1["valid"], radius=100.0)
        idx, _ = matching.match_descriptors(
            d0["desc"], d1["desc"], mask, angles_a=d0["angle"], angles_b=d1["angle"],
            max_dist=matching.TH_LOW, ratio=0.9, use_rotation=True)
        # every keypoint mapped to ideal pinhole pixels, in the same read
        # as the match
        c = _host_intrinsics(self.camera)
        idx, (u0_all, ok0_all), (u1_all, ok1_all) = self._fetch(
            (idx, ideal_pixels(self.camera, d0["xy"]), ideal_pixels(self.camera, d1["xy"])))
        matched = idx >= 0
        n_matches = int(matched.sum())
        # the gate scales with the init frames' feature capacity (the 2x
        # initial extractor; Tracking.cpp:605-614)
        gate = int(round(self.init_min_matches * max(1.0, len(f0.xy) / self.n_feat)))
        if n_matches < gate:
            self.init_frame = frame  # slide the reference forward
            return

        N = len(f0.xy)
        xy1 = np.zeros((N, 2), np.float32)
        xy2 = np.zeros((N, 2), np.float32)
        pair_valid = np.zeros(N, bool)
        sel = np.nonzero(matched)[0]
        xy1[: len(sel)] = u0_all[sel]
        xy2[: len(sel)] = u1_all[idx[sel]]
        pair_valid[: len(sel)] = ok0_all[sel] & ok1_all[idx[sel]]
        K = np.array([[c["fx"], 0.0, c["cx"]], [0.0, c["fy"], c["cy"]], [0.0, 0.0, 1.0]],
                     np.float32)
        # the JAX package's split and draw, on the host beside the mask,
        # uploaded with the pair
        self._ransac_key, sub = prng.split(self._ransac_key)
        xy1_t, xy2_t, valid_t, K_t, idx_t = upload_inputs(
            (xy1, xy2, pair_valid, K, draw_samples(sub, pair_valid)), self.device)
        out = reconstruct_two_views(xy1_t, xy2_t, valid_t, K_t, idx_t)
        out = self._fetch({k: out[k] for k in ("success", "R", "t", "points", "good")})
        if not bool(out["success"]):
            return
        self._create_initial_map(f0, f1, sel, idx[sel].astype(np.int64), out)

    def _create_initial_map(self, f0: Frame, f1: Frame, feat0, feat1, out):
        """Two KFs + triangulated points -> initial_optimize -> depth-1 gauge
        (Tracking.cpp:646-712)."""
        store = self.store
        R21 = np.asarray(out["R"])
        t21 = np.asarray(out["t"])
        good = np.asarray(out["good"])[: len(feat0)]
        X = np.asarray(out["points"])[: len(feat0)]

        # conditioning gate on the initial map (off by default; see the
        # JAX module for the measurements)
        if self.init_max_rel_sigma is not None:
            b = float(np.linalg.norm(t21))
            z_init = X[:, 2]
            rel_sigma = (2.0 / _host_intrinsics(self.camera)["fx"]) * z_init / max(b, 1e-9)
            strong = good & (rel_sigma <= self.init_max_rel_sigma)
            n_needed = max(60, int(0.5 * int(good.sum())))
            if int(strong.sum()) < n_needed:
                order = np.argsort(np.where(good, rel_sigma, np.inf))
                strong = np.zeros_like(good)
                strong[order[:n_needed]] = True
                strong &= good
            good = strong

        # the 2x initial extractor: oversized init frames shrink to the
        # store capacity, two-view inliers first
        cap = self.n_feat
        if len(f0.xy) > cap or len(f1.xy) > cap:
            m0 = _shrink_frame(f0, feat0[good], cap)
            m1 = _shrink_frame(f1, feat1[good], cap)
            feat0 = m0[feat0]
            feat1 = m1[feat1]
            good = good & (feat0 >= 0) & (feat1 >= 0)

        R_cb, t_cb = self._R_cb, self._t_cb

        def body_from_cam(R_cw, t_cw):
            R_wb = R_cw.T @ R_cb
            t_wb = R_cw.T @ (t_cb - t_cw)
            return R_wb.astype(np.float32), t_wb.astype(np.float32)

        R_wb0, t_wb0 = body_from_cam(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        R_wb1, t_wb1 = body_from_cam(R21, t21)

        z3 = np.zeros(3, np.float32)
        k0 = store.add_keyframe(f0.time, R_wb0, t_wb0, z3, z3, z3, _feat_dict(f0))
        k1 = store.add_keyframe(f1.time, R_wb1, t_wb1, z3, z3, z3, _feat_dict(f1))

        for i in np.nonzero(good)[0]:
            p = store.add_point(X[i], f1.desc[feat1[i]], k0)
            store.add_observation(p, k0, int(feat0[i]))
            store.add_observation(p, k1, int(feat1[i]))
            f1.pt_ids[feat1[i]] = p
        store.update_point_stats(store.kf_feat_pt[k1][store.kf_feat_pt[k1] >= 0],
                                 R_cb, t_cb, self.scale_factors)

        self.problems.initial_optimize(store, [k0, k1])

        # gauge: median scene depth of KF0 -> 1 (Tracking.cpp:682-688)
        pids = store.kf_feat_pt[k0]
        pids = pids[pids >= 0]
        R_cw0 = R_cb @ store.kf_R[k0].T
        t_cw0 = t_cb - R_cw0 @ store.kf_t[k0]
        z = (store.pt_xyz[pids] @ R_cw0.T + t_cw0)[:, 2]
        med = float(np.median(z))
        if med < 1e-6 or (z > 0).sum() < 30:
            store.reset()
            self.init_frame = None
            return
        inv = 1.0 / med
        # scale CAMERA CENTRES, not body origins: the lever arm is metric
        # (t_wb' = s t_wb + (s - 1) R_wb t_bc)
        for kk in (k0, k1):
            lever = store.kf_R[kk] @ self._t_bc
            store.kf_t[kk] = inv * store.kf_t[kk] + (inv - 1.0) * lever
        store.pt_xyz[pids] *= inv
        store.pt_min_dist[pids] *= inv
        store.pt_max_dist[pids] *= inv

        f1.state = KfState(store.kf_R[k1].copy(), store.kf_t[k1].copy(), z3.copy(), z3.copy(),
                           z3.copy())
        f1.ref_kf = k1
        f1.n_tracked = int(good.sum())
        self.ref_kf = k1
        self.last_kf_id = k1
        self.last_kf_time = f1.time
        self.kf_tracked_count = f1.n_tracked
        # rebuild the k0 -> k1 IMU window from the rolling sample log
        buf01 = ImuBuffer()
        prev_t = f0.time
        for row in self._imu_log:
            if f0.time < row[0] <= f1.time + 1e-9:
                buf01.add(row[1:4], row[4:7], max(float(row[0]) - prev_t, 0.0))
                prev_t = float(row[0])
        store.kf_imu[k0] = buf01
        self.kf_imu_buffer = ImuBuffer()
        store.kf_imu[k1] = self.kf_imu_buffer
        self.state = OK
        self.frames_since_kf = 0
        if self.new_kf_callback:
            self.new_kf_callback(k0, initial=True)
            self.new_kf_callback(k1, initial=True)

    # ------------------------------------------------------------------
    # per-frame tracking (Tracking.cpp:96-174)
    # ------------------------------------------------------------------

    def _kf_state(self, k: int) -> KfState:
        s = self.store
        return KfState(s.kf_R[k].copy(), s.kf_t[k].copy(), s.kf_v[k].copy(),
                       s.kf_bg[k].copy(), s.kf_ba[k].copy())

    def _predict_state(self, frame: Frame) -> KfState:
        """IMU prediction from the last KF (Tracking.cpp:211-243) on the
        deltas fetched with the frame, or the constant camera-motion
        model: host math."""
        if (self.imu_ready and frame.pre_from_kf is not None
                and frame._pred_deltas is not None and self.last_kf_id >= 0):
            k = self.last_kf_id
            dR, dV, dP = (np.asarray(a, np.float32) for a in frame._pred_deltas)
            dt = float(frame.pre_from_kf.dt)
            R0, t0, v0 = self.store.kf_R[k], self.store.kf_t[k], self.store.kf_v[k]
            R = R0 @ dR
            v = v0 + G_W * dt + R0 @ dV
            t = t0 + v0 * dt + 0.5 * G_W * dt * dt + R0 @ dP
            return KfState(R.astype(np.float32), t.astype(np.float32), v.astype(np.float32),
                           self.store.kf_bg[k].copy(), self.store.kf_ba[k].copy())
        # constant-velocity motion model on the body pose
        last = self.last_frame
        if last is not None and last.state is not None and self.velocity_rel is not None:
            R_rel, t_rel = self.velocity_rel
            R = _orthonormalize(np.asarray(last.state.R_wb) @ R_rel)
            t = np.asarray(last.state.t_wb) + np.asarray(last.state.R_wb) @ t_rel
            return KfState(R.astype(np.float32), t.astype(np.float32),
                           last.state.v, last.state.bg, last.state.ba)
        if last is not None and last.state is not None:
            return last.state
        # no frame history (first frame after a checkpoint resume): the
        # newest keyframe's state
        if self.last_kf_id >= 0:
            return self._kf_state(self.last_kf_id)
        return _zero_state()

    def _track_frame(self, frame: Frame):
        frame.state = self._predict_state(frame)
        frame.ref_kf = self.ref_kf

        ok = False
        if self.state == OK:
            last_strong = self.last_frame is not None and self.last_frame.n_tracked > 0
            if self.imu_ready:
                # post-IMU-init dispatch (Tracking.cpp:111-121)
                if last_strong and self.last_frame.n_tracked >= self.coarse_weak_inliers:
                    ok = self._match_against_last(frame)
                if not ok:
                    frame.state = self._predict_state(frame)
                    ok = self._match_against_last_kf(frame)
            elif last_strong:
                ok = self._match_against_last(frame)
            if not ok:
                frame.state = self._predict_state(frame)
                ok = self._match_against_ref_kf(frame)
        else:  # RECENTLY_LOST: IMU prediction, last-KF reattach, local map
            if self.imu_ready:
                ok = self._match_against_last_kf(frame)
                if not ok:
                    frame.state = self._predict_state(frame)
                    ok = True

        # the local map is the self-healing stage: tried even when the
        # coarse stages failed
        ok = self._track_local_map(frame) or (ok and frame.n_tracked >= self.min_track_inliers)

        # gyro-consistency guard (beyond the reference; see the JAX module):
        # a fit whose frame-to-frame rotation contradicts the raw gyro is
        # refit from the gyro-composed prediction
        if (ok and not self._state_jump and frame.pre_from_frame is not None
                and self.last_frame is not None and self.last_frame.state is not None):
            dR_gyro = np.asarray(frame.pre_from_frame.dR, np.float64)
            R_last = np.asarray(self.last_frame.state.R_wb, np.float64)
            dR_fit = R_last.T @ np.asarray(frame.state.R_wb, np.float64)
            dev = _rot_angle(dR_fit.T @ dR_gyro)
            gate = max(self.gyro_gate, 0.25 * _rot_angle(dR_gyro))
            if dev > gate:
                st = self._predict_state(frame)
                R_pred = _orthonormalize(R_last @ dR_gyro).astype(np.float32)
                frame.state = KfState(R_pred, st.t_wb, st.v, st.bg, st.ba)
                frame.pt_ids[:] = -1
                ok = self._track_local_map(frame)
                if ok:
                    dR_fit = R_last.T @ np.asarray(frame.state.R_wb, np.float64)
                    ok = _rot_angle(dR_fit.T @ dR_gyro) <= 2.0 * gate
        self._state_jump = False

        if ok:
            self.state = OK
            self.lost_since = None
            # the camera-frame motion model (Tracking.cpp:131-136): the
            # translation smoothed, the rotation instantaneous and
            # re-projected onto SO(3)
            if self.last_frame is not None and self.last_frame.state is not None:
                R_last = np.asarray(self.last_frame.state.R_wb)
                t_last = np.asarray(self.last_frame.state.t_wb)
                R_cur = np.asarray(frame.state.R_wb)
                t_cur = np.asarray(frame.state.t_wb)
                t_rel_new = R_last.T @ (t_cur - t_last)
                if self.velocity_rel is not None:
                    t_rel_new = 0.5 * t_rel_new + 0.5 * self.velocity_rel[1]
                self.velocity_rel = (_orthonormalize(R_last.T @ R_cur), t_rel_new)
            self.frames_since_kf += 1
            if self._need_new_keyframe(frame):
                self._create_keyframe(frame)
        else:
            if self.state == OK:
                self.state = RECENTLY_LOST if self.imu_ready else LOST
                self.lost_since = frame.time
            elif self.state == RECENTLY_LOST:
                if frame.time - (self.lost_since or frame.time) > self.lost_timeout:
                    self.state = LOST
            frame.n_tracked = 0

    # -- matching stages ------------------------------------------------

    def _candidate_points(self, pt_ids, feat_angles=None):
        """Pad candidate point data to the feature capacity; with
        `feat_angles`, each candidate's source-view orientation for the
        rotation histogram (ORBMatcher.cpp:329-345)."""
        N = self.n_feat
        src = np.nonzero(pt_ids >= 0)[0][:N]
        sel = pt_ids[src]
        xyz = np.zeros((N, 3), np.float32)
        desc = np.zeros((N, 8), np.uint32)
        valid = np.zeros(N, bool)
        ang = np.zeros(N, np.float32)
        n = len(sel)
        xyz[:n] = self.store.pt_xyz[sel]
        desc[:n] = self.store.pt_desc[sel]
        valid[:n] = self.store.pt_valid[sel]
        if feat_angles is not None:
            ang[:n] = feat_angles[src]
        ids = np.full(N, -1, np.int64)
        ids[:n] = sel
        return xyz, desc, valid, ids, ang

    def _project(self, state: KfState, xyz):
        """World points -> (pixels, in view) seen from `state`, on the
        device, with one fetch (the JAX package keeps it beside the stages;
        the tracking path itself selects with `_in_view_np`)."""
        R_wb, t_wb, pts = upload_inputs((state.R_wb, state.t_wb, xyz), self.device)
        return self._fetch(_project_points(R_wb, t_wb, self.calib.R_cb, self.calib.t_cb, pts,
                                           self.camera))

    def _cand_extra2(self, state: KfState, xyz: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Per-candidate extra measurement variance (px^2) from the point's
        along-ray depth uncertainty seen from `state`, computed before
        matching so the fused stages assemble the pose problem on the
        device."""
        store = self.store
        center = np.asarray(state.t_wb) + np.asarray(state.R_wb) @ self._t_bc
        vec = xyz - center
        z = np.linalg.norm(vec, axis=1)
        ray = vec / np.maximum(z[:, None], 1e-9)
        normal = store.pt_normal[np.maximum(ids, 0)]
        cos_t = np.abs((ray * normal).sum(1))
        sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
        f = _host_intrinsics(self.camera)["fx"]
        sig = f * store.pt_sigma_z[np.maximum(ids, 0)] * sin_t / np.maximum(z, 1e-6)
        return (sig**2).astype(np.float32)

    def _coarse_track(self, frame: Frame, pt_ids_src, ang_src) -> bool:
        """Shared trackLastFrame / trackLastKeyFrame stage (Tracking.cpp:
        284-343): one upload, the fused coarse stage, one fetch."""
        xyz, desc, valid, ids, ang = self._candidate_points(pt_ids_src, ang_src)
        extra2 = self._cand_extra2(frame.state, xyz, ids)
        fd = self._frame_dev(frame)
        radius = np.full(len(xyz), 15.0, np.float32)
        (*st0, xyz_t, desc_t, valid_t, ang_t, extra2_t, radius_t) = upload_inputs(
            (*frame.state, xyz, desc, valid, ang, extra2, radius), self.device)
        st, ci, n_match, n_inl = self._fetch(_coarse_track_kernel(
            KfState(*st0), xyz_t, desc_t, valid_t, ang_t, extra2_t,
            fd["xy"], fd["desc"], fd["valid"], fd["angle"], fd["sigma2"],
            self.camera, self.calib.R_cb, self.calib.t_cb, radius_t,
            2 * self.min_track_inliers, use_rotation=self.rotation_check))
        frame.pt_ids[:] = -1
        if int(n_match) < self.min_track_inliers:
            return False
        frame.state = _host_state(st)
        sel = ci >= 0
        frame.pt_ids[sel] = ids[ci[sel]]
        return int(n_inl) >= self.min_track_inliers

    def _match_against_last(self, frame: Frame) -> bool:
        """trackLastFrame (Tracking.cpp:284-314)."""
        return self._coarse_track(frame, self.last_frame.pt_ids, self.last_frame.angle)

    def _match_against_last_kf(self, frame: Frame) -> bool:
        """trackLastKeyFrame (Tracking.cpp:316-343): projection match
        against the last KEYFRAME's mapped points."""
        k = self.last_kf_id
        if k < 0:
            return False
        return self._coarse_track(frame, self.store.kf_feat_pt[k], self.store.kf_feat_angle[k])

    def _match_against_ref_kf(self, frame: Frame) -> bool:
        """trackReferenceKeyFrame (Tracking.cpp:255-282): descriptor match
        against the reference KF's mapped features, node-gated with a
        vocabulary, dense without one (group -1 passes everything). Two
        fetches: the match, then the pose LM."""
        k = self.ref_kf
        if k < 0:
            return False
        feat_pt = self.store.kf_feat_pt[k]
        xyz, desc, valid, ids, ang = self._candidate_points(feat_pt, self.store.kf_feat_angle[k])
        groups_kf = np.full(self.n_feat, -1, np.int32)
        feat_sel = np.nonzero(feat_pt >= 0)[0][: self.n_feat]
        groups_kf[: len(feat_sel)] = self.store.kf_feat_group[k, feat_sel]
        groups_f = (frame.group if frame.group is not None
                    else np.full(self.n_feat, -1, np.int32))
        fd = self._frame_dev(frame)
        desc_t, valid_t, ang_t, gk_t, gf_t = upload_inputs(
            (desc, valid, ang, groups_kf, groups_f), self.device)
        idx, _ = projected_match(desc_t, fd["desc"], groups_a=gk_t, groups_b=gf_t,
                                 valid_a=valid_t, valid_b=fd["valid"],
                                 max_dist=matching.TH_LOW, ratio=0.75)
        if self.rotation_check:
            # SearchByBow's orientation check (ORBMatcher.cpp:186-199)
            keep = _rot_filter(ang_t, fd["angle"], torch.clamp(idx, min=0).long(), idx >= 0)
            idx = torch.where(keep, idx, torch.full_like(idx, -1))
        idx = self._fetch(idx)
        frame.pt_ids[:] = -1
        hit = idx >= 0
        frame.pt_ids[idx[hit]] = ids[hit]
        if int(hit.sum()) < self.min_track_inliers:
            return False
        return self._optimize_frame_pose(frame) >= self.min_track_inliers

    def _harvest_local_points(self, frame: Frame):
        """updateLocalKeyFrames/Points (Tracking.cpp:429-537): the points of
        the reference KF's covisible neighbourhood and the recent KFs,
        joined by a pose-keyed frustum harvest over the whole store (see
        the JAX module for why), in-view first under the cap."""
        store = self.store
        kfs = set(store.recent_keyframes(10))
        if self.ref_kf >= 0:
            kfs.add(self.ref_kf)
            for j in store.covisible_keyframes(self.ref_kf, top=20):
                kfs.add(j)
        pid_set = store.kf_feat_pt[np.asarray(sorted(kfs), np.int32)]
        pids = np.unique(pid_set[pid_set >= 0])
        pids = pids[store.pt_valid[pids]]
        in_view_all = self._in_view_np(frame.state, store.pt_xyz)
        cand = np.nonzero(in_view_all & store.pt_valid & (store.pt_n_obs >= 3))[0]
        pids = np.union1d(pids, cand)
        if len(pids) > self.local_pt_cap:
            key = in_view_all[pids] * 10_000 + np.minimum(store.pt_n_obs[pids], 9_999)
            pids = pids[np.argsort(-key)[: self.local_pt_cap]]
        return pids

    def _in_view_np(self, state: KfState, xyz: np.ndarray) -> np.ndarray:
        """Host-side in-frustum test (the harvest only selects candidates)."""
        R_cw = self._R_cb @ np.asarray(state.R_wb).T
        t_cw = self._t_cb - R_cw @ np.asarray(state.t_wb)
        pc = xyz @ R_cw.T + t_cw
        _, ok = project_np(self.camera, pc)
        return ok

    def _track_local_map(self, frame: Frame) -> bool:
        """trackLocalMap (Tracking.cpp:345-427): candidate selection and the
        per-candidate radius policy on the host; one upload, the fused
        local stage (with the inertial edge after the IMU init), one
        fetch."""
        store = self.store
        pids = self._harvest_local_points(frame)
        P = self.local_pt_cap
        xyz = np.zeros((P, 3), np.float32)
        desc = np.zeros((P, 8), np.uint32)
        valid = np.zeros(P, bool)
        ids = np.full(P, -1, np.int64)
        n = len(pids)
        xyz[:n] = store.pt_xyz[pids]
        desc[:n] = store.pt_desc[pids]
        valid[:n] = True
        ids[:n] = pids

        # scale-band radius: predicted level from distance (MapPoint.cpp:
        # 159-170)
        center = np.asarray(frame.state.t_wb) + np.asarray(frame.state.R_wb) @ self._t_bc
        dist = np.linalg.norm(xyz - center, axis=1)
        normal = store.pt_normal[np.maximum(ids, 0)].astype(np.float32)
        has_normal = np.linalg.norm(normal, axis=1) > 0.5
        # view-angle gate (Frame::isInFrustum), applied on the device
        use_vcos = has_normal & (self.view_cos_gate > -1.0) & valid
        with np.errstate(divide="ignore", invalid="ignore"):
            ratio = np.where(dist > 1e-6, store.pt_max_dist[np.maximum(ids, 0)]
                             / np.maximum(dist, 1e-6), 1.0)
        level_pred = np.clip(np.round(np.log(np.maximum(ratio, 1e-3)) / np.log(1.2)), 0,
                             len(self.scale_factors) - 1).astype(np.int32)
        # a generous base radius (the self-healing loop), opened by the
        # projected depth uncertainty, by staleness, and during the
        # IMU-only bridge (the JAX module gives the measurements)
        radius = np.maximum(12.0, 4.0 * self.scale_factors[level_pred]).astype(np.float32)
        sigma_px = self._point_depth_sigma_px_arr(frame, xyz, ids, dist)
        radius = radius + np.minimum(2.0 * sigma_px, 48.0).astype(np.float32)
        obs_kf = store.pt_obs_kf[np.maximum(ids, 0)]
        obs_t = store.kf_time[np.maximum(obs_kf, 0)]
        has_obs = obs_kf >= 0
        # empty observation slots must not count as "observed now"
        last_t = np.where(has_obs, obs_t, -np.inf).max(axis=1)
        staleness = np.where(np.isfinite(last_t), np.maximum(frame.time - last_t, 0.0), 0.0)
        radius = radius + np.minimum(25.0 * staleness, 50.0).astype(np.float32)
        if self.state == RECENTLY_LOST and self.lost_since is not None:
            radius = radius * float(1.0 + min(4.0, 3.0 * (frame.time - self.lost_since)))

        # coarse-assignment merge inputs: per-feature problem rows of the
        # already-assigned points, and blockrow (candidate row of each
        # coarse point, for the one-observation-per-point rule)
        N = self.n_feat
        coarse_pts = np.zeros((N, 3), np.float32)
        coarse_inv_s2 = np.ones(N, np.float32)
        coarse_valid = np.zeros(N, bool)
        blockrow = np.full(N, -1, np.int32)
        csel = np.nonzero(frame.pt_ids >= 0)[0]
        if len(csel):
            cpids = frame.pt_ids[csel]
            coarse_pts[csel] = store.pt_xyz[cpids]
            cex = self._point_depth_sigma_px(frame, cpids)
            coarse_inv_s2[csel] = 1.0 / (frame.sigma2[csel] + cex**2)
            coarse_valid[csel] = True
            if n:
                pos = np.searchsorted(pids, cpids)
                pos_c = np.minimum(pos, n - 1)
                pos_ok = pids[pos_c] == cpids
                blockrow[csel[pos_ok]] = pos_c[pos_ok]

        use_inertial = bool(self.imu_ready and frame.pre_from_kf is not None
                            and self.last_kf_id >= 0)
        last = self._kf_state(self.last_kf_id) if use_inertial else _zero_state()
        extra2 = (sigma_px**2).astype(np.float32)
        up = upload_inputs((*frame.state, *last, xyz, desc, valid, normal, use_vcos, extra2,
                            radius.astype(np.float32), blockrow, coarse_pts, coarse_inv_s2,
                            coarse_valid), self.device)
        st0, last_t_state = KfState(*up[:5]), KfState(*up[5:10])
        (xyz_t, desc_t, valid_t, normal_t, vcos_t, extra2_t, radius_t, blockrow_t,
         cpts_t, cinv_t, cvalid_t) = up[10:]
        if use_inertial:
            edge = whiten(frame._pre_kf_dev)
            edge_valid = 1.0
        else:
            edge = _identity_edge(self.device)
            edge_valid = 0.0
        fd = self._frame_dev(frame)
        st, lci, keep_coarse, hit, n_inl = self._fetch(_local_track_kernel(
            st0, xyz_t, desc_t, valid_t, normal_t, vcos_t, extra2_t, radius_t, blockrow_t,
            cpts_t, cinv_t, cvalid_t, fd["xy"], fd["desc"], fd["valid"], fd["sigma2"],
            self.camera, self.calib.R_cb, self.calib.t_cb, self.calib.t_bc,
            self.view_cos_gate, 2 * self.min_track_inliers,
            edge, last_t_state, edge_valid, use_inertial=use_inertial))

        stats_vis = ids[hit & (ids >= 0)]
        store.pt_visible[stats_vis] += 1
        frame.state = _host_state(st)
        new_ids = np.full(N, -1, np.int64)
        new_ids[keep_coarse] = frame.pt_ids[keep_coarse]
        lsel = lci >= 0
        new_ids[lsel] = ids[lci[lsel]]
        frame.pt_ids[:] = new_ids
        tracked = frame.pt_ids >= 0
        store.pt_found[frame.pt_ids[tracked]] += 1
        n_inliers = int(n_inl)
        frame.n_tracked = n_inliers
        return n_inliers >= self.min_track_inliers

    def _point_depth_sigma_px_arr(self, frame: Frame, xyz: np.ndarray, ids: np.ndarray,
                                  dist: np.ndarray) -> np.ndarray:
        """_point_depth_sigma_px over the padded candidate arrays (reuses
        the point-to-camera distances)."""
        store = self.store
        st = frame.state
        center = np.asarray(st.t_wb) + np.asarray(st.R_wb) @ self._t_bc
        ray = (xyz - center) / np.maximum(dist, 1e-9)[:, None]
        normal = store.pt_normal[np.maximum(ids, 0)]
        cos_t = np.abs((ray * normal).sum(1))
        sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
        f = _host_intrinsics(self.camera)["fx"]
        sig = store.pt_sigma_z[np.maximum(ids, 0)]
        return f * sig * sin_t / np.maximum(dist, 1e-6)

    def _point_depth_sigma_px(self, frame: Frame, pids: np.ndarray) -> np.ndarray:
        """Per-point extra pixel sigma from the point's along-ray (depth)
        uncertainty seen from the current viewpoint:
        sigma_px ~ f * sigma_z * sin(theta) / z."""
        store = self.store
        st = frame.state
        center = np.asarray(st.t_wb) + np.asarray(st.R_wb) @ self._t_bc
        vec = store.pt_xyz[pids] - center
        z = np.linalg.norm(vec, axis=1)
        ray = vec / np.maximum(z[:, None], 1e-9)
        normal = store.pt_normal[pids]
        cos_t = np.abs((ray * normal).sum(1))
        sin_t = np.sqrt(np.maximum(1.0 - cos_t**2, 0.0))
        f = _host_intrinsics(self.camera)["fx"]
        return f * store.pt_sigma_z[pids] * sin_t / np.maximum(z, 1e-6)

    def _optimize_frame_pose(self, frame: Frame, full: bool = False) -> int:
        """poseOptimize / poseFullOptimize, with each observation's sigma
        inflated by the matched point's projected depth uncertainty."""
        N = self.n_feat
        sel = np.nonzero(frame.pt_ids >= 0)[0]
        pts = np.zeros((N, 3), np.float32)
        uv = np.zeros((N, 2), np.float32)
        inv_s2 = np.ones(N, np.float32)
        valid = np.zeros(N, bool)
        n = len(sel)
        pids = frame.pt_ids[sel]
        pts[:n] = self.store.pt_xyz[pids]
        uv[:n] = frame.xy[sel]
        extra_px = self._point_depth_sigma_px(frame, pids)
        eff_sigma2 = frame.sigma2[sel] + extra_px**2
        inv_s2[:n] = 1.0 / eff_sigma2
        valid[:n] = True

        if full and frame.pre_from_kf is not None and self.last_kf_id >= 0:
            state, inlier = self.problems.pose_full_optimize(
                frame.state, pts, uv, inv_s2, valid, self._kf_state(self.last_kf_id),
                frame._pre_kf_dev)
        else:
            state, inlier = self.problems.pose_optimize(frame.state, pts, uv, inv_s2, valid)
        frame.state = _host_state(state)
        # outliers lose their association
        out = sel[~inlier[:n]]
        frame.pt_ids[out] = -1
        return int(inlier[:n].sum())

    # ------------------------------------------------------------------
    # keyframe policy (Tracking.cpp:539-588)
    # ------------------------------------------------------------------

    def _num_ref_matches(self, min_obs: int) -> int:
        """Reference-KF tracked map points with >= min_obs observations
        (KeyFrame::getNumTrackedMapPoint)."""
        if self.ref_kf < 0:
            return 0
        pids = self.store.kf_feat_pt[self.ref_kf]
        pids = pids[pids >= 0]
        good = self.store.pt_valid[pids] & (self.store.pt_n_obs[pids] >= min_obs)
        return int(good.sum())

    def _need_new_keyframe(self, frame: Frame) -> bool:
        """needNewKeyFrame (Tracking.cpp:539-576): c1a max-frames, c1b
        min-frames + mapper idle, c2 weak against the reference KF's good
        points, c3 max time, c4 weak absolute count, gated by the mapper's
        probes (see the JAX module for the async-mode rationale)."""
        dt = frame.time - self.last_kf_time
        if dt < self.kf_min_interval:
            return False
        if frame.n_tracked < self.min_track_inliers:
            return False
        if self.mapper_accepts is not None and not self.mapper_accepts():
            return False  # queue full: hard backpressure
        idle = self.mapper_idle() if self.mapper_idle is not None else True
        min_obs = 3 if self.store.n_keyframes() > 2 else 2
        n_ref = self._num_ref_matches(min_obs)
        ratio = (self.kf_ref_ratio_many if frame.n_tracked > self.kf_many_inliers
                 else self.kf_tracked_ratio)
        c1a = self.frames_since_kf >= self.kf_max_frames
        c1b = self.frames_since_kf >= self.kf_min_frames and idle and dt >= self.kf_idle_interval
        c2 = frame.n_tracked < ratio * n_ref
        c3 = dt >= self.kf_max_interval
        c4 = self.min_track_inliers < frame.n_tracked < self.kf_weak_inliers
        if ((c1a or c1b) and c2) or c3 or c4:
            if self.mapper_accepts is not None:
                return True
            # sync mode: a busy mapper vetoes all but the hard triggers
            return idle or c3 or c4
        return False

    def _create_keyframe(self, frame: Frame):
        store = self.store
        st = frame.state
        # velocity/bias prior information from the preintegration
        # covariance (KeyFrame.cpp:86-98)
        prior = np.zeros(9, np.float32)
        if frame.pre_from_kf is not None and self.imu_ready:
            C = np.asarray(frame.pre_from_kf.C)
            v_sig = np.sqrt(np.maximum(np.diagonal(C)[3:6], 1e-12))
            prior[0:3] = 1.0 / np.maximum(v_sig, 1e-6)
            prior[3:6] = 1e2  # gyro-bias prior
            prior[6:9] = 1e1  # acc-bias prior
        k = store.add_keyframe(frame.time, np.asarray(st.R_wb), np.asarray(st.t_wb),
                               np.asarray(st.v), np.asarray(st.bg), np.asarray(st.ba),
                               _feat_dict(frame), prior_inv_sigma=prior)
        for f in np.nonzero(frame.pt_ids >= 0)[0]:
            store.add_observation(int(frame.pt_ids[f]), k, int(f))
        self.ref_kf = k
        frame.ref_kf = k
        self.last_kf_id = k
        self.last_kf_time = frame.time
        self.kf_tracked_count = frame.n_tracked
        self.frames_since_kf = 0
        self.kf_imu_buffer = ImuBuffer()
        store.kf_imu[k] = self.kf_imu_buffer
        if self.new_kf_callback:
            self.new_kf_callback(k)
            # a synchronous mapper may have bundle-adjusted this KF:
            # re-sync the frame state for the next prediction
            frame.state = self._kf_state(k)

    # ------------------------------------------------------------------

    def update_after_gauge_change(self):
        """After the mapper rewrites the map gauge (inertial init): refresh
        the cached frame state from the newest KF (Tracking::updateFrameIMU,
        LocalMapping.cpp:441-446)."""
        if self.last_frame is None or self.last_kf_id < 0:
            return
        self.last_frame.state = self._kf_state(self.last_kf_id)
        self.velocity_rel = None
        self._state_jump = True

    def reset(self):
        self.state = NO_IMAGE
        self.imu_ready = False
        self.resume_prev_t = None
        self.last_frame = None
        self.init_frame = None
        self.ref_kf = -1
        self.last_kf_id = -1
        self.last_kf_time = -1e9
        self.kf_imu_buffer = ImuBuffer()
        self.velocity_rel = None
        self.lost_since = None
        self.frames_since_kf = 0


def _feat_dict(frame: Frame) -> dict:
    return {
        "xy": frame.xy, "level": frame.level, "angle": frame.angle,
        "desc": frame.desc, "valid": frame.valid, "sigma2": frame.sigma2,
        "group": frame.group,
    }
