#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Builds the hand kernels from `monoorbslam3_tpu_torch/csrc/` and drives the
port's three paths, each with the kernel launch counts set to 0 just
before it and read just after:

1. tracking: the per-frame visual tracking path (ORB extraction ->
   finish_features -> coarse stage -> local stage) over 40 rendered
   EuRoC-size frames (kernels K1, K2);
2. mapper search: the keyframe searches of local mapping on rendered
   EuRoC-size keyframes, triangulation of a keyframe pair and the fuse of
   the new points into a third keyframe (K3);
3. window BA: `schur_ba` on the `bench.py` window (24+8 keyframes, 2048
   points, 6144 observations), flat and grouped layouts (K4).

Then it holds each kernel against its plain PyTorch version on the inputs
its path gave it, and prints local-BA iterations/s.

    python3 chip_smoke.py    # needs one card; no arguments

Exits non-zero, without the final `{"ok": true, ...}` line, when no CUDA
device is present, when a kernel fails to build, launch or agree, when a
kernel was never launched by its path, when a tracked frame keeps fewer
than 12 inliers or the median pose error exceeds its bound, when the
mapper search or the BA costs leave the bounds set by the JAX package's
run of the same inputs on the CPU. Prints, before the last line, the
card's name and power limit and one JSON object with each kernel's
launches, error and times.
"""

from __future__ import annotations

import collections
import json
import subprocess
import sys
import time

import numpy as np

# EuRoC MAV cam0 (settings/euroc.yaml:3-8): 752x480, radtan k1 k2 p1 p2
EUROC_CAM = dict(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                 dist=[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
                 width=752, height=480)
# ORB settings of settings/euroc.yaml:9-14
N_FEAT, N_LEVELS, SCALE = 1024, 8, 1.2
FPS = 20.0
# camera 45 deg between forward (+x body) and outward (-y body), y down: the
# rig of the repository's e2e tests, which looks at the rendered wall
_S2 = 1.0 / np.sqrt(2.0)
_Z_C = np.array([_S2, -_S2, 0.0])
_X_C = np.array([-_S2, -_S2, 0.0])
R_BC = np.stack([_X_C, np.cross(_Z_C, _X_C), _Z_C], axis=1)
T_BC = np.array([0.03, 0.01, -0.02])
R_CB = R_BC.T.astype(np.float32)
T_CB = (-R_BC.T @ T_BC).astype(np.float32)

P_LOCAL = 4096  # local-map window (local_pt_cap, tracking.py:283)
SEED_EVERY = 5  # re-seed the map every 5 frames (stands in for the mapper)
N_SEEDS = 3  # the last three seeds form the local window
MIN_INLIERS = 12  # min_track_inliers (tracking.py:251)
COARSE_RADIUS = 15.0  # tracking.py:805
RETRY = 2 * MIN_INLIERS  # tracking.py:806, 1051
VIEW_COS_GATE = 0.5  # tracking.py:282

# median pose-error bounds: twice the medians of the same 40-frame drive
# through the JAX package on the CPU (experiments/port_slice_drive_jax.py:
# 1.41 mm and 0.0205 deg; PERF.md records the run), rounded up
MAX_MEDIAN_T_ERR_M = 0.003
MAX_MEDIAN_R_ERR_DEG = 0.05


# mapper search: keyframes at t = 0 and 0.5 s (0.87 m apart on the circle,
# the wall ~6 m away) are triangulated; the new points are fused into the
# keyframe at 0.25 s, with the fuse radius of LocalMapping._dispatch_fuse
KF_TIMES = (0.0, 0.5, 0.25)
FUSE_RADIUS = 4.0
# bounds from the same search through the JAX package on the CPU
# (experiments/port_mapper_jax.py: 262 points accepted, median 3D error
# 71.5 mm, 217 fused; PERF.md records the run): 90% of the counts, 1.5x the
# error. At ~6-10 m depth over a 0.87 m baseline, a half-pixel keypoint
# error moves a point by several cm along the ray.
MIN_ACCEPTED = 235
MAX_MEDIAN_TRI_ERR_M = 0.107
MIN_FUSED = 195

# window BA: 10 LM iterations on bench_window.build_problem(seed=0); the
# JAX package's costs for the same window on the CPU
# (experiments/port_mapper_jax.py; PERF.md records the run)
BA_ITERS = 10
BA_VARIANTS = {"flat_deferred": dict(deferred=True, grouped_obs=0),
               "grouped_deferred": dict(deferred=True, grouped_obs=192),
               "flat_parallel": dict(deferred=False, grouped_obs=0)}
JAX_BA_COST0 = 200982.5625
JAX_BA_COST = {"flat_deferred": 1118.5657, "grouped_deferred": 1118.5652,
               "flat_parallel": 1118.5652}
BA_COST0_RTOL = 1e-4
BA_COST_RTOL = 1e-3


def _orthonormalize(R):
    U, _, Vt = np.linalg.svd(np.asarray(R, np.float64))
    Rn = U @ Vt
    if np.linalg.det(Rn) < 0.0:
        Rn = (U * np.array([1.0, 1.0, -1.0])) @ Vt
    return Rn.astype(np.float32)


def _rot_err_deg(R_a, R_b):
    """Geodesic angle between two rotations, accurate for small angles
    (atan2 of the skew and trace parts of R_a^T R_b, in float64)."""
    M = np.asarray(R_a, np.float64).T @ np.asarray(R_b, np.float64)
    s = 0.5 * np.linalg.norm([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]])
    return float(np.degrees(np.arctan2(s, 0.5 * (np.trace(M) - 1.0))))


def _state(R, t):
    z = np.zeros(3, np.float32)
    return (np.asarray(R, np.float32), np.asarray(t, np.float32), z, z, z)


class MapWindow:
    """Seeded map points (host arrays): true world points of a frame's
    keypoints, lifted through the renderer's own ray/scene intersection."""

    def __init__(self):
        self.xyz = np.zeros((0, 3), np.float32)
        self.desc = np.zeros((0, 8), np.uint32)
        self.normal = np.zeros((0, 3), np.float32)
        self.level = np.zeros(0, np.int32)
        self.seeds = []

    def seed(self, world, cam_cpu, t, feats):
        """Add a frame's valid keypoints; returns (point ids, feature idx)."""
        fidx = np.nonzero(feats["valid"])[0]
        X = world.world_points(t, cam_cpu, R_BC, T_BC, feats["xy_raw"][fidx])
        center = world.traj.pos(t) + world.traj.R_wb(t) @ T_BC
        v = X - center
        ids = np.arange(len(self.xyz), len(self.xyz) + len(fidx))
        self.xyz = np.concatenate([self.xyz, X.astype(np.float32)])
        self.desc = np.concatenate([self.desc, feats["desc"][fidx]])
        self.normal = np.concatenate(
            [self.normal, (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)])
        self.level = np.concatenate([self.level, feats["level"][fidx].astype(np.int32)])
        self.seeds = (self.seeds + [ids])[-N_SEEDS:]
        return ids, fidx

    def coarse_candidates(self, ids, angles):
        """Previous frame's matched points, padded to N_FEAT."""
        n = min(len(ids), N_FEAT)
        c = dict(cand_xyz=np.zeros((N_FEAT, 3), np.float32),
                 cand_desc=np.zeros((N_FEAT, 8), np.uint32),
                 cand_valid=np.zeros(N_FEAT, bool), cand_ang=np.zeros(N_FEAT, np.float32),
                 cand_extra2=np.zeros(N_FEAT, np.float32),
                 radius=np.full(N_FEAT, COARSE_RADIUS, np.float32))
        c["cand_xyz"][:n] = self.xyz[ids[:n]]
        c["cand_desc"][:n] = self.desc[ids[:n]]
        c["cand_valid"][:n] = True
        c["cand_ang"][:n] = angles[:n]
        ids_pad = np.full(N_FEAT, -1, np.int64)
        ids_pad[:n] = ids[:n]
        return c, ids_pad

    def local_candidates(self, coarse_pid, sigma2):
        """The last N_SEEDS seeds padded to P_LOCAL, and the coarse merge
        inputs of the local stage."""
        win = np.concatenate(self.seeds)[:P_LOCAL]
        n = len(win)
        c = dict(cand_xyz=np.zeros((P_LOCAL, 3), np.float32),
                 cand_desc=np.zeros((P_LOCAL, 8), np.uint32),
                 cand_valid=np.zeros(P_LOCAL, bool),
                 cand_normal=np.zeros((P_LOCAL, 3), np.float32),
                 cand_extra2=np.zeros(P_LOCAL, np.float32),
                 radius=np.full(P_LOCAL, 12.0, np.float32))
        c["cand_xyz"][:n] = self.xyz[win]
        c["cand_desc"][:n] = self.desc[win]
        c["cand_valid"][:n] = True
        c["cand_normal"][:n] = self.normal[win]
        # scale-band radius (tracking.py:964)
        c["radius"][:n] = np.maximum(12.0, 4.0 * SCALE ** self.level[win])
        c["cand_use_vcos"] = c["cand_valid"].copy()
        sel = coarse_pid >= 0
        pos = np.minimum(np.searchsorted(win, coarse_pid), n - 1)  # win ascends
        c["blockrow"] = np.where(sel & (win[pos] == coarse_pid), pos, -1).astype(np.int32)
        c["coarse_pts"] = np.zeros((len(coarse_pid), 3), np.float32)
        c["coarse_pts"][sel] = self.xyz[coarse_pid[sel]]
        c["coarse_inv_s2"] = np.where(sel, 1.0 / sigma2, 1.0).astype(np.float32)
        c["coarse_valid"] = sel
        win_pad = np.full(P_LOCAL, -1, np.int64)
        win_pad[:n] = win
        return c, win_pad


def drive(pipe, n_frames=40, log=print):
    """Track `n_frames` rendered frames through `pipe` (see TorchPipe for
    its interface). Returns per-frame records."""
    from monoorbslam3_tpu_torch.models.camera import Pinhole
    from monoorbslam3_tpu_torch.sim import ImageWorld

    cam_cpu = Pinhole.create(**EUROC_CAM)
    world = ImageWorld()
    traj = world.traj
    mapw = MapWindow()

    img0 = world.render(0.0, cam_cpu, R_BC, T_BC, rng=np.random.default_rng(0))
    feats0 = pipe.features(img0)
    ids, fidx = mapw.seed(world, cam_cpu, 0.0, feats0)
    prev_ids, prev_ang = ids, feats0["angle"][fidx]
    hist = [_state(traj.R_wb(0.0), traj.pos(0.0))]
    records = []
    for i in range(1, n_frames):
        t = i / FPS
        img = world.render(t, cam_cpu, R_BC, T_BC, rng=np.random.default_rng(i))
        # constant-velocity motion model (tracking.py:715-728)
        R_cur, t_cur = hist[-1][:2]
        if len(hist) > 1:
            R_last, t_last = hist[-2][:2]
            dR = _orthonormalize(R_last.T @ R_cur)
            pred = _state(_orthonormalize(R_cur @ dR),
                          t_cur + R_cur @ (R_last.T @ (t_cur - t_last)))
        else:
            pred = hist[-1]
        t0 = time.perf_counter()
        cand, cand_ids = mapw.coarse_candidates(prev_ids, prev_ang)
        rc = pipe.coarse(img, pred, cand)
        t1 = time.perf_counter()
        f = rc["feats"]
        ci = rc["ci"]
        coarse_pid = np.where(ci >= 0, cand_ids[np.maximum(ci, 0)], -1)
        state_c = _state(*rc["state"]) if rc["n_match"] >= MIN_INLIERS else pred
        lc, win = mapw.local_candidates(coarse_pid, f["sigma2"])
        rl = pipe.local(state_c, lc)
        t2 = time.perf_counter()
        new = np.full(N_FEAT, -1, np.int64)
        new[rl["keep_coarse"]] = coarse_pid[rl["keep_coarse"]]
        lsel = rl["lci"] >= 0
        new[lsel] = win[rl["lci"][lsel]]
        prev_ids, prev_ang = new[new >= 0], f["angle"][new >= 0]
        st = rl["state"]
        hist = (hist + [_state(st[0], st[1])])[-2:]
        R_true, p_true = traj.R_wb(t), traj.pos(t)
        t_err = float(np.linalg.norm(st[1] - p_true))
        r_err = _rot_err_deg(R_true, st[0])
        rec = dict(frame=i, n_match=int(rc["n_match"]), n_inl_coarse=int(rc["n_inl"]),
                   n_inliers=int(rl["n_inl"]), n_hit=int(rl["hit"].sum()),
                   t_err_m=t_err, r_err_deg=r_err,
                   host_coarse_ms=1e3 * (t1 - t0), host_local_ms=1e3 * (t2 - t1),
                   host_frame_ms=1e3 * (t2 - t0), **rc.get("device_ms", {}),
                   **rl.get("device_ms", {}))
        records.append(rec)
        log(json.dumps(rec))
        if i % SEED_EVERY == 0:
            mapw.seed(world, cam_cpu, t, f)
    return records


def mapper_search(pipe, log=print):
    """Render the KF_TIMES keyframes, triangulate the first two through
    `pipe`, fuse the accepted points into the third, and score both against
    the renderer's true world points. Returns a summary record."""
    from monoorbslam3_tpu_torch.models.camera import Pinhole
    from monoorbslam3_tpu_torch.sim import ImageWorld

    cam_cpu = Pinhole.create(**EUROC_CAM)
    world = ImageWorld()
    poses, feats = [], []
    for i, t in enumerate(KF_TIMES):
        img = world.render(t, cam_cpu, R_BC, T_BC, rng=np.random.default_rng(100 + i))
        R_cw, t_cw = world.pose_cw(t, R_BC, T_BC)
        poses.append((R_cw.astype(np.float32), t_cw.astype(np.float32)))
        feats.append(pipe.keyframe(img))
    tri = pipe.triangulate(0, 1, poses[0], poses[1])
    acc = np.nonzero(tri["accept"])[0]
    X_true = world.world_points(KF_TIMES[0], cam_cpu, R_BC, T_BC, feats[0]["xy_raw"][acc])
    tri_err = np.linalg.norm(tri["X"][acc] - X_true, axis=1)

    # the new points, padded to the store's per-KF capacity (N_FEAT), as
    # LocalMapping._dispatch_fuse packs them
    n = min(len(acc), N_FEAT)
    pts = np.zeros((N_FEAT, 3), np.float32)
    pts[:n] = tri["X"][acc[:n]]
    src = np.full(N_FEAT, -1, np.int64)
    src[:n] = acc[:n]
    fidx = pipe.fuse(0, pts, src, 2, poses[2])
    fused = np.nonzero(fidx >= 0)[0]
    X3 = world.world_points(KF_TIMES[2], cam_cpu, R_BC, T_BC, feats[2]["xy_raw"][fidx[fused]])
    fuse_gap = np.linalg.norm(pts[fused] - X3, axis=1)
    rec = dict(n_valid=[int(f["valid"].sum()) for f in feats],
               n_matched=int((tri["idx"] >= 0).sum()), n_accepted=int(len(acc)),
               median_tri_err_m=float(np.median(tri_err)) if len(acc) else float("inf"),
               p90_tri_err_m=float(np.percentile(tri_err, 90)) if len(acc) else float("inf"),
               n_fused=int(len(fused)),
               median_fuse_gap_m=float(np.median(fuse_gap)) if len(fused) else float("inf"),
               **pipe.mapper_times)
    log(json.dumps(rec))
    return rec


def window_ba(device, n_runs=15, log=print):
    """Every BA_VARIANTS solve of the bench window on `device`. Per variant:
    one warm-up solve; one solve under the sync debug mode, which counts
    the host syncs inside a solve and gives cost0, the converged cost and
    the inputs of every reduced solve (K4's wrapper on the card, its plain
    version on the CPU); then the wall time of `n_runs`
    whole solves, each ending in the one fetch of its result and a
    synchronize. Returns {variant: record}, with the reduced systems under
    "systems"."""
    import warnings

    import torch

    from monoorbslam3_tpu_torch.backend.solver import schur_ba
    from monoorbslam3_tpu_torch.bench_window import build_problem
    from monoorbslam3_tpu_torch.ops import chol_pallas
    from monoorbslam3_tpu_torch.utils.fetch import SyncCounter, fetch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    problem, cam = build_problem(seed=0, device=dev)
    R_cb = torch.eye(3, device=dev)
    t_cb = torch.zeros(3, device=dev)
    syncs = SyncCounter()
    out = {}
    for name, kw in BA_VARIANTS.items():
        def solve():
            _, pts, info = schur_ba(problem, cam, R_cb, t_cb, n_iters=BA_ITERS, **kw)
            return pts, info

        fetch(solve()[1]["cost"], syncs)  # warm-up
        solver = "chol_solve_cuda" if on_card else "chol_solve_plain"
        with _Capture(chol_pallas, solver, maxlen=None) as k4, \
                warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if on_card:
                torch.cuda.set_sync_debug_mode("warn")
            try:
                pts, info = solve()
            finally:
                if on_card:
                    torch.cuda.set_sync_debug_mode("default")
        # the debug mode's own prototype notice is not a sync
        sync_sites = collections.Counter(f"{w.filename}:{w.lineno}" for w in caught
                                         if "called a synchronizing" in str(w.message))
        n0 = syncs.n
        host = fetch(dict(cost0=info["cost0"], cost=info["cost"], hist=info["cost_hist"],
                          finite=torch.isfinite(pts).all()), syncs)
        fetches = syncs.n - n0
        times = []
        for _ in range(n_runs):
            t0 = time.perf_counter()
            pts, info = solve()
            fetch(info["cost"], syncs)
            if on_card:
                torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        out[name] = dict(cost0=float(host["cost0"]), cost=float(host["cost"]),
                         cost_hist=[float(c) for c in host["hist"]],
                         finite=bool(host["finite"]),
                         syncs_in_solve=sum(sync_sites.values()), sync_sites=dict(sync_sites),
                         fetches_per_solve=fetches, solve_ms=[1e3 * t for t in times],
                         median_solve_ms=1e3 * med, iters_per_s=BA_ITERS / med,
                         systems=list(k4.calls))
        log(json.dumps({k: v for k, v in out[name].items() if k != "systems"} | {"variant": name}))
    return out


class TorchPipe:
    """The port's tracking and mapper paths on one device. `features`
    brings a frame's features to the host (seeding only); `coarse` uploads
    the frame and the coarse candidates, extracts, runs the coarse stage
    and reads its result with one fetch; `local` runs the local stage on
    the same frame with one fetch. `keyframe`, `triangulate` and `fuse` are
    the mapper search's steps, one fetch each."""

    def __init__(self, device):
        import torch

        from monoorbslam3_tpu_torch.models.camera import Pinhole
        from monoorbslam3_tpu_torch.ops.orb import OrbExtractor
        from monoorbslam3_tpu_torch.utils.fetch import SyncCounter

        self.torch = torch
        self.dev = torch.device(device)
        self.cam = Pinhole.create(**EUROC_CAM, device=self.dev)
        self.ext = OrbExtractor(EUROC_CAM["height"], EUROC_CAM["width"],
                                n_features=N_FEAT, n_levels=N_LEVELS, scale=SCALE,
                                device=self.dev)
        self.R_cb = self._up(R_CB)
        self.t_cb = self._up(T_CB)
        self.t_bc = self._up(T_BC.astype(np.float32))
        self.syncs = SyncCounter()
        self._feats = None
        self._kfs = []
        self.mapper_times = {}

    def _up(self, x):
        """Host array -> device tensor through pinned memory, without a
        host wait (uint32 descriptors become their int32 view)."""
        from monoorbslam3_tpu_torch import convert

        t = convert.tensor(x)
        if self.dev.type != "cuda":  # CPU rehearsal of the drive
            return t
        return t.pin_memory().to(self.dev, non_blocking=True)

    def _fetch(self, tree):
        from monoorbslam3_tpu_torch.utils.fetch import fetch

        return fetch(tree, self.syncs)

    def _frame(self, img):
        from monoorbslam3_tpu_torch.frontend.frame import finish_features

        out = self.ext(self._up(img.astype(np.float32)))
        return finish_features(out, self.cam, self.ext.scale_factors)

    @staticmethod
    def _host_feats(f):
        return {k: f[k] for k in ("xy_raw", "angle", "valid", "level", "sigma2", "desc")}

    def features(self, img):
        h = self._fetch(self._host_feats(self._frame(img)))
        h["desc"] = h["desc"].view(np.uint32)
        return h

    def _event(self):
        if self.dev.type != "cuda":
            return None
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    @staticmethod
    def _span(a, b):
        return a.elapsed_time(b) if a is not None else float("nan")

    def coarse(self, img, state, cand):
        from monoorbslam3_tpu_torch.backend.residuals import KfState
        from monoorbslam3_tpu_torch.frontend.tracking import _coarse_track_kernel

        state = KfState(*(self._up(a) for a in state))
        c = {k: self._up(v) for k, v in cand.items()}
        e0 = self._event()
        f = self._frame(img)
        self._feats = f
        e1 = self._event()
        st, ci, n_match, n_inl = _coarse_track_kernel(
            state, c["cand_xyz"], c["cand_desc"], c["cand_valid"], c["cand_ang"],
            c["cand_extra2"], f["xy"], f["desc"], f["valid"], f["angle"], f["sigma2"],
            self.cam, self.R_cb, self.t_cb, c["radius"], RETRY, use_rotation=True)
        e2 = self._event()
        out = self._fetch(dict(state=(st.R_wb, st.t_wb), ci=ci, n_match=n_match,
                               n_inl=n_inl, feats=self._host_feats(f)))
        out["feats"]["desc"] = out["feats"]["desc"].view(np.uint32)
        out["n_match"], out["n_inl"] = int(out["n_match"]), int(out["n_inl"])
        out["device_ms"] = dict(dev_extract_ms=self._span(e0, e1),
                                dev_coarse_ms=self._span(e1, e2))
        return out

    def keyframe(self, img):
        """Extract a keyframe's features on the device; keep them for the
        searches and bring the raw keypoints and validity to the host."""
        f = self._frame(img)
        self._kfs.append(f)
        return self._fetch({k: f[k] for k in ("xy_raw", "valid")})

    def _pose(self, pose):
        return self._up(pose[0]), self._up(pose[1])

    def triangulate(self, i, j, pose_i, pose_j):
        from monoorbslam3_tpu_torch.frontend.local_mapping import _triangulate_pair_kernel

        a, b = self._kfs[i], self._kfs[j]
        (R1, t1), (R2, t2) = self._pose(pose_i), self._pose(pose_j)
        e0 = self._event()
        idx, X, accept = _triangulate_pair_kernel(
            a["xy"], a["desc"], a["valid"], a["sigma2"],
            b["xy"], b["desc"], b["valid"], b["sigma2"], self.cam, R1, t1, R2, t2)
        e1 = self._event()
        out = self._fetch(dict(idx=idx, X=X, accept=accept))
        self.mapper_times["dev_triangulate_ms"] = self._span(e0, e1)
        return out

    def fuse(self, i, pts, src, j, pose_j):
        """Fuse points (host [P, 3]) whose descriptors are those of keyframe
        i's features `src` (-1 = padding) into keyframe j."""
        import torch

        from monoorbslam3_tpu_torch.frontend.local_mapping import _fuse_project_kernel

        a, b = self._kfs[i], self._kfs[j]
        src_t = self._up(src)
        valid = src_t >= 0
        desc = torch.where(valid[:, None], a["desc"][torch.clamp(src_t, min=0)],
                           torch.zeros_like(a["desc"][:1]))
        R, t = self._pose(pose_j)
        e0 = self._event()
        idx = _fuse_project_kernel(self._up(pts), desc, valid, b["xy"], b["desc"],
                                   b["valid"], b["sigma2"], self.cam, R, t, FUSE_RADIUS)
        e1 = self._event()
        out = self._fetch(idx)
        self.mapper_times["dev_fuse_ms"] = self._span(e0, e1)
        return out

    def local(self, state, cand):
        from monoorbslam3_tpu_torch.backend.problems import _identity_edge
        from monoorbslam3_tpu_torch.backend.residuals import KfState
        from monoorbslam3_tpu_torch.frontend.tracking import _local_track_kernel

        state = KfState(*(self._up(a) for a in state))
        c = {k: self._up(v) for k, v in cand.items()}
        f = self._feats
        z = KfState.zeros(device=self.dev)
        e0 = self._event()
        st, lci, keep, hit, n_inl = _local_track_kernel(
            state, c["cand_xyz"], c["cand_desc"], c["cand_valid"], c["cand_normal"],
            c["cand_use_vcos"], c["cand_extra2"], c["radius"], c["blockrow"],
            c["coarse_pts"], c["coarse_inv_s2"], c["coarse_valid"],
            f["xy"], f["desc"], f["valid"], f["sigma2"], self.cam, self.R_cb, self.t_cb,
            self.t_bc, VIEW_COS_GATE, RETRY, _identity_edge(self.dev), z, 0.0,
            use_inertial=False)
        e1 = self._event()
        out = self._fetch(dict(state=(st.R_wb, st.t_wb), lci=lci, keep_coarse=keep,
                               hit=hit, n_inl=n_inl))
        out["n_inl"] = int(out["n_inl"])
        out["device_ms"] = dict(dev_local_ms=self._span(e0, e1))
        return out


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _time_ms(fn, reps=20, warmup=3):
    """Median device time of fn() over `reps` launches (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


class _Capture:
    """Keeps the arguments of the last `maxlen` calls of `module.name` made
    inside the block (a kernel wrapper), so a kernel phase replays exactly
    the inputs its path gave it."""

    def __init__(self, module, name, maxlen=8):
        self.mod, self.name, self.maxlen = module, name, maxlen

    def __enter__(self):
        self.orig = getattr(self.mod, self.name)
        self.calls, self.n = collections.deque(maxlen=self.maxlen), 0

        def spy(*args):
            self.calls.append(args)
            self.n += 1
            return self.orig(*args)

        setattr(self.mod, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.mod, self.name, self.orig)


def _zero(counts):
    for k in counts:
        counts[k] = 0


def _rel(x, ref):
    """Per-system relative error ||x - ref|| / ||ref|| over the last axis."""
    return (x.double() - ref.double()).norm(dim=-1) / ref.double().norm(dim=-1)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one", file=sys.stderr)
        return 2
    from monoorbslam3_tpu_torch.ops import chol_pallas, cuda_lib, match_pallas, pallas_kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device",
          torch.cuda.get_device_name(0))

    # -- build the kernels from csrc/ -------------------------------------
    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s into {cuda_lib.LIB}")
    for line in cuda_lib.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    # -- path 1, tracking: the 40-frame slice drive ---------------------------
    pipe = TorchPipe(dev)
    # warm-up outside the counted runs (first launches load modules)
    pipe.features(np.zeros((EUROC_CAM["height"], EUROC_CAM["width"]), np.float32))
    warm = torch.zeros((64, 8), dtype=torch.int32, device=dev)
    pallas_kernels.hamming_matrix_cuda(warm, warm)
    chol_pallas.chol_solve_cuda(torch.eye(16, device=dev)[None], torch.ones((1, 16), device=dev))
    torch.cuda.synchronize()
    _zero(cuda_lib.launches)
    pipe.syncs.n = 0
    with _Capture(match_pallas, "_match_rows_cuda") as cap:
        records = drive(pipe)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    syncs = pipe.syncs.n
    print("launches in the tracking drive:", json.dumps(launches))
    n_fr = len(records)
    print(f"host syncs: {syncs} over {n_fr} frames + 1 seed frame "
          f"({(syncs - 1) / n_fr:.2f} per tracked frame)")

    # -- path 2, mapper search: triangulate + fuse on rendered keyframes -----
    _zero(cuda_lib.launches)
    s0 = pipe.syncs.n
    t0 = time.perf_counter()
    with _Capture(pallas_kernels, "hamming_matrix_cuda") as hcap:
        mrec = mapper_search(pipe)
    torch.cuda.synchronize()
    map_launches = dict(cuda_lib.launches)
    print(f"mapper search: {time.perf_counter() - t0:.2f} s host (3 renders included), "
          f"{pipe.syncs.n - s0} host syncs, launches {json.dumps(map_launches)}")
    print(f"mapper bounds: accepted >= {MIN_ACCEPTED}, median 3D error <= "
          f"{MAX_MEDIAN_TRI_ERR_M} m, fused >= {MIN_FUSED}")

    # -- path 3, window BA on the bench window -----------------------------
    _zero(cuda_lib.launches)
    ba = window_ba(dev)
    torch.cuda.synchronize()
    ba_launches = dict(cuda_lib.launches)
    print("launches in the BA runs:", json.dumps(ba_launches))
    for name, r in ba.items():
        print(f"window BA {name}: cost0 {r['cost0']:.4f} (JAX-CPU {JAX_BA_COST0}), cost "
              f"{r['cost']:.4f} (JAX-CPU {JAX_BA_COST[name]}); "
              f"local-BA {r['iters_per_s']:.2f} iters/s (median of "
              f"{len(r['solve_ms'])} solves, {r['median_solve_ms']:.3f} ms per "
              f"{BA_ITERS}-iteration solve, quartiles {_pct(r['solve_ms'], 25):.3f} / "
              f"{_pct(r['solve_ms'], 75):.3f} ms); host syncs per solve: "
              f"{r['syncs_in_solve']} inside + {r['fetches_per_solve']} fetch")

    # -- kernel phases at the drive's shapes ---------------------------------
    kernels = []
    # K1 on the EuRoC atlas of a rendered frame, K = 1024
    from monoorbslam3_tpu_torch.models.camera import Pinhole
    from monoorbslam3_tpu_torch.sim import ImageWorld

    img = ImageWorld().render(0.5, Pinhole.create(**EUROC_CAM), R_BC, T_BC,
                              rng=np.random.default_rng(5))
    atlas, ys, xs, _ = pipe.ext._detect(torch.as_tensor(img, device=dev))
    n0 = cuda_lib.launches["gather_patches"]
    got = pallas_kernels.gather_patches_cuda(atlas, ys, xs)
    torch.cuda.synchronize()
    if cuda_lib.launches["gather_patches"] != n0 + 1:
        raise RuntimeError("K1 wrapper did not count its launch")
    ref = pallas_kernels.gather_patches_plain(atlas, ys, xs)
    k1_err = float((got - ref).abs().max())
    if not torch.equal(got, ref):
        raise RuntimeError(f"K1 gather disagrees with its plain version: {k1_err}")
    k1_ms = _time_ms(lambda: pallas_kernels.gather_patches_cuda(atlas, ys, xs))
    k1_plain = _time_ms(lambda: pallas_kernels.gather_patches_plain(atlas, ys, xs))
    print(f"K1 atlas {tuple(atlas.shape)} K={ys.shape[0]}: bit-exact; "
          f"kernel {k1_ms:.4f} ms, plain {k1_plain:.4f} ms")
    kernels.append(dict(name="gather_patches", route="cuda",
                        source="monoorbslam3_tpu_torch/csrc/gather_patches.cu",
                        replaces="monoorbslam3_tpu/ops/pallas_kernels.py:80",
                        launches=launches["gather_patches"], max_abs_err=k1_err,
                        ms=k1_ms, plain_ms=k1_plain))

    # K2 on the last frame's inputs: coarse 1024x1024 and local 4096x1024,
    # tight pass, rows and transposed
    n_calls = cap.n
    last = list(cap.calls)  # per frame: 2 stages x 2 radii x 2 directions
    picks = {"coarse rows": last[0], "coarse transposed": last[1],
             "local rows": last[4], "local transposed": last[5]}
    k2_err, k2_rows = 0.0, []
    for label, a in picks.items():
        got = match_pallas._match_rows_cuda(*a)
        torch.cuda.synchronize()
        ref = match_pallas._match_rows_plain(*a)
        for g, r, nm in zip(got, ref, ("best", "second", "idx")):
            if not torch.equal(g, r):
                raise RuntimeError(f"K2 {label} {nm} disagrees with the plain version")
            k2_err = max(k2_err, float((g.double() - r.double()).abs().max()))
        ms = _time_ms(lambda: match_pallas._match_rows_cuda(*a))
        pms = _time_ms(lambda: match_pallas._match_rows_plain(*a))
        shape = (a[0].shape[0], a[1].shape[0])
        k2_rows.append(dict(pass_=label, shape=shape, ms=ms, plain_ms=pms))
        print(f"K2 {label} {shape[0]}x{shape[1]}: bit-identical; kernel {ms:.4f} ms, "
              f"plain {pms:.4f} ms, valid rows {int((a[6] > 0).sum())}, "
              f"matched rows {int((ref[2] >= 0).sum())}")
    big = next(r for r in k2_rows if r["pass_"] == "local rows")
    kernels.append(dict(name="match_rows", route="cuda",
                        source="monoorbslam3_tpu_torch/csrc/match_rows.cu",
                        replaces="monoorbslam3_tpu/ops/match_pallas.py:43",
                        launches=launches["match_rows"], max_abs_err=k2_err,
                        ms=big["ms"], plain_ms=big["plain_ms"]))
    print(f"K2 launches captured in the drive: {n_calls}")

    # K3 on the mapper search's inputs: triangulation 1024x1024 (KF1 x KF2
    # features) and fuse 1024x1024 (new points x KF3 features)
    k3_rows, k3_err = [], 0.0
    for label, a in zip(("triangulate", "fuse"), hcap.calls):
        got = pallas_kernels.hamming_matrix_cuda(*a)
        torch.cuda.synchronize()
        ref = pallas_kernels.hamming_matrix_plain(*a)
        k3_err = max(k3_err, float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise RuntimeError(f"K3 {label} disagrees with its plain version")
        ms = _time_ms(lambda: pallas_kernels.hamming_matrix_cuda(*a))
        pms = _time_ms(lambda: pallas_kernels.hamming_matrix_plain(*a))
        k3_rows.append(dict(pass_=label, ms=ms, plain_ms=pms))
        print(f"K3 {label} {a[0].shape[0]}x{a[1].shape[0]}: bit-identical; "
              f"kernel {ms:.4f} ms, plain {pms:.4f} ms")
    if len(k3_rows) != 2:
        raise RuntimeError(f"K3: expected the triangulate and fuse launches, got {hcap.n}")
    kernels.append(dict(name="hamming", route="cuda",
                        source="monoorbslam3_tpu_torch/csrc/hamming.cu",
                        replaces="monoorbslam3_tpu/ops/pallas_kernels.py:28",
                        launches=map_launches["hamming"], max_abs_err=k3_err,
                        ms=k3_rows[0]["ms"], plain_ms=k3_rows[0]["plain_ms"]))

    # K4 on every reduced system the BA runs solved (D = 480; G = 1 from the
    # deferred LM, G = 2 from the parallel-lambda LM) and on seeded SPD
    # systems (A A^T + D I) at D = 12, 96, 480
    k4_f64, k4_plain, k4_abs = 0.0, 0.0, 0.0
    rng = np.random.default_rng(44)
    seeded = []
    for D in (12, 96, 480):
        A = rng.normal(size=(2, D, D)).astype(np.float32)
        S = A @ A.transpose(0, 2, 1) + D * np.eye(D, dtype=np.float32)
        seeded.append((torch.as_tensor(S, device=dev),
                       torch.as_tensor(rng.normal(size=(2, D)).astype(np.float32), device=dev)))
    systems = {"BA G=1": ba["flat_deferred"]["systems"], "BA G=2": ba["flat_parallel"]["systems"],
               "seeded": seeded}
    for label, items in systems.items():
        e64, ep = 0.0, 0.0
        for S, b in items:
            x = chol_pallas.chol_solve_cuda(S, b)
            xp = chol_pallas.chol_solve_plain(S, b)
            x64 = torch.linalg.solve(S.double(), b.double())
            e64 = max(e64, float(_rel(x, x64).max()))
            ep = max(ep, float(_rel(x, xp).max()))
            k4_abs = max(k4_abs, float((x - xp).abs().max()))
        k4_f64, k4_plain = max(k4_f64, e64), max(k4_plain, ep)
        print(f"K4 {label}: {len(items)} systems of {tuple(items[-1][0].shape)}; max relative "
              f"error {e64:.3e} vs float64, {ep:.3e} vs the plain version (bound 1e-5)")
        if e64 > 1e-5 or ep > 1e-5:
            raise RuntimeError(f"K4 {label} exceeds 1e-5 relative error")
    k4_rows = []
    for label in ("BA G=1", "BA G=2"):
        S, b = systems[label][-1]
        ms = _time_ms(lambda: chol_pallas.chol_solve_cuda(S, b))
        pms = _time_ms(lambda: chol_pallas.chol_solve_plain(S, b))
        k4_rows.append(dict(pass_=label, ms=ms, plain_ms=pms))
        print(f"K4 {label} {tuple(S.shape)}: kernel {ms:.4f} ms, plain {pms:.4f} ms")
    kernels.append(dict(name="chol_solve", route="cuda",
                        source="monoorbslam3_tpu_torch/csrc/chol_solve.cu",
                        replaces="monoorbslam3_tpu/ops/chol_pallas.py:40",
                        launches=ba_launches["chol_solve"], max_abs_err=k4_abs,
                        max_rel_err_vs_f64=k4_f64, max_rel_err_vs_plain=k4_plain,
                        ms=k4_rows[0]["ms"], plain_ms=k4_rows[0]["plain_ms"],
                        ms_g2=k4_rows[1]["ms"], plain_ms_g2=k4_rows[1]["plain_ms"]))

    # -- results ----------------------------------------------------------------
    t_errs = [r["t_err_m"] for r in records]
    r_errs = [r["r_err_deg"] for r in records]
    for key in ("dev_extract_ms", "dev_coarse_ms", "dev_local_ms", "host_coarse_ms",
                "host_local_ms", "host_frame_ms"):
        xs_ = [r[key] for r in records[1:]] or [r[key] for r in records]
        print(f"{key}: p50 {_pct(xs_, 50):.3f} p90 {_pct(xs_, 90):.3f} "
              f"max {max(xs_):.3f} (frames 2..{n_fr})")
    print(f"pose error: median t {np.median(t_errs):.5f} m (max {max(t_errs):.5f}), "
          f"median R {np.median(r_errs):.5f} deg (max {max(r_errs):.5f}); "
          f"bounds {MAX_MEDIAN_T_ERR_M} m, {MAX_MEDIAN_R_ERR_DEG} deg")
    print("inliers per frame:", [r["n_inliers"] for r in records])
    print("coarse matches per frame:", [r["n_match"] for r in records])

    failures = []
    for path, k, counts in (("tracking", "gather_patches", launches),
                            ("tracking", "match_rows", launches),
                            ("mapper search", "hamming", map_launches),
                            ("window BA", "chol_solve", ba_launches)):
        if counts[k] == 0:
            failures.append(f"kernel {k} was never launched by the {path} path")
    if mrec["n_accepted"] < MIN_ACCEPTED:
        failures.append(f"mapper: {mrec['n_accepted']} points accepted < {MIN_ACCEPTED}")
    if mrec["median_tri_err_m"] > MAX_MEDIAN_TRI_ERR_M:
        failures.append(f"mapper: median 3D error {mrec['median_tri_err_m']} m")
    if mrec["n_fused"] < MIN_FUSED:
        failures.append(f"mapper: {mrec['n_fused']} points fused < {MIN_FUSED}")
    for name, r in ba.items():
        if not r["finite"]:
            failures.append(f"window BA {name}: non-finite points")
        if abs(r["cost0"] - JAX_BA_COST0) > BA_COST0_RTOL * JAX_BA_COST0:
            failures.append(f"window BA {name}: cost0 {r['cost0']} vs {JAX_BA_COST0}")
        if abs(r["cost"] - JAX_BA_COST[name]) > BA_COST_RTOL * JAX_BA_COST[name]:
            failures.append(f"window BA {name}: cost {r['cost']} vs {JAX_BA_COST[name]}")
    for r in records:
        if r["n_inliers"] < MIN_INLIERS:
            failures.append(f"frame {r['frame']}: {r['n_inliers']} inliers < {MIN_INLIERS}")
    if np.median(t_errs) > MAX_MEDIAN_T_ERR_M:
        failures.append(f"median translation error {np.median(t_errs)} m")
    if np.median(r_errs) > MAX_MEDIAN_R_ERR_DEG:
        failures.append(f"median rotation error {np.median(r_errs)} deg")
    print(card)
    print(json.dumps({"kernels": kernels}))
    if failures:
        for f in failures:
            print("FAIL:", f, file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
