#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Drives the port's per-frame visual tracking path (ORB extraction ->
finish_features -> coarse stage -> local stage) over a rendered EuRoC-size
sequence, builds the hand kernels from `monoorbslam3_tpu_torch/csrc/`, shows
that the drive launched them, and holds each kernel against its plain
PyTorch version at the shapes the drive gave it.

    python3 chip_smoke.py    # needs one card; no arguments

Exits non-zero, without the final `{"ok": true, ...}` line, when no CUDA
device is present, when a kernel fails to build, launch or agree, when a
kernel of the path was never launched by the drive, when a frame after the
first keeps fewer than 12 inliers, or when the median pose error exceeds
its bound. Prints, before the last line, the card's name and power limit
and one JSON object with each kernel's launches, error and times.
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


class TorchPipe:
    """The port's tracking path on one CUDA device. `features` brings a
    frame's features to the host (seeding only); `coarse` uploads the frame
    and the coarse candidates, extracts, runs the coarse stage and reads its
    result with one fetch; `local` runs the local stage on the same frame
    with one fetch."""

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


class _CaptureMatchInputs:
    """Keeps the arguments of every K2 launch made inside the block, so the
    kernel phase replays exactly the main path's inputs."""

    def __enter__(self):
        from monoorbslam3_tpu_torch.ops import match_pallas

        self.mod, self.orig = match_pallas, match_pallas._match_rows_cuda
        self.calls, self.n = collections.deque(maxlen=8), 0

        def spy(*args):
            self.calls.append(args)
            self.n += 1
            return self.orig(*args)

        match_pallas._match_rows_cuda = spy
        return self

    def __exit__(self, *exc):
        self.mod._match_rows_cuda = self.orig


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one", file=sys.stderr)
        return 2
    from monoorbslam3_tpu_torch.ops import cuda_lib, match_pallas, pallas_kernels

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

    # -- slice drive: the main path ---------------------------------------
    pipe = TorchPipe(dev)
    # warm-up frame outside the counted run (first launches load modules)
    pipe.features(np.zeros((EUROC_CAM["height"], EUROC_CAM["width"]), np.float32))
    torch.cuda.synchronize()
    for k in cuda_lib.launches:
        cuda_lib.launches[k] = 0
    pipe.syncs.n = 0
    with _CaptureMatchInputs() as cap:
        records = drive(pipe)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    syncs = pipe.syncs.n
    print("launches in the drive:", json.dumps(launches))
    n_fr = len(records)
    print(f"host syncs: {syncs} over {n_fr} frames + 1 seed frame "
          f"({(syncs - 1) / n_fr:.2f} per tracked frame)")

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
    for k, v in launches.items():
        if v == 0:
            failures.append(f"kernel {k} was never launched by the drive")
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
