"""System façade: construction, per-frame dispatch, save/export, reset
(counterpart of `monoorbslam3_tpu/system.py`).

The analog of the reference System (modules/System.h:29-72,
System.cpp:19-228): builds the map store, the solver façade, tracking and
local mapping on one device (the card unless the caller names another,
`utils/device.py`), dispatches `track`, and exports the keyframe
trajectory (TUM format), per-KF velocity and bias, the PCD point cloud and
per-KF sparse depth (System.cpp:125-222), byte for byte the JAX
package's formats.

The default mapper is a deterministic synchronous step per keyframe;
`async_mapper=True` runs it on a host thread fed by a bounded queue with
the JAX package's drain loop. Both threads issue their device work on the
default CUDA stream, which keeps every tensor they share ordered without
events.

`viewer_dir` starts the live viewer thread (`view/viewer.py`: PNGs of the
tracked frames and of map snapshots taken under the map lock; host numpy
only, no device read). `mesh` (a `torch.distributed` DeviceMesh with a
"dp" dimension) sends every window BA through the sharded solver
(`parallel/sharded_ba.py`, `Problems(mesh=)`). A torch mesh runs one
process per rank, so every rank builds a System, tracks every frame
(replicated) and takes part in each window BA's collectives; only the
window BA's landmark blocks are split between the ranks.
"""

from __future__ import annotations

import queue
import threading
import time

import numpy as np
import torch

from .backend.problems import Problems, _identity_edge, upload_inputs, whiten
from .backend.residuals import KfState
from .frontend import tracking as tracking_mod
from .frontend.frame import finish_features
from .frontend.local_mapping import (IMU_INITIALIZED, LocalMapping, _fuse_project_kernel,
                                     _triangulate_pair_kernel)
from .frontend.tracking import Tracking, _coarse_track_kernel, _local_track_kernel
from .models.checkpoint import load_map, save_map
from .models.imu import ImuBuffer, ImuCalib
from .models.map_state import MapStore
from .utils import lie
from .utils.device import CARD, resolve


def _dummy_preint(calib):
    """A two-sample preintegrated window (the whitened edge's shapes do not
    depend on the sample count)."""
    buf = ImuBuffer()
    g = np.zeros(3, np.float32)
    a = np.array([0.0, 0.0, 9.8], np.float32)
    buf.add(g, a, 0.005)
    buf.add(g, a, 0.005)
    return buf.integrate(np.zeros(3, np.float32), np.zeros(3, np.float32), calib)


class System:
    def __init__(self, camera, calib: ImuCalib, config=None, extractor=None,
                 async_mapper: bool = False, vocab=None, viewer_dir: str | None = None,
                 mesh=None, init_extractor=None, device=CARD):
        """vocab: an optional `ops.vocab.Vocabulary` on the same device.
        With one, every frame's descriptors get vocabulary node ids
        (Frame::computeBow, Frame.cpp:168-178) and the reference-KF and
        triangulation searches gate candidates to shared nodes
        (SearchByBow / SearchForTriangulation); without one, matching is
        dense."""
        self.device = resolve(device)
        for name, obj in (("extractor", extractor), ("init_extractor", init_extractor),
                          ("vocab", vocab)):
            if obj is not None and obj.device.type != self.device.type:
                raise ValueError(f"System: the {name} lies on {obj.device}, not on {self.device}")
        cfg = dict(config or {})
        self.camera = camera
        self.calib = calib
        self.extractor = extractor
        # optional higher-capacity extractor used while NOT_INITIALIZED (the
        # reference's 2x-feature initial extractor, Tracking.cpp:24)
        self.init_extractor = init_extractor
        self.vocab = vocab
        n_feat = cfg.get("n_features", extractor.n_features if extractor else 1024)
        cfg["n_features"] = n_feat
        self.store = MapStore(max_kf=cfg.get("max_kf", 512), max_pt=cfg.get("max_pt", 32768),
                              n_feat=n_feat)
        self.problems = Problems(camera, calib, local_k=cfg.get("local_k", 32),
                                 local_p=cfg.get("local_p", 2048),
                                 local_o=cfg.get("local_o", 6144),
                                 full_polish_mode=cfg.get("full_polish_mode", "hybrid"),
                                 full_k=cfg.get("full_k", 96),
                                 window_layout=cfg.get("window_layout", "flat"),
                                 mesh=mesh, device=self.device)
        if extractor is not None:
            cfg.setdefault("scale_factors", extractor.scale_factors)
        self.tracking = Tracking(camera, calib, self.store, self.problems, cfg)
        self.mapper = LocalMapping(self.store, self.problems, calib, self.tracking, cfg)
        self.tracking.new_kf_callback = self._on_new_kf

        self._async = async_mapper
        self._queue: queue.Queue | None = None
        self._thread = None
        self._stop = False
        self._pending_reset = False
        self.mapper_error: BaseException | None = None
        # trajectory segments archived by _do_reset: a late-run reset would
        # otherwise export an empty trajectory; each segment keeps its own
        # gauge (the archive keeps the deliverable, it does not merge gauges)
        self._archived_traj: list[tuple] = []
        # the map_update_mutex analog (Map.h:59, Tracking.cpp:74): a coarse
        # reentrant lock held by the tracker across its whole iteration and
        # by the mapper across every map-mutating stage. The window BA's
        # device solve runs unlocked (problems.run_window_ba re-acquires it
        # for the write-back, Optimize.cpp:925,1264). The tracker's fetches
        # under the lock wait behind whatever the mapper has enqueued on the
        # shared stream, a BA solve included: that costs the frame time, but
        # cannot deadlock, since the mapper neither holds the lock while its
        # solve runs nor needs it to finish the solve.
        self._map_lock = threading.RLock()
        self.mapper.map_lock = self._map_lock
        # the live viewer thread (the reference's Pangolin thread,
        # System.cpp:60-67, rendered headlessly into viewer_dir)
        self.viewer = None
        if viewer_dir is not None:
            from .view.viewer import Viewer

            self.viewer = Viewer(self.store, calib, viewer_dir, fps=cfg.get("viewer_fps", 2.0),
                                 map_lock=self._map_lock)
        if async_mapper:
            # bounded queue; the KF policy vetoes insertion when it is full
            self._queue = queue.Queue(maxsize=cfg.get("mapper_queue_cap", 4))
            self._mapper_busy = False
            self.tracking.mapper_idle = lambda: not self._mapper_busy and self._queue.empty()
            self.tracking.mapper_accepts = lambda: not self._queue.full()
            # the CUDA current device is per thread: the mapper takes ours
            self._cuda_index = (torch.cuda.current_device() if self.device.type == "cuda"
                                else None)
            self._thread = threading.Thread(target=self._mapper_loop, daemon=True)
            self._thread.start()

    # ------------------------------------------------------------------

    def warmup(self):
        """Run every device path once at its live shapes before the stream,
        so that no frame pays a first use: the nvcc build of `csrc/` and a
        launch of both K4 routes (`Problems.warm_solvers`), the extractor
        (K1) and the init extractor with `finish_features` (whose scale
        table goes up once), the triangulation and fuse searches
        (K3), `Vocabulary.transform`, the coarse stage and the local stage
        at both `use_inertial` variants (K2, the pose LMs, the whitening),
        and the IMU window's power-of-two buckets up to 1024 samples (the
        shapes `ImuBuffer.padded` gives). Eager torch compiles nothing, so
        what this hides is the one-time work of a first call: the kernel
        build, the library handles and modules each path loads, and the
        allocator's first blocks. Dummy values: only the shapes matter.
        Optional: skipping it moves the same work to first use."""
        dev = self.device
        self.problems.warm_solvers()
        for ext in (self.extractor, self.init_extractor):
            if ext is not None:
                out = ext(torch.zeros((ext.height, ext.width), dtype=torch.float32, device=dev))
                finish_features(out, self.camera, ext.scale_factors)
        n = self.store.n_feat
        f32 = dict(dtype=torch.float32, device=dev)
        xy = torch.zeros((n, 2), **f32)
        desc = torch.zeros((n, 8), dtype=torch.int32, device=dev)
        val = torch.zeros(n, dtype=torch.bool, device=dev)
        s2 = torch.ones(n, **f32)
        zn = torch.zeros(n, **f32)
        eye = torch.eye(3, **f32)
        z3 = torch.zeros(3, **f32)
        grp = torch.full((n,), -1, dtype=torch.int32, device=dev)
        _triangulate_pair_kernel(xy, desc, val, s2, xy, desc, val, s2, self.camera, eye, z3,
                                 eye, torch.tensor([0.1, 0.0, 0.0], **f32), grp, grp)
        if self.vocab is not None:
            self.vocab.transform(desc, val)
        _fuse_project_kernel(torch.zeros((n, 3), **f32), desc, val, xy, desc, val, s2,
                             self.camera, eye, z3, 4.0)

        tr, calib = self.tracking, self.calib
        st = KfState.zeros(device=dev)
        xyz_n = torch.zeros((n, 3), **f32)
        (radius_n,) = upload_inputs((np.full(n, 15.0, np.float32),), dev)
        _coarse_track_kernel(st, xyz_n, desc, val, zn, zn, xy, desc, val, zn, s2, self.camera,
                             calib.R_cb, calib.t_cb, radius_n, 2 * tr.min_track_inliers,
                             use_rotation=tr.rotation_check)
        P = tr.local_pt_cap
        xyzP = torch.zeros((P, 3), **f32)
        descP = torch.zeros((P, 8), dtype=torch.int32, device=dev)
        valP = torch.zeros(P, dtype=torch.bool, device=dev)
        fP = torch.zeros(P, **f32)
        blockrow = torch.full((n,), -1, dtype=torch.int32, device=dev)
        buf = ImuBuffer()
        z3h = np.zeros(3, np.float32)
        ah = np.array([0.0, 0.0, 9.8], np.float32)
        for n_samples in (1, 65, 129, 257, 513):  # buckets of 64 .. 1024
            while buf.n < n_samples:
                buf.add(z3h, ah, 0.005)
            buf.integrate(z3h, z3h, calib)
        edge_w = whiten(_dummy_preint(calib))
        for use_inertial, edge in ((False, _identity_edge(dev)), (True, edge_w)):
            _local_track_kernel(st, xyzP, descP, valP, xyzP, valP, fP, fP, blockrow,
                                xyz_n, s2, val, xy, desc, val, s2, self.camera, calib.R_cb,
                                calib.t_cb, calib.t_bc, tr.view_cos_gate,
                                2 * tr.min_track_inliers, edge, st, 1.0,
                                use_inertial=use_inertial)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def _on_new_kf(self, k: int, initial: bool = False):
        if self._async:
            self._queue.put((k, initial))
        else:
            self.mapper.process(k, initial=initial)

    def _mapper_loop(self):
        """The async mapper with the reference's drain semantics
        (LocalMapping.cpp:44-60, 383-387): per-KF stages for every queued
        KF, the expensive BA and the inertial init only for the last one
        drained. An exception ends the thread, as in the JAX package; it is
        kept in `mapper_error` and raised by `shutdown`."""
        if self._cuda_index is not None:
            torch.cuda.set_device(self._cuda_index)
        while not self._stop:
            try:
                k, initial = self._queue.get(timeout=0.05)
            except queue.Empty:
                continue
            self._mapper_busy = True
            try:
                while True:
                    # a light pass while more KFs wait; the last drained KF
                    # runs the full pipeline for the whole batch
                    light = not self._queue.empty()
                    try:
                        self.mapper.process(k, initial=initial, light=light)
                    finally:
                        self._queue.task_done()
                    if self._queue.empty():
                        break
                    k, initial = self._queue.get_nowait()
            except queue.Empty:
                pass
            except BaseException as e:
                self.mapper_error = e
                raise
            finally:
                self._mapper_busy = False

    # ------------------------------------------------------------------

    def _assign_bow(self, feats: dict) -> dict:
        """Fill feats["group"] with vocabulary node ids when a vocabulary is
        configured. The ids stay on the device: the tracker reads them with
        the rest of the frame."""
        if self.vocab is not None and feats.get("group") is None:
            desc, valid = feats["desc"], feats["valid"]
            if not isinstance(desc, torch.Tensor):
                desc, valid = upload_inputs((np.asarray(desc), np.asarray(valid)), self.device)
            _, feats["group"], _ = self.vocab.transform(desc, valid)
        return feats

    def track(self, t: float, image, imu=None) -> int:
        """Full path: ORB extraction on the image, then tracking
        (System::Track, System.cpp:86-106). The image goes up through
        pinned memory, and the extract -> finish -> BoW -> preintegrate
        chain stays on the device until the single read inside
        `Tracking.track_feats`."""
        if self._pending_reset:
            self._do_reset()
        assert self.extractor is not None, "System built without an extractor"
        ext = self.extractor
        if (self.init_extractor is not None
                and self.tracking.state in (tracking_mod.NO_IMAGE,
                                            tracking_mod.NOT_INITIALIZED)):
            ext = self.init_extractor
        host_image = None
        if not isinstance(image, torch.Tensor):
            host_image = np.asarray(image, np.float32)
            (image,) = upload_inputs((host_image,), self.device)
        feats = finish_features(ext(image), self.camera, ext.scale_factors)
        feats["group"] = None
        feats = self._assign_bow(feats)
        with self._map_lock:  # Tracking.cpp:74 map_update_mutex
            state, frame = self.tracking.track_feats(t, feats, imu)
        self._show(t, state, frame, host_image)
        return self._handle_lost(state)

    def track_features(self, t: float, feats: dict, imu=None) -> int:
        """Feature-injection path (deterministic tests, non-image sensors)."""
        if self._pending_reset:
            self._do_reset()
        feats = self._assign_bow(dict(feats))
        with self._map_lock:
            state, frame = self.tracking.track_feats(t, feats, imu)
        self._show(t, state, frame, None)
        return self._handle_lost(state)

    def _show(self, t, state, frame, host_image):
        """Hand the viewer the frame's host arrays (FrameDrawer::Update);
        an image that came as a tensor is not drawn (reading it back would
        wait for the device)."""
        if self.viewer is not None:
            self.viewer.update_frame(host_image, frame.xy, frame.pt_ids >= 0,
                                     f"t={t:.2f} state={state} tracked={frame.n_tracked}")

    def _handle_lost(self, state: int) -> int:
        """LOST -> reset (Tracking.cpp:169-173), with the JAX package's
        refinement: a loss before the inertial init of a map younger than
        10 s is a failed bootstrap, so the system resets at once and
        reports NOT_INITIALIZED; an older map asks for a reset (the next
        frame performs it, archiving the trajectory segment)."""
        if state != tracking_mod.LOST:
            return state
        store, mp = self.store, self.mapper
        ids = store.keyframe_ids()
        span = (float(store.kf_time[ids[-1]] - store.kf_time[ids[0]])
                if len(ids) >= 2 else 0.0)
        if mp.imu_state == 0 and span < 10.0:
            self._do_reset()
            self.tracking.state = tracking_mod.NOT_INITIALIZED
            return tracking_mod.NOT_INITIALIZED
        self.request_reset()
        return state

    def get_tracking_state(self) -> int:
        return self.tracking.state

    # ------------------------------------------------------------------
    # reset / shutdown (System.cpp:76-123)
    # ------------------------------------------------------------------

    def request_reset(self):
        self._pending_reset = True

    def _do_reset(self):
        # park the viewer while the map is cleared (the reset's
        # requestStop/release handshake, Viewer.cpp:165-196)
        if self.viewer is not None:
            self.viewer.request_stop()
        if self._async:
            while not self._queue.empty():
                try:
                    self._queue.get_nowait()
                    self._queue.task_done()
                except queue.Empty:
                    break
        with self._map_lock:  # never clear the map under a running mapper stage
            # snapshot the keyframe trajectory before wiping it
            if self.store.n_keyframes() >= 2:
                self._archived_traj.append(self._live_trajectory())
            self.store.reset()
            self.tracking.reset()
            self.mapper.imu_state = 0
            self.mapper.imu_init_time = None
            self.mapper.last_vi_refine = None
            self.mapper.recent_points = []
            self.mapper.kf_counter = 0
        self._pending_reset = False
        if self.viewer is not None:
            self.viewer.release()

    def shutdown(self):
        """Drain the mapper queue (at most 10 s), stop the mapper's thread
        and the viewer's, then run a pending gravity refinement (the
        inertial init fired but the +3 s refinement never met a keyframe),
        as the reference finishes its mapper queue on ShutDown
        (System.cpp:109-119). Raises the mapper thread's exception, if it
        died of one."""
        if self._async and self._thread is not None:
            deadline = time.time() + 10.0
            while ((not self._queue.empty() or self._mapper_busy)
                   and time.time() < deadline and self._thread.is_alive()):
                time.sleep(0.01)
        self._stop = True
        if self._thread is not None:
            self._thread.join(timeout=2.0)
        if self.viewer is not None:
            self.viewer.join()  # request_finish + wait (System.cpp:109-119)
        if self.mapper_error is not None:
            raise RuntimeError("System: the mapper thread failed") from self.mapper_error
        if self.mapper.imu_state == IMU_INITIALIZED and self.store.n_keyframes() >= 3:
            self.mapper.refine_gravity()

    # ------------------------------------------------------------------
    # checkpoint / resume (the npz format of models/checkpoint.py)
    # ------------------------------------------------------------------

    def save_state(self, path: str):
        """Checkpoint the session: the map store (with the per-KF IMU
        replay windows) and the tracking and mapper scalars a resume needs."""
        tr, mp = self.tracking, self.mapper
        save_map(self.store, path, extra={
            "tracking_state": int(tr.state),
            "imu_ready": bool(tr.imu_ready),
            "ref_kf": int(tr.ref_kf),
            "last_kf_id": int(tr.last_kf_id),
            "last_kf_time": float(tr.last_kf_time),
            "kf_tracked_count": int(tr.kf_tracked_count),
            "imu_state": int(mp.imu_state),
            "imu_init_time": None if mp.imu_init_time is None else float(mp.imu_init_time),
            "kf_counter": int(mp.kf_counter),
            # the IMU timeline anchor: a resume appends the gap-free sample
            # stream to the restored since-KF window from here
            "last_stream_time": (None if tr.last_frame is None
                                 else float(tr.last_frame.time)),
        })

    def load_state(self, path: str):
        """Resume from a checkpoint of save_state (either package's). The
        next frame re-acquires the map from the newest keyframe's pose, the
        same path that heals RECENTLY_LOST."""
        T = tracking_mod
        store, extra = load_map(path)
        assert (store.max_kf == self.store.max_kf and store.max_pt == self.store.max_pt
                and store.n_feat == self.store.n_feat), (
            "checkpoint capacities differ from this System's config")
        self.store = store
        self.tracking.store = store
        self.mapper.store = store
        if self.viewer is not None:
            self.viewer.store = store
        tr, mp = self.tracking, self.mapper
        tr.reset()
        tr.state = (T.OK if extra["tracking_state"] in (T.OK, T.RECENTLY_LOST)
                    else extra["tracking_state"])
        tr.imu_ready = extra["imu_ready"]
        tr.ref_kf = extra["ref_kf"]
        tr.last_kf_id = extra["last_kf_id"]
        tr.last_kf_time = extra["last_kf_time"]
        tr.kf_tracked_count = extra["kf_tracked_count"]
        tr.resume_prev_t = extra.get("last_stream_time")
        if tr.last_kf_id >= 0:
            # continue the restored since-last-KF window, so the
            # preintegration stays gap-free
            restored = store.kf_imu.get(tr.last_kf_id)
            if restored is not None:
                tr.kf_imu_buffer = restored
            else:
                store.kf_imu[tr.last_kf_id] = tr.kf_imu_buffer
        mp.imu_state = extra["imu_state"]
        mp.imu_init_time = extra["imu_init_time"]
        mp.kf_counter = extra["kf_counter"]
        mp.recent_points = []
        self._pending_reset = False

    # ------------------------------------------------------------------
    # exports (System.cpp:125-222)
    # ------------------------------------------------------------------

    def keyframe_trajectory(self):
        """(times [K], t_wc [K, 3], q_wc [K, 4] as (w, x, y, z)): camera
        poses in the TUM convention, of the longest segment among the
        archived ones and the live map (each reset starts a new gauge, so
        segments are not concatenated)."""
        live = self._live_trajectory()
        segs = [s for s in self._archived_traj + [live] if len(s[0])]
        if not segs:
            return live
        return max(segs, key=lambda s: len(s[0]))

    def _live_trajectory(self):
        ids = self.store.keyframe_ids()
        R_cb = self.calib.R_cb.cpu().numpy()
        t_cb = self.calib.t_cb.cpu().numpy()
        times, ts, qs = [], [], []
        for k in ids:
            R_cw, t_cw = self.store.kf_pose_cw(k, R_cb, t_cb)
            R_wc = R_cw.T
            t_wc = -R_wc @ t_cw
            q = lie.rot_to_quat(torch.as_tensor(np.asarray(R_wc, np.float32))).numpy()
            times.append(self.store.kf_time[k])
            ts.append(t_wc)
            qs.append(q)
        return np.asarray(times), np.asarray(ts), np.asarray(qs)

    def save_keyframe_trajectory(self, path: str):
        """TUM format: t x y z qx qy qz qw (System.cpp:125-144)."""
        times, ts, qs = self.keyframe_trajectory()
        with open(path, "w") as f:
            for t, p, q in zip(times, ts, qs):
                f.write(f"{t:.6f} {p[0]:.7f} {p[1]:.7f} {p[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

    def save_velocity_and_bias(self, path: str):
        """Per-KF velocity + bias (System.cpp:146-165)."""
        with open(path, "w") as f:
            for k in self.store.keyframe_ids():
                v, bg, ba = self.store.kf_v[k], self.store.kf_bg[k], self.store.kf_ba[k]
                f.write(f"{self.store.kf_time[k]:.6f} "
                        + " ".join(f"{x:.7f}" for x in (*v, *bg, *ba)) + "\n")

    def save_point_cloud(self, path: str):
        """ASCII PCD export (System.cpp:167-194)."""
        pts = self.store.pt_xyz[self.store.pt_valid]
        with open(path, "w") as f:
            f.write("# .PCD v0.7 - Point Cloud Data file format\n")
            f.write("VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n")
            f.write(f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
            f.write(f"POINTS {len(pts)}\nDATA ascii\n")
            for p in pts:
                f.write(f"{p[0]:.5f} {p[1]:.5f} {p[2]:.5f}\n")

    def save_keyframe_depth(self, path: str):
        """Per-KF sparse depth: kf_time and the count, then (u, v, depth) of
        its tracked points (System.cpp:196-222)."""
        R_cb = self.calib.R_cb.cpu().numpy()
        t_cb = self.calib.t_cb.cpu().numpy()
        with open(path, "w") as f:
            for k in self.store.keyframe_ids():
                pids = self.store.kf_feat_pt[k]
                fsel = np.nonzero(pids >= 0)[0]
                R_cw, t_cw = self.store.kf_pose_cw(k, R_cb, t_cb)
                f.write(f"{self.store.kf_time[k]:.6f} {len(fsel)}\n")
                for ff in fsel:
                    p = pids[ff]
                    z = (R_cw @ self.store.pt_xyz[p] + t_cw)[2]
                    uv = self.store.kf_feat_xy[k, ff]
                    f.write(f"{uv[0]:.2f} {uv[1]:.2f} {z:.5f}\n")
