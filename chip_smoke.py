#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

Builds the hand kernels from `monoorbslam3_tpu_torch/csrc/` and drives the
port's fifteen paths, each with the kernel launch counts set to 0 just
before it and read just after:

1. tracking: the per-frame visual tracking path (ORB extraction ->
   finish_features -> coarse stage -> local stage) over 40 rendered
   EuRoC-size frames (kernels K1, K2);
2. visual-inertial tracking: the same frames with IMU samples (200 Hz, the
   EuRoC noise densities, a constant bias) between them; each frame
   preintegrates its own and its keyframe's window on the card, predicts
   its state from the keyframe through the IMU, runs the coarse stage from
   that prediction and the local stage with the whitened inertial edge in
   the 15-dim pose LM (K1, K2); the calibration comes from
   `settings/euroc.yaml`;
3. mapper search: the keyframe searches of local mapping on rendered
   EuRoC-size keyframes, triangulation of a keyframe pair and the fuse of
   the new points into a third keyframe (K3);
4. fisheye mapper search: the same search with the TUM-VI camera
   (`settings/tum_vi.yaml`: 512x512, Kannala-Brandt) (K3);
5. window BA: `schur_ba` on the `bench.py` window (24+8 keyframes, 2048
   points, 6144 observations), flat and grouped layouts (K4, its cluster
   route);
6. polish BA: `schur_ba` on the full polish's window (96 keyframes, all
   free but the anchor, 4096 points, 18,432 observations, grouped layout;
   D = 1440), deferred and parallel-lambda LM, 12 iterations (K4, its
   large-D route: 12 launches a solve);
7. store BA: the `Problems` façade at its default capacities on a map
   store seeded from the trajectory (`seeded_store`: 96 keyframes, 6,000
   wall points, ~900 observations a keyframe, IMU windows at the EuRoC
   profile's noise): the inertial init and gauge rewrite on a 13-keyframe
   store in a rotated, scaled visual frame, then `local_bundle_adjustment`,
   `local_full_bundle_adjustment`, `local_inertial_bundle_adjustment`
   (K4's cluster route, 8 launches each) and `full_inertial_optimize`
   (hybrid: the grouped K = 96 problem with merged IMU windows; K4's
   large-D route, 12 launches), each held to the JAX package's run of the
   same calls on the same store;
8. track map: the system's main loop, the port's `Tracking` and
   `LocalMapping` wired in sync mode over 100 rendered EuRoC-size frames
   (5 s) with IMU between them: extraction, the two-view bootstrap, the
   coarse and local stages, a keyframe every ~0.25 s, each one's mapper
   step (window BAs, triangulation and fuse searches, the inertial init and
   its full polish), every capacity at its default (K1, K2, K3, K4's
   cluster route), held to the JAX package's `System` on the same stream
   (`experiments/port_track_map_jax.py`): bootstrap, OK ratio, init time,
   keyframe ATE, keyframe and point counts, fetches a frame and a mapper
   step, and 0 host syncs inside every stage and BA solve;
9. system world: run_validation.py's circlebow30 through the port's public
   path (`config.build_system` of settings/synthetic_vocab.yaml with the
   100k-leaf vocabulary, `System.warmup`, `runners.synth.SyntheticDataset`,
   `runners.datasets.run_sequence` over 600 frames of 512x384, `shutdown`,
   the five exports, `evaluation.metrics.evaluate_sequences`): every frame
   through `System.track` (extraction, the vocabulary's tree descent, both
   stages, the node-gated reference-keyframe match and triangulation), a
   sync mapper step per keyframe (K1, K2, K3, K4's cluster route, and its
   large-D route when a full polish holds more than local_k keyframes),
   held to the JAX package's run of the same world
   (`experiments/port_system_jax.py`) and the world's bounds; then a
   resume (`load_state` of its checkpoint into a fresh System, the next 20
   frames) and an async run (`async_mapper=True`, 60 frames);
10. dataset CLI: the user's entry point over a dataset on disk,
   `runners.datasets.main(["euroc", ...])` over 100 frames (5 s) of the
   track map's world and stream written in the EuRoC layout (PNG,
   times.txt, imu.txt; a child process renders them while paths 1-9 run),
   at the EuRoC profile's width (752x480, 1,024 features) with the
   reference-scale vocabulary, the three exports, the checkpoint and the
   live viewer (where matplotlib imports): the native loader's decode and
   prefetch, every frame through `System.track`, a sync mapper step per
   keyframe (K1, K2, K3, K4's cluster route), held to the JAX package's
   `main` on the same files (`experiments/port_dataset_cli_jax.py`);
11. sharded BA: a one-rank NCCL process group and its ("dp",) DeviceMesh
   (`parallel/multihost.py`); `parallel/sharded_ba.sharded_schur_ba` on
   the bench window (K4's cluster route, one all_reduce an iteration)
   against `schur_ba` and the JAX-CPU anchors, `Problems(mesh=)` through
   the local BA on the seeded store against the JAX package's run, and
   `parallel/frontend_dp.make_batch_extractor` over 8 frames (K1) against
   one extraction a frame;
12. measure: the port's measuring entry points (`measure_path`), each
   through its `main` or public function: `graft_entry.entry()`'s
   flagship step (K1, K2) on its seeded inputs and on a rendered set,
   held to the JAX package's `__graft_entry__` on the same inputs
   (`experiments/port_graft_jax.py`), with no host sync inside;
   `measure.bench` (local-BA iterations/s flat and grouped, the tracking
   step's frames/s, each with quartiles and n; K4, K1, K2);
   `measure.bench_kernels` (the JAX script's rows and a line a hand
   kernel, each checked against its plain version; K1-K4, both K4
   routes); `measure.e2e` over the circle10 world with the sync mapper
   (rendered by a child process while paths 1-11 run), held to the JAX
   package's run of it (`experiments/port_e2e_jax.py`), with no kernel
   build after the warm-up; `measure.bench_scaling` at one NCCL rank
   (and two, which one card cannot hold: not measured); and
   `graft_entry.dryrun_multichip(1)` in a spawned rank;
13. battery: two of run_validation.py's worlds whole through the port's
   validation runner (`runners.validation.run_world` and `score_world`,
   the runner's `BatteryMeter` counting), their frames rendered by child
   processes while paths 9-12 run: fastspin30 (600 frames of a 52 deg/s
   sweep: the RECENTLY_LOST recoveries and the reference-keyframe match)
   and corridor60 (600 frames of the forward profile at 10 fps, ~200
   keyframes: full polishes on the grouped problem, K4's large-D route,
   and past full_k on the stride subsample, K4's cluster route) (K1-K4),
   held to run_validation.py's verdict and to the JAX package's runs of the
   same worlds (`experiments/port_battery_jax.py`) by `battery_checks`;
14. profiles: `runners.datasets.main(["kitti", ...])` and `main(["tumvi",
   ...])` over the two datasets `write_dataset` renders in child processes
   while paths 10-13 run (KITTI raw: 200 frames of the corridor at 1392x512
   with 1,536 features, 8-bit PNGs and the IMU at 100 Hz in the KITTI
   layout, settings/kitti.yaml; TUM-VI: 400 frames of the circle through
   the 512x512 KB4 fisheye, 16-bit PNGs in the TUM-VI layout,
   settings/tum_vi.yaml), with the reference-scale vocabulary, the exports
   and the checkpoint, every tracker and mapper knob its default (K1-K4,
   both K4 routes), held to the JAX package's `main` on the same files
   (`experiments/port_profiles_jax.py`) by `profiles_checks`;
15. the last four profiles, the same way over the datasets `write_dataset`
   renders from the script's start: the phone (settings/phone.yaml,
   1280x720 at 30 fps, IMU at 100 Hz, its rig turned onto the wall-facing
   rig of settings/synthetic.yaml with its IMU rows in its own frame,
   `phone_body`; 180 frames of the circle, run with --realtime:
   `System.warmup`, then 0 kernel builds, and the frames over the 33 ms
   budget counted), KAIST-VIO (640x480 at 30 fps, 180 frames of the
   corridor), NTU-VIRAL (752x480 at 10 fps with IMU at 385 Hz, 90 frames
   of the corridor) and rectified TUM-VI (the 512x512 pinhole, 160 frames
   of the circle in the TUM-VI layout), each at 1,024 features, each
   through the EuRoC or TUM-VI layout its settings name (the card's host
   has no cv2 for the phone's video), held to the JAX package's `main` on
   the same files by `profiles_checks` and `profile_shape_checks` (the
   camera, the extractor's atlas and K2's rows at each profile's own
   width, height and feature count).

The frames of paths 1, 2 and 8 (the same EuRoC-size frames) are rendered
ahead by a child process (`_Prefetched`, `_Drained`), as are the frames and files
of paths 9, 10, 12, 13, 14 and 15, each by children of their own. Paths
9 and 13-15 run side by side after path 12, in six child processes
(`Lane`: the system world with its resume and async runs in one, each
battery world in one, path 14's two profiles in another, path 15's four
two by two in the last two, VIO_LANES), each with its own launch counts;
their results come back pickled, and the kernel checks run here.

Then it holds each kernel against its plain PyTorch version on the inputs
its path gave it (K2 on all eight launches of the last frame, and on
seeded ties across column chunks; K1, K2 and K3 at KITTI's 1,536
features, K1 on the phone's 1280x720 atlas, K1 and K2 at each of path 15's
profiles' shapes; K4 on every reduced system both BA paths solved, and on
the profiles' windows and polishes), and prints local-BA iterations/s and the polish solve's
wall time. K4 is also held to float64 on seeded SPD systems up to
D = 1440; its large-D route must be a cooperative grid of more than one
block and give the same bits twice; and both of its routes must return
all-NaN, as the plain version does, for systems that are not positive
definite.

Kernel times are device times: a sleep kernel holds the stream while the
host enqueues 20 calls between two CUDA events (`_time_kernel`); each
kernel's host-inclusive time per call stands beside it as `call_ms`, with
its bound (`bound`: bytes over the HBM rate or operations over the peak
of their type, whichever is larger) and the time of one PyTorch call that
computes the same function, where there is one (`library_ms`).

    python3 chip_smoke.py    # needs one card; no arguments
    python3 chip_smoke.py --ab OTHER/   # + A/B of K1-K4 against OTHER/*.cu

K1 is timed twice: on one atlas, which stays in the L2 cache as the
atlas the path has just built does, and cycling through copies of the
atlas that exceed the L2 twice over; each reading stands beside the bound
of its cache state.

Exits non-zero, without the final `{"ok": true, ...}` line, when no CUDA
device is present, when a kernel fails to build, launch or agree, when a
kernel was never launched by its path, when a tracked frame keeps fewer
than 12 inliers or a median pose or prediction error exceeds its bound,
when either mapper search or either BA path's costs leave the bounds set
by the JAX package's run of the same inputs on the CPU, when the inertial
stage (preintegration, deltas, prediction, whitening) waits for the card
even once, when the card's preintegration or whitening leaves the same
functions on the CPU, or when the polish path's solves launch anything
but K4's large-D route, or when a store BA call leaves the JAX
package's costs, outliers, init recovery or polish ATE, syncs inside its
solve or fetches more than its count, or when the track map misses a gate
of `track_map_checks`, or the system world one of `system_world_checks`,
`system_resume_checks` or `system_async_checks`, or the dataset CLI one of
`dataset_cli_checks` (the native loader must have built: the path fails
with the compiler's output otherwise), or the sharded BA one of
`sharded_ba_checks`, or the measuring entry points one of
`measure_checks`, or the battery one of `battery_checks`, or the profiles
one of `profiles_checks` or `profile_shape_checks`. Prints, before the last line, the
card's name and power limit and one JSON object with each kernel's
launches, error and times.
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import copy
import itertools
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import warnings
from pathlib import Path

import numpy as np

# the card's timing tools, one copy in the port's measure/timing.py
from monoorbslam3_tpu_torch.measure.timing import (  # noqa: F401
    F32_OPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S, K2_GATE_OPS, SLEEP_HZ, TIMED_CALLS,
    Capture as _Capture, bound, k1_bound, k2_bound, k3_bound, k4_bound, span_ms as _span_ms,
    time_kernel as _time_kernel)
from monoorbslam3_tpu_torch.measure.bench_kernels import seeded_spd  # noqa: E402,F401

SETTINGS = Path(__file__).resolve().parent / "settings"
# EuRoC MAV (settings/euroc.yaml): the camera of both drives and of the
# first mapper search (cam0, 752x480, radtan), the IMU of the inertial drive
EUROC_PROFILE = "euroc.yaml"

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


# visual-inertial drive: the visual drive's frames with IMU samples between
# them at the profile's rate and noise densities (settings/euroc.yaml:15-20)
# and a constant bias of the drive's own (BG_TRUE, BA_TRUE). The profile
# gives the IMU's noise model; the extrinsics stay the rendering rig's
# (R_BC, T_BC), since the world is rendered through it.
BG_TRUE = np.array([0.004, -0.003, 0.002])
BA_TRUE = np.array([0.03, -0.02, 0.05])
VI_IMU_SEED = 9
# bounds: twice the medians of the same drive through the JAX package on
# the CPU (experiments/port_slice_drive_jax.py --inertial: 0.0760 mm and
# 0.00388 deg after the local stage, 0.0600 mm and 0.00635 deg for the
# IMU-only prediction from the keyframe before any vision; PERF.md records
# the run), rounded up
MAX_VI_MEDIAN_T_ERR_M = 1.53e-4
MAX_VI_MEDIAN_R_ERR_DEG = 0.0078
MAX_VI_MEDIAN_PRED_T_ERR_M = 1.21e-4
MAX_VI_MEDIAN_PRED_R_ERR_DEG = 0.0127
# host syncs a frame: the JAX package's inertial frame makes three (sync A
# of track_feats with the features, both windows and the deltas, then one
# fetch per stage); the drive may make no more
MAX_VI_SYNCS_PER_FRAME = 3
# the card's preintegration and whitening against the port's on the CPU
VI_CARD_RTOL = 1e-5

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
# the same search with the TUM-VI fisheye (settings/tum_vi.yaml), bounds
# from experiments/port_mapper_jax.py's run of it (159 accepted, median 3D
# error 398.8 mm, 122 fused; PERF.md records it): 90% of the counts, 1.5x
# the error. At 191 px of focal length the same half-pixel error moves a
# point ~2.4 times as far as at EuRoC's 458.
FISHEYE_PROFILE = "tum_vi.yaml"
MIN_ACCEPTED_FISHEYE = 143
MAX_MEDIAN_TRI_ERR_FISHEYE_M = 0.598
MIN_FUSED_FISHEYE = 109

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

# polish BA: the full polish's capacities (full_k = 96, full_p = 4096,
# full_opk = 192 of backend/problems.py; every keyframe free but the
# anchor), 12 LM iterations on the grouped layout, D = 15 x 96 = 1440
POLISH_WINDOW = dict(n_kf=96, n_fixed=1, n_pts=4096, obs_per_kf=192)
POLISH_ITERS = 12
POLISH_VARIANTS = {"polish_deferred": dict(deferred=True, grouped_obs=192),
                   "polish_parallel": dict(deferred=False, grouped_obs=192)}
# the JAX package's costs for the same window on the CPU
# (experiments/port_polish_jax.py; PERF.md records the run)
JAX_POLISH_COST0 = 659415.0
JAX_POLISH_COST = {"polish_deferred": 2306.817626953125, "polish_parallel": 2306.812255859375}

# store BA: a map store seeded from the trajectory (`seeded_store`) solved
# through the `Problems` façade's own methods at its default capacities.
# 96 keyframes every 0.25 s (24 s, 1.3 laps of the circle: the second lap
# revisits the first's wall, so covisibility anchors reach back in time)
# over ~6,000 points on the ImageWorld wall (radius 11 m, |z| <= 2 m):
# ~900 features a keyframe, above the 6,144 observations of a 32-keyframe
# window and the 4,096 points of the polish, so the subsample rules run
STORE_KFS, STORE_DT, STORE_POINTS, STORE_SEED = 96, 0.25, 6000, 7
STORE_WALL_RADIUS, STORE_WALL_HALF_HEIGHT = 11.0, 2.0
STORE_POS_NOISE_M, STORE_ROT_NOISE_DEG, STORE_VEL_NOISE = 0.01, 0.2, 0.05
STORE_PT_NOISE_M = 0.02
STORE_OUTLIER_FRAC, STORE_FLIP_BITS = 0.02, 3
# the biases of tests/test_e2e_synthetic.py:42-43 (the store starts at zero)
STORE_BG_TRUE = np.array([0.003, -0.002, 0.001])
STORE_BA_TRUE = np.array([0.02, -0.015, 0.01])
# velocity (0.1 m/s), gyro-bias and acc-bias prior of a keyframe (the
# bias terms of Tracking._create_keyframe)
STORE_PRIOR_INV_SIGMA = [10.0] * 3 + [1e2] * 3 + [1e1] * 3
# the inertial init's store: 13 keyframes over 3 s in a visual frame
# rotated by exp([0.3, -0.2, 0.5]) and scaled by 1/4, positions noised by
# 2e-4 visual units (~0.8 mm), no rotation noise (the setting of
# tests/test_solver.py::test_inertial_init_recovers_scale_under_visual_noise)
INIT_KFS, INIT_POINTS, INIT_SCALE = 13, 2000, 4.0
INIT_ROT_VEC = (0.3, -0.2, 0.5)
INIT_POS_NOISE = 2e-4
# the JAX package's run of the same calls on the same stores on the CPU
# (experiments/port_store_ba_jax.py; PERF.md records the run). Its fetches
# include one of the constant identity edges that the port builds on the
# host, so the port makes one fewer; the pathological-start split (cost0
# above 1e6) adds one read to the port's call, as it adds reads to JAX's
JAX_STORE_INIT = dict(scale=3.8608593771387505,
                      gravity=[0.11486967653036118, 0.32962867617607117, -0.9370965361595154],
                      bg=[0.0027895288076251745, -0.0019404549384489655, 0.0007848991081118584])
JAX_STORE = {
    "local_bundle_adjustment": dict(cost0=49101.69921875, cost=17395.49609375, n_outliers=269,
                                    n_points=1956, fetches=2),
    "local_full_bundle_adjustment": dict(cost0=262295.40625, cost=20578.068359375,
                                         n_outliers=300, n_points=2048, fetches=3),
    "local_inertial_bundle_adjustment": dict(cost0=263516.25, cost=153645.953125,
                                             n_outliers=2783, n_points=1956, fetches=3),
    "full_inertial_optimize": dict(cost0=1855166.25, cost=39994.8203125, n_outliers=380,
                                   n_points=4096, fetches=3, ate_after_m=0.006209856837182448),
}
STORE_ITERS = {"local_bundle_adjustment": 8, "local_full_bundle_adjustment": 8,
               "local_inertial_bundle_adjustment": 8, "full_inertial_optimize": 12}
PATHOLOGICAL_COST0 = 1e6
STORE_SCALE_RTOL, STORE_GRAVITY_DEG, STORE_BG_TOL = 1e-3, 0.05, 1e-5
STORE_OUTLIER_RTOL, STORE_ATE_FACTOR = 0.02, 1.5

# track map: the system's main loop, `Tracking` and `LocalMapping` wired in
# sync mode (tracking.new_kf_callback = mapper.process, as
# System._on_new_kf wires them) over rendered EuRoC-size frames of the
# ImageWorld circle (the EuRoC profile's camera, 20 fps, the frame noise of
# the drives) with IMU samples between them at the profile's rate and noise
# densities and the bias of tests/test_e2e_synthetic.py:42-43
# (STORE_BG_TRUE, STORE_BA_TRUE), from a seeded generator. The tracker and
# mapper knobs of tests/test_e2e_image.py:34-37; every capacity at its
# default (local_k 32, local_p 2048, local_o 6144, full_k 96,
# local_pt_cap 4096); the extractor of the drives (1024 features, 8
# levels, scale 1.2); no vocabulary
TRACK_MAP_FRAMES = 100
TRACK_MAP_IMU_SEED = 9
TRACK_MAP_CONFIG = dict(init_min_features=100, init_min_matches=60, imu_init_kfs=10,
                        max_pt=16384, kf_max_interval=0.25, kf_tracked_ratio=0.85)
TRACK_MAP_MAX_KF = 512  # System's default store capacity
# the JAX package's run of the same stream through its System in sync mode
# on the CPU (experiments/port_track_map_jax.py; PERF.md records the run):
# bootstrap at frame 2, every frame after it OK, the inertial init at frame
# 49 (2.45 s), keyframe ATE 2.594 mm (scale-aligned), 21 keyframes, 1,993
# points; 3 fetches every tracked frame, 6-10 a mapper step (p50 8). Its
# session stays within local_k keyframes, so the full polish after the init
# solves the regular window (K4's cluster route); the large-D route is off
# this path (store_ba drives it)
JAX_TRACK_MAP = dict(bootstrap_frame=2, ok_ratio=1.0, imu_state=1, imu_init_t=2.45,
                     kf_ate_m=0.0025941003731369066, n_kf=21, n_points=1993,
                     fetches_per_tracked_frame=dict(p50=3.0, mean=3.0, max=3.0),
                     fetches_per_mapper_step=dict(p50=8.0, mean=7.2631578947368425, max=10.0))
# the gates: bootstrap at most 5 frames after JAX's (the RANSAC draws
# differ), no LOST frame, the OK ratio after the bootstrap at least 0.9
# (tests/test_e2e_image.py:66-68) and at least JAX's less 0.05, the
# inertial init when JAX's fires and at most 1 s of stream time after it,
# the keyframe ATE at most twice JAX's and below tests/test_e2e_image.py's
# 10 cm, keyframes and points within 30% of JAX's
TM_BOOT_SLACK, TM_OK_MIN, TM_OK_SLACK, TM_INIT_SLACK_S = 5, 0.9, 0.05, 1.0
TM_ATE_FACTOR, TM_ATE_MAX_M, TM_COUNT_RTOL = 2.0, 0.10, 0.30

# path 9, the system world: run_validation.py's circlebow30 (its settings
# with the reference-scale vocabulary, its stream: the circle world at 20
# fps, SyntheticDataset's default seed and sensor noise) through the
# port's public path: build_system -> warmup -> SyntheticDataset ->
# run_sequence -> shutdown -> the exports -> evaluate_sequences. The
# dataset runs to 32 s so that frames 600-639 follow the 600 frames of the
# world's 30 s for the resume run (the seed's draws run in frame order:
# the first 600 frames are the t_end=30 stream's)
SYSTEM_WORLD_SETTINGS = "synthetic_vocab.yaml"
SYSTEM_WORLD_SPEC = "circle:t_end=32,fps=20"
SYSTEM_WORLD_FRAMES = 600
SYSTEM_RESUME_FRAMES = 20
SYSTEM_ASYNC_FRAMES = 60
# the world's bounds (run_validation.py:51-52) and evaluate_sequences'
# association window there (max_dt 0.05)
SYSTEM_WORLD_ATE_BOUND_M, SYSTEM_WORLD_SCALE_BOUND, SYSTEM_WORLD_MAX_DT = 0.4, 0.12, 0.05
# the JAX package's run of the same 600 frames through its System on the
# CPU (experiments/port_system_jax.py; PERF.md records the run): 599 of 600
# frames OK (the first initializes), no LOST frame, the inertial init at
# 2.30 s and imu_state 2 at the end, keyframe ATE 0.02902 m and scale error
# 0.01061 (VALIDATION_r05.json's run of the world read 0.0243 and 0.0110:
# that run is not this one, and the run here is the source), 103 keyframes
# (121 created), 6,151 points; 3 fetches every tracked frame, 6-12 a mapper
# step (p50 8); its full polishes held 11, 23, 34, 47, 60, 72, 84, 91 and
# 101 keyframes (above local_k = 40 and up to full_k = 96 the grouped
# problem of D = 1440, which takes K4's large-D route); its tracker never
# fell back to the node-gated reference-keyframe match
JAX_SYSTEM_WORLD = dict(n_frames=600, ok_frames=599, ok_ratio=599 / 600, n_lost=0, imu_state=2,
                        imu_init_t=2.30, kf_ate_m=0.029022702679932202,
                        scale_err=0.010605668211111752, n_kf=103, kf_created=121,
                        n_points=6151,
                        fetches_per_tracked_frame=dict(p50=3.0, mean=3.0, max=3.0),
                        fetches_per_mapper_step=dict(p50=8.0, mean=8.15126050420168, max=12.0),
                        polish_kf_counts=[11, 23, 34, 47, 60, 72, 84, 91, 101],
                        ref_kf_matches=0)
# the gates (beside the world's bounds): no LOST frame (run_validation.py
# passes a world so), an OK ratio at least JAX's less 0.05, the inertial
# init, the keyframe ATE at most twice JAX's, keyframes within 30% of JAX's;
# the resume run tracks again within 5 frames and keeps an OK ratio of 0.9
SW_OK_SLACK, SW_ATE_FACTOR, SW_KF_RTOL = 0.05, 2.0, 0.30
SW_RESUME_RECOVER, SW_RESUME_OK_MIN = 5, 0.9
# the outcome path 9 prints beside JAX_SYSTEM_WORLD's (the same seed and draws)
SW_SEED_KEYS = ("ok_frames", "imu_init_t", "kf_ate_m", "scale_err", "n_kf", "n_points")
# the vocabulary gate is live: every valid keyframe feature carries a node
# id into the triangulation searches (transform assigns one to every valid
# descriptor)
SW_GROUPED_MIN = 1.0


# K4 phase: seeded systems beside the BA's own (D = 465 is ragged, K = 31;
# D = 768 is the cluster route's capacity on an H100 and 769 the first D
# past it; D = 1440 is the full polish's K = 96)
K4_SPD_DIMS = (12, 96, 465, 480, 768, 769, 1440)
K4_RTOL = 1e-5
# the battery's reduced systems past this condition number are held to
# twice the plain version's backward error (`k4_backward`, the largest over
# the systems of a label) and not to its forward error: past it the
# rounding of an f32 factor sets the forward error (1e-6 at 1e5, up to 0.5
# at 5e8 from float64), and two correct f32 Cholesky codes land 0.1x to 12x
# apart, while the backward errors of both stay at 1e-9 to 3e-9. Below it
# every system both forward errors stayed under K4_RTOL. The polishes reach
# 1e7 and the capped polish past full_k 5e8 within their LM iterations
# (corridor60 on the CPU, experiments/port_chol_ill_conditioned.py; on an
# NVIDIA H100 80GB HBM3 at 700 W one of the battery's systems of condition
# 2e5-7e5 lands 1.28e-5 from float64, past twice the plain version's 5.9e-6)
K4_FWD_COND = 1e5


def k4_split(label, calls):
    """The systems of `calls` ((S, b) pairs) by their condition number:
    {label: those up to K4_FWD_COND, label + ", cond > ...": the rest}
    (a key only where it has systems), and the condition numbers."""
    import torch

    # the 2-norm condition number of a symmetric system from its
    # eigenvalues (an eigensolve, several times cheaper than the SVD)
    conds = []
    for S, _ in calls:
        ev = torch.linalg.eigvalsh(S.double()).abs()
        conds.append(float((ev.amax(-1) / ev.amin(-1)).max()))
    out = {}
    for key, keep in ((label, lambda c: c <= K4_FWD_COND),
                      (f"{label}, cond > {K4_FWD_COND:.0e}", lambda c: c > K4_FWD_COND)):
        mine = [a for a, c in zip(calls, conds) if keep(c)]
        if mine:
            out[key] = mine
    return out, conds


def k4_backward(x, S, b):
    """The normwise backward error of a solve, per system:
    ||b - S x|| / (||S||_F ||x|| + ||b||), in float64."""
    S, b, x = S.double(), b.double(), x.double()
    r = (b[..., None] - S @ x[..., None]).squeeze(-1).norm(dim=-1)
    return r / (S.flatten(-2).norm(dim=-1) * x.norm(dim=-1) + b.norm(dim=-1))

# K2's eight launches a frame, in the order the tracking step makes them
K2_CALLS = tuple(f"{stage} {radius} {direction}" for stage in ("coarse", "local")
                 for radius in ("tight", "wide") for direction in ("rows", "transposed"))


def seeded_not_spd(D, rng, kind):
    """Q diag(ev) Q^T with Q from the QR of a seeded normal matrix:
    "indefinite" has ev = linspace(1, 2, D) with its last entry -1e-3,
    "negative definite" has ev = -linspace(1, 2, D). float32 numpy."""
    Q, _ = np.linalg.qr(rng.normal(size=(D, D)))
    ev = np.linspace(1.0, 2.0, D)
    if kind == "indefinite":
        ev[-1] = -1e-3
    elif kind == "negative definite":
        ev = -ev
    else:
        raise ValueError(kind)
    return ((Q * ev) @ Q.T).astype(np.float32)


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


def drive(pipe, n_frames=40, log=print, images=None):
    """Track `n_frames` rendered frames (`euroc_image`, or `images(i)`: the
    same frames rendered ahead) through `pipe` (see TorchPipe for its
    interface). Returns per-frame records."""
    from monoorbslam3_tpu_torch.sim import ImageWorld

    cam_cpu = host_camera(pipe.profile)
    world = ImageWorld()
    traj = world.traj
    mapw = MapWindow()
    images = images or (lambda i: euroc_image(world, cam_cpu, i))

    img0 = images(0)
    feats0 = pipe.features(img0)
    ids, fidx = mapw.seed(world, cam_cpu, 0.0, feats0)
    prev_ids, prev_ang = ids, feats0["angle"][fidx]
    hist = [_state(traj.R_wb(0.0), traj.pos(0.0))]
    records = []
    for i in range(1, n_frames):
        t = i / FPS
        img = images(i)
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
        state_c = _state(*rc["state"][:2]) if rc["n_match"] >= MIN_INLIERS else pred
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


def _vi_state(traj, t):
    """The true body state at t with the true biases, float32."""
    return tuple(np.asarray(a, np.float32) for a in
                 (traj.R_wb(t), traj.pos(t), traj.vel(t), BG_TRUE, BA_TRUE))


def host_camera(profile):
    """The camera of `profile` (a file under settings/) on the CPU, for
    rendering and scoring: the one source of every path's camera."""
    from monoorbslam3_tpu_torch import config

    return config.build_camera(config.load_settings(SETTINGS / profile), device="cpu")


def vi_drive(pipe, n_frames=40, log=print, images=None):
    """The visual drive's frames through `pipe`'s inertial step: IMU samples
    of the trajectory between frames (the pipe's profile's rate and noise
    densities, BG_TRUE/BA_TRUE), a frame window and a keyframe window (host
    `ImuBuffer`s); every SEED_EVERY frames the map is re-seeded, that frame
    becomes the keyframe with its true state and biases, and the keyframe
    window restarts. Returns (per-frame records, the last frame's keyframe
    window and keyframe state). `images` as `drive`'s."""
    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.models.imu import ImuBuffer
    from monoorbslam3_tpu_torch.sim import ImageWorld

    settings = config.load_settings(SETTINGS / pipe.profile)
    cam_cpu = config.build_camera(settings, device="cpu")
    imu = settings["IMU"]
    freq = float(imu["Frequency"])
    noise = dict(noise_gyro=float(imu["NoiseGyro"]), noise_acc=float(imu["NoiseAcc"]))
    world = ImageWorld()
    traj = world.traj
    mapw = MapWindow()
    rng = np.random.default_rng(VI_IMU_SEED)
    images = images or (lambda i: euroc_image(world, cam_cpu, i))

    img0 = images(0)
    feats0 = pipe.features(img0)
    ids, fidx = mapw.seed(world, cam_cpu, 0.0, feats0)
    prev_ids, prev_ang = ids, feats0["angle"][fidx]
    kf, kf_buf = _vi_state(traj, 0.0), ImuBuffer()
    records = []
    for i in range(1, n_frames):
        t_prev, t = (i - 1) / FPS, i / FPS
        img = images(i)
        g, a, d = traj.imu_samples(t_prev, t, freq, bg=BG_TRUE, ba=BA_TRUE, rng=rng, **noise)
        fr_buf = ImuBuffer()
        for k in range(len(d)):
            fr_buf.add(g[k], a[k], d[k])
            kf_buf.add(g[k], a[k], d[k])
        t0 = time.perf_counter()
        cand, cand_ids = mapw.coarse_candidates(prev_ids, prev_ang)
        rc = pipe.vi_coarse(img, fr_buf, kf_buf, kf, cand)
        t1 = time.perf_counter()
        f = rc["feats"]
        ci = rc["ci"]
        coarse_pid = np.where(ci >= 0, cand_ids[np.maximum(ci, 0)], -1)
        pred = tuple(rc["pred"])
        state_c = tuple(rc["state"]) if rc["n_match"] >= MIN_INLIERS else pred
        lc, win = mapw.local_candidates(coarse_pid, f["sigma2"])
        rl = pipe.vi_local(state_c, lc)
        t2 = time.perf_counter()
        new = np.full(N_FEAT, -1, np.int64)
        new[rl["keep_coarse"]] = coarse_pid[rl["keep_coarse"]]
        lsel = rl["lci"] >= 0
        new[lsel] = win[rl["lci"][lsel]]
        prev_ids, prev_ang = new[new >= 0], f["angle"][new >= 0]
        st = rl["state"]
        R_true, p_true, v_true = traj.R_wb(t), traj.pos(t), traj.vel(t)
        rec = dict(frame=i, n_imu=int(kf_buf.n), n_match=int(rc["n_match"]),
                   n_inl_coarse=int(rc["n_inl"]), n_inliers=int(rl["n_inl"]),
                   n_hit=int(rl["hit"].sum()),
                   t_err_m=float(np.linalg.norm(st[1] - p_true)),
                   r_err_deg=_rot_err_deg(R_true, st[0]),
                   v_err_mps=float(np.linalg.norm(st[2] - v_true)),
                   pred_t_err_m=float(np.linalg.norm(pred[1] - p_true)),
                   pred_r_err_deg=_rot_err_deg(R_true, pred[0]),
                   host_coarse_ms=1e3 * (t1 - t0), host_local_ms=1e3 * (t2 - t1),
                   host_frame_ms=1e3 * (t2 - t0), **rc.get("device_ms", {}),
                   **rl.get("device_ms", {}))
        records.append(rec)
        log(json.dumps(rec))
        last_window = (kf_buf, kf)
        if i % SEED_EVERY == 0:
            mapw.seed(world, cam_cpu, t, f)
            kf, kf_buf = _vi_state(traj, t), ImuBuffer()
    return records, last_window


def mapper_search(pipe, log=print):
    """Render the KF_TIMES keyframes, triangulate the first two through
    `pipe`, fuse the accepted points into the third, and score both against
    the renderer's true world points, all with the camera of `pipe.profile`.
    Returns a summary record."""
    from monoorbslam3_tpu_torch.sim import ImageWorld

    cam_cpu = host_camera(pipe.profile)
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


def window_ba(device, n_runs=15, log=print, window=None, variants=None, iters=BA_ITERS):
    """Every solve of `variants` (BA_VARIANTS) on the bench window, or on
    `bench_window.build_problem(**window)`, on `device`. Per variant:
    one warm-up solve; one solve under the sync debug mode, which counts
    the host syncs inside a solve and K4's launches by route, and gives
    cost0, the converged cost and the inputs of every reduced solve (K4's
    wrapper on the card, its plain version on the CPU); then the wall time
    of `n_runs` whole solves, each ending in the one fetch of its result and
    a synchronize. Returns {variant: record}, with the reduced systems
    under "systems"."""
    import torch

    from monoorbslam3_tpu_torch.backend.solver import schur_ba
    from monoorbslam3_tpu_torch.bench_window import build_problem
    from monoorbslam3_tpu_torch.ops import chol_pallas, cuda_lib
    from monoorbslam3_tpu_torch.utils.fetch import SyncCounter, fetch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    problem, cam = build_problem(seed=0, device=dev, **(window or {}))
    R_cb = torch.eye(3, device=dev)
    t_cb = torch.zeros(3, device=dev)
    syncs = SyncCounter()
    out = {}
    for name, kw in (variants or BA_VARIANTS).items():
        def solve():
            _, pts, info = schur_ba(problem, cam, R_cb, t_cb, n_iters=iters, **kw)
            return pts, info

        fetch(solve()[1]["cost"], syncs)  # warm-up
        solver = "chol_solve_cuda" if on_card else "chol_solve_plain"
        watch = SyncWatch()
        with _Capture(chol_pallas, solver, maxlen=None) as k4:
            before = dict(cuda_lib.launches)
            with watch(on_card):
                pts, info = solve()
            k4_launches = {k: cuda_lib.launches[k] - before[k]
                           for k in ("chol_solve", "chol_solve_l2")}
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
                         syncs_in_solve=watch.n, sync_sites=dict(watch.sites),
                         fetches_per_solve=fetches, solve_ms=[1e3 * t for t in times],
                         median_solve_ms=1e3 * med, iters_per_s=iters / med,
                         k4_launches_in_solve=k4_launches, systems=list(k4.calls))
        log(json.dumps({k: v for k, v in out[name].items() if k != "systems"} | {"variant": name}))
    return out


def polish_ba(device, n_runs=7, log=print):
    """The full polish's window (POLISH_WINDOW: every keyframe free but the
    anchor, grouped layout, 18,432 observations; D = 1440) through
    `window_ba`: POLISH_ITERS iterations of the deferred LM (one reduced
    system a launch of K4's large-D route) and of the parallel-lambda LM
    (two). Cut against a live polish: the window is the bench generator's
    arc, not a map store's keyframes, and it has no merged inertial
    edges."""
    return window_ba(device, n_runs=n_runs, log=log, window=POLISH_WINDOW,
                     variants=POLISH_VARIANTS, iters=POLISH_ITERS)


def _store_profile():
    """(fx, fy, cx, cy, width, height, IMU node) of the EuRoC profile."""
    from monoorbslam3_tpu_torch import config

    s = config.load_settings(SETTINGS / EUROC_PROFILE)
    K = np.asarray(s["Camera"]["CameraMatrix"], np.float64).reshape(3, 3)
    return (K[0, 0], K[1, 1], K[0, 2], K[1, 2], int(s["Camera"]["Width"]),
            int(s["Camera"]["Height"]), s["IMU"])


def seeded_store(store_cls, buf_cls, n_kf=STORE_KFS, n_pts=STORE_POINTS, dt_kf=STORE_DT,
                 seed=STORE_SEED, pos_noise=STORE_POS_NOISE_M, rot_noise_deg=STORE_ROT_NOISE_DEG,
                 vel_noise=STORE_VEL_NOISE, visual_frame=None, n_feat=N_FEAT, max_obs=24):
    """A map store seeded from the synthetic trajectory, numpy only, built
    with the given MapStore and ImuBuffer classes (either package's, so both
    packages solve the same store).

    Keyframes every `dt_kf` seconds along `sim.Trajectory` with the rig's
    extrinsics (R_BC, T_BC); `n_pts` points on the ImageWorld's cylinder
    wall (radius STORE_WALL_RADIUS), each projected with the EuRoC
    profile's pinhole (ideal model, 8 px margin) into every keyframe that
    sees it, at most `n_feat` features a keyframe (a seeded subset), in a
    seeded feature order; pixel noise 0.5 px x 1.2^level (levels 0-2),
    STORE_OUTLIER_FRAC of the observations moved 15-40 px (gross
    outliers); descriptors random u32 words per point with STORE_FLIP_BITS
    bits flipped per observation. Keyframe states perturbed by `pos_noise`
    and `rot_noise_deg` (the first keyframe exact: it anchors the gauge),
    velocities by `vel_noise`, biases zero; the velocity/bias prior
    STORE_PRIOR_INV_SIGMA; each keyframe's IMU window holds the
    trajectory's samples to the next keyframe at the profile's rate and
    noise, biased by STORE_BG_TRUE/STORE_BA_TRUE. Points seen by two
    keyframes or more enter the store (perturbed by STORE_PT_NOISE_M) with
    their observations in keyframe order, then `update_point_stats`.

    `visual_frame=(R_vw, s)` stores the map in a rotated frame scaled by
    1/s (a monocular map before the inertial init): camera centres and
    points are rotated and scaled, the metric lever arm T_BC is kept.

    Returns (store, true body positions [n_kf, 3] in the world frame)."""
    from monoorbslam3_tpu_torch.backend.problems import _np_exp_so3
    from monoorbslam3_tpu_torch.sim import Trajectory

    fx, fy, cx, cy, W, H, imu = _store_profile()
    freq = float(imu["Frequency"])
    rng = np.random.default_rng(seed)
    traj = Trajectory()
    times = dt_kf * np.arange(n_kf)
    R_vw, s_inv = (np.eye(3), 1.0) if visual_frame is None else (visual_frame[0], 1.0 / visual_frame[1])

    th = rng.uniform(0.0, 2.0 * np.pi, n_pts)
    X = np.stack([STORE_WALL_RADIUS * np.cos(th), STORE_WALL_RADIUS * np.sin(th),
                  rng.uniform(-STORE_WALL_HALF_HEIGHT, STORE_WALL_HALF_HEIGHT, n_pts)], 1)
    desc = rng.integers(0, 2 ** 32, (n_pts, 8), dtype=np.uint32)

    store = store_cls(max_kf=max(128, n_kf), max_pt=max(8192, n_pts), n_feat=n_feat,
                      max_obs=max_obs)
    obs = [[] for _ in range(n_pts)]  # (keyframe slot, feature) per point
    for i, t in enumerate(times):
        R_wb, p_wb = traj.R_wb(t), traj.pos(t)
        R_wc = R_wb @ R_BC
        pc = (X - (p_wb + R_wb @ T_BC)) @ R_wc  # camera-frame points
        z = np.maximum(pc[:, 2], 1e-6)
        uv = np.stack([fx * pc[:, 0] / z + cx, fy * pc[:, 1] / z + cy], 1)
        vis = np.nonzero((pc[:, 2] > 0.1) & (uv[:, 0] >= 8) & (uv[:, 0] < W - 8)
                         & (uv[:, 1] >= 8) & (uv[:, 1] < H - 8))[0]
        if len(vis) > n_feat:
            vis = np.sort(rng.choice(vis, n_feat, replace=False))
        n = len(vis)
        slots = rng.permutation(n)
        level = rng.integers(0, 3, n).astype(np.int32)
        noise = rng.normal(scale=0.5, size=(n, 2)) * (SCALE ** level)[:, None]
        bad = rng.uniform(size=n) < STORE_OUTLIER_FRAC
        ang = rng.uniform(0.0, 2.0 * np.pi, n)
        mag = rng.uniform(15.0, 40.0, n)
        noise[bad] = np.stack([mag * np.cos(ang), mag * np.sin(ang)], 1)[bad]
        fdesc = desc[vis].copy()
        for _ in range(STORE_FLIP_BITS):
            b = rng.integers(0, 256, n)
            fdesc[np.arange(n), b // 32] ^= (np.uint32(1) << (b % 32).astype(np.uint32))
        feats = dict(xy=np.zeros((n_feat, 2), np.float32), level=np.zeros(n_feat, np.int32),
                     angle=np.zeros(n_feat, np.float32),
                     desc=np.zeros((n_feat, 8), np.uint32), valid=np.zeros(n_feat, bool),
                     sigma2=np.ones(n_feat, np.float32))
        feats["xy"][slots] = (uv[vis] + noise).astype(np.float32)
        feats["level"][slots] = level
        feats["desc"][slots] = fdesc
        feats["valid"][slots] = True
        feats["sigma2"][slots] = (SCALE ** (2 * level)).astype(np.float32)

        # the stored state: camera centre in the (visual) map frame, the
        # metric lever arm on top
        dR = np.eye(3) if i == 0 else _np_exp_so3(
            rng.normal(size=3) * np.radians(rot_noise_deg) / np.sqrt(3.0))
        R_st = R_vw @ R_wb @ dR
        c_st = R_vw @ (p_wb + R_wb @ T_BC) * s_inv
        t_st = c_st - R_st @ T_BC + (0.0 if i == 0 else rng.normal(scale=pos_noise, size=3))
        v_st = R_vw @ traj.vel(t) * s_inv + rng.normal(scale=vel_noise, size=3)
        z3 = np.zeros(3, np.float32)
        k = store.add_keyframe(float(t), R_st.astype(np.float32), t_st.astype(np.float32),
                               v_st.astype(np.float32), z3, z3, feats,
                               prior_inv_sigma=np.asarray(STORE_PRIOR_INV_SIGMA, np.float32))
        for j, f in zip(vis, slots):
            obs[j].append((k, int(f)))
        if i + 1 < n_kf:
            g, a, d = traj.imu_samples(t, times[i + 1], freq, bg=STORE_BG_TRUE, ba=STORE_BA_TRUE,
                                       noise_gyro=float(imu["NoiseGyro"]),
                                       noise_acc=float(imu["NoiseAcc"]), rng=rng)
            buf = buf_cls()
            for q in range(len(d)):
                buf.add(g[q], a[q], d[q])
            store.kf_imu[k] = buf

    pids = []
    for j in range(n_pts):
        if len(obs[j]) < 2:
            continue
        xyz = R_vw @ (X[j] + rng.normal(scale=STORE_PT_NOISE_M, size=3)) * s_inv
        p = store.add_point(xyz.astype(np.float32), desc[j], obs[j][0][0])
        for k, f in obs[j]:
            store.add_observation(p, k, f)
        pids.append(p)
    store.update_point_stats(pids, R_CB, T_CB, SCALE ** np.arange(N_LEVELS))
    return store, traj.pos(times)


def store_ate(store, true_pos):
    """RMS keyframe position error (m) of the store against the truth, in
    the world frame the first keyframe anchors (no alignment)."""
    ids = store.keyframe_ids()
    err = np.asarray(store.kf_t, np.float64)[ids] - true_pos[:len(ids)]
    return float(np.sqrt((err ** 2).sum(1).mean()))


def store_calibration(calib_cls, **kw):
    """The store's IMU calibration with `calib_cls` (either package's
    ImuCalib): the rig's extrinsics, the EuRoC profile's noise model."""
    imu = _store_profile()[-1]
    return calib_cls.create(R_bc=R_BC, t_bc=T_BC, noise_gyro=float(imu["NoiseGyro"]),
                            noise_acc=float(imu["NoiseAcc"]), walk_gyro=float(imu["WalkGyro"]),
                            walk_acc=float(imu["WalkAcc"]), freq=float(imu["Frequency"]), **kw)


def init_phase(problems, store_cls, buf_cls):
    """`problems.inertial_optimize` on the init store (INIT_*), then the
    gauge rewrite `apply_scale_rotation` as LocalMapping.initialize_imu
    makes it. Returns the recovered scale, gravity direction (the world's
    -z seen in the visual frame), gravity angle to the truth, gyro-bias
    error and the init's costs."""
    from monoorbslam3_tpu_torch.backend.problems import _np_exp_so3

    R_vw = _np_exp_so3(np.asarray(INIT_ROT_VEC))
    st, _ = seeded_store(store_cls, buf_cls, n_kf=INIT_KFS, n_pts=INIT_POINTS,
                         pos_noise=INIT_POS_NOISE, rot_noise_deg=0.0,
                         visual_frame=(R_vw, INIT_SCALE))
    out = problems.inertial_optimize(st)
    if out is None:
        raise RuntimeError("inertial init deferred on the init store")
    st.apply_scale_rotation(out["R_wg"].T, out["scale"], t_bc=T_BC.astype(np.float32))
    g_est = np.asarray(out["R_wg"], np.float64) @ np.array([0.0, 0.0, -1.0])
    g_true = R_vw @ np.array([0.0, 0.0, -1.0])
    return dict(scale=out["scale"], scale_err_rel=abs(out["scale"] - INIT_SCALE) / INIT_SCALE,
                gravity=g_est.tolist(), gravity_err_deg=_angle_deg(g_est, g_true),
                bg=np.asarray(out["bg"], np.float64).tolist(),
                bg_err=float(np.linalg.norm(out["bg"] - STORE_BG_TRUE)),
                cost0=out["cost0"], cost=out["cost"], scale_sigma_rel=out["scale_sigma_rel"])


def _angle_deg(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b)), a @ b)))


def euroc_image(world, camera, i):
    """Frame i of the drives and the track map: `world` (either package's
    ImageWorld) rendered at t = i / FPS through `camera` (that package's
    host camera of the EuRoC profile) on the rig, with the frame's own
    noise seed."""
    return world.render(i / FPS, camera, R_BC, T_BC, rng=np.random.default_rng(i))


def track_map_stream(world, camera, n_frames, images=None):
    """The track-map stream: yields (i, t, image, imu) for frame i at
    t = i / FPS, the image `euroc_image(world, camera, i)` (or `images(i)`,
    the same frame rendered ahead: `_Drained.get`), and `imu` the
    rows (t, gyro, acc) of the samples since the previous frame (None for
    the first), as tests/test_e2e_image.py feeds `System.track`."""
    imu_node = _store_profile()[-1]
    freq = float(imu_node["Frequency"])
    noise = dict(noise_gyro=float(imu_node["NoiseGyro"]), noise_acc=float(imu_node["NoiseAcc"]))
    rng = np.random.default_rng(TRACK_MAP_IMU_SEED)
    last_t = 0.0
    for i in range(n_frames):
        t = i / FPS
        img = euroc_image(world, camera, i) if images is None else images(i)
        imu = None
        if i:
            g, a, d = world.traj.imu_samples(last_t, t, freq, bg=STORE_BG_TRUE, ba=STORE_BA_TRUE,
                                             rng=rng, **noise)
            ts = last_t + np.cumsum(d)
            imu = np.concatenate([ts[:, None], g, a], axis=1)
        yield i, t, img, imu
        last_t = t


class MapperMeter:
    """Stands between the tracker's keyframe hook and `process` (a
    mapper's): runs each step, then `sync`, and records its frame, keyframe,
    host milliseconds, the fetches `count()` saw during it and the host
    syncs `syncs()` saw."""

    def __init__(self, process, count, sync=lambda: None, syncs=lambda: 0):
        self.process, self.count, self.sync, self.syncs = process, count, sync, syncs
        self.steps = []
        self.frame = -1

    def __call__(self, k, initial=False, light=False):
        n0, y0, t0 = self.count(), self.syncs(), time.perf_counter()
        self.process(k, initial=initial, light=light)
        self.sync()
        self.steps.append(dict(frame=self.frame, kf=int(k), initial=bool(initial),
                               host_ms=1e3 * (time.perf_counter() - t0),
                               fetches=self.count() - n0, syncs=self.syncs() - y0))


def track_map_summary(records, steps, store, traj, umeyama):
    """The track-map run's summary from its per-frame records (state,
    n_tracked, imu_state, frame_ms and fetches without the mapper's), its
    mapper steps (`MapperMeter.steps`), the store and the trajectory;
    `umeyama` is either package's `umeyama_align`. The keyframe ATE aligns
    the keyframe body positions to the truth with scale, as
    tests/test_e2e_image.py:81-98 does."""
    states = np.asarray([r["state"] for r in records])
    ok = states == 2
    boot = int(np.argmax(ok)) if ok.any() else None
    after = states[boot:] if boot is not None else states[:0]
    init = [r["frame"] for r in records if r["imu_state"] >= 1]
    tracked = [r for r in records[boot + 1:] if r["state"] == 2] if boot is not None else []
    ids = store.keyframe_ids()
    kt = np.asarray([store.kf_time[k] for k in ids])
    kp = np.stack([store.kf_t[k] for k in ids]).astype(np.float64)
    gt = traj.pos(kt)
    s, R, t = umeyama(kp, gt)
    err = np.linalg.norm((s * kp @ R.T + t) - gt, axis=1)
    regular = [m for m in steps if not m["initial"]]
    return dict(
        n_frames=len(records), bootstrap_frame=boot,
        ok_ratio=float((after == 2).mean()) if len(after) else 0.0,
        n_lost=int((states == 4).sum()), imu_state=int(records[-1]["imu_state"]),
        imu_init_frame=init[0] if init else None,
        imu_init_t=init[0] / FPS if init else None,
        kf_ate_m=float(np.sqrt((err ** 2).mean())), kf_ate_scale=float(s),
        n_kf=len(ids), kf_created=int(store.kf_created_total), n_points=int(store.n_points()),
        n_mapper_steps=len(regular),
        fetches_per_tracked_frame=_stats([r["fetches"] for r in tracked]),
        fetches_per_mapper_step=_stats([m["fetches"] for m in regular]),
        frame_ms=_stats([r["frame_ms"] for r in tracked]),
        mapper_ms=_stats([m["host_ms"] for m in regular]),
        n_tracked=_stats([r["n_tracked"] for r in tracked]))


def store_calls(store):
    """The store BA sequence of `Problems` calls, each (name, fn(problems,
    store)), at the mapper's defaults (window 10, 8 iterations; the polish
    12): the visual covisibility window around the newest keyframe, the
    visual-inertial sliding window, the velocity/bias window, and the full
    polish (hybrid: at 96 keyframes the grouped K = 96 problem with merged
    IMU windows)."""
    newest = store.keyframe_ids()[-1]
    return (("local_bundle_adjustment", lambda pr, st: pr.local_bundle_adjustment(st, newest)),
            ("local_full_bundle_adjustment", lambda pr, st: pr.local_full_bundle_adjustment(st)),
            ("local_inertial_bundle_adjustment",
             lambda pr, st: pr.local_inertial_bundle_adjustment(st)),
            ("full_inertial_optimize", lambda pr, st: pr.full_inertial_optimize(st)))


def store_checks(sba, on_card=True):
    """The store BA path's failures against the JAX package's run
    (JAX_STORE_INIT, JAX_STORE) and, on the card, the path's own counts
    (fetches, syncs inside the solves, K4's launches by route): an empty
    list when every bound holds."""
    fails = []
    init = sba["init"]
    if not abs(init["scale"] / JAX_STORE_INIT["scale"] - 1.0) <= STORE_SCALE_RTOL:
        fails.append(f"store BA init: scale {init['scale']} vs {JAX_STORE_INIT['scale']}")
    if not _angle_deg(init["gravity"], JAX_STORE_INIT["gravity"]) <= STORE_GRAVITY_DEG:
        fails.append(f"store BA init: gravity {init['gravity']} vs {JAX_STORE_INIT['gravity']}")
    if not np.linalg.norm(np.subtract(init["bg"], JAX_STORE_INIT["bg"])) <= STORE_BG_TOL:
        fails.append(f"store BA init: bg {init['bg']} vs {JAX_STORE_INIT['bg']}")
    for name, ref in JAX_STORE.items():
        r = sba["calls"][name]
        for key, tol in (("cost0", BA_COST0_RTOL), ("cost", BA_COST_RTOL)):
            if not abs(r[key] - ref[key]) <= tol * ref[key]:
                fails.append(f"store BA {name}: {key} {r[key]} vs {ref[key]}")
        if abs(r["n_outliers"] - ref["n_outliers"]) > max(1.0, STORE_OUTLIER_RTOL * ref["n_outliers"]):
            fails.append(f"store BA {name}: {r['n_outliers']} outliers vs {ref['n_outliers']}")
        if r["n_points"] != ref["n_points"] or not r["finite"]:
            fails.append(f"store BA {name}: {r['n_points']} points (JAX {ref['n_points']}), "
                         f"finite {r['finite']}")
        if not on_card:
            continue
        want = ref["fetches"] - 1 + (r["cost0"] > PATHOLOGICAL_COST0)
        if r["fetches"] != want:
            fails.append(f"store BA {name}: {r['fetches']} fetches, expected {want}")
        if r["syncs_in_solve"]:
            fails.append(f"store BA {name}: {r['syncs_in_solve']} host syncs inside the solve "
                         f"{r['sync_sites']}")
        route = "chol_solve_l2" if name == "full_inertial_optimize" else "chol_solve"
        if r["k4_launches"] != {**{"chol_solve": 0, "chol_solve_l2": 0},
                                route: STORE_ITERS[name]}:
            fails.append(f"store BA {name}: K4 launches {r['k4_launches']}, expected "
                         f"{STORE_ITERS[name]} of {route}")
    polish = sba["calls"]["full_inertial_optimize"]
    ate_max = STORE_ATE_FACTOR * JAX_STORE["full_inertial_optimize"]["ate_after_m"]
    if not polish["ate_after_m"] <= ate_max:
        fails.append(f"store BA polish: ATE {polish['ate_after_m']} m > {ate_max}")
    return fails


def store_ba(device, n_runs=5, log=print):
    """The store BA path on `device`, through the `Problems` façade at its
    default capacities (the CPU rehearsal passes "cpu"). The launch counts
    are set to 0 after the façade's warm-up, just before the path.

    1. The inertial init on its own 13-keyframe store (`init_phase`).
    2. Each call of `store_calls` on a copy of the 96-keyframe seeded store
       (every call starts from the same bits as the JAX package's run of
       it, `experiments/port_store_ba_jax.py`): one counted run, where the
       solve (`schur_ba`) runs under the sync debug mode, K4's launches are
       counted by route, the façade's fetches are counted and the last
       reduced systems are kept for the K4 phase; then `n_runs` timed runs
       on fresh copies (host clock, each ending in the call's own fetch and
       a synchronize). The polish also reports the keyframe ATE of the
       store before and after it.

    Returns {"init": ..., "calls": {name: record}, "systems": {name:
    [(S, b)]}}."""
    import copy

    import torch

    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.backend import problems as problems_mod
    from monoorbslam3_tpu_torch.backend.problems import Problems
    from monoorbslam3_tpu_torch.models.imu import ImuBuffer, ImuCalib
    from monoorbslam3_tpu_torch.models.map_state import MapStore
    from monoorbslam3_tpu_torch.ops import chol_pallas, cuda_lib

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cam = config.build_camera(config.load_settings(SETTINGS / EUROC_PROFILE), device=dev)
    pr = Problems(cam, store_calibration(ImuCalib, device=dev), device=dev)
    pr.warm_solvers()
    _zero(cuda_lib.launches)  # the warm-up's launches are not the path's
    t0 = time.perf_counter()
    init = init_phase(pr, MapStore, ImuBuffer)
    init["host_s"] = time.perf_counter() - t0
    log(json.dumps({"store_ba": "inertial_optimize"} | init))
    t0 = time.perf_counter()
    base, truth = seeded_store(MapStore, ImuBuffer)
    log(f"store: {base.n_keyframes()} keyframes, {base.n_points()} points, "
        f"{int((base.kf_feat_pt >= 0).sum())} observations, built in "
        f"{time.perf_counter() - t0:.1f} s")

    watch = SyncWatch()
    orig_schur = problems_mod.schur_ba

    def watched_schur(*args, **kwargs):
        with watch(on_card):
            return orig_schur(*args, **kwargs)

    solver = "chol_solve_cuda" if on_card else "chol_solve_plain"
    calls, systems = {}, {}
    for name, fn in store_calls(base):
        st = copy.deepcopy(base)
        ate0 = store_ate(st, truth)
        watch.n, watch.sites = 0, collections.Counter()
        n0, before = pr.syncs.n, dict(cuda_lib.launches)
        problems_mod.schur_ba = watched_schur
        try:
            with _Capture(chol_pallas, solver, maxlen=1) as k4:
                out = fn(pr, st)
        finally:
            problems_mod.schur_ba = orig_schur
        sync()
        rec = dict(cost0=out["cost0"], cost=out["cost"], n_outliers=out["n_outliers"],
                   n_points=out["n_points"], n_kf=len(out["ids"]), n_ie=out["n_ie"],
                   fetches=pr.syncs.n - n0, syncs_in_solve=watch.n,
                   sync_sites=dict(watch.sites),
                   k4_launches={k: cuda_lib.launches[k] - before[k]
                                for k in ("chol_solve", "chol_solve_l2")},
                   ate_before_m=ate0, ate_after_m=store_ate(st, truth),
                   finite=bool(np.isfinite(st.kf_t).all() and np.isfinite(st.pt_xyz).all()))
        systems[name] = list(k4.calls)
        times = []
        for _ in range(n_runs):
            st = copy.deepcopy(base)
            t0 = time.perf_counter()
            fn(pr, st)
            sync()
            times.append(time.perf_counter() - t0)
        rec["wall_ms"] = [1e3 * t for t in times]
        rec["median_wall_ms"] = 1e3 * float(np.median(times)) if times else float("nan")
        calls[name] = rec
        log(json.dumps({"store_ba": name} | {k: v for k, v in rec.items()}))
    return dict(init=init, calls=calls, systems=systems)


class SyncLedger:
    """Records, over a whole run, every host sync that PyTorch's sync debug
    mode reports (nothing off the card), each on the thread that made it:
    the mode is global to the process, and an async mapper's syncs must not
    land on the tracker's frames. `n()` counts the calling thread's, and
    `with ledger.region(name):` adds the syncs its thread makes inside it
    to `counts[name]` (the region's own and its inner regions')."""

    def __init__(self, on_card):
        self.on_card = on_card
        self.by_thread = collections.Counter()
        self.counts = collections.Counter()
        self.sites = collections.Counter()
        self._lock = threading.Lock()

    def n(self):
        return self.by_thread[threading.get_ident()]

    def _seen(self, message, category, filename, lineno, file=None, line=None):
        if "called a synchronizing" in str(message):
            with self._lock:
                self.by_thread[threading.get_ident()] += 1
                self.sites[f"{filename}:{lineno}"] += 1

    @contextlib.contextmanager
    def recording(self):
        if not self.on_card:
            yield self
            return
        import torch

        with warnings.catch_warnings():
            warnings.simplefilter("always")
            # showwarning runs on the warning's own thread
            warnings.showwarning = self._seen
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode("default")

    @contextlib.contextmanager
    def region(self, name):
        n0 = self.n()
        try:
            yield
        finally:
            self.counts[name] += self.n() - n0

    def wrap(self, module, attr, name):
        """Replace module.attr by a wrapper that runs it inside region
        `name`; returns a function that puts the original back."""
        orig = getattr(module, attr)

        def wrapped(*args, **kwargs):
            with self.region(name):
                return orig(*args, **kwargs)

        setattr(module, attr, wrapped)
        return lambda: setattr(module, attr, orig)


# the device work of the track-map path with no host read of its own: the
# two tracking stages, the window BA solve, the mapper's two searches, the
# IMU window preintegration, and the two-view bootstrap (whose batched SVDs
# do read back: counted, not held to 0)
TRACK_MAP_REGIONS = (("frontend.tracking", "_coarse_track_kernel", "coarse stage"),
                     ("frontend.tracking", "_local_track_kernel", "local stage"),
                     ("backend.problems", "schur_ba", "BA solve"),
                     ("frontend.local_mapping", "_triangulate_pair_kernel", "triangulate"),
                     ("frontend.local_mapping", "_fuse_project_kernel", "fuse"),
                     ("models.imu", "preintegrate_tree", "preintegration"),
                     ("frontend.tracking", "reconstruct_two_views", "two-view bootstrap"))


def track_map(pipe, n_frames=TRACK_MAP_FRAMES, log=print, images=None):
    """The track-map path on `pipe`'s device: the port's `Tracking` and
    `LocalMapping` wired in sync mode (the tracker's keyframe hook runs
    `mapper.process` through a `MapperMeter`) over `track_map_stream`:
    each frame extracted by `pipe.ext`, finished on the device and handed
    to `Tracking.track_feats` with its IMU rows. The store, the `Problems`
    façade (every capacity at its default) and the calibration (the rig's
    extrinsics, the EuRoC profile's noise) are built here; the façade's
    warm-up runs before the launch counts are set to 0.

    Per frame: the state, n_tracked, the IMU state, the host time of the
    extraction plus `track_feats` without the mapper's steps, the fetches
    and host syncs (sync debug mode, `SyncLedger`) without the mapper's;
    per mapper step its host time and fetches. Syncs are attributed to the
    regions of TRACK_MAP_REGIONS. `images` as `drive`'s. Returns (records,
    mapper steps, summary)."""
    import torch

    from monoorbslam3_tpu_torch.backend.problems import Problems
    from monoorbslam3_tpu_torch.evaluation.ate import umeyama_align
    from monoorbslam3_tpu_torch.frontend.frame import finish_features
    from monoorbslam3_tpu_torch.frontend.local_mapping import LocalMapping
    from monoorbslam3_tpu_torch.frontend.tracking import Tracking
    from monoorbslam3_tpu_torch.models.imu import ImuCalib
    from monoorbslam3_tpu_torch.models.map_state import MapStore
    from monoorbslam3_tpu_torch.ops import cuda_lib
    from monoorbslam3_tpu_torch.sim import ImageWorld

    dev = pipe.dev
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    cfg = dict(TRACK_MAP_CONFIG, n_features=N_FEAT, scale_factors=pipe.ext.scale_factors)
    store = MapStore(max_kf=TRACK_MAP_MAX_KF, max_pt=cfg["max_pt"], n_feat=N_FEAT)
    problems = Problems(pipe.cam, store_calibration(ImuCalib, device=dev), device=dev)
    tracker = Tracking(pipe.cam, problems.calib, store, problems, cfg)
    mapper = LocalMapping(store, problems, problems.calib, tracker, cfg)
    ledger = SyncLedger(on_card)
    meter = MapperMeter(mapper.process, lambda: problems.syncs.n, sync, ledger.n)
    tracker.new_kf_callback = meter  # System._on_new_kf in sync mode
    problems.warm_solvers()
    world = ImageWorld()
    host_cam = host_camera(pipe.profile)
    records, sync_sites = [], collections.Counter()
    _zero(cuda_lib.launches)  # the warm-up's launches are not the path's
    with recorded(ledger, TRACK_MAP_REGIONS):
        for i, t, img, imu in track_map_stream(world, host_cam, n_frames, images):
            meter.frame = i
            n_steps, n0, s0 = len(meter.steps), problems.syncs.n, ledger.n()
            m0 = dict(ledger.counts)
            t0 = time.perf_counter()
            feats = finish_features(pipe.ext(pipe._up(img)), pipe.cam, pipe.ext.scale_factors)
            feats["group"] = None  # no vocabulary
            state, frame = tracker.track_feats(t, feats, imu)
            sync()
            dt = 1e3 * (time.perf_counter() - t0)
            mine = meter.steps[n_steps:]
            step_syncs = sum(m["syncs"] for m in mine)
            rec = dict(frame=i, t=t, state=int(state), n_tracked=int(frame.n_tracked),
                       imu_state=int(mapper.imu_state),
                       frame_ms=dt - sum(m["host_ms"] for m in mine),
                       fetches=problems.syncs.n - n0 - sum(m["fetches"] for m in mine),
                       syncs=ledger.n() - s0 - step_syncs,
                       regions={k: v - m0.get(k, 0) for k, v in ledger.counts.items()
                                if v - m0.get(k, 0)},
                       n_kf=store.n_keyframes(), n_points=int(store.n_points()))
            records.append(rec)
            log(json.dumps(rec))
            for m in mine:
                log(json.dumps({"mapper_step": m}))
    summary = track_map_summary(records, meter.steps, store, world.traj, umeyama_align)
    summary["launches"] = dict(cuda_lib.launches)
    summary["region_syncs"] = dict(ledger.counts)
    summary["sync_sites"] = dict(ledger.sites)
    return records, meter.steps, summary


def track_map_checks(tm, records, steps, on_card=True):
    """The track-map gates on a `track_map` run against JAX_TRACK_MAP (the
    fetch and sync gates only on the card, where fetches and syncs are
    counted). Returns the failures."""
    ref, fails = JAX_TRACK_MAP, []
    boot = tm["bootstrap_frame"]
    if boot is None or boot > ref["bootstrap_frame"] + TM_BOOT_SLACK:
        fails.append(f"track map: bootstrap at frame {boot}, JAX's at {ref['bootstrap_frame']}")
    if tm["n_lost"]:
        fails.append(f"track map: {tm['n_lost']} LOST frames")
    ok_min = max(TM_OK_MIN, ref["ok_ratio"] - TM_OK_SLACK)
    if not tm["ok_ratio"] >= ok_min:
        fails.append(f"track map: OK ratio {tm['ok_ratio']} < {ok_min}")
    if ref["imu_state"] >= 1:
        if tm["imu_state"] < 1:
            fails.append("track map: the inertial init never fired")
        elif tm["imu_init_t"] > ref["imu_init_t"] + TM_INIT_SLACK_S:
            fails.append(f"track map: inertial init at {tm['imu_init_t']} s, JAX's at "
                         f"{ref['imu_init_t']} s")
    ate_max = min(TM_ATE_FACTOR * ref["kf_ate_m"], TM_ATE_MAX_M)
    if not tm["kf_ate_m"] <= ate_max:
        fails.append(f"track map: keyframe ATE {tm['kf_ate_m']} m > {ate_max} m")
    for key in ("n_kf", "n_points"):
        if abs(tm[key] - ref[key]) > TM_COUNT_RTOL * ref[key]:
            fails.append(f"track map: {key} {tm[key]}, JAX's {ref[key]}")
    if not on_card:
        return fails
    for key in ("fetches_per_tracked_frame", "fetches_per_mapper_step"):
        got, lim = tm[key], ref[key]
        if got is None or got["max"] > lim["max"] or got["p50"] > lim["p50"]:
            fails.append(f"track map: {key} {got}, JAX's {lim}")
    for name, n in tm["region_syncs"].items():
        if n and name != "two-view bootstrap":
            fails.append(f"track map: {n} host syncs inside the {name}")
    after = records[boot + 1:] if boot is not None else []
    for r in after:
        if r["state"] == 2 and r["syncs"] > r["fetches"]:
            fails.append(f"track map: frame {r['frame']} synced {r['syncs']} times for "
                         f"{r['fetches']} fetches")
    for m in steps:
        if m["syncs"] > m["fetches"]:
            fails.append(f"track map: the mapper step of KF {m['kf']} synced {m['syncs']} "
                         f"times for {m['fetches']} fetches")
    return fails


class FrameMeter:
    """Stands in for `system.track` (either package's System; assign it to
    the instance's `track`): runs each frame, then `sync`, and records its
    state, n_tracked, the IMU state, the host milliseconds, fetches
    (`count()`) and host syncs (`syncs()`) of the frame without the mapper
    steps it ran (those `meter` recorded during it; in async mode the
    mapper runs on its own thread and nothing is taken out)."""

    def __init__(self, system, meter, count, sync=lambda: None, syncs=lambda: 0,
                 async_mapper=False, log=lambda line: None):
        self.track, self.system, self.meter = system.track, system, meter
        self.count, self.sync, self.syncs = count, sync, syncs
        self.async_mapper, self.log = async_mapper, log
        self.records = []

    def __call__(self, t, image, imu=None):
        i = len(self.records)
        self.meter.frame = i
        n_steps, n0, s0, t0 = len(self.meter.steps), self.count(), self.syncs(), time.perf_counter()
        state = self.track(t, image, imu)
        self.sync()
        dt = 1e3 * (time.perf_counter() - t0)
        mine = [] if self.async_mapper else self.meter.steps[n_steps:]
        syst = self.system
        last = syst.tracking.last_frame  # None after a reset inside the frame
        rec = dict(frame=i, t=float(t), state=int(state),
                   n_tracked=int(last.n_tracked) if last is not None else 0,
                   imu_state=int(syst.mapper.imu_state),
                   frame_ms=dt - sum(m["host_ms"] for m in mine),
                   fetches=self.count() - n0 - sum(m["fetches"] for m in mine),
                   syncs=self.syncs() - s0 - sum(m["syncs"] for m in mine),
                   n_kf=syst.store.n_keyframes(), n_points=int(syst.store.n_points()))
        self.records.append(rec)
        self.log(json.dumps(rec))
        for m in mine:
            self.log(json.dumps({"mapper_step": m}))
        return state


def on_call(obj, name, note):
    """Wraps obj.name so that note(*args, **kwargs) runs before each call."""
    inner = getattr(obj, name)

    def wrapped(*args, **kwargs):
        note(*args, **kwargs)
        return inner(*args, **kwargs)

    setattr(obj, name, wrapped)


def meter_system(syst, ledger, sync=lambda: None, async_mapper=False, log=lambda line: None):
    """Puts the harness's meters in front of a System (either package's): a
    `MapperMeter` before its mapper's `process` and a `FrameMeter` before
    its `track`, both counting the fetches of its `Problems`' counter and
    `ledger`'s host syncs, and calling `sync` after each frame and step.
    Returns (frames, meter)."""
    count = lambda: syst.problems.syncs.n
    meter = MapperMeter(syst.mapper.process, count, sync, ledger.n)
    syst.mapper.process = meter  # System._on_new_kf calls self.mapper.process
    frames = FrameMeter(syst, meter, count, sync, ledger.n, async_mapper=async_mapper, log=log)
    syst.track = frames
    return frames, meter


@contextlib.contextmanager
def recorded(ledger, regions):
    """`ledger.recording()`, with each (module under the port's package,
    function, region name) of `regions` run inside its region until the
    block ends."""
    import importlib

    restore = [ledger.wrap(importlib.import_module(f"monoorbslam3_tpu_torch.{m}"), attr, name)
               for m, attr, name in regions]
    try:
        with ledger.recording():
            yield ledger
    finally:
        for r in restore:
            r()


def _stats(xs):
    xs = np.asarray(xs, np.float64)
    if not len(xs):
        return None
    return dict(p50=float(np.percentile(xs, 50)), p99=float(np.percentile(xs, 99)),
                mean=float(xs.mean()), max=float(xs.max()))


def system_world_summary(records, steps, system, ate):
    """A `System` run's summary from its `FrameMeter.records`, its
    `MapperMeter.steps`, the system and `ate` (one row of either package's
    `evaluate_sequences` on the written keyframe trajectory): frames, OK
    frames and ratio (over every frame, as run_validation.py counts them),
    LOST events, the bootstrap frame, the inertial init, the keyframe ATE
    and scale error, keyframe and point counts, fetches a tracked frame
    (OK frames after the bootstrap) and a mapper step, and host times."""
    states = np.asarray([r["state"] for r in records])
    ok = states == 2
    boot = int(np.argmax(ok)) if ok.any() else None
    init = [r for r in records if r["imu_state"] >= 1]
    tracked = [r for r in records[boot + 1:] if r["state"] == 2] if boot is not None else []
    regular = [m for m in steps if not m["initial"]]
    store = system.store
    return dict(
        n_frames=len(records), ok_frames=int(ok.sum()),
        ok_ratio=float(ok.mean()) if len(ok) else 0.0, n_lost=int((states == 4).sum()),
        bootstrap_frame=boot, imu_state=int(system.mapper.imu_state),
        imu_init_t=init[0]["t"] if init else None,
        kf_ate_m=float(ate["rmse"]), scale_err=abs(float(ate["scale"]) - 1.0),
        ate_matched=int(ate["n"]), n_kf=store.n_keyframes(),
        kf_created=int(store.kf_created_total), n_points=int(store.n_points()),
        n_mapper_steps=len(regular),
        fetches_per_tracked_frame=_stats([r["fetches"] for r in tracked]),
        fetches_per_mapper_step=_stats([m["fetches"] for m in regular]),
        frame_ms=_stats([r["frame_ms"] for r in tracked]),
        mapper_ms=_stats([m["host_ms"] for m in regular]),
        n_tracked=_stats([r["n_tracked"] for r in tracked]))


# the device work of the system world with no host read of its own: the
# track map's regions and the vocabulary's tree descent
SYSTEM_WORLD_REGIONS = TRACK_MAP_REGIONS + (("ops.vocab", "_transform_impl", "vocabulary"),)
EXPORTS = ("save_keyframe_trajectory", "save_velocity_and_bias", "save_point_cloud",
           "save_keyframe_depth")


# the environment of the render children: one thread each (numpy's BLAS
# would start one a core), and `nice` below the driving process, whose host
# time is what the paths measure
_CHILD_ENV = dict(os.environ, OMP_NUM_THREADS="1", OPENBLAS_NUM_THREADS="1",
                  MKL_NUM_THREADS="1")
_CHILD_NICE = 10

# the child process of `_Prefetched`: renders the frames of a source
# (`rendered_frames`) and writes each, pickled, to its standard output (its
# prints, if any, go to standard error)
_RENDER_CHILD = """
import os, pickle, sys
os.nice({nice!r})
out = os.fdopen(os.dup(1), "wb")
os.dup2(2, 1)
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import chip_smoke
for item in chip_smoke.rendered_frames({source!r}):
    pickle.dump(item, out, protocol=pickle.HIGHEST_PROTOCOL)
    out.flush()
"""


def rendered_frames(source):
    """The frames a render child writes, by source: ("synthetic", spec,
    settings path), the items of SyntheticDataset(spec) on a CPU rig of the
    settings file (the dataset's own bits: it renders from a CPU copy of the
    camera on any device); ("euroc", profile, n), `euroc_image` of frames
    0..n-1 on `profile`'s host camera (the bits the drives and the track map
    render)."""
    kind, *args = source
    if kind == "euroc":
        from monoorbslam3_tpu_torch.sim import ImageWorld

        profile, n = args
        world, camera = ImageWorld(), host_camera(profile)
        return (euroc_image(world, camera, i) for i in range(n))
    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.runners.synth import SyntheticDataset

    spec, settings_path = args
    settings = config.load_settings(str(settings_path))
    return SyntheticDataset(spec, config.build_camera(settings, "cpu"),
                            config.build_imu_calib(settings, "cpu")).frames()


class _Prefetched:
    """The frames of a `rendered_frames` source, rendered ahead by a child
    process (the renderers are host numpy, ~0.3-0.45 s a frame: on the
    run's own thread they would double the path's wall time; in its own
    process, `nice`d by `nice`, a source takes one core and none of the
    frame's clock). `frames()` continues one stream: `run_sequence` draws
    one frame past its `max_frames` before it stops, so that frame is kept
    and handed out first by the next `frames()`. `close()` stops the
    child."""

    def __init__(self, source, nice=_CHILD_NICE):
        code = _RENDER_CHILD.format(root=str(Path(__file__).resolve().parent),
                                    source=tuple(str(a) if isinstance(a, Path) else a
                                                 for a in source), nice=nice)
        self.proc = subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                                     env=_CHILD_ENV)
        self.pending = None

    def frames(self):
        import pickle

        while True:
            if self.pending is None:
                try:
                    self.pending = pickle.load(self.proc.stdout)
                except EOFError:
                    if self.proc.wait() != 0:
                        raise RuntimeError(f"the frame renderer exited ({self.proc.returncode})")
                    return
            yield self.pending
            self.pending = None  # not reached when the consumer stops here

    def close(self):
        self.proc.kill()
        self.proc.wait()
        self.proc.stdout.close()


class _Drained(threading.Thread):
    """Reads a `_Prefetched` stream to its end on a thread of its own, so
    that its child renders the whole stream ahead (a child blocks once its
    pipe is full). `get(i)` waits for frame i; `frames()` waits for the end;
    both raise the reader's error, if it stopped before. `close()` stops
    the child."""

    def __init__(self, stream):
        super().__init__(daemon=True)
        self.stream, self.items, self.error, self.done = stream, [], None, False
        self.ready = threading.Condition()
        self.start()

    def run(self):
        try:
            for item in self.stream.frames():
                with self.ready:
                    self.items.append(item)
                    self.ready.notify_all()
        except BaseException as exc:  # handed to the caller of get() or frames()
            self.error = exc
        finally:
            with self.ready:
                self.done = True
                self.ready.notify_all()

    def get(self, i):
        with self.ready:
            self.ready.wait_for(lambda: len(self.items) > i or self.done)
            if len(self.items) <= i:
                raise RuntimeError(f"the frame renderer stopped at frame {len(self.items)} "
                                   f"({self.error!r})")
            return self.items[i]

    def frames(self):
        self.join()
        if self.error is not None:
            raise self.error
        return self.items

    def close(self):
        self.stream.close()


# the child process of `Lane`: its prints go to standard error (the
# script's standard output ends in the contract's lines); it calls
# chip_smoke.<name>(*args) and pickles what that returns, every tensor moved
# to the host, into a file
_LANE_CHILD = """
import os, pickle, sys
os.dup2(2, 1)
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads({threads!r})
import chip_smoke
result = chip_smoke.to_device(getattr(chip_smoke, {name!r})(*{args!r}), "cpu")
with open({out!r} + ".part", "wb") as f:
    pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
os.replace({out!r} + ".part", {out!r})
"""
# the torch threads of a lane: three lanes share the host's cores
LANE_THREADS = 2


def to_device(obj, device):
    """obj with every tensor in it (through dicts, lists and tuples) moved
    to `device`."""
    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, dict):
        return {k: to_device(v, device) for k, v in obj.items()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # a named tuple
        return type(obj)(*(to_device(v, device) for v in obj))
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_device(v, device) for v in obj)
    return obj


def _wait_file(path, timeout=900.0):
    """Waits until `path` exists; raises after `timeout` seconds."""
    t0 = time.perf_counter()
    while not os.path.exists(path):
        if time.perf_counter() - t0 > timeout:
            raise RuntimeError(f"{path} did not appear within {timeout} s")
        time.sleep(0.1)


class Lane:
    """`chip_smoke.<name>(*args)` in a child process of its own (paths 13
    and 14: each drives a System whose frames are host-bound, so three of
    them run side by side on the host's cores and share the card; each sets
    its own launch counts to 0 before its drive and reads them after). The
    call's result is pickled into `out`. `result(device)` waits for the
    child and returns what the call returned, every tensor on `device`, or
    raises if the child failed. `close()` stops the child."""

    def __init__(self, out, name, *args):
        self.out, self.name = str(out), name
        code = _LANE_CHILD.format(root=str(Path(__file__).resolve().parent), name=name,
                                  args=args, out=self.out, threads=LANE_THREADS)
        self.proc = subprocess.Popen([sys.executable, "-c", code])

    def result(self, device, timeout=1100):
        import pickle

        rc = self.proc.wait(timeout=timeout)
        if rc != 0 or not os.path.exists(self.out):
            raise RuntimeError(f"the lane {self.name} exited ({rc})")
        with open(self.out, "rb") as f:
            return to_device(pickle.load(f), device)

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


def _write_exports(syst, out_dir, tag):
    """The five exports of `syst` into out_dir: the four text files and the
    checkpoint. Returns ({name: path}, the checkpoint's path)."""
    paths = {}
    for name in EXPORTS:
        paths[name] = str(Path(out_dir) / f"{tag}_{name}.txt")
        getattr(syst, name)(paths[name])
    ckpt = str(Path(out_dir) / f"{tag}_state.npz")
    syst.save_state(ckpt)
    paths["save_state"] = ckpt
    return paths, ckpt


def system_world(device, out_dir, n_frames=SYSTEM_WORLD_FRAMES, log=print):
    """The system world on `device` through the port's public path:
    `build_system(SYSTEM_WORLD_SETTINGS)` and `warmup` (each timed), a
    `SyntheticDataset` of SYSTEM_WORLD_SPEC, `run_sequence` over its first
    `n_frames` frames (rendered ahead by `_Prefetched`; each frame through
    `System.track`, metered by
    `FrameMeter`; each mapper step by `MapperMeter`; syncs recorded by
    `SyncLedger` and attributed to SYSTEM_WORLD_REGIONS), `shutdown`, the
    five exports into out_dir, and the keyframe ATE of the written
    trajectory against the written ground truth (`evaluate_sequences`).
    The launch counts are set to 0 after the warm-up. Returns (records,
    mapper steps, summary, the stream to resume from, the checkpoint); the
    caller closes the stream (`system_resume` does)."""
    import torch

    from monoorbslam3_tpu_torch.config import build_system
    from monoorbslam3_tpu_torch.evaluation.metrics import evaluate_sequences, load_tum
    from monoorbslam3_tpu_torch.ops import cuda_lib
    from monoorbslam3_tpu_torch.runners.datasets import run_sequence
    from monoorbslam3_tpu_torch.runners.synth import SyntheticDataset

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t0 = time.perf_counter()
    syst = build_system(str(SETTINGS / SYSTEM_WORLD_SETTINGS), device=device)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    syst.warmup()
    warmup_s = time.perf_counter() - t0
    ledger = SyncLedger(on_card)
    # the keyframes each full polish holds, and the tracker's fallbacks to
    # the node-gated reference-keyframe match
    polishes, ref_kf_matches = [], []
    on_call(syst.problems, "full_inertial_optimize",
            lambda store, *a, **k: polishes.append(store.n_keyframes()))
    on_call(syst.tracking, "_match_against_ref_kf", lambda *a: ref_kf_matches.append(1))
    frames, meter = meter_system(syst, ledger, sync, log=log)
    dataset = SyntheticDataset(SYSTEM_WORLD_SPEC, syst.camera, syst.calib)
    stream = _Prefetched(("synthetic", SYSTEM_WORLD_SPEC, SETTINGS / SYSTEM_WORLD_SETTINGS))
    _zero(cuda_lib.launches)  # the warm-up's launches are not the path's
    t0 = time.perf_counter()
    try:
        with recorded(ledger, SYSTEM_WORLD_REGIONS):
            run_sequence(syst, stream, max_frames=n_frames, progress_every=0,
                         log=lambda line: None)
    except BaseException:
        stream.close()
        raise
    sync()
    run_s = time.perf_counter() - t0
    launches = dict(cuda_lib.launches)
    n_ref_kf = len(ref_kf_matches)
    # the node-gated reference-keyframe search (SearchByBow), replayed after
    # the run on a copy of the last frame against its reference keyframe:
    # the tracker falls back to it only when the last frame's and the last
    # keyframe's matches fail, which a healthy run may never do
    replay = copy.copy(syst.tracking.last_frame)
    replay.pt_ids = replay.pt_ids.copy()
    replay_inliers = bool(syst.tracking._match_against_ref_kf(replay))
    syst.shutdown()
    paths, ckpt = _write_exports(syst, out_dir, "system_world")
    gt = str(Path(out_dir) / "system_world_gt.txt")
    dataset.save_ground_truth(gt)
    (ate,) = evaluate_sequences([("circlebow30", paths["save_keyframe_trajectory"], gt)],
                                max_dt=SYSTEM_WORLD_MAX_DT, log=lambda line: None)
    summary = system_world_summary(frames.records, meter.steps, syst, ate)
    t_est, _, _ = load_tum(paths["save_keyframe_trajectory"])
    # the groups every keyframe's features carry into the triangulation
    # searches' node gate and the reference-keyframe match
    ids = syst.store.keyframe_ids()
    fv = syst.store.kf_feat_valid[ids]
    summary.update(
        ref_kf_matches=n_ref_kf, ref_kf_replay_tracked=replay_inliers,
        kf_features_grouped=float((syst.store.kf_feat_group[ids][fv] >= 0).mean()),
        build_s=build_s, warmup_s=warmup_s, run_s=run_s, launches=launches,
        polish_kf_counts=polishes, region_syncs=dict(ledger.counts),
        sync_sites=dict(ledger.sites),
        exports={k: os.path.getsize(p) if os.path.exists(p) else None for k, p in paths.items()},
        trajectory_rows=len(t_est))
    return frames.records, meter.steps, summary, stream, ckpt


def system_resume(device, ckpt, stream, n_frames=SYSTEM_RESUME_FRAMES, log=print):
    """`load_state` of the system world's checkpoint into a fresh System on
    `device`, then the next `n_frames` frames of the same stream through
    `run_sequence`. Returns its FrameMeter records."""
    from monoorbslam3_tpu_torch.config import build_system
    from monoorbslam3_tpu_torch.runners.datasets import run_sequence

    syst = build_system(str(SETTINGS / SYSTEM_WORLD_SETTINGS), device=device)
    syst.load_state(ckpt)
    frames, _ = meter_system(syst, SyncLedger(False), log=log)
    try:
        run_sequence(syst, stream, max_frames=n_frames, progress_every=0, log=lambda line: None)
    finally:
        stream.close()
    syst.shutdown()
    return frames.records


def system_async(device, out_dir, n_frames=SYSTEM_ASYNC_FRAMES, log=print):
    """`build_system(..., async_mapper=True)` and `warmup`, then the first
    `n_frames` frames of a new SyntheticDataset of SYSTEM_WORLD_SPEC through
    `run_sequence`; the mapper runs on its own thread (each step metered
    there, syncs attributed per thread), so no mapper step is on a frame's
    clock. Returns (records, mapper steps, summary: the system world's
    plus whether the queue drained at `shutdown`)."""
    import torch

    from monoorbslam3_tpu_torch.config import build_system
    from monoorbslam3_tpu_torch.evaluation.metrics import evaluate_sequences
    from monoorbslam3_tpu_torch.runners.datasets import run_sequence
    from monoorbslam3_tpu_torch.runners.synth import SyntheticDataset

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    syst = build_system(str(SETTINGS / SYSTEM_WORLD_SETTINGS), device=device,
                        async_mapper=True)
    syst.warmup()
    ledger = SyncLedger(on_card)
    frames, meter = meter_system(syst, ledger, sync, async_mapper=True, log=log)
    dataset = SyntheticDataset(SYSTEM_WORLD_SPEC, syst.camera, syst.calib)
    stream = _Prefetched(("synthetic", SYSTEM_WORLD_SPEC, SETTINGS / SYSTEM_WORLD_SETTINGS))
    try:
        with ledger.recording():
            run_sequence(syst, stream, max_frames=n_frames, progress_every=0,
                         log=lambda line: None)
            syst.shutdown()
    finally:
        stream.close()
    drained = syst._queue.empty() and not syst._mapper_busy
    est = str(Path(out_dir) / "system_async_trajectory.txt")
    gt = str(Path(out_dir) / "system_async_gt.txt")
    syst.save_keyframe_trajectory(est)
    dataset.save_ground_truth(gt)
    (ate,) = evaluate_sequences([("circlebow30 async", est, gt)],
                                max_dt=SYSTEM_WORLD_MAX_DT, log=lambda line: None)
    summary = system_world_summary(frames.records, meter.steps, syst, ate)
    summary["queue_drained"] = bool(drained)
    return frames.records, meter.steps, summary


def system_world_checks(sw, records, steps, on_card=True):
    """The system world's gates on a `system_world` run against
    JAX_SYSTEM_WORLD and the world's bounds (the fetch and sync gates only
    on the card, where they are counted). Returns the failures."""
    ref, fails = JAX_SYSTEM_WORLD, []
    if sw["n_lost"]:
        fails.append(f"system world: {sw['n_lost']} LOST frames")
    ok_min = ref["ok_ratio"] - SW_OK_SLACK
    if not sw["ok_ratio"] >= ok_min:
        fails.append(f"system world: OK ratio {sw['ok_ratio']} < {ok_min}")
    if sw["imu_state"] < 1:
        fails.append("system world: the inertial init never fired")
    ate_max = min(SW_ATE_FACTOR * ref["kf_ate_m"], SYSTEM_WORLD_ATE_BOUND_M)
    if not sw["kf_ate_m"] <= ate_max:
        fails.append(f"system world: keyframe ATE {sw['kf_ate_m']} m > {ate_max} m")
    if not sw["scale_err"] <= SYSTEM_WORLD_SCALE_BOUND:
        fails.append(f"system world: scale error {sw['scale_err']} > {SYSTEM_WORLD_SCALE_BOUND}")
    if abs(sw["n_kf"] - ref["n_kf"]) > SW_KF_RTOL * ref["n_kf"]:
        fails.append(f"system world: {sw['n_kf']} keyframes, JAX's {ref['n_kf']}")
    for name, size in sw["exports"].items():
        if not size:
            fails.append(f"system world: the export {name} was not written")
    if not sw["kf_features_grouped"] >= SW_GROUPED_MIN:
        fails.append(f"system world: {sw['kf_features_grouped']} of the keyframe features "
                     f"carry a vocabulary group")
    if sw["trajectory_rows"] != sw["n_kf"]:
        fails.append(f"system world: the trajectory file holds {sw['trajectory_rows']} rows "
                     f"for {sw['n_kf']} keyframes")
    if not on_card:
        return fails
    for key in ("fetches_per_tracked_frame", "fetches_per_mapper_step"):
        got, lim = sw[key], ref[key]
        if got is None or got["max"] > lim["max"]:
            fails.append(f"system world: {key} {got}, JAX's {lim}")
    for name, n in sw["region_syncs"].items():
        if n and name != "two-view bootstrap":
            fails.append(f"system world: {n} host syncs inside the {name}")
    boot = sw["bootstrap_frame"]
    for r in records[boot + 1:] if boot is not None else []:
        if r["state"] == 2 and r["syncs"] > r["fetches"]:
            fails.append(f"system world: frame {r['frame']} synced {r['syncs']} times for "
                         f"{r['fetches']} fetches")
    for m in steps:
        if m["syncs"] > m["fetches"]:
            fails.append(f"system world: the mapper step of KF {m['kf']} synced {m['syncs']} "
                         f"times for {m['fetches']} fetches")
    return fails


def system_resume_checks(records):
    """The resume run's gates: tracked again within SW_RESUME_RECOVER
    frames, no LOST frame, an OK ratio of at least SW_RESUME_OK_MIN."""
    states = np.asarray([r["state"] for r in records])
    ok = states == 2
    fails = []
    if not ok[:SW_RESUME_RECOVER].any():
        fails.append(f"resume: no frame tracked within {SW_RESUME_RECOVER} frames")
    if (states == 4).any():
        fails.append(f"resume: {(states == 4).sum()} LOST frames")
    if not ok.mean() >= SW_RESUME_OK_MIN:
        fails.append(f"resume: OK ratio {ok.mean()} < {SW_RESUME_OK_MIN}")
    return fails


def system_lane(device, out_dir, go):
    """Path 9 in a `Lane`: once the file `go` exists, `system_world` on
    `device` with the arguments of its kernels' last launches kept for the
    kernel checks (K2's last eight, a frame; K3's last 4; K1's last; K4's
    last 8 cluster-route systems and last large-D one; the last
    `projected_match`, the node-gated reference-keyframe match), then the
    resume and the async run. Returns dict(records, steps, summary,
    seconds, resume, resume_s, async_records, async_steps, async_summary,
    async_s, k1, k2, k3, k4, k4_l2, ref: (args, kwargs))."""
    import torch

    from monoorbslam3_tpu_torch.frontend import tracking
    from monoorbslam3_tpu_torch.ops import chol_pallas, match_pallas, pallas_kernels

    _wait_file(go)
    t0 = time.perf_counter()
    with _Capture(match_pallas, "_match_rows_cuda") as k2, \
            _Capture(pallas_kernels, "hamming_matrix_cuda", maxlen=4) as k3, \
            _Capture(pallas_kernels, "gather_patches_cuda", maxlen=1) as k1, \
            _Capture(chol_pallas, "chol_solve_cluster", maxlen=8) as k4, \
            _Capture(chol_pallas, "chol_solve_l2", maxlen=1) as k4l2, \
            _Capture(tracking, "projected_match", maxlen=1) as ref:
        records, steps, summary, stream, ckpt = system_world(device, out_dir,
                                                             log=lambda line: None)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    out = dict(records=records, steps=steps, summary=summary, seconds=time.perf_counter() - t0,
               k1=list(k1.calls), k2=list(k2.calls), k3=list(k3.calls), k4=list(k4.calls),
               k4_l2=list(k4l2.calls), ref=(ref.calls[-1], ref.kwargs[-1]))
    t0 = time.perf_counter()
    out["resume"] = system_resume(device, ckpt, stream, log=lambda line: None)
    out["resume_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["async_records"], out["async_steps"], out["async_summary"] = system_async(
        device, out_dir, log=lambda line: None)
    out["async_s"] = time.perf_counter() - t0
    return out


def system_async_checks(sa):
    """The async run's gates: no LOST frame, the inertial init, the
    keyframe ATE within the world's bound, the queue drained at shutdown."""
    fails = []
    if sa["n_lost"]:
        fails.append(f"async: {sa['n_lost']} LOST frames")
    if sa["imu_state"] < 1:
        fails.append("async: the inertial init never fired")
    if not sa["kf_ate_m"] <= SYSTEM_WORLD_ATE_BOUND_M:
        fails.append(f"async: keyframe ATE {sa['kf_ate_m']} m > {SYSTEM_WORLD_ATE_BOUND_M} m")
    if not sa["queue_drained"]:
        fails.append("async: the mapper queue did not drain at shutdown")
    return fails


# path 10, the dataset CLI: the user's entry point over a dataset on disk.
# DATASET_FRAMES frames (5 s, cut from 10 s for the script's time) of the
# track map's world and stream
# (`track_map_stream`: the EuRoC profile's camera, 752x480, the frames'
# noise, IMU at 200 Hz with the profile's noise and the store's bias),
# written in the EuRoC layout with the ground truth (TUM) and a settings
# file beside them: settings/euroc.yaml with the rig's extrinsics (R_BC,
# T_BC) in place of the EuRoC body's, which would point the camera at the
# sky of this world (the track map's calibration makes the same swap,
# `store_calibration`). The 1,024 features, the camera and the noise model
# are the profile's, every tracker and mapper knob its default; the
# vocabulary is the reference-scale one
DATASET_FRAMES = 100
DATASET_VOCAB = "synthetic_voc_100k.txt.gz"
DATASET_SETTINGS_NAME = "settings.yaml"
DATASET_GT_NAME = "gt.txt"
DATASET_EXPORTS = {"--velocity-out": "velocity.txt", "--map-out": "map.pcd",
                   "--depth-out": "depth.txt", "--save-state": "state.npz"}
# the on-disk layouts `runners.datasets` reads, by kind: (times file, image
# folder, image name pattern, IMU file). The phone's (phoneDemo.cpp) is one
# video, `video.mp4` beside times.txt and imu.txt, which cv2 writes and
# decodes; the card's host has no cv2, so the card runs the phone's frames
# from the EuRoC layout (runners.datasets.main takes any settings file with
# any kind)
DATASET_LAYOUTS = {"euroc": ("cam0/times.txt", "cam0/data", "%08d.png", "imu.txt"),
                   "kitti": ("image_00/times.txt", "image_00/data", "%010d.png",
                             "oxts/imu.txt"),
                   "tumvi": ("cam0/times.txt", "cam0/data", "%08d.png", "imu.txt"),
                   "phone": ("times.txt", None, "video.mp4", "imu.txt")}
# the profiles the writer renders, by name: the settings file under
# settings/, the layout kind it is written in (and run as), the synthetic
# world it is rendered in (runners/synth.py's spec; None: the track map's
# stream, above), the frame count and the PNGs' bit depth (TUM-VI's 512_16
# sequences ship 16-bit PNGs, the 8-bit value x 257, which the native
# decoder's 16-bit branch reads back to the same 8-bit values). No profile
# has a `System:` block, so every tracker and mapper knob keeps its
# default. Path 14 (`profiles`): KITTI raw (settings/kitti.yaml as it
# stands: 1392x512, radtan with k1 -0.373 and a fifth coefficient, 1,536
# features, 10 fps, IMU at 100 Hz, the lever arm (1.08, -0.32, 0.72) m; its
# Rbc is the forward profile's, for which the corridor world is built) over
# 20 s of the corridor, 160 m at 8 m/s; TUM-VI (settings/tum_vi.yaml as it
# stands: 512x512 KB4 fisheye, 1,024 features, 20 fps, IMU at 200 Hz; its
# optical axis, -y body, faces the circle world's wall) over 20 s of the
# circle. Path 15 (`profiles` in VIO_LANES): the phone (settings/phone.yaml:
# 1280x720 at 30 fps, IMU at 100 Hz, run with --realtime) over the circle
# in a body frame of its own (`phone_body`); KAIST-VIO (640x480 at 30 fps,
# a forward rig with the lever arm (0.05, 0, 0)) and NTU-VIRAL (752x480 at
# 10 fps, IMU at 385 Hz, the camera rolled 180 deg about its axis) down the
# corridor at 8 m/s; rectified TUM-VI (a ~107 deg pinhole with zero radtan
# coefficients on TUM-VI's rig, 8-bit PNGs in TUM-VI's layout) over the
# circle. Each of these streams is as long as the JAX package's runs over
# seeds 0-3 need to reach imu_state 2, within the script's time (PERF.md
# section 4)
DATASET_PROFILES = {
    "euroc": dict(settings=EUROC_PROFILE, layout="euroc", spec=None, frames=DATASET_FRAMES,
                  depth=8),
    "kitti": dict(settings="kitti.yaml", layout="kitti", spec="corridor:t_end=20,fps=10",
                  frames=200, depth=8),
    "tumvi": dict(settings="tum_vi.yaml", layout="tumvi", spec="circle:t_end=20,fps=20",
                  frames=400, depth=16),
    "phone": dict(settings="phone.yaml", layout="euroc", spec="circle:t_end=6,fps=30",
                  frames=180, depth=8, body="synthetic.yaml", realtime=True),
    "kaist": dict(settings="kaist_vio.yaml", layout="euroc", spec="corridor:t_end=6,fps=30",
                  frames=180, depth=8),
    "ntu": dict(settings="ntu_viral.yaml", layout="euroc", spec="corridor:t_end=9,fps=10",
                frames=90, depth=8),
    "recttum": dict(settings="rect_tum.yaml", layout="tumvi", spec="circle:t_end=8,fps=20",
                    frames=160, depth=8),
}
PROFILE_KINDS = ("kitti", "tumvi")
# path 15's profiles, two lanes of two: NTU-VIRAL runs first in its lane
# while the phone's 180 frames at 1280x720 (the longest render, ~2.2 s a
# frame on one core of the card's host) are still being written
VIO_LANES = (("ntu", "phone"), ("kaist", "recttum"))
VIO_PROFILES = tuple(p for lane in VIO_LANES for p in lane)


def _settings_rbc(name):
    """The IMU's Rbc of settings/<name>, float64 [3, 3]."""
    import yaml

    s = yaml.safe_load((SETTINGS / name).read_text())
    return np.asarray(s["IMU"]["Rbc"], np.float64).reshape(3, 3)


def phone_body(profile="phone"):
    """R_BP of a profile rendered in a body frame of its own (its `body`
    entry), else None: the rotation from the profile's IMU frame P to the
    trajectory's body B, R_bc(body's settings) @ R_bc(profile)^T, which
    puts the camera on the body profile's rig (the phone's Rbc, its optical
    axis on -z, would face the ground or the circle's axis in
    runners/synth.py's worlds, where body z is up). The camera renders at
    R_BP @ R_bc(profile) with the profile's t_bc (the phone's is 0); each
    IMU row is written in P (gyro_P = R_BP^T gyro_B, acc_P = R_BP^T acc_B),
    so gravity lies on P's x axis, as for a phone filming in landscape; the
    ground truth stays the camera's trajectory."""
    body = DATASET_PROFILES[profile].get("body")
    if body is None:
        return None
    return _settings_rbc(body) @ _settings_rbc(DATASET_PROFILES[profile]["settings"]).T


def png_gray(img, depth=8):
    """An 8-bit grayscale image [H, W] as PNG bytes of bit depth 8, or of
    depth 16 with each value x 257 (standard library only: one IDAT of
    filter-0 big-endian rows through zlib, each chunk with its CRC)."""
    import struct
    import zlib

    u8 = np.ascontiguousarray(img, np.uint8)
    h, w = u8.shape
    rows = u8 if depth == 8 else (u8.astype(">u2") * 257).view(np.uint8).reshape(h, 2 * w)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], 1)

    def chunk(tag, data):
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b""))


def png_gray_pixels(data):
    """The pixels [H, W] (uint8, or uint16 at depth 16) of PNG bytes that
    `png_gray` wrote (one IDAT of filter-0 rows; no other PNG)."""
    import struct
    import zlib

    w, h, depth = struct.unpack(">IIB", data[16:25])
    start = data.index(b"IDAT") + 4
    (size,) = struct.unpack(">I", data[start - 8:start - 4])
    raw = np.frombuffer(zlib.decompress(data[start:start + size]), np.uint8)
    rows = raw.reshape(h, -1)[:, 1:]
    return rows.copy() if depth == 8 else rows.copy().view(">u2").astype(np.uint16)


def dataset_settings_text(profile="euroc"):
    """The settings file of a `profile` dataset: its settings file as it
    stands, with the rig's extrinsics on the EuRoC profile (see
    DATASET_FRAMES)."""
    import yaml

    text = (SETTINGS / DATASET_PROFILES[profile]["settings"]).read_text()
    if profile != "euroc":
        return text
    s = yaml.safe_load(text)
    s["IMU"]["Rbc"] = [float(x) for x in np.asarray(R_BC).ravel()]
    s["IMU"]["tbc"] = [float(x) for x in np.asarray(T_BC)]
    return yaml.safe_dump(s, sort_keys=False)


def profile_fps(profile):
    """The frame rate of a profile's stream (its spec's)."""
    from monoorbslam3_tpu_torch.runners.synth import parse_spec

    spec = DATASET_PROFILES[profile]["spec"]
    return FPS if spec is None else parse_spec(spec)[1].get("fps", FPS)


def _dataset_stream(profile, n_frames):
    """(rows (t, image, imu) of the first n_frames frames of a `profile`
    dataset, its trajectory, the R_bc and t_bc it renders at): the track
    map's stream on the rig's extrinsics for EuRoC, else
    `runners.synth.SyntheticDataset` of the profile's spec on a CPU camera
    and calibration built from the profile's settings, at its frame rate
    (the spec's), IMU rate and noise densities; a profile with a body frame
    of its own renders and writes its IMU rows as `phone_body` says."""
    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.runners.synth import SyntheticDataset
    from monoorbslam3_tpu_torch.sim import ImageWorld

    prof = DATASET_PROFILES[profile]
    if prof["spec"] is None:
        world = ImageWorld()
        rows = ((t, img, imu) for _, t, img, imu in
                track_map_stream(world, host_camera(prof["settings"]), n_frames))
        return rows, world.traj, np.asarray(R_BC), np.asarray(T_BC)
    s = config.load_settings(str(SETTINGS / prof["settings"]))
    imu = s["IMU"]
    ds = SyntheticDataset(prof["spec"], config.build_camera(s, "cpu"),
                          config.build_imu_calib(s, "cpu"), imu_freq=float(imu["Frequency"]),
                          noise_gyro=float(imu["NoiseGyro"]), noise_acc=float(imu["NoiseAcc"]))
    R_BP = phone_body(profile)
    if R_BP is not None:
        ds.R_bc = R_BP @ _settings_rbc(prof["settings"])
    # where a frame period is no whole number of IMU periods, the
    # generator's last sample of each frame (measured at its interval's
    # start, as every sample) runs past the frame's time: its row is written
    # at the frame's time, so that a frame's rows span its period exactly
    # as the loaders and the tracker (a row's dt: its time less the one
    # before) read them
    trim = not (float(imu["Frequency"]) / profile_fps(profile)).is_integer()
    if R_BP is None and not trim:
        return itertools.islice(ds.frames(), n_frames), ds.traj, ds.R_bc, ds.t_bc

    def rows():
        for t, img, m in itertools.islice(ds.frames(), n_frames):
            if m is not None:
                m = m.copy()
                if trim:
                    m[:, 0] = np.minimum(m[:, 0], t)
                if R_BP is not None:  # (gyro, acc) rows: each v_P = R_BP^T v_B
                    m[:, 1:4] = m[:, 1:4] @ R_BP
                    m[:, 4:7] = m[:, 4:7] @ R_BP
            yield t, img, m

    return rows(), ds.traj, ds.R_bc, ds.t_bc


def _write_video(path, frames_u8, fps):
    """8-bit gray frames into an mp4v video through cv2, as BGR (the
    layout phoneDemo.cpp reads)."""
    import cv2

    h, w = frames_u8[0].shape
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
    try:
        for u8 in frames_u8:
            writer.write(cv2.cvtColor(u8, cv2.COLOR_GRAY2BGR))
    finally:
        writer.release()


def write_dataset(root, profile="euroc", n_frames=None, layout=None):
    """Renders the first n_frames frames (the profile's count by default)
    of a `profile` dataset (DATASET_PROFILES) with the port's renderer on
    the CPU into `root` in its layout (DATASET_LAYOUTS; `layout` names
    another, "phone" for the video), with DATASET_SETTINGS_NAME and the
    ground truth (the camera's TUM trajectory at the frame times) beside
    them. The images are the rendered floats clipped and cast to uint8."""
    import torch

    from monoorbslam3_tpu_torch.utils import lie

    prof = DATASET_PROFILES[profile]
    n_frames = prof["frames"] if n_frames is None else n_frames
    times_rel, image_rel, pattern, imu_rel = DATASET_LAYOUTS[layout or prof["layout"]]
    root = Path(root)
    for rel in (times_rel, imu_rel):
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
    if image_rel is not None:
        (root / image_rel).mkdir(parents=True, exist_ok=True)
    (root / DATASET_SETTINGS_NAME).write_text(dataset_settings_text(profile))
    rows, traj, R_bc, t_bc = _dataset_stream(profile, n_frames)
    # frame times at 6 decimals where the frame period is exact there (10
    # and 20 fps), else at the IMU rows' 9: a 30 fps time rounded down to 6
    # decimals would fall before the IMU row of the same instant, and the
    # loaders would hand that row to the next frame
    digits = 6 if (1e6 / profile_fps(profile)).is_integer() else 9
    video = []
    with open(root / times_rel, "w") as ft, open(root / imu_rel, "w") as fi, \
            open(root / DATASET_GT_NAME, "w") as fg:
        for i, (t, img, imu) in enumerate(rows):
            u8 = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
            if image_rel is None:
                video.append(u8)
            else:
                (root / image_rel / (pattern % i)).write_bytes(png_gray(u8, prof["depth"]))
            ft.write(f"{t:.{digits}f}\n")
            for row in imu if imu is not None else ():
                fi.write(" ".join(f"{x:.9f}" for x in row) + "\n")
            R_wb = traj.R_wb(t)
            R_wc = R_wb @ R_bc
            t_wc = R_wb @ t_bc + traj.pos(t)
            q = lie.rot_to_quat(torch.as_tensor(np.asarray(R_wc, np.float32))).numpy()
            fg.write(f"{t:.{digits}f} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
                     f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")
    if image_rel is None:
        _write_video(root / pattern, video, float(profile_fps(profile)))
    (root / "done").write_text(str(n_frames))


def dataset_digest(root, profile):
    """The sha256 over a written dataset's files that the runners read (the
    settings, times, IMU rows, ground truth and every PNG, in name order),
    and the sha256 of each PNG by name: two renderers' datasets compare
    by it."""
    import hashlib

    times_rel, image_rel, _, imu_rel = DATASET_LAYOUTS[DATASET_PROFILES[profile]["layout"]]
    root = Path(root)
    total, pngs = hashlib.sha256(), {}
    for rel in (DATASET_SETTINGS_NAME, times_rel, imu_rel, DATASET_GT_NAME):
        total.update((root / rel).read_bytes())
    for p in sorted((root / image_rel).iterdir()):
        data = p.read_bytes()
        pngs[p.name] = hashlib.sha256(data).hexdigest()
        total.update(data)
    return total.hexdigest(), pngs


# the child process of `DatasetWriter`: writes the dataset, then the
# seconds that took into DatasetWriter.SECONDS_NAME beside it
_DATASET_CHILD = """
import os, sys, time
os.nice({nice!r})
t0 = time.perf_counter()
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(1)
import chip_smoke
chip_smoke.write_dataset({out!r}, {profile!r}, {n!r})
with open(os.path.join({out!r}, chip_smoke.DatasetWriter.SECONDS_NAME), "w") as f:
    f.write(str(time.perf_counter() - t0))
"""


class DatasetWriter:
    """`write_dataset(out, profile, n_frames)` in a child process, started at
    once so that the rendering (host numpy, ~0.4 s a 752x480 frame)
    overlaps the caller's other work; `wait()` returns the dataset's root,
    or raises if the child failed, and sets `seconds`, the child's own
    time."""

    SECONDS_NAME = "written_s.txt"

    def __init__(self, out, profile="euroc", n_frames=None):
        self.out = str(out)
        code = _DATASET_CHILD.format(root=str(Path(__file__).resolve().parent), out=self.out,
                                     profile=profile, n=n_frames, nice=_CHILD_NICE)
        self.proc = subprocess.Popen([sys.executable, "-c", code], env=_CHILD_ENV)
        self.seconds = None

    def wait(self, timeout=900):
        rc = self.proc.wait(timeout=timeout)
        if rc != 0 or not (Path(self.out) / "done").exists():
            raise RuntimeError(f"the dataset writer exited ({rc})")
        self.seconds = float((Path(self.out) / self.SECONDS_NAME).read_text())
        return self.out

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()


# the JAX package's run of the same dataset through its `runners.datasets.
# main` on the CPU (experiments/port_dataset_cli_jax.py --frames 100; PERF.md
# records the run): its native loader's branch, 99 of 100 frames OK (the
# first initializes), no LOST frame, the bootstrap at frame 1, the inertial
# init at 3.85 s and imu_state 2 at the end, keyframe ATE 0.0244 m and
# scale error 0.0721 (evaluate_sequences, max_dt 0.05, the exported
# trajectory against the written ground truth), 21 keyframes, 1,936 points;
# 3 fetches every tracked frame, 6-10 a mapper step (p50 6). (At 200
# frames: 199/200, ATE 0.1203 m, 41 keyframes, 6-12 fetches a step.)
JAX_DATASET_CLI = dict(n_frames=100, ok_frames=99, ok_ratio=0.99, n_lost=0, bootstrap_frame=1,
                       imu_state=2, imu_init_t=3.85, kf_ate_m=0.024379197330357996,
                       scale_err=0.07208717007648735, n_kf=21, n_points=1936,
                       fetches_per_tracked_frame=dict(p50=3.0, mean=3.0, max=3.0),
                       fetches_per_mapper_step=dict(p50=6.0, mean=6.631578947368421, max=10.0))
# the gates: the system world's (no LOST frame, OK ratio at least JAX's less
# 0.05, the inertial init, keyframe ATE at most twice JAX's, keyframes
# within 30%), the exports as tests/test_e2e_dataset_cli.py checks them
# (velocity rows = keyframes, PCD POINTS = its data rows > 100, a depth
# file), the checkpoint reloads, and on the card 3 fetches and 3 syncs a
# tracked frame, no sync in the viewer's thread
DC_MIN_PCD_POINTS = 100


def dataset_cli(device, root, out_dir, profile="euroc", viewer=True, log=print):
    """The dataset CLI on `device`: `runners.datasets.main([kind,
    root/settings.yaml, root, traj, "--vocab", settings/DATASET_VOCAB,
    the three exports, "--save-state", ..., "--viewer-dir", ...,
    "--device", device])` over the `profile` dataset `write_dataset` wrote
    into `root` (kind: the profile's layout), with "--realtime" where the
    profile says so, the viewer only if `viewer` and where matplotlib
    imports (else the line says why not). The System that `main` builds
    is metered as the system world's (`config.build_system` wrapped:
    `FrameMeter`, `MapperMeter`, syncs per thread by `SyncLedger`,
    SYSTEM_WORLD_REGIONS; each frame's fetch allowance,
    BATTERY_FRAME_FETCHES and the BATTERY_STAGE_FETCHES of the stages it
    ran; the keyframes each full polish holds), and the launch and build
    counts are set to 0 just before `main` streams (with --realtime: when
    System.warmup has returned; the frames over the frame period's budget
    are counted). After it: the native loader's branch (the path fails
    with the compiler's output if the loader did not build), the consumer's
    wait on the prefetcher and a direct decode time a frame, the keyframe
    ATE of the exported trajectory (`evaluate_sequences`), the exports
    parsed, the checkpoint reloaded, the viewer's PNGs, and
    `evaluation.plots.main` on the export (its numbers alone,
    `compare_trajectories`, where matplotlib is missing). Returns (records,
    mapper steps, summary)."""
    import importlib.util

    import torch

    from monoorbslam3_tpu_torch import config, native
    from monoorbslam3_tpu_torch.evaluation import plots
    from monoorbslam3_tpu_torch.evaluation.metrics import (evaluate_sequences, load_tum,
                                                           load_velocity_file)
    from monoorbslam3_tpu_torch.models.checkpoint import load_map
    from monoorbslam3_tpu_torch.ops import cuda_lib
    from monoorbslam3_tpu_torch.runners import datasets

    root, out_dir = Path(root), Path(out_dir)
    kind, realtime = DATASET_PROFILES[profile]["layout"], DATASET_PROFILES[profile].get("realtime")
    branch = native.branch("dataloader")
    if branch != "native":
        raise RuntimeError(f"{kind} dataset CLI: the native dataset loader did not build:\n"
                           + native.build_errors.get("dataloader", "MONOSLAM_NO_NATIVE is set"))
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    viewer_dir = out_dir / f"{profile}_viewer"
    viewer_note = None
    if not viewer:
        viewer_dir, viewer_note = None, "not asked for"
    elif importlib.util.find_spec("matplotlib") is None:
        viewer_dir, viewer_note = None, "matplotlib does not import on this host"
    ledger = SyncLedger(on_card)
    built, loaded = {}, {"warmup_s": None}
    allowance = collections.Counter()  # frame -> the fetches of the stages it ran
    polishes = []
    loader_name = f"{kind}_dataset"
    inner_build, inner_loader = config.build_system, getattr(datasets, loader_name)

    def build_system(*a, **k):
        syst = inner_build(*a, **k)
        frames, meter = meter_system(syst, ledger, sync, log=log)
        for stage, n in BATTERY_STAGE_FETCHES.items():
            on_call(syst.tracking, stage,
                    lambda *a, n=n: allowance.update({len(frames.records): n}))
        on_call(syst.problems, "full_inertial_optimize",
                lambda store, *a, **k: polishes.append(store.n_keyframes()))
        inner_warmup = syst.warmup

        def warmup():
            t0 = time.perf_counter()
            inner_warmup()
            sync()
            loaded["warmup_s"] = time.perf_counter() - t0
            _zero(cuda_lib.launches)  # --realtime: the path starts here
            loaded["builds"] = dict(cuda_lib.builds)

        syst.warmup = warmup
        built.update(system=syst, meter=meter, frames=frames)
        return syst

    def loader(path):
        loaded["dataset"] = inner_loader(path)
        _zero(cuda_lib.launches)  # the path starts here
        loaded["builds"] = dict(cuda_lib.builds)
        return loaded["dataset"]

    traj = out_dir / f"{profile}_trajectory.txt"
    files = {flag: out_dir / f"{profile}_{name}" for flag, name in DATASET_EXPORTS.items()}
    argv = [kind, str(root / DATASET_SETTINGS_NAME), str(root), str(traj),
            "--vocab", str(SETTINGS / DATASET_VOCAB), "--device", str(device)]
    for flag, path in files.items():
        argv += [flag, str(path)]
    if realtime:
        argv.append("--realtime")
    if viewer_dir is not None:
        argv += ["--viewer-dir", str(viewer_dir)]
    config.build_system = build_system
    setattr(datasets, loader_name, loader)
    t0 = time.perf_counter()
    try:
        with recorded(ledger, SYSTEM_WORLD_REGIONS):
            datasets.main(argv)
    finally:
        config.build_system = inner_build
        setattr(datasets, loader_name, inner_loader)
    sync()
    run_s = time.perf_counter() - t0
    syst, meter, frames = built["system"], built["meter"], built["frames"]
    launches = dict(cuda_lib.launches)
    builds = {k: cuda_lib.builds[k] - loaded["builds"][k] for k in loaded["builds"]}
    dataset = loaded["dataset"]
    n_frames = len(frames.records)
    for r in frames.records:
        r["fetch_allowance"] = BATTERY_FRAME_FETCHES + allowance[r["frame"]]
    viewer_syncs = (ledger.by_thread[syst.viewer._thread.ident]
                    if syst.viewer is not None else None)
    # a direct decode of the first 20 frames, on this thread
    paths = [Path(dataset.image_dir) / (dataset.image_pattern % i) for i in range(20)]
    t1 = time.perf_counter()
    for p in paths:
        native.load_gray(str(p))
    decode_ms = 1e3 * (time.perf_counter() - t1) / len(paths)

    gt = str(root / DATASET_GT_NAME)
    (ate,) = evaluate_sequences([(profile, str(traj), gt)], max_dt=SYSTEM_WORLD_MAX_DT,
                                log=lambda line: None)
    summary = system_world_summary(frames.records, meter.steps, syst, ate)
    t_kf, _, _ = load_tum(str(traj))
    t_v, v, _, _ = load_velocity_file(str(files["--velocity-out"]))
    pcd = files["--map-out"].read_text().splitlines()
    pcd_declared = next(int(line.split()[1]) for line in pcd if line.startswith("POINTS"))
    pcd_rows = len(pcd) - (pcd.index("DATA ascii") + 1)
    depth_lines = len(files["--depth-out"].read_text().splitlines())
    store, _ = load_map(str(files["--save-state"]))
    pngs = sorted(os.listdir(viewer_dir)) if viewer_dir is not None else []
    if viewer_dir is not None:
        plot_out = str(out_dir / f"{profile}_plot.png")
        results = plots.main([gt, str(traj), "-o", plot_out, "--labels", "port",
                              "--max-dt", str(SYSTEM_WORLD_MAX_DT)])
    else:
        _, _, results = plots.compare_trajectories(gt, [str(traj)], ["port"],
                                                   max_dt=SYSTEM_WORLD_MAX_DT)
    # the frame period's budget against each System.track call as the
    # pacing of run_sequence times it (the frame and its mapper steps)
    budget_ms = 1e3 / profile_fps(profile)
    track_ms = {r["frame"]: r["frame_ms"] for r in frames.records}
    for m in meter.steps:
        track_ms[m["frame"]] = track_ms.get(m["frame"], 0.0) + m["host_ms"]
    summary.update(
        kind=kind, profile=profile, realtime=bool(realtime), warmup_s=loaded["warmup_s"],
        frame_budget_ms=budget_ms,
        frames_over_budget=sum(v > budget_ms for v in track_ms.values()),
        width=syst.camera.width, height=syst.camera.height,
        extractor=dict(width=syst.extractor.width, height=syst.extractor.height,
                       n_features=syst.extractor.n_features,
                       atlas=[syst.extractor.atlas_h, syst.extractor.atlas_w]),
        native_branch={"dataloader": branch, "map_ops": native.branch("map_ops")},
        run_s=run_s, launches=launches, kernel_builds=builds, polish_kf_counts=polishes,
        local_k=syst.problems.local_k, region_syncs=dict(ledger.counts),
        sync_sites=dict(ledger.sites), viewer=viewer_note or "ran",
        viewer_syncs=viewer_syncs,
        viewer_pngs={"frame": sum(p.startswith("frame_") for p in pngs),
                     "map": sum(p.startswith("map_") for p in pngs)},
        viewer_error=(repr(syst.viewer.last_error)
                      if syst.viewer is not None and syst.viewer.last_error else None),
        prefetch_wait_ms=1e3 * dataset.prefetcher.wait_s / max(n_frames, 1),
        decode_ms=decode_ms, trajectory_rows=len(t_kf), velocity_rows=len(t_v),
        velocity_finite=bool(np.isfinite(v).all()), pcd_points=pcd_declared,
        pcd_rows=pcd_rows, depth_lines=depth_lines,
        checkpoint_kf=store.n_keyframes(), checkpoint_points=int(store.n_points()),
        plots={label: dict(rmse=float(r["rmse"]), scale=float(r.get("scale", 1.0)),
                           n=int(r.get("n_matches", 0))) for label, r in results})
    return frames.records, meter.steps, summary


def dataset_cli_checks(dc, records, steps, on_card=True, profile="euroc"):
    """The dataset CLI's gates on a `dataset_cli` run of a `profile`
    dataset: against JAX_DATASET_CLI (EuRoC, path 10) or
    JAX_PROFILES[profile] (paths 14 and 15, which add the gates of
    PROFILE_*: imu_state 2, keyframes created, the ATE over JAX's seeds and
    the family's bound, no kernel build after the warm-up (System.warmup's
    with --realtime, which must have run), K1-K4 launched, K4's large-D
    route whenever a polish held more than local_k keyframes, and the fetch
    allowance of each tracked frame). The fetch, sync and viewer-thread
    gates only on the card, where they are counted. Returns the
    failures."""
    euroc = profile == "euroc"
    ref = JAX_DATASET_CLI if euroc else JAX_PROFILES[profile]
    tag, fails = "dataset CLI" if euroc else f"profile {profile}", []
    if dc.get("realtime") and dc["warmup_s"] is None:
        fails.append(f"{tag}: --realtime, and System.warmup did not run")
    if dc["native_branch"]["dataloader"] != "native":
        fails.append(f"{tag}: the loader took the {dc['native_branch']} branch")
    if dc["n_lost"]:
        fails.append(f"{tag}: {dc['n_lost']} LOST frames")
    ok_min = ref["ok_ratio"] - SW_OK_SLACK
    if not dc["ok_ratio"] >= ok_min:
        fails.append(f"{tag}: OK ratio {dc['ok_ratio']} < {ok_min}")
    if dc["imu_state"] < (1 if euroc else 2):
        fails.append(f"{tag}: imu_state {dc['imu_state']}")
    ate_over_seeds = [ref["kf_ate_m"]] if euroc else ref["kf_ate_over_seeds"]
    ate_max = min(SW_ATE_FACTOR * max(ate_over_seeds), ref.get("ate_bound_m", np.inf))
    if not dc["kf_ate_m"] <= ate_max:
        fails.append(f"{tag}: keyframe ATE {dc['kf_ate_m']} m > {ate_max} m")
    counts = (("n_kf", [ref["n_kf"]]),) if euroc else (
        ("n_kf", ref["n_kf_over_seeds"]), ("kf_created", ref["kf_created_over_seeds"]))
    for key, seeds in counts:
        lo, hi = (1 - SW_KF_RTOL) * min(seeds), (1 + SW_KF_RTOL) * max(seeds)
        if not lo <= dc[key] <= hi:
            fails.append(f"{tag}: {key} {dc[key]}, JAX's {seeds}")
    if not (dc["trajectory_rows"] == dc["velocity_rows"] == dc["n_kf"] and dc["velocity_finite"]):
        fails.append(f"{tag}: {dc['trajectory_rows']} trajectory rows, "
                     f"{dc['velocity_rows']} velocity rows for {dc['n_kf']} keyframes")
    if not (dc["pcd_points"] == dc["pcd_rows"] and dc["pcd_points"] > DC_MIN_PCD_POINTS):
        fails.append(f"{tag}: the PCD declares {dc['pcd_points']} points and holds "
                     f"{dc['pcd_rows']}")
    if not dc["depth_lines"]:
        fails.append(f"{tag}: an empty depth file")
    if dc["checkpoint_kf"] != dc["n_kf"]:
        fails.append(f"{tag}: the checkpoint reloads {dc['checkpoint_kf']} keyframes")
    if dc["viewer"] == "ran" and not (dc["viewer_pngs"]["frame"] and dc["viewer_pngs"]["map"]):
        fails.append(f"{tag}: the viewer wrote {dc['viewer_pngs']} ({dc['viewer_error']})")
    if not euroc:
        if any(dc["kernel_builds"].values()):
            fails.append(f"{tag}: kernel builds after the warm-up {dc['kernel_builds']}")
        for k in PROFILE_KERNELS:
            if not dc["launches"][k]:
                fails.append(f"{tag}: kernel {k} was never launched")
        if (any(n > dc["local_k"] for n in dc["polish_kf_counts"])
                and not dc["launches"]["chol_solve_l2"]):
            fails.append(f"{tag}: polishes at {dc['polish_kf_counts']} keyframes launched no "
                         f"large-D K4")
    if not on_card:
        return fails
    if euroc:
        for key in ("fetches_per_tracked_frame", "fetches_per_mapper_step"):
            got, lim = dc[key], ref[key]
            if got is None or got["max"] > lim["max"]:
                fails.append(f"{tag}: {key} {got}, JAX's {lim}")
    for name, n in dc["region_syncs"].items():
        if n and name != "two-view bootstrap":
            fails.append(f"{tag}: {n} host syncs inside the {name}")
    boot = dc["bootstrap_frame"]
    for prev, r in zip(records, records[1:]) if boot is not None else ():
        if r["frame"] <= boot or r["state"] != 2:
            continue
        if r["syncs"] > r["fetches"]:
            fails.append(f"{tag}: frame {r['frame']} synced {r['syncs']} times for "
                         f"{r['fetches']} fetches")
        if not euroc and prev["state"] == 2 and r["fetches"] > r["fetch_allowance"]:
            fails.append(f"{tag}: frame {r['frame']} fetched {r['fetches']} times for "
                         f"{r['fetch_allowance']}")
    for m in steps:
        if m["syncs"] > m["fetches"]:
            fails.append(f"{tag}: the mapper step of KF {m['kf']} synced {m['syncs']} "
                         f"times for {m['fetches']} fetches")
    if dc["viewer_syncs"]:
        fails.append(f"{tag}: {dc['viewer_syncs']} host syncs in the viewer's thread")
    return fails


# path 14, the profiles: the dataset CLI (`dataset_cli`, no viewer) over the
# KITTI-raw and TUM-VI datasets `write_dataset` renders (DATASET_PROFILES:
# 200 frames of the corridor at 1392x512 with 1,536 features; 400 frames of
# the circle through the 512x512 KB4 fisheye), each profile's settings as
# they stand (no `System:` block: every tracker and mapper knob its
# default), the reference-scale vocabulary, the exports and the checkpoint;
# child processes render both while paths 10-13 run. Each run must launch
# K1-K4, and K4's large-D route whenever a polish holds more than local_k
# keyframes (PROFILE_KERNELS)
PROFILE_KERNELS = ("gather_patches", "match_rows", "hamming", "chol_solve")
# KITTI's feature count (settings/kitti.yaml): the rows of K2's launches,
# the windows of K1's and the side of a keyframe-pair search on that run
PROFILE_SEARCH = 1536
# the family's battery bound on the keyframe ATE, scaled to the path:
# corridor60's 4.5 m over its 480 m (run_validation.py) for each drive at
# 8 m/s (KITTI's 160 m, KAIST-VIO's 48 m, NTU-VIRAL's 72 m); circlebow30's
# 0.4 m for the circle
PROFILE_ATE_BOUND_M = {"kitti": 4.5 * 160.0 / 480.0, "tumvi": 0.4, "phone": 0.4,
                       "kaist": 4.5 * 48.0 / 480.0, "ntu": 4.5 * 72.0 / 480.0, "recttum": 0.4}
# the JAX package's runs of the same files through its `runners.datasets.
# main` on the CPU (experiments/port_profiles_jax.py --seeds 0: its summary
# at seed 0 of the tracker's RANSAC draws, the default; PERF.md records the
# runs): the native loader's branch, the bootstrap at frame 1 and every
# later frame OK, no LOST frame, imu_state 2 at the end; keyframe ATE and
# scale error (evaluate_sequences, max_dt 0.05, the exported trajectory
# against the written ground truth), keyframes kept / created, points, the
# keyframe counts of its full polishes; 3 fetches every tracked frame,
# 6-12 a mapper step (p50 8). The *_over_seeds lists hold seeds 0-3 of the
# same runs (`--seeds 0,1,2,3`: KITTI ATE 0.129-0.277 m, 68 keyframes at
# every seed; TUM-VI 21.3-23.9 mm, 72-77 keyframes; every seed 199/200 and
# 399/400 OK, imu_state 2). KITTI: init at 4.6 s, ATE 0.275 m, 68 / 68 keyframes, polishes
# at 17-61 keyframes (three above local_k 32: K4's large-D route). TUM-VI:
# init at 3.95 s, ATE 22.4 mm, 77 / 80 keyframes, polishes at 17-76
# (four above local_k). Path 15's four (experiments/port_profiles_jax.py
# --kinds phone,kaist,ntu,recttum --seeds 0,1,2,3, the phone with
# --realtime; every seed's summary in experiments/port_profiles_runs.json):
# each entry seed 0's summary with seeds 0-3 in its *_over_seeds lists.
# Phone 177-179/180 OK, init 4.70-4.93 s, 19-20 keyframes, ATE 1.47-3.39
# mm; KAIST-VIO 178/180, init 4.07 s, 24 keyframes, ATE 31.6-67.8 mm; both
# reach imu_state 2 in System.shutdown's pending gravity refinement (init
# + 3 s lies past their 6 s). NTU-VIRAL 89/90, init 4.6 s, imu_state 2 at
# 7.9 s, 31 keyframes, ATE 24.2-57.9 mm; rectified TUM-VI 159/160, init
# 3.9 s, imu_state 2 at 7.0 s, 32 keyframes, ATE 3.07-5.58 mm. No polish
# above local_k (17-29 keyframes)
JAX_PROFILES = {
    "kitti": dict(n_frames=200, ok_frames=199, ok_ratio=0.995, n_lost=0, bootstrap_frame=1,
                  imu_state=2, imu_init_t=4.6, kf_ate_m=0.27524490604794016,
                  scale_err=0.04785388690912229, n_kf=68, kf_created=68, n_points=7565,
                  polish_kf_counts=[17, 28, 39, 50, 61],
                  fetches_per_tracked_frame=dict(p50=3.0, mean=3.0, max=3.0),
                  fetches_per_mapper_step=dict(p50=8.0, mean=7.848484848484849, max=12.0),
                  kf_ate_over_seeds=[0.27524490604794016, 0.27690660667713013,
                                     0.12893700587621884, 0.14919418522850222],
                  n_kf_over_seeds=[68, 68, 68, 68], kf_created_over_seeds=[68, 68, 68, 68],
                  ate_bound_m=PROFILE_ATE_BOUND_M["kitti"]),
    "tumvi": dict(n_frames=400, ok_frames=399, ok_ratio=0.9975, n_lost=0, bootstrap_frame=1,
                  imu_state=2, imu_init_t=3.95, kf_ate_m=0.02241137096171336,
                  scale_err=0.003543471745316884, n_kf=77, kf_created=80, n_points=4732,
                  polish_kf_counts=[17, 28, 41, 52, 64, 76],
                  fetches_per_tracked_frame=dict(p50=3.0, mean=3.0, max=3.0),
                  fetches_per_mapper_step=dict(p50=8.0, mean=7.923076923076923, max=12.0),
                  kf_ate_over_seeds=[0.02241137096171336, 0.023869501318574012,
                                     0.023069818449493566, 0.021336503903239584],
                  n_kf_over_seeds=[77, 72, 73, 76], kf_created_over_seeds=[80, 75, 75, 79],
                  ate_bound_m=PROFILE_ATE_BOUND_M["tumvi"]),
    "phone": dict(n_frames=180, ok_frames=178, ok_ratio=0.9888888888888889, n_lost=0,
               bootstrap_frame=2, imu_state=2, imu_init_t=4.933333333,
               kf_ate_m=0.003388375345569572, scale_err=0.05050088934515684,
               n_kf=19, kf_created=19, n_points=2172, polish_kf_counts=[17, 19],
               fetches_per_tracked_frame=dict(p50=3.0, mean=3.0, max=3.0),
               fetches_per_mapper_step=dict(p50=6.0, mean=6.470588235294118, max=10.0),
               kf_ate_over_seeds=[0.003388375345569572, 0.0014747260350355472,
                                  0.002070589932291785, 0.001693809034058671],
               n_kf_over_seeds=[19, 19, 20, 19], kf_created_over_seeds=[19, 19, 20, 19],
               ate_bound_m=PROFILE_ATE_BOUND_M["phone"]),
    "kaist": dict(n_frames=180, ok_frames=178, ok_ratio=0.9888888888888889, n_lost=0,
               bootstrap_frame=2, imu_state=2, imu_init_t=4.066666667,
               kf_ate_m=0.03157006227948381, scale_err=0.11665132929861144,
               n_kf=24, kf_created=24, n_points=1893, polish_kf_counts=[17, 24],
               fetches_per_tracked_frame=dict(p50=3.0, mean=3.0, max=3.0),
               fetches_per_mapper_step=dict(p50=6.0, mean=6.818181818181818, max=10.0),
               kf_ate_over_seeds=[0.03157006227948381, 0.061429501677372975,
                                  0.03713464126405048, 0.06776832413147757],
               n_kf_over_seeds=[24, 24, 24, 24], kf_created_over_seeds=[24, 24, 24, 24],
               ate_bound_m=PROFILE_ATE_BOUND_M["kaist"]),
    "ntu": dict(n_frames=90, ok_frames=89, ok_ratio=0.9888888888888889, n_lost=0,
               bootstrap_frame=1, imu_state=2, imu_init_t=4.6,
               kf_ate_m=0.05786437252891944, scale_err=0.08871457169141683,
               n_kf=31, kf_created=31, n_points=2313, polish_kf_counts=[17, 28],
               fetches_per_tracked_frame=dict(p50=3.0, mean=3.0, max=3.0),
               fetches_per_mapper_step=dict(p50=8.0, mean=7.241379310344827, max=12.0),
               kf_ate_over_seeds=[0.05786437252891944, 0.029487553176391502,
                                  0.024167040694580692, 0.02599753911809183],
               n_kf_over_seeds=[31, 31, 31, 31], kf_created_over_seeds=[31, 31, 31, 31],
               ate_bound_m=PROFILE_ATE_BOUND_M["ntu"]),
    "recttum": dict(n_frames=160, ok_frames=159, ok_ratio=0.99375, n_lost=0,
               bootstrap_frame=1, imu_state=2, imu_init_t=3.9,
               kf_ate_m=0.0036640729961306163, scale_err=0.016281049501502443,
               n_kf=32, kf_created=32, n_points=2656, polish_kf_counts=[17, 29],
               fetches_per_tracked_frame=dict(p50=3.0, mean=3.0, max=3.0),
               fetches_per_mapper_step=dict(p50=8.0, mean=7.266666666666667, max=12.0),
               kf_ate_over_seeds=[0.0036640729961306163, 0.00558351701448536,
                                  0.00416056556538911, 0.0030662413206153766],
               n_kf_over_seeds=[32, 32, 32, 32], kf_created_over_seeds=[32, 32, 32, 32],
               ate_bound_m=PROFILE_ATE_BOUND_M["recttum"]),
}
# the digests of the files experiments/port_profiles_jax.py wrote and read
# on the CPU (`dataset_digest`: the whole folder's and each PNG's, its
# first 16 hex digits), against which path 14 checks the files the card's
# host renders. The reference pixels are not kept (~0.55 MB a KITTI PNG):
# the first PROFILE_PNGS_KEPT PNGs that differ are copied under
# PROFILE_PNGS_OUT/<kind>, and `experiments/port_profiles_jax.py
# --count-pixels PROFILE_PNGS_OUT` counts their differing pixels against
# its own render of the same files
PROFILE_DIGESTS = Path(__file__).resolve().parent / "experiments" / "port_profiles_digests.json"
PROFILE_PNGS_OUT = Path(__file__).resolve().parent / "chiprun_out" / "profile_pngs"
PROFILE_PNGS_KEPT = 8


def profile_digest_check(root, kind):
    """The written dataset's digest against PROFILE_DIGESTS[kind]: (the
    same files, the names of the PNGs that differ), with the first
    PROFILE_PNGS_KEPT of those copied under PROFILE_PNGS_OUT/kind."""
    digest, pngs = dataset_digest(root, kind)
    ref = json.loads(PROFILE_DIGESTS.read_text())[kind]
    differ = [name for name, h in pngs.items() if ref["pngs"].get(name) != h[:16]]
    image_dir = Path(root) / DATASET_LAYOUTS[DATASET_PROFILES[kind]["layout"]][1]
    for name in differ[:PROFILE_PNGS_KEPT]:
        (PROFILE_PNGS_OUT / kind).mkdir(parents=True, exist_ok=True)
        shutil.copyfile(image_dir / name, PROFILE_PNGS_OUT / kind / name)
    return digest == ref["digest"], differ


def profiles(device, roots, out_dir, kinds=PROFILE_KINDS, log=lambda line: None):
    """Paths 14 and 15 on `device`: `dataset_cli` over each profile's
    dataset in `kinds` (PROFILE_KINDS, path 14's, or a lane of VIO_LANES;
    roots: {profile: its root}) without the viewer, each once its
    `DatasetWriter` has written it (its seconds file exists) and checked
    against PROFILE_DIGESTS first, with the kernels' last inputs of each run
    kept for the kernel phase: K1's last launch, K2's last eight (a frame),
    K3's last 16 searches, K4's last 8 cluster-route systems and last
    large-D one. Returns {profile: dict(records, steps, summary, same_files,
    differing_pngs, seconds, k1, k2, k3, k4, k4_l2)}."""
    from monoorbslam3_tpu_torch.ops import chol_pallas, match_pallas, pallas_kernels

    out = {}
    for kind in kinds:
        _wait_file(Path(roots[kind]) / DatasetWriter.SECONDS_NAME)
        same, differ = profile_digest_check(roots[kind], kind)
        t0 = time.perf_counter()
        with _Capture(pallas_kernels, "gather_patches_cuda", maxlen=1) as k1, \
                _Capture(match_pallas, "_match_rows_cuda") as k2, \
                _Capture(pallas_kernels, "hamming_matrix_cuda", maxlen=16) as k3, \
                _Capture(chol_pallas, "chol_solve_cluster", maxlen=8) as k4, \
                _Capture(chol_pallas, "chol_solve_l2", maxlen=1) as k4l2:
            records, steps, summary = dataset_cli(device, roots[kind], out_dir, profile=kind,
                                                  viewer=False, log=log)
        out[kind] = dict(records=records, steps=steps, summary=summary, same_files=same,
                         differing_pngs=differ, seconds=time.perf_counter() - t0,
                         k1=list(k1.calls), k2=list(k2.calls), k3=list(k3.calls),
                         k4=list(k4.calls), k4_l2=list(k4l2.calls))
    return out


def profile_k2_checks(shapes, n_features=PROFILE_SEARCH, name="KITTI"):
    """The gate on K2's launches of the last frame of a profile (`name`), as (rows,
    columns): the eight of K2_CALLS, with the frame's n_features features
    (the profile's ORB.Features: 1,536 on KITTI, 48 row tiles) as the rows
    of both coarse directions (the last frame's against this one's) and of
    the local stage's transposed launches, and as the columns of every
    "rows" launch. Returns the failures."""
    off = [(label, n, m) for label, (n, m) in zip(K2_CALLS, shapes)
           if (n != n_features and (label.startswith("coarse")
                                    or label.endswith("transposed")))
           or (m != n_features and label.endswith(" rows"))]
    if len(shapes) == len(K2_CALLS) and not off:
        return []
    return [f"profiles: K2's last {name} frame ran {list(shapes)} (rows, columns), not "
            f"{len(K2_CALLS)} launches with the frame's {n_features} features as the rows "
            f"of the coarse and the transposed ones and the columns of the \"rows\" ones "
            f"(off: {off})"]


def profile_shape_checks(profile, p):
    """A profile's shapes on the card against its settings and extractor:
    the camera's width and height are the settings file's, the extractor's
    too; K1's last launch read the extractor's atlas (atlas_h x atlas_w)
    at its feature count; K2's last frame's launches pass
    `profile_k2_checks` at that count. Returns the failures."""
    import yaml

    s = yaml.safe_load((SETTINGS / DATASET_PROFILES[profile]["settings"]).read_text())
    size = (int(s["Camera"]["Width"]), int(s["Camera"]["Height"]))
    n_feat = int(s["ORB"]["Features"])
    ext, summ, fails = p["summary"]["extractor"], p["summary"], []
    if not (summ["width"], summ["height"]) == (ext["width"], ext["height"]) == size:
        fails.append(f"profile {profile}: camera {summ['width']}x{summ['height']}, extractor "
                     f"{ext['width']}x{ext['height']}, settings {size[0]}x{size[1]}")
    k1 = [(tuple(a[0].shape), int(a[1].shape[0])) for a in p["k1"]]
    if k1 != [(tuple(ext["atlas"]), n_feat)] or ext["n_features"] != n_feat:
        fails.append(f"profile {profile}: K1's last launch read {k1} (atlas, K), the "
                     f"extractor's atlas {ext['atlas']} at {ext['n_features']} features, the "
                     f"settings' {n_feat}")
    return fails + profile_k2_checks([(int(a[0].shape[0]), int(a[1].shape[0]))
                                      for a in p["k2"]], n_feat, profile)


def profiles_checks(prof, on_card=True, large_d=True):
    """Path 14's and 15's gates: `dataset_cli_checks` of each profile's
    run, and (path 14, `large_d`) K4's large-D route in at least one of
    them. Returns the failures."""
    fails = []
    for profile, p in prof.items():
        fails += dataset_cli_checks(p["summary"], p["records"], p["steps"], on_card, profile)
    if large_d and not any(p["summary"]["launches"]["chol_solve_l2"] for p in prof.values()):
        fails.append("profiles: K4's large-D route ran in neither profile")
    return fails


def print_profiles(prof, card):
    """Prints each profile run of `profiles` (paths 14 and 15) beside the
    JAX package's: its files against the digests, states, fetches, mapper
    steps, summary and the line of its outcome; with --realtime, the
    warm-up and the frames over the frame period's budget."""
    for kind, p in prof.items():
        s, ref = p["summary"], JAX_PROFILES[kind]
        print(f"profile {kind} files: the JAX run's {p['same_files']}; "
              f"{len(p['differing_pngs'])} PNGs differ {p['differing_pngs'][:PROFILE_PNGS_KEPT]}"
              + (f" (copied under {PROFILE_PNGS_OUT / kind}; experiments/port_profiles_jax.py "
                 f"--count-pixels counts their pixels)" if p["differing_pngs"] else ""))
        print(f"profile {kind} states:", "".join(str(r["state"]) for r in p["records"]))
        print(f"profile {kind} fetches / allowance / syncs a frame:",
              [(r["fetches"], r["fetch_allowance"], r["syncs"]) for r in p["records"]])
        print(f"profile {kind} mapper steps (frame, KF, ms, fetches, syncs):",
              [(m["frame"], m["kf"], round(m["host_ms"], 1), m["fetches"], m["syncs"])
               for m in p["steps"]])
        print(f"profile {kind} summary:", json.dumps(s))
        print(f"profile {kind} against the JAX package on the CPU: {json.dumps(ref)}")
        print(f"profile {kind} ({card}): {s['width']}x{s['height']}, OK "
              f"{s['ok_frames']}/{s['n_frames']} (JAX's "
              f"{ref['ok_frames']}), LOST {s['n_lost']}, bootstrap at frame "
              f"{s['bootstrap_frame']} (JAX's {ref['bootstrap_frame']}), init at "
              f"{s['imu_init_t']} s (JAX's {ref['imu_init_t']}), imu_state {s['imu_state']}, "
              f"keyframe ATE {s['kf_ate_m']:.5f} m (JAX's {ref['kf_ate_m']:.5f}, over its "
              f"seeds {json.dumps(ref['kf_ate_over_seeds'])}, bound "
              f"{ref['ate_bound_m']:.2f}), scale error {s['scale_err']:.5f} (JAX's "
              f"{ref['scale_err']:.5f}), keyframes {s['n_kf']} / {s['kf_created']} (JAX's "
              f"{ref['n_kf']} / {ref['kf_created']}), points {s['n_points']} (JAX's "
              f"{ref['n_points']}), polishes at {s['polish_kf_counts']} keyframes (JAX's "
              f"{ref['polish_kf_counts']}); frame p50 {s['frame_ms']['p50']:.1f} / p99 "
              f"{s['frame_ms']['p99']:.1f} ms, mapper step p50 {s['mapper_ms']['p50']:.1f} / "
              f"p99 {s['mapper_ms']['p99']:.1f} ms; decode {s['decode_ms']:.2f} ms a frame, "
              f"kernel builds {json.dumps(s['kernel_builds'])}")
        if s["realtime"]:
            print(f"profile {kind} --realtime ({card}): System.warmup {s['warmup_s']:.2f} s, "
                  f"kernel builds after it {json.dumps(s['kernel_builds'])}; "
                  f"{s['frames_over_budget']} of {s['n_frames']} System.track calls over the "
                  f"{s['frame_budget_ms']:.1f} ms frame period")


def profile_kernel_checks(prof, k1_k2_kinds):
    """Holds the kernels' captured inputs of `profiles` runs to their plain
    versions on the card: K1's last launch and K2's last eight of each
    profile in k1_k2_kinds, K3's last searches of every run (bit-identical;
    raises otherwise). Returns {profile: K3's (rows, columns)}."""
    import torch

    from monoorbslam3_tpu_torch.ops import match_pallas, pallas_kernels

    k3_shapes, lines = {}, []
    for kind in k1_k2_kinds:
        p = prof[kind]
        for a in p["k1"]:
            got = pallas_kernels.gather_patches_cuda(*a)
            torch.cuda.synchronize()
            if not torch.equal(got, pallas_kernels.gather_patches_plain(*a)):
                raise RuntimeError(f"K1 on the {kind} run's last frame disagrees with its plain "
                                   f"version")
        for label, a in zip(K2_CALLS, p["k2"]):
            got = match_pallas._match_rows_cuda(*a)
            torch.cuda.synchronize()
            _same(got, match_pallas._match_rows_plain(*a), f"K2 profile {kind} {label}")
        lines.append(f"K1 on the last {kind} frame's atlas {tuple(p['k1'][-1][0].shape)} K="
                     f"{p['k1'][-1][1].shape[0]}, K2 on its {len(p['k2'])} launches "
                     f"({[tuple(int(x.shape[0]) for x in a[:2]) for a in p['k2']]} rows x "
                     f"columns)")
    for kind, p in prof.items():
        for a in p["k3"]:
            got = pallas_kernels.hamming_matrix_cuda(*a)
            torch.cuda.synchronize()
            if not torch.equal(got, pallas_kernels.hamming_matrix_plain(*a)):
                raise RuntimeError(f"K3 on the {kind} run's searches disagrees with its plain "
                                   f"version")
        k3_shapes[kind] = [tuple(int(x.shape[0]) for x in a[:2]) for a in p["k3"]]
    print("profiles: " + "; ".join(lines) + f"; K3 on the last searches {json.dumps(k3_shapes)}: "
          f"bit-identical")
    return k3_shapes


# path 11, the sharded BA: the distributed solver on a one-rank group (the
# card's machine has one card, and NCCL refuses two ranks on one card):
# `sharded_schur_ba` on the bench window (BA_ITERS iterations) held to the
# port's `schur_ba` in the same run and to the JAX-CPU anchors (JAX_BA_COST0,
# JAX_BA_COST["flat_deferred"]) at the window BA's tolerances;
# `Problems(mesh=)` through the local BA on a copy of the seeded 96-KF store
# against JAX_STORE's bounds; `make_batch_extractor` over SHARDED_FRAMES
# frames, bit-identical to one extraction a frame
SHARDED_FRAMES = 8


def sharded_ba(device, out_dir=None, images=None, n_runs=15, log=print):
    """The sharded BA path on `device` (the CPU rehearsal passes "cpu": a
    one-rank gloo group). Joins a one-rank process group through
    `parallel.multihost.initialize` (a file store under out_dir; NCCL on the
    card) and lays the ("dp",) mesh over it; destroys the group at the end.

    1. `sharded_schur_ba` on the bench window: one solve under the sync
       debug mode (syncs inside, K4 launches, `all_reduce` calls), then the
       wall time of `n_runs` solves, each ending in its fetch and a
       synchronize; `schur_ba` (flat, deferred) on the same window timed in
       turns with it.
    2. `Problems(mesh=mesh).local_bundle_adjustment` on a copy of the seeded
       96-KF store, counted as store_ba counts a call.
    3. `make_batch_extractor` (the EuRoC profile's extractor) over
       `images` ([SHARDED_FRAMES, H, W]; rendered frames by default), held
       bit for bit to one extraction a frame; its K1 launches.

    Returns a summary dict; "launches" holds the path's own launches (the
    sharded solves and the batch extractor, not the runs they are held
    to)."""
    import copy

    import torch
    import torch.distributed as dist

    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.backend.problems import Problems
    from monoorbslam3_tpu_torch.backend.solver import schur_ba
    from monoorbslam3_tpu_torch.bench_window import build_problem
    from monoorbslam3_tpu_torch.models.imu import ImuBuffer, ImuCalib
    from monoorbslam3_tpu_torch.models.map_state import MapStore
    from monoorbslam3_tpu_torch.ops import cuda_lib
    from monoorbslam3_tpu_torch.ops.orb import OrbExtractor
    from monoorbslam3_tpu_torch.parallel import frontend_dp, multihost
    from monoorbslam3_tpu_torch.parallel import sharded_ba as sb
    from monoorbslam3_tpu_torch.utils.fetch import SyncCounter, fetch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dist_", dir=out_dir)
    multihost.initialize(coordinator=f"file://{tmp.name}/store", num_processes=1,
                         process_id=0, device_type=dev.type)
    n_reduce = [0]
    inner_reduce = dist.all_reduce

    def all_reduce(*a, **k):
        n_reduce[0] += 1
        return inner_reduce(*a, **k)

    dist.all_reduce = all_reduce
    # the path's launches: the sharded solves and the batch extractor, not
    # the schur_ba and single-frame runs they are compared with
    path = collections.Counter()

    @contextlib.contextmanager
    def on_path():
        b = dict(cuda_lib.launches)
        try:
            yield
        finally:
            path.update({k: cuda_lib.launches[k] - b[k] for k in b})

    try:
        mesh = multihost.global_mesh(("dp",), device_type=dev.type)
        out = dict(mesh=str(mesh), process_info=multihost.process_info())

        # 1. the bench window
        problem, cam = build_problem(seed=0, device=dev)
        R_cb, t_cb = torch.eye(3, device=dev), torch.zeros(3, device=dev)
        sharded, dropped = sb.shard_problem_by_point(problem, 1)
        syncs = SyncCounter()
        solve = lambda: sb.sharded_schur_ba(sharded, cam, R_cb, t_cb, mesh, n_iters=BA_ITERS)
        single = lambda: schur_ba(problem, cam, R_cb, t_cb, n_iters=BA_ITERS)
        with on_path():
            fetch(solve()[2]["cost"], syncs)  # warm-up
        fetch(single()[2]["cost"], syncs)
        watch = SyncWatch()
        before, r0 = dict(cuda_lib.launches), n_reduce[0]
        with on_path(), watch(on_card):
            kf, pts, info = solve()
        reduces = n_reduce[0] - r0
        k4 = {k: cuda_lib.launches[k] - before[k] for k in ("chol_solve", "chol_solve_l2")}
        kf1, pts1, info1 = single()
        host = fetch(dict(cost0=info["cost0"], cost=info["cost"], t=kf.t_wb, R=kf.R_wb, pts=pts,
                          cost1=info1["cost"], t1=kf1.t_wb, R1=kf1.R_wb, pts1=pts1), syncs)
        times = {"sharded": [], "single": []}
        for i in range(n_runs):
            for name in (("sharded", "single") if i % 2 == 0 else ("single", "sharded")):
                with on_path() if name == "sharded" else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    fetch((solve if name == "sharded" else single)()[2]["cost"], syncs)
                    sync()
                    times[name].append(1e3 * (time.perf_counter() - t0))
        out["window"] = dict(
            cost0=float(host["cost0"]), cost=float(host["cost"]),
            single_cost=float(host["cost1"]), dropped=int(dropped),
            pose_t_max_diff=float(np.abs(host["t"] - host["t1"]).max()),
            pose_R_max_diff=float(np.abs(host["R"] - host["R1"]).max()),
            points_max_diff=float(np.abs(host["pts"] - host["pts1"]).max()),
            finite=bool(np.isfinite(host["pts"]).all()),
            syncs_in_solve=watch.n, sync_sites=dict(watch.sites), k4_launches=k4,
            all_reduce_per_solve=reduces, all_reduce_per_iter=(reduces - 2) / BA_ITERS,
            solve_ms=times["sharded"], single_ms=times["single"],
            median_solve_ms=float(np.median(times["sharded"])) if n_runs else None,
            median_single_ms=float(np.median(times["single"])) if n_runs else None)
        log(json.dumps({"sharded_ba": "window"} | out["window"]))

        # 2. Problems(mesh=) through the local BA on the seeded store
        settings = config.load_settings(SETTINGS / EUROC_PROFILE)
        pr = Problems(config.build_camera(settings, device=dev),
                      store_calibration(ImuCalib, device=dev), mesh=mesh, device=dev)
        pr.warm_solvers()
        base, truth = seeded_store(MapStore, ImuBuffer)
        st = copy.deepcopy(base)
        n_sharded = [0]
        inner_solve = pr._solve_sharded

        def solve_sharded(*a, **k):
            n_sharded[0] += 1
            return inner_solve(*a, **k)

        pr._solve_sharded = solve_sharded
        watch = SyncWatch()
        inner_ssb = sb.sharded_schur_ba

        def watched(*a, **k):
            with watch(on_card):
                return inner_ssb(*a, **k)

        sb.sharded_schur_ba = watched
        before, n0 = dict(cuda_lib.launches), pr.syncs.n
        t0 = time.perf_counter()
        try:
            with on_path():
                res = pr.local_bundle_adjustment(st, st.keyframe_ids()[-1])
                sync()
        finally:
            sb.sharded_schur_ba = inner_ssb
        out["store_local_ba"] = dict(
            cost0=res["cost0"], cost=res["cost"], n_outliers=res["n_outliers"],
            n_points=res["n_points"], n_kf=len(res["ids"]), fetches=pr.syncs.n - n0,
            sharded_calls=n_sharded[0], syncs_in_solve=watch.n, sync_sites=dict(watch.sites),
            k4_launches={k: cuda_lib.launches[k] - before[k]
                         for k in ("chol_solve", "chol_solve_l2")},
            wall_ms=1e3 * (time.perf_counter() - t0),
            finite=bool(np.isfinite(st.kf_t).all() and np.isfinite(st.pt_xyz).all()))
        log(json.dumps({"sharded_ba": "store local BA"} | out["store_local_ba"]))

        # 3. the batch extractor
        H, W = int(settings["Camera"]["Height"]), int(settings["Camera"]["Width"])
        ext = OrbExtractor(H, W, n_features=N_FEAT, n_levels=N_LEVELS, scale=SCALE, device=dev)
        if images is None:
            from monoorbslam3_tpu_torch.sim import ImageWorld

            world, hc = ImageWorld(), host_camera(EUROC_PROFILE)
            images = np.stack([world.render(i / FPS, hc, R_BC, T_BC, rng=np.random.default_rng(i))
                               for i in range(SHARDED_FRAMES)]).astype(np.float32)
        run = frontend_dp.make_batch_extractor(ext, mesh)
        with on_path():
            run(images[:1])  # warm-up
            sync()
        k0 = cuda_lib.launches["gather_patches"]
        with on_path():
            batched = run(images)
            sync()
        k1 = cuda_lib.launches["gather_patches"] - k0
        singles = [ext(images[i]) for i in range(len(images))]
        same = {key: bool(torch.equal(batched[key], torch.stack([o[key] for o in singles])))
                for key in batched}
        out["batch_extract"] = dict(frames=len(images), k1_launches=k1, identical=same,
                                    n_valid=int(batched["valid"].sum()))
        log(json.dumps({"sharded_ba": "batch extract"} | out["batch_extract"]))
        out["launches"] = {k: path[k] for k in cuda_lib.launches}
    finally:
        dist.all_reduce = inner_reduce
        dist.destroy_process_group()
        tmp.cleanup()
    return out


def sharded_ba_checks(shb, on_card=True):
    """The sharded BA path's gates: the bench window's costs within the
    window BA's tolerances of the JAX-CPU anchors and of `schur_ba`'s cost,
    poses within 2e-3 of it (tests/test_sharded_ba.py's bound), no sync in
    the solve, one all_reduce an iteration; the store's local BA within
    JAX_STORE's bounds, through the sharded solver; the batch extractor
    bit-identical with one K1 launch a frame. Returns the failures."""
    fails = []
    w = shb["window"]
    if abs(w["cost0"] - JAX_BA_COST0) > BA_COST0_RTOL * JAX_BA_COST0:
        fails.append(f"sharded BA: cost0 {w['cost0']} vs {JAX_BA_COST0}")
    ref = JAX_BA_COST["flat_deferred"]
    for key in ("cost", "single_cost"):
        if abs(w[key] - ref) > BA_COST_RTOL * ref:
            fails.append(f"sharded BA: {key} {w[key]} vs {ref}")
    if not (w["pose_t_max_diff"] <= 2e-3 and w["pose_R_max_diff"] <= 2e-3 and w["finite"]):
        fails.append(f"sharded BA: poses {w['pose_t_max_diff']}, {w['pose_R_max_diff']} from "
                     f"schur_ba's, finite {w['finite']}")
    if w["all_reduce_per_iter"] != 1:
        fails.append(f"sharded BA: {w['all_reduce_per_solve']} all_reduce calls a solve")
    r = shb["store_local_ba"]
    jr = JAX_STORE["local_bundle_adjustment"]
    for key, tol in (("cost0", BA_COST0_RTOL), ("cost", BA_COST_RTOL)):
        if not abs(r[key] - jr[key]) <= tol * jr[key]:
            fails.append(f"sharded store BA: {key} {r[key]} vs {jr[key]}")
    if abs(r["n_outliers"] - jr["n_outliers"]) > max(1.0, STORE_OUTLIER_RTOL * jr["n_outliers"]):
        fails.append(f"sharded store BA: {r['n_outliers']} outliers vs {jr['n_outliers']}")
    if r["n_points"] != jr["n_points"] or not r["finite"] or r["sharded_calls"] != 1:
        fails.append(f"sharded store BA: {r['n_points']} points (JAX {jr['n_points']}), finite "
                     f"{r['finite']}, {r['sharded_calls']} sharded solves")
    b = shb["batch_extract"]
    if not all(b["identical"].values()) or b["n_valid"] <= SHARDED_FRAMES:
        fails.append(f"batch extractor: {b}")
    if not on_card:
        return fails
    if w["syncs_in_solve"] or r["syncs_in_solve"]:
        fails.append(f"sharded BA: host syncs inside the solve {w['sync_sites']} "
                     f"{r['sync_sites']}")
    if w["k4_launches"] != {"chol_solve": BA_ITERS, "chol_solve_l2": 0}:
        fails.append(f"sharded BA: K4 launches {w['k4_launches']}")
    if r["k4_launches"] != {"chol_solve": STORE_ITERS["local_bundle_adjustment"],
                            "chol_solve_l2": 0}:
        fails.append(f"sharded store BA: K4 launches {r['k4_launches']}")
    if r["fetches"] != jr["fetches"] - 1:
        fails.append(f"sharded store BA: {r['fetches']} fetches")
    if b["k1_launches"] != b["frames"]:
        fails.append(f"batch extractor: {b['k1_launches']} K1 launches for {b['frames']} frames")
    return fails


# -- path 12, measure: the port's measuring entry points ---------------------
# The graft entry's rendered set: two frames of the tracking drive's world
# through the drive's rig on the flagship's pinhole (752x480, no
# distortion). The map is the first frame's keypoints lifted to their true
# world points, with the descriptors of the JAX package's extraction of
# that frame (experiments/port_graft_jax.py writes them into
# GRAFT_RENDERED); the step tracks the second frame from the first one's
# camera pose (the flagship's body is its camera: R_cb = I).
GRAFT_T = (0.5, 0.55)
GRAFT_RENDERED = Path(__file__).resolve().parent / "experiments" / "port_graft_rendered.npz"


def graft_frames(H=480, W=752):
    """(map image, tracked image, world, the flagship's camera on the CPU)
    of the rendered set, H x W (the flagship's intrinsics at any size, as
    its step takes them)."""
    from monoorbslam3_tpu_torch import graft_entry
    from monoorbslam3_tpu_torch.models.camera import Pinhole
    from monoorbslam3_tpu_torch.sim import ImageWorld

    cam = Pinhole.create(**graft_entry.FLAGSHIP_CAM, width=W, height=H, device="cpu")
    world = ImageWorld()
    imgs = [world.render(t, cam, R_BC, T_BC, rng=np.random.default_rng(i))
            for i, t in enumerate(GRAFT_T)]
    return imgs[0], imgs[1], world, cam


def graft_camera_pose(world, t):
    """(R_wc, camera centre) at t: the flagship step's (R0, t0)."""
    R_cw, t_cw = world.pose_cw(t, R_BC, T_BC)
    return R_cw.T.astype(np.float32), (-R_cw.T @ t_cw).astype(np.float32)


def graft_rendered_inputs(xy, desc, valid, world, cam):
    """The map of the rendered set from the map frame's features (xy [N, 2]
    level-0 pixels, desc [N, 8] u32, valid [N]): (pt_xyz, pt_desc,
    pt_valid, R0, t0) as numpy; a keypoint whose ray misses the scene is
    invalid."""
    X = world.world_points(GRAFT_T[0], cam, R_BC, T_BC, np.asarray(xy, np.float64))
    ok = np.asarray(valid, bool) & np.isfinite(X).all(1)
    pt_xyz = np.where(ok[:, None], X, 0.0).astype(np.float32)
    R0, t0 = graft_camera_pose(world, GRAFT_T[0])
    return pt_xyz, np.asarray(desc, np.uint32), ok, R0, t0


# the JAX package's `__graft_entry__.entry()` on the CPU
# (experiments/port_graft_jax.py): the flagship's seeded inputs (one inlier:
# the LM barely constrained) and the rendered set
JAX_GRAFT = {
    "seeded": dict(R=[[0.9997597932815552, 0.021791374310851097, 0.002327773254364729],
                      [-0.021771129220724106, 0.999727725982666, -0.00839488860219717],
                      [-0.002510075457394123, 0.008342194370925426, 0.9999620914459229]],
                   t=[0.021400826051831245, -0.06266402453184128, 0.09173732250928879],
                   n_inliers=1),
    "rendered": dict(R=[[0.8293997049331665, -7.414104038616642e-05, 0.5586556196212769],
                        [-0.5586556196212769, -1.0888164979405701e-05, 0.8293997645378113],
                        [-5.5409822380170226e-05, -1.0, -5.044994759373367e-05]],
                     t=[4.8923492431640625, 0.9795652627944946, 0.17031650245189667],
                     n_inliers=463),
}
GRAFT_TOL, GRAFT_INLIER_SLACK, GRAFT_MIN_RENDERED_INLIERS = 1e-3, 2, 100
# the JAX package's experiments/tpu_e2e.run_world("circle10", sync=True) on
# the CPU (experiments/port_e2e_jax.py; the JAX script rounds ATE and scale
# error to 4 digits) at the trackers' default RANSAC seed, its keyframe ATE
# over seeds 0-3 (`--seeds 0,1,2,3`: one JAX run is no bound, the spread is
# 5x), and run_validation.py's bounds of the circle world (circle60's:
# circle10 is its first 10 s)
E2E_WORLD = "circle10"
JAX_E2E_CIRCLE10 = dict(frames=200, ok_frames=199, ok_ratio=0.995, lost_events=0, n_keyframes=40,
                        ate_rmse=0.0029, scale_err=0.0135)
JAX_E2E_ATE_OVER_SEEDS = {0: 0.0029, 1: 0.0047, 2: 0.014, 3: 0.0049}
E2E_ATE_BOUND_M, E2E_SCALE_BOUND = 0.8, 0.12
# bench_scaling on the card: one rank a card, and the size one card cannot
# hold, reported as not measured
SCALING_SIZES = ("1", "2")


def measure_path(device, e2e_frames, out_dir, log=print):
    """Path 12 on `device`: the port's measuring entry points, each through
    its `main` or its public function, in one process but for the ranks
    they spawn.

    1. `graft_entry.entry()`: the flagship step on its seeded inputs, once
       under the sync debug mode (syncs inside) and read with one fetch;
       then on the rendered set (GRAFT_RENDERED's map, the tracked frame
       rendered again here: its pixel sum must be the JAX run's).
    2. `measure.bench.main`: local-BA iterations/s (flat and grouped) and
       the tracking step's frames/s, each with quartiles and n.
    3. `measure.bench_kernels.main`: the JAX script's rows and one line a
       hand kernel at the main path's shapes, each kernel checked against
       its plain version.
    4. `measure.e2e.run_world(E2E_WORLD, sync=True)` on `e2e_frames` (the
       world's frames, rendered ahead by the caller).
    5. `measure.bench_scaling.main(SCALING_SIZES)`: one NCCL rank a card.
    6. `graft_entry.dryrun_multichip(1)`: one spawned rank.

    Returns a summary dict of each entry point's outputs."""
    import torch

    from monoorbslam3_tpu_torch import graft_entry
    from monoorbslam3_tpu_torch.measure import bench, bench_kernels, bench_scaling, e2e
    from monoorbslam3_tpu_torch.utils.fetch import SyncCounter, fetch

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    out = {}
    t0 = time.perf_counter()
    step, args = graft_entry.entry(dev)
    step(*args)  # the extractor's constants go up at the first call
    watch, fetches = SyncWatch(), SyncCounter()
    with watch(on_card):
        res = step(*args)
    R, t, n = fetch(res, fetches)
    out["graft_seeded"] = dict(R=R.tolist(), t=t.tolist(), n_inliers=int(n),
                               syncs_in_step=watch.n, sync_sites=dict(watch.sites),
                               fetches=fetches.n)
    saved = np.load(GRAFT_RENDERED)
    _, img_track, _, _ = graft_frames()
    rendered = (img_track, saved["pt_xyz"], saved["pt_desc"], saved["pt_valid"], saved["R0"],
                saved["t0"])
    R, t, n = fetch(step(*graft_entry.upload(rendered, dev)), fetches)
    out["graft_rendered"] = dict(
        R=R.tolist(), t=t.tolist(), n_inliers=int(n),
        image_sum=float(img_track.astype(np.float64).sum()),
        jax_image_sum=float(saved["image_sum"]))
    out["graft_s"] = time.perf_counter() - t0
    log("graft entry: " + json.dumps(out["graft_seeded"]) + " " + json.dumps(out["graft_rendered"]))

    argv = ["--device", dev.type]
    t0 = time.perf_counter()
    out["bench"] = bench.main(argv)
    out["bench_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["bench_kernels"] = bench_kernels.main(argv)
    out["bench_kernels_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out["e2e"] = e2e.run_world(E2E_WORLD, out_dir, sync=True, device=dev, frames=e2e_frames,
                               log=lambda line: None)
    out["e2e_s"] = time.perf_counter() - t0
    log("e2e: " + json.dumps(out["e2e"]))

    if on_card:
        torch.cuda.empty_cache()  # the spawned ranks share the card
    t0 = time.perf_counter()
    out["bench_scaling"] = bench_scaling.main([*SCALING_SIZES, *argv])
    out["bench_scaling_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out["dryrun"] = graft_entry.dryrun_multichip(1, dev)
    out["dryrun_s"] = time.perf_counter() - t0
    log("dryrun_multichip(1): " + json.dumps(out["dryrun"]))
    return out


def measure_checks(meas, on_card=True):
    """Path 12's gates: the graft step at its JAX anchors (R, t within
    GRAFT_TOL, inliers within GRAFT_INLIER_SLACK, over
    GRAFT_MIN_RENDERED_INLIERS on the rendered set, 0 syncs inside and one
    fetch of its outputs); the bench window's costs at the JAX-CPU anchors, every rate a
    measured number with n >= 10; every bench_kernels line measured (but
    for the rows whose launches cannot be held) with its check; the e2e
    row within the system world's gates against JAX_E2E_CIRCLE10 (the ATE
    against 2x the largest of JAX_E2E_ATE_OVER_SEEDS) and the world's
    bounds, with 0 kernel builds after the warm-up; bench_scaling's
    one-rank rows measured and its two-rank rows not; the dry run on every
    rank. Returns the failures."""
    fails = []
    for name in ("seeded", "rendered"):
        got, ref = meas[f"graft_{name}"], JAX_GRAFT[name]
        for key in ("R", "t"):
            err = float(np.abs(np.subtract(got[key], ref[key])).max())
            if not err <= GRAFT_TOL:
                fails.append(f"graft entry ({name}): {key} {err:.3e} from JAX's")
        if abs(got["n_inliers"] - ref["n_inliers"]) > GRAFT_INLIER_SLACK:
            fails.append(f"graft entry ({name}): {got['n_inliers']} inliers, JAX's "
                         f"{ref['n_inliers']}")
    gr = meas["graft_rendered"]
    if gr["image_sum"] != gr["jax_image_sum"]:
        fails.append("graft entry: the rendered frame is not the JAX run's")
    if not gr["n_inliers"] > GRAFT_MIN_RENDERED_INLIERS:
        fails.append(f"graft entry: {gr['n_inliers']} inliers on the rendered set")
    gs = meas["graft_seeded"]
    if on_card and (gs["syncs_in_step"] or gs["fetches"] != 1):
        fails.append(f"graft entry: {gs['syncs_in_step']} syncs inside the step "
                     f"{gs['sync_sites']}, {gs['fetches']} fetches of its outputs")
    b = meas["bench"]
    if abs(b["cost0"] - JAX_BA_COST0) > BA_COST0_RTOL * JAX_BA_COST0:
        fails.append(f"bench: cost0 {b['cost0']} vs {JAX_BA_COST0}")
    if abs(b["cost"] - JAX_BA_COST["flat_deferred"]) > BA_COST_RTOL * JAX_BA_COST["flat_deferred"]:
        fails.append(f"bench: cost {b['cost']} vs {JAX_BA_COST['flat_deferred']}")
    if on_card:
        for key in ("value", "grouped_polish_iters_per_s", "frontend_fps", "setup_s"):
            if not isinstance(b[key], float) or not b[key] > 0:
                fails.append(f"bench: {key} {b[key]}")
        for key, tm in b["timing"].items():
            if tm["n"] < 10 or not tm["q25_ms"] <= tm["median_ms"] <= tm["q75_ms"]:
                fails.append(f"bench: timing {key} {tm}")
        if "power_limit" not in b["device"]:
            fails.append("bench: no card and power limit beside its numbers")
    rows = {r["metric"]: r for r in meas["bench_kernels"]}
    for name in ("hamming_rt", "hamming_bulk", "match_step_rt", "orb_extract_frame",
                 "preintegrate_200", "schur_ba_iter", "K1_gather_atlas_in_l2",
                 "K1_gather_atlas_from_hbm", "K2_match_rows_rows", "K2_match_rows_transposed",
                 "K4_chol_cluster", "K4_chol_large_d"):
        r = rows.get(f"kernel_{name}")
        if r is None:
            fails.append(f"bench_kernels: no line {name}")
            continue
        if not on_card:
            continue
        if not isinstance(r["call_ms"], float) or "power_limit" not in r["device"]:
            fails.append(f"bench_kernels {name}: call time {r['call_ms']}, device {r['device']}")
        launch_heavy = name in ("orb_extract_frame", "preintegrate_200", "schur_ba_iter")
        if not launch_heavy and not isinstance(r["device_ms"], float):
            fails.append(f"bench_kernels {name}: device time {r['device_ms']}")
        if r.get("kernel") and name != "preintegrate_200" and "check" not in r:
            fails.append(f"bench_kernels {name}: no check of its kernel")
    e = meas["e2e"]
    ref = JAX_E2E_CIRCLE10
    ok_ratio = e["ok_frames"] / e["frames"]
    ate_max = min(SW_ATE_FACTOR * max(JAX_E2E_ATE_OVER_SEEDS.values()), E2E_ATE_BOUND_M)
    for bad, what in ((e["frames"] != ref["frames"], f"{e['frames']} frames"),
                      (e["lost_events"] > 0, f"{e['lost_events']} LOST frames"),
                      (not ok_ratio >= ref["ok_ratio"] - SW_OK_SLACK, f"OK ratio {ok_ratio}"),
                      (not e["ate_rmse"] <= ate_max, f"ATE {e['ate_rmse']} m > {ate_max} m"),
                      (not e["scale_err"] <= E2E_SCALE_BOUND, f"scale error {e['scale_err']}"),
                      (any(e["kernel_builds_after_warmup"].values()),
                       f"kernel builds after the warm-up {e['kernel_builds_after_warmup']}")):
        if bad:
            fails.append(f"e2e {E2E_WORLD}: {what}")
    if on_card:
        for key in ("fps", "realtime_factor", "warmup_s", "wall_s"):
            if not isinstance(e[key], float):
                fails.append(f"e2e: {key} {e[key]}")
        if e["frame_ms"]["n"] != e["frames"]:
            fails.append(f"e2e: frame times {e['frame_ms']}")
    for line in meas["bench_scaling"]:
        n, value = line.get("n_devices"), line["value"]
        if line["metric"] == "frontend_dp_scaling_efficiency":
            continue
        if n == 1 and not isinstance(value, float):
            fails.append(f"bench_scaling: {line['metric']} at one rank: {value}")
        if on_card and n > 1 and value != "not measured":
            fails.append(f"bench_scaling: {line['metric']} at {n} ranks on one card: {value}")
    for r in meas["dryrun"]:
        if not (np.isfinite(r["sharded_cost"]) and np.isfinite(r["live_cost"])
                and r["extracted_frames"] == r["ranks"]):
            fails.append(f"dryrun_multichip: rank {r['rank']} {r}")
    return fails


# path 13, the battery: two of run_validation.py's worlds whole (its table
# is `runners.validation.WORLDS`), through the port's runner
# (`runners.validation.run_world`, then `score_world`: run_validation.py's
# row and verdict) on the card, each reaching what no earlier path does:
# fastspin30 (settings/synthetic.yaml, 600 frames at 20 fps of a 52 deg/s
# sweep: the tracker's RECENTLY_LOST recoveries and its reference-keyframe
# match) and corridor60 (settings/synthetic_forward.yaml, the forward
# profile with its optical axis on +x body, 600 frames at 10 fps: ~200
# keyframes, so its full polishes take the grouped problem between local_k
# and full_k keyframes, K4's large-D route, and the stride subsample past
# full_k, K4's cluster route). Child processes render their frames while
# paths 9-12 run.
BATTERY_WORLDS = ("fastspin30", "corridor60")
# the JAX package's runs of the same worlds on the CPU
# (experiments/port_battery_jax.py --seeds 0,1,2,3; PERF.md records the
# runs): run_validation.py's row at seed 0 of the tracker's RANSAC draws
# (the default), its RECENTLY_LOST frames, polishes by branch and
# reference-keyframe matches, the most fetches a tracked frame made over
# seeds 0-3, and the ATE and keyframe counts of seeds 0-3
JAX_BATTERY = {
    "fastspin30": dict(frames=600, ok_frames=595, ok_ratio=595 / 600, lost_events=0,
                       recently_lost_frames=0, n_keyframes=110, kf_created_total=128,
                       imu_state=2, imu_init_t=2.7, ate_rmse=0.02171511820379242,
                       scale_err=0.044593508288812145, bound_ate=0.4, bound_scale=0.1,
                       polishes=dict(n=9, window=2, grouped=5, subsampled=2), ref_kf_matches=2,
                       # seed 2 fails the world's ATE bound (0.466 m), with
                       # 14 RECENTLY_LOST frames
                       max_fetches_tracked_frame=4,
                       ate_over_seeds=[0.02171511820379242, 0.016282302760614497,
                                       0.4657179335704575, 0.38697529119977053],
                       n_keyframes_over_seeds=[110, 108, 150, 162],
                       kf_created_over_seeds=[128, 130, 152, 162]),
    "corridor60": dict(frames=600, ok_frames=599, ok_ratio=599 / 600, lost_events=0,
                       recently_lost_frames=0, n_keyframes=197, kf_created_total=197,
                       imu_state=2, imu_init_t=6.4, ate_rmse=1.4919797487702016,
                       scale_err=0.11875832320333823, bound_ate=4.5, bound_scale=0.25,
                       polishes=dict(n=17, window=2, grouped=6, subsampled=9), ref_kf_matches=0,
                       max_fetches_tracked_frame=3,
                       ate_over_seeds=[1.4919797487702016, 1.9269808904578338,
                                       2.7459244163101584, 1.6800259803721087],
                       n_keyframes_over_seeds=[197, 198, 198, 198],
                       kf_created_over_seeds=[197, 198, 198, 198]),
}
# the gates beside run_validation.py's verdict (the world's ATE and scale
# bounds, no LOST event): an OK ratio at least JAX's less 0.05 and the
# inertial init finished (imu_state 2); keyframes kept and created within
# 30% of the range of JAX's seeds; the ATE at most twice the largest over
# JAX's seeds; a tracked frame (OK, after an OK frame: a bootstrap's
# batched SVDs sync) fetches no more often than the stages it ran fetch in
# either package (BATTERY_*_FETCHES: 3 a frame that tracks the last frame,
# one more for each fall-back stage) and syncs no more than it fetches; a
# mapper step syncs no more than it fetches; no kernel build after the
# warm-up; the device memory the
# allocator holds at the last progress line within 25% of the line at
# frame 300 (every store has a fixed capacity)
BATTERY_OK_SLACK, BATTERY_KF_RTOL, BATTERY_ATE_FACTOR = 0.05, 0.30, 2.0
# the fetches of a tracked frame: one at its start, and one a stage it
# runs, but two for the reference-keyframe match (its match, then its pose
# LM; the JAX package's match reads its result with np.asarray, which its
# experiment's count of `fetch` calls misses: JAX's frames count 3, and 4
# with a fall-back stage)
BATTERY_FRAME_FETCHES = 1
BATTERY_STAGE_FETCHES = {"_match_against_last": 1, "_match_against_last_kf": 1,
                         "_match_against_ref_kf": 2, "_track_local_map": 1}
BATTERY_MEM_FRAME, BATTERY_MEM_RTOL = 300, 0.25
# the kernels each world must launch: K1-K4 (cluster route) in both, and
# on corridor60 K4's large-D route and a polish past full_k too
BATTERY_KERNELS = {"fastspin30": ("gather_patches", "match_rows", "hamming", "chol_solve"),
                   "corridor60": ("gather_patches", "match_rows", "hamming", "chol_solve",
                                  "chol_solve_l2")}
BATTERY_MIN_SUBSAMPLED = {"fastspin30": 0, "corridor60": 1}


def battery_stream(name):
    """A battery world's frames, rendered by a child process (`_Prefetched`)
    and read to the end on a thread (`_Drained`); the child is stopped when
    this process exits."""
    from monoorbslam3_tpu_torch.runners import validation

    settings, spec, _, _ = validation.WORLDS[name]
    stream = _Prefetched(("synthetic", spec, Path(validation.REPO) / settings))
    atexit.register(stream.close)
    return _Drained(stream)


def battery_world(device, name, frames, out_dir, log=lambda line: None):
    """One battery world on `device` through `runners.validation.run_world`
    (build_system, warmup, the stream, shutdown, the keyframe trajectory,
    the runner's `BatteryMeter`) and `score_world`, with the system world's
    meters put in after the warm-up (`meter_system`; syncs attributed to
    SYSTEM_WORLD_REGIONS) and the launch counts set to 0 there. `frames`:
    the stream (`battery_stream`). Returns dict(row: the runner's row,
    records, steps: the meters', region_syncs, sync_sites)."""
    import torch

    from monoorbslam3_tpu_torch.ops import cuda_lib
    from monoorbslam3_tpu_torch.runners import validation

    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    ledger = SyncLedger(on_card)
    metered = {}

    allowance = collections.Counter()  # frame -> the fetches of the stages it ran

    def instrument(syst):
        frames_, metered["meter"] = meter_system(syst, ledger, sync, log=log)
        metered["frames"] = frames_
        for stage, n in BATTERY_STAGE_FETCHES.items():
            on_call(syst.tracking, stage,
                    lambda *a, n=n: allowance.update({len(frames_.records): n}))
        _zero(cuda_lib.launches)  # the warm-up's launches are not the path's
        return recorded(ledger, SYSTEM_WORLD_REGIONS)

    settings, spec, _, _ = validation.WORLDS[name]
    info = validation.run_world(name, settings, spec, out_dir, device, frames=frames,
                                instrument=instrument)
    records = metered["frames"].records
    for r in records:
        r["fetch_allowance"] = BATTERY_FRAME_FETCHES + allowance[r["frame"]]
    return dict(row=validation.score_world(name, info), records=records,
                steps=metered["meter"].steps, region_syncs=dict(ledger.counts),
                sync_sites=dict(ledger.sites))


def battery_lane(device, name, out_dir, go):
    """Path 13's world `name` in a `Lane`: its frames rendered ahead from
    the lane's start (`battery_stream`), then, once the file `go` exists,
    `battery_world` on `device` with the arguments of the kernels' last
    launches kept for the kernel checks (K1's last, K2's last eight: a
    frame, K3's last 4, K4's last 24 cluster-route and 12 large-D systems).
    Returns battery_world's result with `seconds` and k1, k2, k3, k4,
    k4_l2."""
    import torch

    from monoorbslam3_tpu_torch.ops import chol_pallas, match_pallas, pallas_kernels

    frames = battery_stream(name)
    _wait_file(go)
    t0 = time.perf_counter()
    with _Capture(match_pallas, "_match_rows_cuda") as k2, \
            _Capture(pallas_kernels, "hamming_matrix_cuda", maxlen=4) as k3, \
            _Capture(pallas_kernels, "gather_patches_cuda", maxlen=1) as k1, \
            _Capture(chol_pallas, "chol_solve_cluster", maxlen=24) as k4, \
            _Capture(chol_pallas, "chol_solve_l2", maxlen=12) as k4l2:
        out = battery_world(device, name, frames, out_dir)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    out.update(seconds=time.perf_counter() - t0, k1=list(k1.calls), k2=list(k2.calls),
               k3=list(k3.calls), k4=list(k4.calls), k4_l2=list(k4l2.calls))
    return out


def battery_checks(bat, on_card=True):
    """The battery's gates on {world: `battery_world`'s result} against
    JAX_BATTERY and the worlds' bounds (the fetch, sync and memory gates
    only on the card, where they are counted). Returns the failures."""
    fails = []
    for name, w in bat.items():
        ref, row, tag = JAX_BATTERY[name], w["row"], f"battery {name}"
        if not row["ate_rmse"] <= row["bound_ate"]:
            fails.append(f"{tag}: ATE {row['ate_rmse']} m > the world's {row['bound_ate']} m")
        if not row["scale_err"] <= row["bound_scale"]:
            fails.append(f"{tag}: scale error {row['scale_err']} > {row['bound_scale']}")
        if row["lost_events"]:
            fails.append(f"{tag}: {row['lost_events']} LOST events")
        ok_min = ref["ok_ratio"] - BATTERY_OK_SLACK
        if not row["ok_frames"] >= ok_min * row["frames"] or not row["frames"]:
            fails.append(f"{tag}: {row['ok_frames']} of {row['frames']} frames OK, JAX's "
                         f"ratio {ref['ok_ratio']}")
        if row["imu_state"] != 2:
            fails.append(f"{tag}: imu_state {row['imu_state']}")
        for key, seeds in (("n_keyframes", ref["n_keyframes_over_seeds"]),
                           ("kf_created_total", ref["kf_created_over_seeds"])):
            lo, hi = (1 - BATTERY_KF_RTOL) * min(seeds), (1 + BATTERY_KF_RTOL) * max(seeds)
            if not lo <= row[key] <= hi:
                fails.append(f"{tag}: {key} {row[key]}, JAX's {seeds} over its seeds")
        ate_max = BATTERY_ATE_FACTOR * max(ref["ate_over_seeds"])
        if not row["ate_rmse"] <= ate_max:
            fails.append(f"{tag}: ATE {row['ate_rmse']} m > {ate_max} m (twice JAX's largest "
                         f"over its seeds)")
        if any(row["kernel_builds_after_warmup"].values()):
            fails.append(f"{tag}: kernel builds after the warm-up "
                         f"{row['kernel_builds_after_warmup']}")
        for k in BATTERY_KERNELS[name]:
            if not row["launches"][k]:
                fails.append(f"{tag}: kernel {k} was never launched")
        if row["polishes"]["subsampled"] < BATTERY_MIN_SUBSAMPLED[name]:
            fails.append(f"{tag}: {row['polishes']['subsampled']} full polishes past full_k")
        if not on_card:
            continue
        for prev, r in zip(w["records"], w["records"][1:]):
            if (prev["state"] == r["state"] == 2
                    and not r["syncs"] <= r["fetches"] <= r["fetch_allowance"]):
                fails.append(f"{tag}: frame {r['frame']} fetched {r['fetches']} times for "
                             f"{r['fetch_allowance']} and synced {r['syncs']}")
        for m in w["steps"]:
            if m["syncs"] > m["fetches"]:
                fails.append(f"{tag}: the mapper step of KF {m['kf']} synced {m['syncs']} "
                             f"times for {m['fetches']} fetches")
        for region, n in w["region_syncs"].items():
            if n and region != "two-view bootstrap":
                fails.append(f"{tag}: {n} host syncs inside the {region}")
        census = row["memory"]["census"]
        at = [c for c in census if c["frame"] == BATTERY_MEM_FRAME]
        if not at or not (abs(census[-1]["alloc_mb"] - at[0]["alloc_mb"])
                          <= BATTERY_MEM_RTOL * at[0]["alloc_mb"]):
            fails.append(f"{tag}: device memory {census[-1] if census else None} at the last "
                         f"progress line, {at} at frame {BATTERY_MEM_FRAME}")
    return fails


class SyncWatch:
    """Counts the host syncs that PyTorch's sync debug mode reports inside
    `with watch(on_card):` blocks (nothing is counted off the card), and
    the source lines that made them."""

    def __init__(self):
        self.n = 0
        self.sites = collections.Counter()

    @contextlib.contextmanager
    def __call__(self, on_card):
        if not on_card:
            yield
            return
        import torch

        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # the debug mode's own prototype notice is not a sync
        for w in caught:
            if "called a synchronizing" in str(w.message):
                self.n += 1
                self.sites[f"{w.filename}:{w.lineno}"] += 1


class TorchPipe:
    """The port's tracking and mapper paths on one device, with the camera
    and IMU calibration of a profile under settings/ (EuRoC's unless told
    otherwise). `features` brings a frame's features to the host (seeding
    only); `coarse` uploads the frame and the coarse candidates, extracts,
    runs the coarse stage and reads its result with one fetch; `local` runs
    the local stage on the same frame with one fetch. `vi_coarse` and
    `vi_local` are the inertial frame's two halves, one fetch each.
    `keyframe`, `triangulate` and `fuse` are the mapper search's steps, one
    fetch each."""

    def __init__(self, device, profile=EUROC_PROFILE):
        import torch

        from monoorbslam3_tpu_torch import config
        from monoorbslam3_tpu_torch.ops.orb import OrbExtractor
        from monoorbslam3_tpu_torch.utils.fetch import SyncCounter

        self.torch = torch
        self.dev = torch.device(device)
        self.profile = profile
        settings = config.load_settings(SETTINGS / profile)
        self.cam = config.build_camera(settings, device=self.dev)
        self.calib = config.build_imu_calib(settings, device=self.dev)
        self.ext = OrbExtractor(self.cam.height, self.cam.width,
                                n_features=N_FEAT, n_levels=N_LEVELS, scale=SCALE,
                                device=self.dev)
        self.R_cb = self._up(R_CB)
        self.t_cb = self._up(T_CB)
        self.t_bc = self._up(T_BC.astype(np.float32))
        self.syncs = SyncCounter()
        # host syncs inside the inertial stage (preintegration, deltas,
        # prediction, whitening) and inside the two stage kernels
        self.inertial_watch = SyncWatch()
        self.stage_watch = SyncWatch()
        self._feats = None
        self._vi = None
        self._kfs = []
        self.mapper_times = {}

    def _up(self, x):
        """Host array -> device tensor through pinned memory, without a
        host wait (uint32 descriptors become their int32 view)."""
        from monoorbslam3_tpu_torch import convert

        t = convert.tensor(x, "cpu")
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
        out = self._fetch(dict(state=st, ci=ci, n_match=n_match, n_inl=n_inl,
                               feats=self._host_feats(f)))
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
        out = self._fetch(dict(state=st, lci=lci, keep_coarse=keep, hit=hit, n_inl=n_inl))
        out["n_inl"] = int(out["n_inl"])
        out["device_ms"] = dict(dev_local_ms=self._span(e0, e1))
        return out

    def vi_coarse(self, img, fr_buf, kf_buf, kf_state, cand):
        """The inertial frame's first half. The inertial stage, all on the
        device and under `inertial_watch`: both windows (`fr_buf`, `kf_buf`)
        preintegrated at the keyframe's biases, the keyframe window's
        bias-corrected deltas, and the IMU-only prediction from the
        keyframe's state. Then extraction and the coarse stage from that
        prediction. One fetch brings the coarse result, the prediction and
        both windows' spans home."""
        from monoorbslam3_tpu_torch.backend.residuals import KfState
        from monoorbslam3_tpu_torch.frontend.tracking import (_coarse_track_kernel,
                                                              _predict_deltas,
                                                              _predict_state_inertial)

        on_card = self.dev.type == "cuda"
        c = {k: self._up(v) for k, v in cand.items()}
        e0 = self._event()
        with self.inertial_watch(on_card):
            kf = KfState(*(self._up(a) for a in kf_state))
            pre_f = fr_buf.integrate(kf.bg, kf.ba, self.calib)
            pre_kf = kf_buf.integrate(kf.bg, kf.ba, self.calib)
            pred = _predict_state_inertial(kf, *_predict_deltas(pre_kf, kf.bg, kf.ba),
                                           pre_kf.dt)
        e1 = self._event()
        f = self._frame(img)
        self._feats = f
        self._vi = dict(kf=kf, pre_kf=pre_kf)
        e2 = self._event()
        with self.stage_watch(on_card):
            st, ci, n_match, n_inl = _coarse_track_kernel(
                pred, c["cand_xyz"], c["cand_desc"], c["cand_valid"], c["cand_ang"],
                c["cand_extra2"], f["xy"], f["desc"], f["valid"], f["angle"], f["sigma2"],
                self.cam, self.R_cb, self.t_cb, c["radius"], RETRY, use_rotation=True)
        e3 = self._event()
        out = self._fetch(dict(state=st, pred=pred, ci=ci, n_match=n_match, n_inl=n_inl,
                               dt=(pre_f.dt, pre_kf.dt), feats=self._host_feats(f)))
        out["feats"]["desc"] = out["feats"]["desc"].view(np.uint32)
        out["n_match"], out["n_inl"] = int(out["n_match"]), int(out["n_inl"])
        out["device_ms"] = dict(dev_imu_ms=self._span(e0, e1), dev_extract_ms=self._span(e1, e2),
                                dev_coarse_ms=self._span(e2, e3))
        return out

    def vi_local(self, state, cand):
        """The inertial frame's second half: the keyframe window whitened
        into an edge (under `inertial_watch`), then the local stage with
        that edge from the keyframe's state in the 15-dim pose LM. One
        fetch."""
        from monoorbslam3_tpu_torch.backend.problems import whiten
        from monoorbslam3_tpu_torch.backend.residuals import KfState
        from monoorbslam3_tpu_torch.frontend.tracking import _local_track_kernel

        on_card = self.dev.type == "cuda"
        state = KfState(*(self._up(a) for a in state))
        c = {k: self._up(v) for k, v in cand.items()}
        f = self._feats
        e0 = self._event()
        with self.inertial_watch(on_card):
            edge = whiten(self._vi["pre_kf"])
        e1 = self._event()
        with self.stage_watch(on_card):
            st, lci, keep, hit, n_inl = _local_track_kernel(
                state, c["cand_xyz"], c["cand_desc"], c["cand_valid"], c["cand_normal"],
                c["cand_use_vcos"], c["cand_extra2"], c["radius"], c["blockrow"],
                c["coarse_pts"], c["coarse_inv_s2"], c["coarse_valid"],
                f["xy"], f["desc"], f["valid"], f["sigma2"], self.cam, self.R_cb, self.t_cb,
                self.t_bc, VIEW_COS_GATE, RETRY, edge, self._vi["kf"], 1.0, use_inertial=True)
        e2 = self._event()
        out = self._fetch(dict(state=st, lci=lci, keep_coarse=keep, hit=hit, n_inl=n_inl))
        out["n_inl"] = int(out["n_inl"])
        out["device_ms"] = dict(dev_whiten_ms=self._span(e0, e1), dev_local_ms=self._span(e1, e2))
        return out


def _pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q))


def _tensor_core_ops(lib_path):
    """{kernel: {tensor-core SASS opcode: count}} of a built library, from
    `cuobjdump -sass`; None when cuobjdump did not run."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                              check=True, timeout=120).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
        elif name and (op := next((w for w in line.split()
                                   if w.split(".")[0].endswith("MMA")), None)):
            ops = out.setdefault(name, {})
            ops[op] = ops.get(op, 0) + 1
    return out


def seeded_match_ties(N, M, rng, widths=(8, 16, 32, 64, 128, 256, 512)):
    """K2 inputs (rows then columns, as `_match_rows` takes them) whose
    rows each find their best distance at two columns: one pair of columns
    straddles a boundary at every multiple of each of `widths` below M,
    the other rows' pairs lie at random columns. The spatial gate is open,
    every descriptor valid and every group -1."""
    import torch

    da = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    db = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint32)
    pairs = sorted({(c - 1, c) for w in widths for c in range(w, M, w)})
    used = {j for p in pairs for j in p}
    free = rng.permutation([j for j in range(M) if j not in used])
    pairs += [tuple(sorted(free[2 * k: 2 * k + 2]))
              for k in range(max(0, min(N - len(pairs), len(free) // 2)))]
    for r, (j1, j2) in enumerate(pairs[:N]):
        d = da[r].copy()
        d[r % 8] ^= np.uint32(1 << (r % 32))  # distance 1 at both columns
        db[j1] = db[j2] = d
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    w = lambda x: torch.as_tensor(x.view(np.int32))
    return [w(da), w(db), f(np.zeros(N)), f(np.zeros(N)), f(np.full(N, 1e9)),
            f(np.full(N, -1.0)), f(np.ones(N)), f(np.zeros(M)), f(np.zeros(M)),
            f(np.full(M, 1e9)), f(np.full(M, -1.0)), f(np.ones(M))]


def _zero(counts):
    for k in counts:
        counts[k] = 0


def _rel(x, ref):
    """Per-system relative error ||x - ref|| / ||ref|| over the last axis."""
    return (x.double() - ref.double()).norm(dim=-1) / ref.double().norm(dim=-1)


class _OtherBuild:
    """Inside the block every kernel wrapper launches from another build:
    the package's library is swapped for one compiled from `src` (another
    version of a source of csrc/, a parent's, say) into `src`'s directory.
    The functions `src` does not define are missing inside the block."""

    def __init__(self, src):
        import ctypes

        from monoorbslam3_tpu_torch.ops import cuda_lib

        self.cuda_lib = cuda_lib
        out = Path(src).with_suffix(".so")
        proc = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared", "-o",
                               str(out), str(src)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr[-4000:]}")
        self.lib = ctypes.CDLL(str(out))
        for name, argtypes in cuda_lib._SIGNATURES.items():
            if hasattr(self.lib, name):
                getattr(self.lib, name).argtypes = argtypes
                getattr(self.lib, name).restype = ctypes.c_int

    def __enter__(self):
        self.orig = self.cuda_lib.lib()
        self.cuda_lib._lib = self.lib
        return self

    def __exit__(self, *exc):
        self.cuda_lib._lib = self.orig


def _ab_build(ab_dir, name):
    """`_OtherBuild` of `ab_dir/name`, or None without that file."""
    src = Path(ab_dir or "", name)
    return _OtherBuild(src) if ab_dir and src.exists() else None


def _ab_times(kern, other, other_kern=None):
    """(device_ms, call_ms, other_device_ms, other_call_ms) of `kern`
    timed in the order other, package, package, other, each the mean of
    its two windows. The other side is `kern` inside `other` (an
    `_OtherBuild`), or `other_kern` where the other build's entry point
    differs from the package's."""
    def timed_other():
        if other_kern is not None:
            return _time_kernel(other_kern)
        with other:
            return _time_kernel(kern)

    p1 = timed_other()
    c1, c2 = _time_kernel(kern), _time_kernel(kern)
    p2 = timed_other()
    return ((c1[0] + c2[0]) / 2, (c1[1] + c2[1]) / 2, (p1[0] + p2[0]) / 2, (p1[1] + p2[1]) / 2)


def one_block_solver(other):
    """solve(S, b) through the one-block large-D kernel that builds of
    chol_solve.cu had before the grid route (`chol_solve_f32(S, b, G, D,
    work [G, D, D], x, stream)`), from `other` (an `_OtherBuild`); None
    when `other` has no such entry point."""
    import ctypes

    import torch

    from monoorbslam3_tpu_torch.ops import cuda_lib

    fn = getattr(other.lib, "chol_solve_f32", None)
    if fn is None:
        return None
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int

    def solve(S, b):
        D = S.shape[-1]
        Sc, bc = S.reshape(-1, D, D).contiguous(), b.reshape(-1, D).contiguous()
        work, x = torch.empty_like(Sc), torch.empty_like(bc)
        cuda_lib.check(fn(Sc.data_ptr(), bc.data_ptr(), Sc.shape[0], D, work.data_ptr(),
                          x.data_ptr(), torch.cuda.current_stream(S.device).cuda_stream),
                       "chol_solve_f32")
        return x.reshape(b.shape)

    return solve


class _SolverChol:
    """Inside the block `schur_ba`'s reduced solve goes through `solve`
    instead of K4's wrapper (another build's kernel, for a same-call A/B
    of whole BA solves)."""

    def __init__(self, solve):
        self.solve = solve

    def __enter__(self):
        from monoorbslam3_tpu_torch.backend import solver

        self.solver, self.orig = solver, solver.chol_solve
        solver.chol_solve = self.solve
        return self

    def __exit__(self, *exc):
        self.solver.chol_solve = self.orig


def polish_wall_ab(device, other_solve, n_runs=5, log=print):
    """Median wall ms of whole polish solves per POLISH_VARIANTS entry,
    with `other_solve` as the reduced solve and with the package's K4, in
    the order other, package, package, other (each `n_runs` solves after a
    warm-up one): {variant: {"parent_solve_ms", "solve_ms", "parent_cost",
    "cost"}}."""
    import torch

    from monoorbslam3_tpu_torch.backend.solver import schur_ba
    from monoorbslam3_tpu_torch.bench_window import build_problem
    from monoorbslam3_tpu_torch.utils.fetch import SyncCounter, fetch

    dev = torch.device(device)
    problem, cam = build_problem(seed=0, device=dev, **POLISH_WINDOW)
    R_cb, t_cb = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    syncs = SyncCounter()
    out = {}
    for name, kw in POLISH_VARIANTS.items():
        def run():
            ts, cost = [], None
            for i in range(n_runs + 1):
                t0 = time.perf_counter()
                info = schur_ba(problem, cam, R_cb, t_cb, n_iters=POLISH_ITERS, **kw)[2]
                cost = float(fetch(info["cost"], syncs))
                torch.cuda.synchronize()
                ts.append(1e3 * (time.perf_counter() - t0))
            return ts[1:], cost

        turns = []
        for other in (True, False, False, True):
            if other:
                with _SolverChol(other_solve):
                    turns.append(run())
            else:
                turns.append(run())
        out[name] = dict(parent_solve_ms=float(np.median(turns[0][0] + turns[3][0])),
                         solve_ms=float(np.median(turns[1][0] + turns[2][0])),
                         parent_cost=turns[0][1], cost=turns[1][1])
        log(json.dumps(out[name] | {"variant": name}))
    return out


def _same(got, ref, label):
    """Raise unless every output of a kernel equals its plain version's."""
    import torch

    for g, r, name in zip(got, ref, ("best", "second", "idx")):
        if not torch.equal(g, r):
            raise RuntimeError(f"{label}: {name} disagrees with the plain version")


def _rel_fields(got, ref):
    """max |got - ref| / max |ref| over each field of two records."""
    out = {}
    for name, g, r in zip(ref._fields, got, ref):
        g, r = g.double().cpu(), r.double().cpu()
        out[name] = float((g - r).abs().max() / r.abs().max().clamp(min=1e-30))
    return out


def vi_card_checks(dev, buf, kf_state, lm_cap):
    """The inertial stage on the card against the port on the CPU and
    against the SVD, and its device times, on the drive's last keyframe
    window `buf` at its keyframe's biases:
    - `preintegrate_tree` and `whiten` on the card and on the CPU (no TF32
      or other card-specific arithmetic may creep in: VI_CARD_RTOL);
    - `Preintegrated.delta_rotation`'s polar step against the SVD
      projection of the JAX package's `normalize_rotation`, and how many
      host syncs the SVD makes on the card (sync debug mode);
    - the CUDA-event span of one call (after a synchronize, so host
      launch time included: these functions launch 45 to ~3,300 kernels,
      too many to hold behind a sleep) of the tree, the whitening, the
      deltas, the SVD projection, and the last local stage's pose LM with
      its inertial tail and without it (`lm_cap` holds that call). Their
      device times come from `experiments/port_track_profile.py
      --inertial`."""
    import torch

    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.backend import problems
    from monoorbslam3_tpu_torch.frontend.tracking import _predict_deltas
    from monoorbslam3_tpu_torch.utils import lie

    settings = config.load_settings(SETTINGS / EUROC_PROFILE)
    calib_card = config.build_imu_calib(settings, device=dev)
    calib_cpu = config.build_imu_calib(settings, device="cpu")
    bg, ba = kf_state[3], kf_state[4]
    pre_card = buf.integrate(torch.as_tensor(bg, device=dev), torch.as_tensor(ba, device=dev),
                             calib_card)
    pre_cpu = buf.integrate(bg, ba, calib_cpu)
    edge_card, edge_cpu = problems.whiten(pre_card), problems.whiten(pre_cpu)
    out = dict(window_samples=int(buf.n), padded_to=int(buf.padded()[0].shape[0]),
               tree_vs_cpu=_rel_fields(pre_card, pre_cpu),
               whiten_vs_cpu=_rel_fields(edge_card, edge_cpu))
    out["max_rel_vs_cpu"] = max(max(out["tree_vs_cpu"].values()),
                                max(out["whiten_vs_cpu"].values()))

    # the deltas' rotation: Newton-Schulz polar step against the SVD
    bg_d, ba_d = pre_card.bg, pre_card.ba
    prod = pre_card.dR @ lie.exp_so3(pre_card.JRg @ (bg_d - pre_card.bg))
    svd_watch = SyncWatch()
    with svd_watch(True):
        R_svd = lie.normalize_rotation(prod)
    out["svd_syncs"] = svd_watch.n
    out["polar_vs_svd_max_abs"] = float((lie.polar_rotation(prod) - R_svd).abs().max())

    args, kwargs = lm_cap.calls[-1], lm_cap.kwargs[-1]
    out["lm_use_inertial"] = bool(kwargs.get("use_inertial"))
    visual = dict(kwargs, use_inertial=False)
    calls = {"tree": lambda: buf.integrate(pre_card.bg, pre_card.ba, calib_card),
             "whiten": lambda: problems.whiten(pre_card),
             "deltas": lambda: _predict_deltas(pre_card, bg_d, ba_d),
             "svd": lambda: lie.normalize_rotation(prod),
             "lm_inertial": lambda: problems._pose_optimize_impl(*args, **kwargs),
             "lm_visual": lambda: problems._pose_optimize_impl(*args, **visual)}
    for fn in calls.values():  # warm-up
        fn()
    out["span_ms"] = {name: _span_ms(fn, TIMED_CALLS) for name, fn in calls.items()}
    return out


def main(argv=None) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", metavar="DIR", default=None,
                    help="a directory with other sources of the kernels (gather_patches.cu, "
                         "match_rows.cu, hamming.cu, chol_solve.cu: a parent's, say), each "
                         "built and timed in turns with the package's on the same launches")
    ab_dir = ap.parse_args(argv).ab

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs one", file=sys.stderr)
        return 2
    from monoorbslam3_tpu_torch.frontend import tracking
    from monoorbslam3_tpu_torch.ops import chol_pallas, cuda_lib, match_pallas, pallas_kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    card = smi[0].strip()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    print("torch", torch.__version__, "cuda", torch.version.cuda, "device",
          torch.cuda.get_device_name(0))

    # path 15's four datasets, written by four children from the start (the
    # phone's 180 frames at 1280x720 take ~400 s of one core of the card's
    # host; its lane runs NTU-VIRAL first and the lanes' phase lasts as long
    # as corridor60's, so it has room to wait)
    vio_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_vio_")
    vio_writers = {kind: DatasetWriter(Path(vio_tmp.name) / kind, kind) for kind in VIO_PROFILES}
    for w in vio_writers.values():
        atexit.register(w.close)

    # -- build the kernels from csrc/ -------------------------------------
    t0 = time.perf_counter()
    cuda_lib.build()
    cuda_lib.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s into {cuda_lib.LIB}")
    for line in cuda_lib.BUILD_LOG.read_text().splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())
    tc_ops = _tensor_core_ops(cuda_lib.LIB)
    if tc_ops is None:
        print("sass: cuobjdump did not run; the tensor-core check is not made")
    for name, ops in (tc_ops or {}).items():
        print(f"sass: {name}: {json.dumps(ops)}")
    # the frames of paths 1, 2 and 8, rendered ahead by a child process
    # (not niced: the drives wait on it)
    euroc_images = _Drained(_Prefetched(("euroc", EUROC_PROFILE, TRACK_MAP_FRAMES), nice=0))
    atexit.register(euroc_images.close)
    # path 10's dataset, rendered by a child process while paths 1-9 run
    ds_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_dataset_")
    writer = DatasetWriter(Path(ds_tmp.name) / "euroc")
    atexit.register(writer.close)  # the child ends with this process, whatever happens
    # path 12's end-to-end world, rendered by another child meanwhile
    from monoorbslam3_tpu_torch.measure import e2e

    e2e_settings, e2e_spec, _ = e2e.WORLDS[E2E_WORLD]
    e2e_stream = _Prefetched(("synthetic", e2e_spec, e2e.REPO / e2e_settings))
    atexit.register(e2e_stream.close)
    e2e_reader = _Drained(e2e_stream)
    # (path 13's and path 14's children start later, after path 8,
    # so that fewer children share the host with the paths at a time)

    # the host seconds of each phase, printed before the kernels' line
    phase_s, phase_t = [], [time.perf_counter()]

    def lap():
        now = time.perf_counter()
        phase_s.append(round(now - phase_t[0], 1))
        phase_t[0] = now

    lap()  # the build and the children's start
    # -- path 1, tracking: the 40-frame slice drive ---------------------------
    pipe = TorchPipe(dev)
    # warm-up outside the counted runs (first launches load modules)
    pipe.features(np.zeros((pipe.cam.height, pipe.cam.width), np.float32))
    warm = torch.zeros((64, 8), dtype=torch.int32, device=dev)
    pallas_kernels.hamming_matrix_cuda(warm, warm)
    chol_pallas.chol_solve_cuda(torch.eye(16, device=dev)[None], torch.ones((1, 16), device=dev))
    torch.cuda.synchronize()
    _zero(cuda_lib.launches)
    pipe.syncs.n = 0
    with _Capture(match_pallas, "_match_rows_cuda") as cap:
        records = drive(pipe, images=euroc_images.get)
    torch.cuda.synchronize()
    launches = dict(cuda_lib.launches)
    syncs = pipe.syncs.n
    print("launches in the tracking drive:", json.dumps(launches))
    n_fr = len(records)
    print(f"host syncs: {syncs} over {n_fr} frames + 1 seed frame "
          f"({(syncs - 1) / n_fr:.2f} per tracked frame)")

    lap()
    # -- path 2, visual-inertial tracking: the drive with the IMU ------------
    _zero(cuda_lib.launches)
    pipe.syncs.n = 0
    with _Capture(match_pallas, "_match_rows_cuda") as vcap, \
            _Capture(tracking, "_pose_optimize_impl", maxlen=1) as lm_cap:
        vi_records, (vi_buf, vi_kf) = vi_drive(pipe, images=euroc_images.get)
    torch.cuda.synchronize()
    vi_launches = dict(cuda_lib.launches)
    vi_syncs = pipe.syncs.n
    n_vi = len(vi_records)
    print("launches in the visual-inertial drive:", json.dumps(vi_launches))
    print(f"host syncs: {vi_syncs} over {n_vi} frames + 1 seed frame "
          f"({(vi_syncs - 1) / n_vi:.2f} per tracked frame; the JAX package's inertial "
          f"frame makes {MAX_VI_SYNCS_PER_FRAME})")
    print(f"host syncs inside the inertial stage (sync debug mode): {pipe.inertial_watch.n} "
          f"{json.dumps(dict(pipe.inertial_watch.sites))}; inside the two stage kernels, for "
          f"information: {pipe.stage_watch.n} {json.dumps(dict(pipe.stage_watch.sites))}")
    vi_check = vi_card_checks(dev, vi_buf, vi_kf, lm_cap)
    print("visual-inertial checks:", json.dumps(vi_check))

    lap()
    # -- path 3, mapper search: triangulate + fuse on rendered keyframes -----
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

    lap()
    # -- path 4, fisheye mapper search: the TUM-VI camera ---------------------
    fpipe = TorchPipe(dev, profile=FISHEYE_PROFILE)
    fpipe.features(np.zeros((fpipe.cam.height, fpipe.cam.width), np.float32))
    torch.cuda.synchronize()
    _zero(cuda_lib.launches)
    t0 = time.perf_counter()
    with _Capture(pallas_kernels, "hamming_matrix_cuda") as fcap:
        frec = mapper_search(fpipe)
    torch.cuda.synchronize()
    fish_launches = dict(cuda_lib.launches)
    print(f"fisheye mapper search: {time.perf_counter() - t0:.2f} s host (3 renders included), "
          f"{fpipe.syncs.n} host syncs, launches {json.dumps(fish_launches)}")
    print(f"fisheye mapper bounds: accepted >= {MIN_ACCEPTED_FISHEYE}, median 3D error <= "
          f"{MAX_MEDIAN_TRI_ERR_FISHEYE_M} m, fused >= {MIN_FUSED_FISHEYE}")
    for label, a in zip(("fisheye triangulate", "fisheye fuse"), fcap.calls):
        got = pallas_kernels.hamming_matrix_cuda(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, pallas_kernels.hamming_matrix_plain(*a)):
            raise RuntimeError(f"K3 {label} disagrees with its plain version")
    print(f"K3 on the fisheye search's {fcap.n} launches: bit-identical to the plain version")

    lap()
    # -- path 5, window BA on the bench window -----------------------------
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

    lap()
    # -- path 6, polish BA on the full polish's window -----------------------
    _zero(cuda_lib.launches)
    polish = polish_ba(dev)
    torch.cuda.synchronize()
    polish_launches = dict(cuda_lib.launches)
    print("launches in the polish runs:", json.dumps(polish_launches))
    for name, r in polish.items():
        print(f"polish BA {name}: cost0 {r['cost0']:.4f} (JAX-CPU {JAX_POLISH_COST0}), cost "
              f"{r['cost']:.4f} (JAX-CPU {JAX_POLISH_COST[name]}); median of "
              f"{len(r['solve_ms'])} solves {r['median_solve_ms']:.3f} ms per "
              f"{POLISH_ITERS}-iteration solve (quartiles {_pct(r['solve_ms'], 25):.3f} / "
              f"{_pct(r['solve_ms'], 75):.3f} ms); K4 launches in a solve "
              f"{json.dumps(r['k4_launches_in_solve'])}; host syncs per solve: "
              f"{r['syncs_in_solve']} inside + {r['fetches_per_solve']} fetch")

    lap()
    # -- path 7, store BA: the Problems façade on a seeded map store ---------
    # (store_ba sets the counts to 0 itself, after the façade's warm-up)
    sba = store_ba(dev)
    torch.cuda.synchronize()
    store_launches = dict(cuda_lib.launches)
    print("launches in the store BA runs:", json.dumps(store_launches))
    si = sba["init"]
    print(f"store BA inertial_optimize: scale {si['scale']:.7f} (JAX-CPU "
          f"{JAX_STORE_INIT['scale']:.7f}, truth {INIT_SCALE}), gravity {si['gravity_err_deg']:.5f} "
          f"deg from the truth and {_angle_deg(si['gravity'], JAX_STORE_INIT['gravity']):.2e} deg "
          f"from JAX-CPU's, bg error {si['bg_err']:.3e} ({np.linalg.norm(np.subtract(si['bg'], JAX_STORE_INIT['bg'])):.2e} "
          f"from JAX-CPU's), {1e3 * si['host_s']:.1f} ms host")
    for name, r in sba["calls"].items():
        ref = JAX_STORE[name]
        print(f"store BA {name}: cost0 {r['cost0']:.4f} (JAX-CPU {ref['cost0']}), cost "
              f"{r['cost']:.4f} (JAX-CPU {ref['cost']}); {r['n_outliers']} outliers (JAX-CPU "
              f"{ref['n_outliers']}), {r['n_points']} points, {r['n_kf']} KF, {r['n_ie']} inertial "
              f"edges; K4 {json.dumps(r['k4_launches'])}; fetches {r['fetches']} (JAX-CPU "
              f"{ref['fetches']}, one of them its constant identity edges), host syncs inside the "
              f"solve {r['syncs_in_solve']}; median of {len(r['wall_ms'])} calls "
              f"{r['median_wall_ms']:.2f} ms (quartiles {_pct(r['wall_ms'], 25):.2f} / "
              f"{_pct(r['wall_ms'], 75):.2f}); keyframe ATE {r['ate_before_m']:.5f} -> "
              f"{r['ate_after_m']:.5f} m")

    lap()
    # -- path 8, track map: Tracking and LocalMapping over rendered frames ----
    # (track_map sets the counts to 0 itself, after the façade's warm-up)
    t0 = time.perf_counter()
    with _Capture(match_pallas, "_match_rows_cuda") as tm_k2, \
            _Capture(pallas_kernels, "hamming_matrix_cuda", maxlen=4) as tm_k3, \
            _Capture(pallas_kernels, "gather_patches_cuda", maxlen=1) as tm_k1, \
            _Capture(chol_pallas, "chol_solve_cuda", maxlen=8) as tm_k4:
        tm_records, tm_steps, tm = track_map(pipe, log=lambda line: None,
                                             images=euroc_images.get)
    torch.cuda.synchronize()
    tm_s = time.perf_counter() - t0
    tm_launches = tm["launches"]
    print(f"track map: {len(tm_records)} frames in {tm_s:.1f} s host; launches "
          f"{json.dumps(tm_launches)}")
    print("track map states:", "".join(str(r["state"]) for r in tm_records))
    print("track map n_tracked:", [r["n_tracked"] for r in tm_records])
    print("track map frame ms:", [round(r["frame_ms"], 1) for r in tm_records])
    print("track map fetches / syncs a frame:", [(r["fetches"], r["syncs"]) for r in tm_records])
    print("track map mapper steps (frame, KF, ms, fetches, syncs):",
          [(m["frame"], m["kf"], round(m["host_ms"], 1), m["fetches"], m["syncs"])
           for m in tm_steps])
    print("track map summary:", json.dumps(tm))
    print(f"track map against the JAX package on the CPU: {json.dumps(JAX_TRACK_MAP)}")
    print(f"track map timing ({card}): frame p50 {tm['frame_ms']['p50']:.1f} ms, p99 "
          f"{tm['frame_ms']['p99']:.1f} ms; mapper step p50 {tm['mapper_ms']['p50']:.1f} ms, "
          f"mean {tm['mapper_ms']['mean']:.1f} ms per keyframe")
    for label, a in zip(K2_CALLS, tm_k2.calls):
        got = match_pallas._match_rows_cuda(*a)
        torch.cuda.synchronize()
        _same(got, match_pallas._match_rows_plain(*a), f"K2 track map {label}")
    for a in tm_k3.calls:
        got = pallas_kernels.hamming_matrix_cuda(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, pallas_kernels.hamming_matrix_plain(*a)):
            raise RuntimeError("K3 on the track map's searches disagrees with its plain version")
    for a in tm_k1.calls:
        got = pallas_kernels.gather_patches_cuda(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, pallas_kernels.gather_patches_plain(*a)):
            raise RuntimeError("K1 on the track map's last frame disagrees with its plain version")
    print(f"track map: K2 on the last frame's {len(tm_k2.calls)} launches, K3 on the last "
          f"{len(tm_k3.calls)} searches, K1 on the last frame: bit-identical; K4's last "
          f"{len(tm_k4.calls)} reduced systems join the K4 phase")

    lap()
    # path 13's two worlds, each in a lane of its own from here: the lane
    # renders its world's frames ahead by a child and drives it once `go`
    # exists (after path 12), beside path 14's lane
    bat_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_battery_")
    go = Path(bat_tmp.name) / "go"
    battery_lanes = {name: Lane(Path(bat_tmp.name) / f"{name}.pkl", "battery_lane", str(dev),
                                name, bat_tmp.name, str(go)) for name in BATTERY_WORLDS}
    for lane in battery_lanes.values():
        atexit.register(lane.close)

    # path 9, the system world, in a lane of its own from here too: it drives
    # the world once `go` exists (after path 12), beside paths 13-15's lanes
    # (system_world sets the lane's counts to 0 itself, after build_system
    # and its warm-up); then the resume and the async runs of the same world
    sw_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_")
    system_lane_ = Lane(Path(sw_tmp.name) / "system.pkl", "system_lane", str(dev), sw_tmp.name,
                        str(go))
    atexit.register(system_lane_.close)

    # path 14's two datasets, written by two more children from here
    prof_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_profiles_")
    profile_writers = {kind: DatasetWriter(Path(prof_tmp.name) / kind, kind)
                       for kind in PROFILE_KINDS}
    for w in profile_writers.values():
        atexit.register(w.close)

    # -- path 10, the dataset CLI: runners.datasets.main over the disk dataset -
    # (the counts are set to 0 when main has built its System)
    root = writer.wait()
    print(f"dataset: {DATASET_FRAMES} frames written in {writer.seconds:.1f} s by a child "
          f"process (EuRoC layout, {sum(1 for _ in (Path(root) / 'cam0' / 'data').iterdir())} "
          f"PNGs)")
    t0 = time.perf_counter()
    with _Capture(match_pallas, "_match_rows_cuda") as dc_k2, \
            _Capture(pallas_kernels, "hamming_matrix_cuda", maxlen=4) as dc_k3, \
            _Capture(pallas_kernels, "gather_patches_cuda", maxlen=1) as dc_k1:
        dc_records, dc_steps, dc = dataset_cli(dev, root, ds_tmp.name, log=lambda line: None)
    torch.cuda.synchronize()
    dc_launches = dc["launches"]
    print(f"dataset CLI: {len(dc_records)} frames through runners.datasets.main in "
          f"{dc['run_s']:.1f} s host ({time.perf_counter() - t0:.1f} s with the checks); "
          f"launches {json.dumps(dc_launches)}")
    print(f"dataset CLI native branch: {json.dumps(dc['native_branch'])}; decode "
          f"{dc['decode_ms']:.2f} ms a frame (load_gray on this thread), the tracker waited "
          f"{dc['prefetch_wait_ms']:.3f} ms a frame on the prefetcher")
    print(f"dataset CLI viewer: {dc['viewer']}; PNGs {json.dumps(dc['viewer_pngs'])}; syncs in "
          f"its thread {dc['viewer_syncs']}; last error {dc['viewer_error']}")
    print("dataset CLI states:", "".join(str(r["state"]) for r in dc_records))
    print("dataset CLI fetches / syncs a frame:", [(r["fetches"], r["syncs"]) for r in dc_records])
    print("dataset CLI mapper steps (frame, KF, ms, fetches, syncs):",
          [(m["frame"], m["kf"], round(m["host_ms"], 1), m["fetches"], m["syncs"])
           for m in dc_steps])
    print("dataset CLI summary:", json.dumps(dc))
    print(f"dataset CLI against the JAX package on the CPU: {json.dumps(JAX_DATASET_CLI)}")
    print(f"dataset CLI ({card}): OK {dc['ok_frames']}/{dc['n_frames']} (JAX's "
          f"{JAX_DATASET_CLI['ok_frames']}), LOST {dc['n_lost']}, init at {dc['imu_init_t']} s "
          f"(JAX's {JAX_DATASET_CLI['imu_init_t']}), keyframe ATE {dc['kf_ate_m']:.5f} m (JAX's "
          f"{JAX_DATASET_CLI['kf_ate_m']:.5f}), keyframes {dc['n_kf']} (JAX's "
          f"{JAX_DATASET_CLI['n_kf']}), points {dc['n_points']} (JAX's "
          f"{JAX_DATASET_CLI['n_points']}); frame p50 {dc['frame_ms']['p50']:.1f} ms, p99 "
          f"{dc['frame_ms']['p99']:.1f} ms; mapper step p50 {dc['mapper_ms']['p50']:.1f} ms")
    for label, a in zip(K2_CALLS, dc_k2.calls):
        got = match_pallas._match_rows_cuda(*a)
        torch.cuda.synchronize()
        _same(got, match_pallas._match_rows_plain(*a), f"K2 dataset CLI {label}")
    for a in dc_k3.calls:
        got = pallas_kernels.hamming_matrix_cuda(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, pallas_kernels.hamming_matrix_plain(*a)):
            raise RuntimeError("K3 on the dataset CLI's searches disagrees with its plain version")
    for a in dc_k1.calls:
        got = pallas_kernels.gather_patches_cuda(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, pallas_kernels.gather_patches_plain(*a)):
            raise RuntimeError("K1 on the dataset CLI's last frame disagrees with its plain version")
    print(f"dataset CLI: K2 on the last frame's {len(dc_k2.calls)} launches, K3 on the last "
          f"{len(dc_k3.calls)} searches, K1 on the last frame: bit-identical")

    lap()
    # -- path 11, the sharded BA on a one-rank NCCL group ----------------------
    from monoorbslam3_tpu_torch import native as native_mod

    data_dir = Path(root) / "cam0" / "data"
    ds_images = np.stack([native_mod.load_gray(str(data_dir / ("%08d.png" % i)))
                          for i in range(SHARDED_FRAMES)])
    t0 = time.perf_counter()
    shb = sharded_ba(dev, ds_tmp.name, images=ds_images, log=lambda line: None)
    torch.cuda.synchronize()
    shb_launches = shb["launches"]
    w, sl, be = shb["window"], shb["store_local_ba"], shb["batch_extract"]
    print(f"sharded BA ({time.perf_counter() - t0:.1f} s): {shb['mesh']}, "
          f"{json.dumps(shb['process_info'])}")
    print(f"sharded BA window ({card}): cost0 {w['cost0']:.4f} (JAX-CPU {JAX_BA_COST0}), cost "
          f"{w['cost']:.4f} (JAX-CPU {JAX_BA_COST['flat_deferred']}, schur_ba here "
          f"{w['single_cost']:.4f}); poses within {w['pose_t_max_diff']:.2e} m / "
          f"{w['pose_R_max_diff']:.2e} of schur_ba's; {w['all_reduce_per_iter']} all_reduce an "
          f"iteration ({w['all_reduce_per_solve']} a solve); host syncs inside the solve "
          f"{w['syncs_in_solve']}; K4 {json.dumps(w['k4_launches'])}; median solve "
          f"{w['median_solve_ms']:.2f} ms against schur_ba's {w['median_single_ms']:.2f} ms "
          f"(in turns, {len(w['solve_ms'])} each)")
    print(f"sharded BA store local BA ({card}): cost0 {sl['cost0']:.4f} (JAX-CPU "
          f"{JAX_STORE['local_bundle_adjustment']['cost0']}), cost {sl['cost']:.4f} (JAX-CPU "
          f"{JAX_STORE['local_bundle_adjustment']['cost']}), {sl['n_outliers']} outliers, "
          f"{sl['n_points']} points, {sl['sharded_calls']} sharded solve, fetches "
          f"{sl['fetches']}, host syncs inside the solve {sl['syncs_in_solve']}, K4 "
          f"{json.dumps(sl['k4_launches'])}, {sl['wall_ms']:.1f} ms")
    print(f"sharded BA batch extractor: {be['frames']} frames, {be['k1_launches']} K1 launches, "
          f"bit-identical to one extraction a frame {json.dumps(be['identical'])}")
    ds_tmp.cleanup()

    lap()
    # -- path 12, measure: the port's measuring entry points ------------------
    e2e_frames = e2e_reader.frames()
    meas_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_measure_")
    _zero(cuda_lib.launches)
    t0 = time.perf_counter()
    meas = measure_path(dev, e2e_frames, meas_tmp.name)
    torch.cuda.synchronize()
    meas_launches = dict(cuda_lib.launches)
    del e2e_frames
    meas_tmp.cleanup()
    print(f"measure ({time.perf_counter() - t0:.1f} s: graft entry {meas['graft_s']:.1f}, bench "
          f"{meas['bench_s']:.1f}, bench_kernels {meas['bench_kernels_s']:.1f}, e2e "
          f"{meas['e2e_s']:.1f}, bench_scaling {meas['bench_scaling_s']:.1f}, dryrun "
          f"{meas['dryrun_s']:.1f}); launches {json.dumps(meas_launches)}")
    b, e = meas["bench"], meas["e2e"]
    print(f"measure ({card}): local-BA {b['value']:.2f} iters/s (quartiles "
          f"{b['timing']['local_ba']['iters_per_s']['q25']:.2f} / "
          f"{b['timing']['local_ba']['iters_per_s']['q75']:.2f}, n "
          f"{b['timing']['local_ba']['n']}), grouped {b['grouped_polish_iters_per_s']:.2f}, "
          f"tracking step {b['frontend_fps']:.2f} frames/s; e2e {E2E_WORLD}: {e['fps']:.2f} "
          f"frames/s, frame p50 {e['frame_ms']['p50']:.1f} / p99 {e['frame_ms']['p99']:.1f} ms, "
          f"OK {e['ok_frames']}/{e['frames']} (JAX's {JAX_E2E_CIRCLE10['ok_frames']}), ATE "
          f"{e['ate_rmse']:.5f} m (JAX's {JAX_E2E_CIRCLE10['ate_rmse']}, over seeds 0-3 "
          f"{json.dumps(JAX_E2E_ATE_OVER_SEEDS)}), "
          f"{e['n_keyframes']} keyframes (JAX's {JAX_E2E_CIRCLE10['n_keyframes']}), kernel "
          f"builds after the warm-up {json.dumps(e['kernel_builds_after_warmup'])}")

    lap()
    # -- paths 9 and 13-15, side by side in six lanes (`Lane`) ---------------
    # path 9, the system world, in the lane made after path 8;
    # path 13, the battery: two whole worlds through runners.validation,
    # each in a lane of its own (battery_world sets the lane's counts to 0
    # itself, after the world's warm-up; the path's launches are the two
    # worlds' summed);
    # path 14, the profiles: runners.datasets.main over KITTI and TUM-VI in
    # the third lane (dataset_cli sets the counts to 0 when main has built
    # its System; the path's launches are the two runs' summed)
    # path 15, the last four profiles: runners.datasets.main over the phone
    # (with --realtime), KAIST-VIO, NTU-VIRAL and rectified TUM-VI in two
    # more lanes (VIO_LANES; dataset_cli sets each lane's counts to 0 when
    # main has built its System, or when its warm-up has returned)
    go.touch()
    t0 = time.perf_counter()
    profiles_lane = Lane(Path(prof_tmp.name) / "profiles.pkl", "profiles", str(dev),
                         {kind: str(w.out) for kind, w in profile_writers.items()},
                         prof_tmp.name)
    atexit.register(profiles_lane.close)
    vio_roots = {kind: str(w.out) for kind, w in vio_writers.items()}
    vio_lanes = [Lane(Path(vio_tmp.name) / f"lane{i}.pkl", "profiles", str(dev), vio_roots,
                      vio_tmp.name, kinds) for i, kinds in enumerate(VIO_LANES)]
    for lane in vio_lanes:
        atexit.register(lane.close)
    for w in (*profile_writers.values(), *vio_writers.values()):
        w.wait()  # raises if a writer failed
    bat = {name: lane.result(dev) for name, lane in battery_lanes.items()}
    bat_s = time.perf_counter() - t0
    bat_launches = collections.Counter()
    for w in bat.values():
        bat_launches.update(w["row"]["launches"])
    # the last world's last frame for K1-K3, as when the worlds ran in turn;
    # K4's last systems of both worlds, the last world's last
    last = bat[BATTERY_WORLDS[-1]]
    bt_k1, bt_k2, bt_k3 = last["k1"], last["k2"], last["k3"]
    bt_k4 = [a for w in bat.values() for a in w["k4"]][-24:]
    bt_k4l2 = [a for w in bat.values() for a in w["k4_l2"]][-12:]
    bat_tmp.cleanup()
    print(f"battery ({bat_s:.1f} s, beside path 14's lane: "
          + ", ".join(f"{n} {w['seconds']:.1f}" for n, w in bat.items())
          + f"); launches {json.dumps(bat_launches)}")
    for name, w in bat.items():
        row, ref = w["row"], JAX_BATTERY[name]
        print(f"battery {name} states:", "".join(str(r["state"]) for r in w["records"]))
        print(f"battery {name} fetches / syncs a frame:",
              [(r["fetches"], r["syncs"]) for r in w["records"]])
        print(f"battery {name} mapper steps (frame, KF, ms, fetches, syncs):",
              [(m["frame"], m["kf"], round(m["host_ms"], 1), m["fetches"], m["syncs"])
               for m in w["steps"]])
        print(f"battery {name} row:", json.dumps({k: v for k, v in row.items()
                                                  if k not in ("est", "gt")}))
        print(f"battery {name} region syncs {json.dumps(w['region_syncs'])}, sites "
              f"{json.dumps(w['sync_sites'])}")
        print(f"battery {name} against the JAX package on the CPU: {json.dumps(ref)}")
        print(f"battery {name} ({card}): OK {row['ok_frames']}/{row['frames']} (JAX's "
              f"{ref['ok_frames']}), LOST {row['lost_events']}, RECENTLY_LOST frames "
              f"{row['recently_lost_frames']} (JAX's {ref['recently_lost_frames']}), "
              f"reference-keyframe matches {row['ref_kf_matches']} (JAX's "
              f"{ref['ref_kf_matches']}), keyframes {row['n_keyframes']} / "
              f"{row['kf_created_total']} (JAX's {ref['n_keyframes']} / "
              f"{ref['kf_created_total']}), ATE {row['ate_rmse']:.5f} m (JAX's "
              f"{ref['ate_rmse']:.5f}, over its seeds {json.dumps(ref['ate_over_seeds'])}, "
              f"bound {row['bound_ate']}), scale error {row['scale_err']:.5f} (JAX's "
              f"{ref['scale_err']:.5f}, bound {row['bound_scale']}), polishes "
              f"{json.dumps({k: v for k, v in row['polishes'].items() if k != 'kf_counts'})} "
              f"(JAX's {json.dumps(ref['polishes'])}); frame p50 {row['frame_ms']['p50']:.1f} / "
              f"p99 {row['frame_ms']['p99']:.1f} ms, mapper step p50 "
              f"{row['mapper_ms']['p50']:.1f} / p99 {row['mapper_ms']['p99']:.1f} ms; device "
              f"memory {json.dumps(row['memory']['first'])} -> "
              f"{json.dumps(row['memory']['last'])}, peak RSS {row['peak_rss_mb']:.0f} MB")
    for label, a in zip(K2_CALLS, bt_k2):
        got = match_pallas._match_rows_cuda(*a)
        torch.cuda.synchronize()
        _same(got, match_pallas._match_rows_plain(*a), f"K2 battery {label}")
    for a in bt_k3:
        got = pallas_kernels.hamming_matrix_cuda(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, pallas_kernels.hamming_matrix_plain(*a)):
            raise RuntimeError("K3 on the battery's searches disagrees with its plain version")
    for a in bt_k1:
        got = pallas_kernels.gather_patches_cuda(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, pallas_kernels.gather_patches_plain(*a)):
            raise RuntimeError("K1 on the battery's last frame disagrees with its plain version")
    print(f"battery: K2 on the last frame's {len(bt_k2)} launches, K3 on the last "
          f"{len(bt_k3)} searches, K1 on the last frame: bit-identical; K4's last "
          f"{len(bt_k4)} cluster-route and {len(bt_k4l2)} large-D systems join the "
          f"K4 phase")

    lap()
    # -- path 9's results (its lane ran beside paths 13-15's) -----------------
    sys_run = system_lane_.result(dev)
    sw_records, sw_steps, sw = sys_run["records"], sys_run["steps"], sys_run["summary"]
    sw_k1, sw_k2, sw_k3 = sys_run["k1"], sys_run["k2"], sys_run["k3"]
    sw_k4, sw_k4l2 = sys_run["k4"], sys_run["k4_l2"]
    sw_launches = sw["launches"]
    print(f"system world: build_system {sw['build_s']:.2f} s, warmup {sw['warmup_s']:.2f} s, "
          f"{len(sw_records)} frames in {sw['run_s']:.1f} s host "
          f"({sys_run['seconds']:.1f} s with the exports, in its lane); launches "
          f"{json.dumps(sw_launches)}")
    print("system world states:", "".join(str(r["state"]) for r in sw_records))
    print("system world n_tracked:", [r["n_tracked"] for r in sw_records])
    print("system world frame ms:", [round(r["frame_ms"], 1) for r in sw_records])
    print("system world fetches / syncs a frame:",
          [(r["fetches"], r["syncs"]) for r in sw_records])
    print("system world mapper steps (frame, KF, ms, fetches, syncs):",
          [(m["frame"], m["kf"], round(m["host_ms"], 1), m["fetches"], m["syncs"])
           for m in sw_steps])
    print(f"system world full polishes at keyframe counts {sw['polish_kf_counts']} (JAX's "
          f"{JAX_SYSTEM_WORLD['polish_kf_counts']}; above local_k the grouped problem, "
          f"K4's large-D route: {sw_launches['chol_solve_l2']} launches)")
    print("system world summary:", json.dumps(sw))
    print(f"system world against the JAX package on the CPU: {json.dumps(JAX_SYSTEM_WORLD)}")
    print(f"system world ({card}): OK {sw['ok_frames']}/{sw['n_frames']} (JAX's "
          f"{JAX_SYSTEM_WORLD['ok_frames']}/{JAX_SYSTEM_WORLD['n_frames']}), LOST {sw['n_lost']}, "
          f"imu_state {sw['imu_state']} (JAX's {JAX_SYSTEM_WORLD['imu_state']}), init at "
          f"{sw['imu_init_t']} s (JAX's {JAX_SYSTEM_WORLD['imu_init_t']}), keyframe ATE "
          f"{sw['kf_ate_m']:.5f} m (JAX's {JAX_SYSTEM_WORLD['kf_ate_m']:.5f}, bound "
          f"{SYSTEM_WORLD_ATE_BOUND_M}), scale error {sw['scale_err']:.5f} (JAX's "
          f"{JAX_SYSTEM_WORLD['scale_err']:.5f}, bound {SYSTEM_WORLD_SCALE_BOUND}), keyframes "
          f"{sw['n_kf']} (JAX's {JAX_SYSTEM_WORLD['n_kf']}), points {sw['n_points']} (JAX's "
          f"{JAX_SYSTEM_WORLD['n_points']}); frame p50 {sw['frame_ms']['p50']:.1f} ms, p99 "
          f"{sw['frame_ms']['p99']:.1f} ms; mapper step p50 {sw['mapper_ms']['p50']:.1f} ms, "
          f"mean {sw['mapper_ms']['mean']:.1f} ms")
    # the tracker of either package draws its bootstrap's RANSAC samples
    # from seed 0's key (the port through utils.prng): both runs start from
    # the same samples
    print("system world, seed 0 in both packages (the same RANSAC draws): " + json.dumps(
        {"device": card, "port": {k: sw[k] for k in SW_SEED_KEYS},
         "jax_cpu": {k: JAX_SYSTEM_WORLD[k] for k in SW_SEED_KEYS}}))
    for label, a in zip(K2_CALLS, sw_k2):
        got = match_pallas._match_rows_cuda(*a)
        torch.cuda.synchronize()
        _same(got, match_pallas._match_rows_plain(*a), f"K2 system world {label}")
    # the last projected match of the path is the node-gated reference-
    # keyframe match system_world replays on the last frame: K2 with the
    # vocabulary's groups, held to the same match on the CPU's plain path
    ref_args, ref_kw = sys_run["ref"]
    cpu = lambda x: x.cpu() if isinstance(x, torch.Tensor) else x
    n0 = cuda_lib.launches["match_rows"]
    got = tracking.projected_match(*ref_args, **ref_kw)
    torch.cuda.synchronize()
    node_gated_launches = cuda_lib.launches["match_rows"] - n0
    ref = tracking.projected_match(*map(cpu, ref_args), **{k: cpu(v) for k, v in ref_kw.items()})
    if not all(torch.equal(g.cpu(), r) for g, r in zip(got, ref)):
        raise RuntimeError("K2 on the node-gated reference-keyframe match disagrees with the "
                           "CPU's plain path")
    for a in sw_k3:
        got = pallas_kernels.hamming_matrix_cuda(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, pallas_kernels.hamming_matrix_plain(*a)):
            raise RuntimeError("K3 on the system world's searches disagrees with its plain version")
    for a in sw_k1:
        got = pallas_kernels.gather_patches_cuda(*a)
        torch.cuda.synchronize()
        if not torch.equal(got, pallas_kernels.gather_patches_plain(*a)):
            raise RuntimeError("K1 on the system world's last frame disagrees with its plain version")
    print(f"system world: K2 on the last frame's {len(sw_k2)} launches and on the "
          f"{node_gated_launches} launches of the node-gated reference-keyframe match "
          f"replayed on the last frame ({sw['ref_kf_matches']} such matches on the path), K3 "
          f"on the last {len(sw_k3)} searches (every keyframe feature node-gated: "
          f"{sw['kf_features_grouped']}), K1 on the last frame: bit-identical; K4's last "
          f"{len(sw_k4)} cluster-route and {len(sw_k4l2)} large-D systems join the "
          f"K4 phase")
    resume_records = sys_run["resume"]
    print(f"system resume ({sys_run['resume_s']:.1f} s): frames "
          f"{SYSTEM_WORLD_FRAMES}..{SYSTEM_WORLD_FRAMES + len(resume_records) - 1} states "
          + "".join(str(r["state"]) for r in resume_records) + ", n_tracked "
          + str([r["n_tracked"] for r in resume_records]))
    async_records, async_steps, sa = (sys_run["async_records"], sys_run["async_steps"],
                                      sys_run["async_summary"])
    print(f"system async ({sys_run['async_s']:.1f} s): states "
          + "".join(str(r["state"]) for r in async_records))
    print("system async summary:", json.dumps(sa))
    print(f"system async ({card}): frame p50 {sa['frame_ms']['p50']:.1f} ms, p99 "
          f"{sa['frame_ms']['p99']:.1f} ms with the mapper on its own thread (the sync run: p50 "
          f"{sw['frame_ms']['p50']:.1f}, p99 {sw['frame_ms']['p99']:.1f} ms); "
          f"{len(async_steps)} mapper steps, keyframe ATE {sa['kf_ate_m']:.5f} m, init "
          f"{sa['imu_init_t']} s, queue drained {sa['queue_drained']}")
    sw_tmp.cleanup()

    lap()
    # -- path 14's results (its lane ran beside path 13's) --------------------
    print("profiles: written by child processes in " + ", ".join(
        f"{kind} {w.seconds:.1f} s ({DATASET_PROFILES[kind]['frames']} frames)"
        for kind, w in profile_writers.items()))
    prof = profiles_lane.result(dev)
    prof_launches = collections.Counter()
    for p in prof.values():
        prof_launches.update(p["summary"]["launches"])
    print(f"profiles ({time.perf_counter() - t0:.1f} s from the lanes' start, beside path 13's "
          f"lanes: " + ", ".join(f"{kind} {p['seconds']:.1f}" for kind, p in prof.items())
          + f"); launches {json.dumps(prof_launches)}")
    print_profiles(prof, card)
    # each kernel on this path's inputs, against its plain version: K1 on
    # the last KITTI frame's atlas (K = 1,536), K2 on its eight launches
    # (1,536 rows), K3 on the last searches of both runs; K4's systems
    # join the K4 phase
    k3_shapes = profile_kernel_checks(prof, ("kitti",))
    pk = prof["kitti"]
    prof_tmp.cleanup()

    lap()
    # -- path 15's results (its two lanes ran beside paths 13 and 14) ---------
    print("path 15: written by child processes in " + ", ".join(
        f"{kind} {w.seconds:.1f} s ({DATASET_PROFILES[kind]['frames']} frames)"
        for kind, w in vio_writers.items()))
    vio = {}
    for lane in vio_lanes:
        vio.update(lane.result(dev))
    vio = {kind: vio[kind] for kind in VIO_PROFILES}
    vio_launches = collections.Counter()
    for p in vio.values():
        vio_launches.update(p["summary"]["launches"])
    print(f"path 15 ({time.perf_counter() - t0:.1f} s from the lanes' start, beside paths 13 "
          f"and 14, lanes {json.dumps(VIO_LANES)}: "
          + ", ".join(f"{kind} {p['seconds']:.1f}" for kind, p in vio.items())
          + f"); launches {json.dumps(vio_launches)}")
    print_profiles(vio, card)
    # each kernel on this path's inputs, against its plain version: K1 on
    # each profile's last frame (the phone's 1280x720 atlas among them), K2
    # on each one's last eight launches, K3 on each one's last searches;
    # K4's systems join the K4 phase
    profile_kernel_checks(vio, VIO_PROFILES)
    vio_tmp.cleanup()

    ab_chol = _ab_build(ab_dir, "chol_solve.cu")
    polish_ab = None
    if ab_chol is not None and one_block_solver(ab_chol) is not None:
        print("polish BA, whole solves with the A/B build's one-block K4 in turns with the "
              "package's (median wall ms):")
        polish_ab = polish_wall_ab(dev, one_block_solver(ab_chol))

    lap()
    # -- kernel phases at the drive's shapes ---------------------------------
    # Each kernel is held against its plain version on the inputs its path
    # gave it, then timed by `_time_kernel` (device_ms: the device alone;
    # call_ms: host-inclusive) beside its plain version, its bound and,
    # where one PyTorch call computes the same function, that call
    # (library_ms; the port never calls it).
    kernels = []
    n_frames = n_fr + 1  # the seed frame is extracted too
    floor_ms, floor_call = _time_kernel(lambda: torch.cuda._sleep(1))
    print(f"launch floor (an empty kernel, torch.cuda._sleep(1)): device {floor_ms:.5f} ms, "
          f"call {floor_call:.5f} ms")

    # K1 on the EuRoC atlas of a rendered frame, K = 1024
    from monoorbslam3_tpu_torch.sim import ImageWorld

    img = ImageWorld().render(0.5, host_camera(pipe.profile), R_BC, T_BC,
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
    # the yardstick: one index into the atlas's view of all 48x48 windows,
    # at the clamped corners
    windows = atlas.unfold(0, 48, 1).unfold(1, 48, 1)
    y0 = ys.long().clamp(0, atlas.shape[0] - 48)
    x0 = xs.long().clamp(0, atlas.shape[1] - 48)
    if not torch.equal(windows[y0, x0], ref):
        raise RuntimeError("K1's yardstick computes another function")
    k1_kern = lambda: pallas_kernels.gather_patches_cuda(atlas, ys, xs)
    # the path's atlas was built just before K1 reads it, so a window of 20
    # calls on one atlas finds it in the L2 cache as the path does: its
    # bound reads the atlas from L2. The other reading cycles through
    # copies of the atlas that exceed the L2 twice over, against the bound
    # that reads every byte from HBM.
    l2_bytes = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 50 * 2 ** 20)
    atlases = itertools.cycle([atlas.clone() for _ in range(2 * l2_bytes // atlas.nbytes + 2)])
    k1_cold_kern = lambda: pallas_kernels.gather_patches_cuda(next(atlases), ys, xs)
    k1_ab = {}
    ab_k1 = _ab_build(ab_dir, "gather_patches.cu")
    if ab_k1 is None:
        k1_dev, k1_call = _time_kernel(k1_kern)
        k1_cold, _ = _time_kernel(k1_cold_kern)
    else:
        with ab_k1:
            if not torch.equal(k1_kern(), ref):
                raise RuntimeError("K1 A/B build disagrees with the plain version")
        k1_dev, k1_call, k1_ab["parent_device_ms"], k1_ab["parent_call_ms"] = _ab_times(k1_kern, ab_k1)
        k1_cold, _, k1_ab["parent_device_ms_l2_exceeded"], _ = _ab_times(k1_cold_kern, ab_k1)
        print("K1 A/B build:", json.dumps(k1_ab))
    del atlases
    k1_plain, _ = _time_kernel(lambda: pallas_kernels.gather_patches_plain(atlas, ys, xs))
    k1_lib, _ = _time_kernel(lambda: windows[y0, x0])
    k1_b = k1_bound(atlas, ys, xs)
    k1_b_l2 = k1_bound(atlas, ys, xs, atlas_in_l2=True)
    # on the phone's last frame (path 15): the largest atlas of any profile
    # (1280x720: 3379x1536 f32, 20.8 MB, inside the L2 as the path finds it)
    ph_atlas, ph_ys, ph_xs = vio["phone"]["k1"][-1]
    k1_phone, _ = _time_kernel(lambda: pallas_kernels.gather_patches_cuda(ph_atlas, ph_ys, ph_xs))
    k1_b_phone = k1_bound(ph_atlas, ph_ys, ph_xs, atlas_in_l2=True)
    print(f"K1 on the phone's atlas {tuple(ph_atlas.shape)} ({ph_atlas.nbytes / 1e6:.1f} MB) "
          f"K={ph_ys.shape[0]}: device {k1_phone:.5f} ms (bound {k1_b_phone['bound_us']:.3f} us, "
          f"atlas in L2)")
    print(f"K1 atlas {tuple(atlas.shape)} K={ys.shape[0]}: bit-exact; device {k1_dev:.5f} ms "
          f"(atlas in L2; bound {k1_b_l2['bound_us']:.3f} us, "
          f"{k1_b_l2['bound_us'] / (1e3 * k1_dev):.0%} of it), {k1_cold:.5f} ms with the L2 "
          f"exceeded (bound {k1_b['bound_us']:.3f} us, {k1_b['bound_ms'] / k1_cold:.0%} of it; "
          f"{k1_b['bound_by']}, {k1_b['bytes']} B); call {k1_call:.5f} ms, plain "
          f"{k1_plain:.5f} ms, unfold-index {k1_lib:.5f} ms")
    kernels.append(dict(name="gather_patches", route="cuda",
                        source="monoorbslam3_tpu_torch/csrc/gather_patches.cu",
                        replaces="monoorbslam3_tpu/ops/pallas_kernels.py:80",
                        launches=launches["gather_patches"],
                        launches_vi_drive=vi_launches["gather_patches"],
                        launches_track_map=tm_launches["gather_patches"],
                        launches_system_world=sw_launches["gather_patches"],
                        launches_dataset_cli=dc_launches["gather_patches"],
                        launches_sharded_ba=shb_launches["gather_patches"],
                        launches_measure=meas_launches["gather_patches"],
                        launches_battery=bat_launches["gather_patches"],
                        launches_profiles=prof_launches["gather_patches"],
                        launches_vio_profiles=vio_launches["gather_patches"],
                        launches_per_frame=launches["gather_patches"] / n_frames,
                        max_abs_err=k1_err, ms=k1_dev, device_ms=k1_dev, call_ms=k1_call,
                        plain_ms=k1_plain, library_ms=k1_lib, **k1_b,
                        device_ms_l2_exceeded=k1_cold, bound_us_atlas_in_l2=k1_b_l2["bound_us"],
                        device_ms_phone_atlas=k1_phone, phone_atlas=list(ph_atlas.shape),
                        bound_us_phone_atlas=k1_b_phone["bound_us"],
                        **k1_ab))

    # K2 on all eight launches of the last frame (K2_CALLS), and on seeded
    # ties that straddle column-chunk boundaries; with --ab, another build
    # of K2 (the parent's) timed in turns beside it
    last = list(cap.calls)
    if len(last) != len(K2_CALLS) or cap.n != len(K2_CALLS) * n_fr:
        raise RuntimeError(f"K2: {cap.n} launches over {n_fr} frames, expected "
                           f"{len(K2_CALLS)} a frame")
    ab_lib = _ab_build(ab_dir, "match_rows.cu")
    k2_err, k2_rows = 0.0, []
    for label, a in zip(K2_CALLS, last):
        got = match_pallas._match_rows_cuda(*a)
        torch.cuda.synchronize()
        ref = match_pallas._match_rows_plain(*a)
        _same(got, ref, f"K2 {label}")
        k2_err = max(k2_err, *(float((g.double() - r.double()).abs().max()) for g, r in zip(got, ref)))
        N, M = a[0].shape[0], a[1].shape[0]
        kern = lambda: match_pallas._match_rows_cuda(*a)
        row = dict(call=label, shape=[N, M], blocks=cuda_lib.lib().match_rows_blocks(N))
        if ab_lib is None:
            row["device_ms"], row["call_ms"] = _time_kernel(kern)
        else:
            with ab_lib:
                _same(kern(), ref, f"K2 A/B build, {label}")
            times = _ab_times(kern, ab_lib)
            row.update(zip(("device_ms", "call_ms", "parent_device_ms", "parent_call_ms"), times))
        row["plain_ms"], _ = _time_kernel(lambda: match_pallas._match_rows_plain(*a))
        row.update(k2_bound(N, M))
        k2_rows.append(row)
        print(f"K2 {label} {N}x{M}: bit-identical; " + ", ".join(
            f"{k} {row[k]:.5f}" for k in ("device_ms", "call_ms", "parent_device_ms",
                                         "parent_call_ms", "plain_ms") if k in row)
              + f", bound {row['bound_us']:.3f} us ({row['bound_by']}); {row['blocks']} blocks; valid rows "
              f"{int((a[6] > 0).sum())}, matched rows {int((ref[2] >= 0).sum())}")
    vi_last = list(vcap.calls)
    if len(vi_last) != len(K2_CALLS) or vcap.n != len(K2_CALLS) * n_vi:
        raise RuntimeError(f"K2: {vcap.n} launches over {n_vi} inertial frames, expected "
                           f"{len(K2_CALLS)} a frame")
    for label, a in zip(K2_CALLS, vi_last):
        got = match_pallas._match_rows_cuda(*a)
        torch.cuda.synchronize()
        _same(got, match_pallas._match_rows_plain(*a), f"K2 inertial drive {label}")
    print("K2 on the eight launches of the inertial drive's last frame: bit-identical")
    for N, M in ((1024, 1024), (4096, 1024), (1024, 4096), (37, 1000)):
        args = [t.to(dev) for t in seeded_match_ties(N, M, np.random.default_rng(N + M))]
        got = match_pallas._match_rows_cuda(*args)
        torch.cuda.synchronize()
        ref = match_pallas._match_rows_plain(*args)
        _same(got, ref, f"K2 seeded ties {N}x{M}")
        print(f"K2 seeded ties {N}x{M}: bit-identical; {int((ref[1] == ref[0]).sum())} rows "
              f"with second == best")
    per_frame = {k: sum(r[k] for r in k2_rows) for k in k2_rows[0]
                 if k.endswith("_ms")}
    print("K2 per frame, the sum over its eight launches:", json.dumps(per_frame))
    top = max(k2_rows, key=lambda r: r["bound_ms"])
    per_call = {k: v / len(k2_rows) for k, v in per_frame.items()}
    kernels.append(dict(name="match_rows", route="cuda",
                        source="monoorbslam3_tpu_torch/csrc/match_rows.cu",
                        replaces="monoorbslam3_tpu/ops/match_pallas.py:43",
                        launches=launches["match_rows"],
                        launches_vi_drive=vi_launches["match_rows"],
                        launches_track_map=tm_launches["match_rows"],
                        launches_system_world=sw_launches["match_rows"],
                        launches_dataset_cli=dc_launches["match_rows"],
                        launches_sharded_ba=shb_launches["match_rows"],
                        launches_measure=meas_launches["match_rows"],
                        launches_battery=bat_launches["match_rows"],
                        launches_profiles=prof_launches["match_rows"],
                        launches_vio_profiles=vio_launches["match_rows"],
                        launches_per_frame=launches["match_rows"] / n_fr,
                        max_abs_err=k2_err, ms=per_call["device_ms"], **per_call,
                        bound_us=1e3 * per_call["bound_ms"], bound_by=top["bound_by"],
                        library_ms=None, per_frame=per_frame, calls=k2_rows))

    # K3 on the mapper search's inputs: triangulation 1024x1024 (KF1 x KF2
    # features) and fuse 1024x1024 (new points x KF3 features). Its
    # yardstick is the JAX package's own Hamming matrix (ops/matching.py:
    # hamming_matrix): one +-1 bf16 product with float32 accumulation on bit
    # planes unpacked beforehand, which gives 256 - 2 x the distance.
    k3_rows, k3_err = [], 0.0
    ab_hamming_lib = _ab_build(ab_dir, "hamming.cu")
    for label, a in zip(("triangulate", "fuse"), hcap.calls):
        got = pallas_kernels.hamming_matrix_cuda(*a)
        torch.cuda.synchronize()
        ref = pallas_kernels.hamming_matrix_plain(*a)
        k3_err = max(k3_err, float((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise RuntimeError(f"K3 {label} disagrees with its plain version")
        pa, pb = (pallas_kernels.pm1_planes(d, torch.bfloat16) for d in a)
        if not torch.equal((256 - (pa @ pb.T).float()) / 2, ref.float()):
            raise RuntimeError("K3: the +-1 product is not 256 - 2 x the distance")
        N, M = a[0].shape[0], a[1].shape[0]
        row = dict(call=label, shape=[N, M])
        kern = lambda: pallas_kernels.hamming_matrix_cuda(*a)
        if ab_hamming_lib is None:
            row["device_ms"], row["call_ms"] = _time_kernel(kern)
        else:
            with ab_hamming_lib:
                if not torch.equal(kern(), ref):
                    raise RuntimeError(f"K3 A/B build, {label}: disagrees with the plain version")
            times = _ab_times(kern, ab_hamming_lib)
            row.update(zip(("device_ms", "call_ms", "parent_device_ms", "parent_call_ms"), times))
        row["plain_ms"], _ = _time_kernel(lambda: pallas_kernels.hamming_matrix_plain(*a))
        row["library_ms"], _ = _time_kernel(lambda: pa @ pb.T)
        row.update(k3_bound(N, M))
        k3_rows.append(row)
        parent = (f", A/B build device {row['parent_device_ms']:.5f} ms, call "
                  f"{row['parent_call_ms']:.5f} ms" if "parent_device_ms" in row else "")
        print(f"K3 {label} {N}x{M}: bit-identical; device {row['device_ms']:.5f} ms, call "
              f"{row['call_ms']:.5f} ms{parent}, plain {row['plain_ms']:.5f} ms, +-1 bf16 matmul "
              f"(the yardstick, on planes unpacked beforehand) {row['library_ms']:.5f} ms, "
              f"bound {row['bound_us']:.3f} us ({row['bound_by']})")
    if len(k3_rows) != 2:
        raise RuntimeError(f"K3: expected the triangulate and fuse launches, got {hcap.n}")
    k3 = {k: float(np.mean([r[k] for r in k3_rows])) for k in k3_rows[0] if k.endswith("_ms")}
    kernels.append(dict(name="hamming", route="cuda",
                        source="monoorbslam3_tpu_torch/csrc/hamming.cu",
                        replaces="monoorbslam3_tpu/ops/pallas_kernels.py:28",
                        launches=map_launches["hamming"],
                        launches_fisheye_search=fish_launches["hamming"],
                        launches_track_map=tm_launches["hamming"],
                        launches_system_world=sw_launches["hamming"],
                        launches_dataset_cli=dc_launches["hamming"],
                        launches_sharded_ba=shb_launches["hamming"],
                        launches_measure=meas_launches["hamming"],
                        launches_battery=bat_launches["hamming"],
                        launches_profiles=prof_launches["hamming"],
                        launches_vio_profiles=vio_launches["hamming"],
                        launches_per_frame=launches["hamming"] / n_fr,
                        launches_per_search=map_launches["hamming"], max_abs_err=k3_err,
                        ms=k3["device_ms"], **k3, bound_us=1e3 * k3["bound_ms"],
                        bound_by=k3_rows[0]["bound_by"], calls=k3_rows))

    # K4 on every reduced system the BA runs solved (D = 480; G = 1 from the
    # deferred LM, G = 2 from the parallel-lambda LM) and on seeded SPD
    # systems (A A^T + D I) at K4_SPD_DIMS, through the wrapper's dispatch
    # on D; each held against float64 and the plain version
    k4_f64, k4_plain, k4_abs, k4_checks = 0.0, 0.0, 0.0, {}
    rng = np.random.default_rng(44)
    seeded = {}
    for D in K4_SPD_DIMS:
        S, b = seeded_spd(D, rng, G=2)
        seeded[f"seeded D={D}"] = [(torch.as_tensor(S, device=dev), torch.as_tensor(b, device=dev))]
    systems = {"BA G=1": ba["flat_deferred"]["systems"], "BA G=2": ba["flat_parallel"]["systems"],
               "polish G=1": polish["polish_deferred"]["systems"],
               "polish G=2": polish["polish_parallel"]["systems"],
               "store local G=1": sba["systems"]["local_full_bundle_adjustment"],
               "store polish G=1": sba["systems"]["full_inertial_optimize"],
               "track map G=1": list(tm_k4.calls), "system world G=1": sw_k4,
               **({"system world large-D": sw_k4l2} if sw_k4l2 else {}),
               **seeded}
    # the battery's systems (the last local windows' and polishes' of its
    # path), split by their condition number at K4_FWD_COND
    for label, calls in (("battery G=1", bt_k4), ("battery large-D", bt_k4l2)):
        parts, conds = k4_split(label, calls)
        systems.update(parts)
        print(f"K4 {label}: condition numbers of its {len(conds)} systems "
              f"{json.dumps([float(f'{c:.3g}') for c in conds])}")
    # path 14's: each profile's last local windows and its last large-D
    # polish system, split likewise
    for kind, p in {**prof, **vio}.items():
        for label, calls in ((f"profile {kind} G=1", p["k4"]),
                             (f"profile {kind} large-D", p["k4_l2"])):
            parts, conds = k4_split(label, calls)
            systems.update(parts)
            print(f"K4 {label}: condition numbers of its {len(conds)} systems "
                  f"{json.dumps([float(f'{c:.3g}') for c in conds])}")
    route_launches = {}
    for label, items in systems.items():
        e64, ep, epl64, bw, bwp = 0.0, 0.0, 0.0, 0.0, 0.0
        n0 = dict(cuda_lib.launches)
        for S, b in items:
            x = chol_pallas.chol_solve_cuda(S, b)
            xp = chol_pallas.chol_solve_plain(S, b)
            x64 = torch.linalg.solve(S.double(), b.double())
            e64 = max(e64, float(_rel(x, x64).max()))
            ep = max(ep, float(_rel(x, xp).max()))
            epl64 = max(epl64, float(_rel(xp, x64).max()))
            bw = max(bw, float(k4_backward(x, S, b).max()))
            bwp = max(bwp, float(k4_backward(xp, S, b).max()))
            k4_abs = max(k4_abs, float((x - xp).abs().max()))
        torch.cuda.synchronize()
        route_launches[label] = {k: cuda_lib.launches[k] - n0[k] for k in ("chol_solve", "chol_solve_l2")}
        # K4_RTOL, unless the plain version itself (the library's Cholesky
        # and the same refinement step) lies further than that from
        # float64: then the system's conditioning, not the kernel, sets the
        # error of an f32 factor, and the kernel is held to twice the plain
        # version's; past K4_FWD_COND (battery systems), twice the plain
        # version's backward error
        backward = "cond >" in label
        tol = 2.0 * bwp if backward else max(K4_RTOL, 2.0 * epl64)
        if not backward:
            k4_f64, k4_plain = max(k4_f64, e64), max(k4_plain, ep)
        k4_checks[label] = dict(n=len(items), vs_f64=e64, vs_plain=ep, plain_vs_f64=epl64, tol=tol,
                                backward=bw, plain_backward=bwp, held_to="backward" if backward
                                else "forward")
        D = items[-1][0].shape[-1]
        print(f"K4 {label}: {len(items)} systems of {tuple(items[-1][0].shape)}, route "
              f"{chol_pallas.route(D, dev)} {json.dumps(route_launches[label])}; max relative "
              f"error {e64:.3e} vs float64, {ep:.3e} vs the plain version (the plain version "
              f"{epl64:.3e} vs float64); backward error {bw:.3e} (the plain version's "
              f"{bwp:.3e}); held to its {k4_checks[label]['held_to']} error, bound {tol:.3g}")
        if backward and not bw <= tol:
            raise RuntimeError(f"K4 {label}: backward error {bw:.3g} exceeds {tol:.3g}")
        if not backward and not (e64 <= tol and ep <= tol):
            raise RuntimeError(f"K4 {label} exceeds {tol:.3g} relative error")
        want = "chol_solve" if chol_pallas.route(D, dev) == "cluster" else "chol_solve_l2"
        if route_launches[label][want] != len(items) or sum(route_launches[label].values()) != len(items):
            raise RuntimeError(f"K4 {label}: launches {route_launches[label]}, expected {want}")
    if [chol_pallas.route(D, dev) for D in (480, 768, 769, 1440)] != ["cluster", "cluster", "l2", "l2"]:
        raise RuntimeError("K4: D = 480 and 768 must take the cluster route, 769 and 1440 the large-D route")
    # the large-D route is one cooperative launch over the card, and two
    # runs on one input are bit-identical (the LM's decisions turn on
    # rounding)
    grid_blocks = cuda_lib.lib().chol_grid_blocks(1440)
    S, b = systems["polish G=2"][-1]
    print(f"K4 condition numbers (2-norm, float64) of the last reduced systems: bench window "
          f"{float(torch.linalg.cond(systems['BA G=1'][-1][0][0].double())):.3e}, polish window "
          f"{float(torch.linalg.cond(systems['polish G=1'][-1][0][0].double())):.3e}")
    same_bits = torch.equal(chol_pallas.chol_solve_l2(S, b), chol_pallas.chol_solve_l2(S, b))
    print(f"K4 large-D route: a cooperative grid of {grid_blocks} blocks; two runs on the "
          f"polish's last G = 2 system bit-identical: {same_bits}")
    if grid_blocks < 2 or not same_bits:
        raise RuntimeError("K4 large-D route: not spread over the card, or not deterministic")
    # a system that is not positive definite, batched beside an SPD one:
    # both routes give all-NaN for it, as the plain version does
    for kind in ("indefinite", "negative definite"):
        S_spd, b_spd = seeded_spd(480, rng)
        S = torch.as_tensor(np.stack([seeded_not_spd(480, rng, kind), S_spd[0]]), device=dev)
        b = torch.as_tensor(np.stack([np.ones(480, np.float32), b_spd[0]]), device=dev)
        xp = chol_pallas.chol_solve_plain(S, b)
        ref = torch.linalg.solve(S[1].double(), b[1].double())
        for kernel, solve in (("cluster", chol_pallas.chol_solve_cluster),
                              ("l2", chol_pallas.chol_solve_l2)):
            x = solve(S, b)
            torch.cuda.synchronize()
            e = float((x[1].double() - ref).norm() / ref.norm())
            print(f"K4 {kind} 480 beside an SPD system, {kernel} route: all-NaN "
                  f"{bool(torch.isnan(x[0]).all())} (plain {bool(torch.isnan(xp[0]).all())}), "
                  f"SPD neighbour {e:.3e} vs float64")
            if not (torch.isnan(x[0]).all() and torch.isnan(xp[0]).all() and e <= K4_RTOL):
                raise RuntimeError(f"K4 {kernel} route on the {kind} system")
    # K4's yardstick: torch.linalg.solve_ex, the library's LU solve without
    # its host-side error check (torch.linalg.solve reads the info back).
    # With --ab, the large-D rows also time the other build of
    # chol_solve.cu (a parent's) in turns with the package's.
    k4_rows = {}
    S769, b769 = seeded["seeded D=769"][0]
    S1440, b1440 = seeded["seeded D=1440"][0]
    for label, (S, b) in (("G1", systems["BA G=1"][-1]), ("G2", systems["BA G=2"][-1]),
                          ("d769", (S769[:1], b769[:1])), ("d769_g2", (S769, b769)),
                          ("d1440", (S1440[:1], b1440[:1])), ("d1440_g2", (S1440, b1440)),
                          ("polish_g1", systems["polish G=1"][-1]),
                          ("polish_g2", systems["polish G=2"][-1])):
        row = dict(shape=list(S.shape), route=chol_pallas.route(S.shape[-1], dev))
        kern = lambda: chol_pallas.chol_solve_cuda(S, b)
        if ab_chol is None or row["route"] != "l2":
            row["device_ms"], row["call_ms"] = _time_kernel(kern)
        else:
            one_block = one_block_solver(ab_chol)
            other_kern = None if one_block is None else (lambda: one_block(S, b))
            ref64 = torch.linalg.solve(S.double(), b.double())
            if other_kern is not None:
                x_other = other_kern()
            else:
                with ab_chol:
                    x_other = kern()
            tol = max(K4_RTOL, 2.0 * float(_rel(chol_pallas.chol_solve_plain(S, b), ref64).max()))
            if float(_rel(x_other, ref64).max()) > tol:
                raise RuntimeError(f"K4 A/B build, {label}: exceeds {tol:.3g} relative error")
            times = _ab_times(kern, ab_chol, other_kern)
            row.update(zip(("device_ms", "call_ms", "parent_device_ms", "parent_call_ms"), times))
        row["plain_ms"], _ = _time_kernel(lambda: chol_pallas.chol_solve_plain(S, b),
                                          f"K4 {label} plain version")
        row["library_ms"], _ = _time_kernel(lambda: torch.linalg.solve_ex(S, b),
                                            f"K4 {label} linalg.solve_ex")
        row.update(k4_bound(S.shape[0], S.shape[-1]))
        k4_rows[label] = row
        parent = (f" (A/B build: device {row['parent_device_ms']:.5f} ms, call "
                  f"{row['parent_call_ms']:.5f} ms)" if "parent_device_ms" in row else "")
        print(f"K4 {label} {tuple(S.shape)} ({row['route']} route): "
              f"device {row['device_ms']:.5f} ms, call {row['call_ms']:.5f} ms{parent}, plain "
              f"{row['plain_ms']:.5f} ms, linalg.solve_ex {row['library_ms']:.5f} ms, bound "
              f"{row['bound_us']:.3f} us ({row['bound_by']})")
    g1 = k4_rows["G1"]
    k4_common = dict(route="cuda", source="monoorbslam3_tpu_torch/csrc/chol_solve.cu",
                     replaces="monoorbslam3_tpu/ops/chol_pallas.py:40", max_abs_err=k4_abs,
                     max_rel_err_vs_f64=k4_f64, max_rel_err_vs_plain=k4_plain, checks=k4_checks,
                     launches_per_frame=(launches["chol_solve"] + launches["chol_solve_l2"]) / n_fr)
    store_k4 = {name: r["k4_launches"] for name, r in sba["calls"].items()}
    kernels.append(dict(name="chol_solve", **k4_common,
                        launches=ba_launches["chol_solve"],
                        launches_store_ba=store_launches["chol_solve"],
                        launches_track_map=tm_launches["chol_solve"],
                        launches_system_world=sw_launches["chol_solve"],
                        launches_dataset_cli=dc_launches["chol_solve"],
                        launches_sharded_ba=shb_launches["chol_solve"],
                        launches_measure=meas_launches["chol_solve"],
                        launches_battery=bat_launches["chol_solve"],
                        launches_profiles=prof_launches["chol_solve"],
                        launches_vio_profiles=vio_launches["chol_solve"],
                        launches_store_ba_per_call={n: c["chol_solve"] for n, c in store_k4.items()},
                        launches_per_solve=len(ba["flat_deferred"]["systems"]),
                        ms=g1["device_ms"], **{k: v for k, v in g1.items() if k != "route"},
                        g2=k4_rows["G2"],
                        cluster_size=chol_pallas.cluster_shape(dev)[0],
                        cluster_max_d=chol_pallas.cluster_shape(dev)[1]))
    # the large-D route, at the polish path's own last system
    p1 = k4_rows["polish_g1"]
    kernels.append(dict(name="chol_solve_l2", **k4_common,
                        launches=polish_launches["chol_solve_l2"],
                        launches_store_ba=store_launches["chol_solve_l2"],
                        launches_track_map=tm_launches["chol_solve_l2"],
                        launches_system_world=sw_launches["chol_solve_l2"],
                        launches_dataset_cli=dc_launches["chol_solve_l2"],
                        launches_sharded_ba=shb_launches["chol_solve_l2"],
                        launches_measure=meas_launches["chol_solve_l2"],
                        launches_battery=bat_launches["chol_solve_l2"],
                        launches_profiles=prof_launches["chol_solve_l2"],
                        launches_vio_profiles=vio_launches["chol_solve_l2"],
                        launches_store_ba_per_call={n: c["chol_solve_l2"] for n, c in store_k4.items()},
                        launches_per_solve=polish["polish_deferred"]["k4_launches_in_solve"]["chol_solve_l2"],
                        ms=p1["device_ms"], **{k: v for k, v in p1.items() if k != "route"},
                        grid_blocks=grid_blocks, polish_solves=polish_ab,
                        **{k: k4_rows[k] for k in ("polish_g2", "d1440", "d1440_g2", "d769", "d769_g2")}))

    lap()
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

    vi_keys = ("dev_imu_ms", "dev_extract_ms", "dev_coarse_ms", "dev_whiten_ms", "dev_local_ms",
               "host_coarse_ms", "host_local_ms", "host_frame_ms", "t_err_m", "r_err_deg",
               "v_err_mps", "pred_t_err_m", "pred_r_err_deg", "n_inliers")
    vi_summary = {}
    for key in vi_keys:
        xs_ = [r[key] for r in vi_records[1:]] or [r[key] for r in vi_records]
        vi_summary[key] = dict(p50=_pct(xs_, 50), p90=_pct(xs_, 90), p99=_pct(xs_, 99),
                               max=max(xs_), min=min(xs_))
    vi_summary["syncs_per_frame"] = (vi_syncs - 1) / n_vi
    vi_summary["inertial_syncs"] = pipe.inertial_watch.n
    vi_summary["stage_syncs"] = pipe.stage_watch.n
    vi_summary["launches"] = {k: vi_launches[k] for k in ("gather_patches", "match_rows")}
    print("visual-inertial drive (frames 2..%d):" % n_vi, json.dumps(vi_summary))
    print(f"visual-inertial bounds: median t {MAX_VI_MEDIAN_T_ERR_M} m, R {MAX_VI_MEDIAN_R_ERR_DEG} "
          f"deg; IMU-only prediction t {MAX_VI_MEDIAN_PRED_T_ERR_M} m, R "
          f"{MAX_VI_MEDIAN_PRED_R_ERR_DEG} deg; inliers >= {MIN_INLIERS} every frame")
    print("inertial inliers per frame:", [r["n_inliers"] for r in vi_records])

    failures = []
    for path, k, counts in (("tracking", "gather_patches", launches),
                            ("tracking", "match_rows", launches),
                            ("visual-inertial tracking", "gather_patches", vi_launches),
                            ("visual-inertial tracking", "match_rows", vi_launches),
                            ("mapper search", "hamming", map_launches),
                            ("fisheye mapper search", "hamming", fish_launches),
                            ("window BA", "chol_solve", ba_launches),
                            ("polish BA", "chol_solve_l2", polish_launches),
                            ("store BA", "chol_solve", store_launches),
                            ("store BA", "chol_solve_l2", store_launches),
                            ("track map", "gather_patches", tm_launches),
                            ("track map", "match_rows", tm_launches),
                            ("track map", "hamming", tm_launches),
                            ("track map", "chol_solve", tm_launches),
                            ("system world", "gather_patches", sw_launches),
                            ("system world", "match_rows", sw_launches),
                            ("system world", "hamming", sw_launches),
                            ("system world", "chol_solve", sw_launches),
                            ("dataset CLI", "gather_patches", dc_launches),
                            ("dataset CLI", "match_rows", dc_launches),
                            ("dataset CLI", "hamming", dc_launches),
                            ("dataset CLI", "chol_solve", dc_launches),
                            ("sharded BA", "gather_patches", shb_launches),
                            ("sharded BA", "chol_solve", shb_launches),
                            ("measure", "gather_patches", meas_launches),
                            ("measure", "match_rows", meas_launches),
                            ("measure", "hamming", meas_launches),
                            ("measure", "chol_solve", meas_launches),
                            ("measure", "chol_solve_l2", meas_launches),
                            ("measure's e2e run", "gather_patches", meas["e2e"]["launches"]),
                            ("measure's e2e run", "match_rows", meas["e2e"]["launches"]),
                            ("measure's e2e run", "hamming", meas["e2e"]["launches"]),
                            ("measure's e2e run", "chol_solve", meas["e2e"]["launches"]),
                            *((f"battery {n}", k, bat[n]["row"]["launches"])
                              for n in BATTERY_WORLDS for k in BATTERY_KERNELS[n])):
        if counts[k] == 0:
            failures.append(f"kernel {k} was never launched by the {path} path")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    for r in kernels[1]["calls"]:
        if r["blocks"] < n_sm:
            failures.append(f"K2 {r['call']}: {r['blocks']} blocks < {n_sm}, the card's SMs")
    for kern in ("match_rows_kernel", "hamming_kernel"):
        if tc_ops is not None and not any(kern in name and any(op.startswith("BMMA") for op in ops)
                                          for name, ops in tc_ops.items()):
            failures.append(f"{kern}: no BMMA (tensor-core) instruction in its SASS")
    if ba_launches["chol_solve_l2"]:
        failures.append("window BA: K4's large-D route ran on the D = 480 systems")
    failures += store_checks(sba)
    failures += track_map_checks(tm, tm_records, tm_steps)
    failures += system_world_checks(sw, sw_records, sw_steps)
    if ref_kw.get("groups_a") is None or not node_gated_launches:
        failures.append("system world: the node-gated reference-keyframe match launched no K2")
    failures += system_resume_checks(resume_records)
    failures += system_async_checks(sa)
    failures += dataset_cli_checks(dc, dc_records, dc_steps)
    failures += sharded_ba_checks(shb)
    failures += measure_checks(meas)
    failures += battery_checks(bat)
    failures += profiles_checks(prof)
    if not any(m == n == PROFILE_SEARCH for n, m in k3_shapes["kitti"]):
        failures.append(f"profiles: no {PROFILE_SEARCH}x{PROFILE_SEARCH} search among the "
                        f"KITTI run's last K3 launches {k3_shapes['kitti']}")
    failures += profile_k2_checks([(int(a[0].shape[0]), int(a[1].shape[0])) for a in pk["k2"]])
    if pk["k1"][-1][1].shape[0] != PROFILE_SEARCH:
        failures.append(f"profiles: K1's last KITTI launch gathered {pk['k1'][-1][1].shape[0]} "
                        f"windows")
    failures += profiles_checks(vio, large_d=False)
    for kind, p in vio.items():
        failures += profile_shape_checks(kind, p)
    for name, r in polish.items():
        n_sys = len(r["systems"])
        if r["k4_launches_in_solve"] != {"chol_solve": 0, "chol_solve_l2": n_sys} or n_sys != POLISH_ITERS:
            failures.append(f"polish BA {name}: K4 launches {r['k4_launches_in_solve']} for {n_sys} "
                            f"reduced solves, expected {POLISH_ITERS} of the large-D route")
        if r["syncs_in_solve"]:
            failures.append(f"polish BA {name}: {r['syncs_in_solve']} host syncs inside the solve")
        if not r["finite"]:
            failures.append(f"polish BA {name}: non-finite points")
        if abs(r["cost0"] - JAX_POLISH_COST0) > BA_COST0_RTOL * JAX_POLISH_COST0:
            failures.append(f"polish BA {name}: cost0 {r['cost0']} vs {JAX_POLISH_COST0}")
        if abs(r["cost"] - JAX_POLISH_COST[name]) > BA_COST_RTOL * JAX_POLISH_COST[name]:
            failures.append(f"polish BA {name}: cost {r['cost']} vs {JAX_POLISH_COST[name]}")
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
    for r in vi_records:
        if r["n_inliers"] < MIN_INLIERS:
            failures.append(f"inertial frame {r['frame']}: {r['n_inliers']} inliers < {MIN_INLIERS}")
    for key, lim in (("t_err_m", MAX_VI_MEDIAN_T_ERR_M), ("r_err_deg", MAX_VI_MEDIAN_R_ERR_DEG),
                     ("pred_t_err_m", MAX_VI_MEDIAN_PRED_T_ERR_M),
                     ("pred_r_err_deg", MAX_VI_MEDIAN_PRED_R_ERR_DEG)):
        med = float(np.median([r[key] for r in vi_records]))
        if not med <= lim:
            failures.append(f"visual-inertial drive: median {key} {med} > {lim}")
    if vi_summary["syncs_per_frame"] > MAX_VI_SYNCS_PER_FRAME:
        failures.append(f"visual-inertial drive: {vi_summary['syncs_per_frame']} host syncs a frame")
    if pipe.inertial_watch.n:
        failures.append(f"inertial stage: {pipe.inertial_watch.n} host syncs "
                        f"{dict(pipe.inertial_watch.sites)}")
    if not vi_check["max_rel_vs_cpu"] <= VI_CARD_RTOL:
        failures.append(f"inertial stage: the card's tree/whitening {vi_check['max_rel_vs_cpu']} "
                        f"from the CPU's")
    if not vi_check["polar_vs_svd_max_abs"] <= 1e-6:
        failures.append(f"delta_rotation: polar step {vi_check['polar_vs_svd_max_abs']} from the SVD")
    if not vi_check["lm_use_inertial"]:
        failures.append("visual-inertial drive: the local stage's LM ran without its inertial tail")
    if frec["n_accepted"] < MIN_ACCEPTED_FISHEYE:
        failures.append(f"fisheye mapper: {frec['n_accepted']} points accepted < {MIN_ACCEPTED_FISHEYE}")
    if not frec["median_tri_err_m"] <= MAX_MEDIAN_TRI_ERR_FISHEYE_M:
        failures.append(f"fisheye mapper: median 3D error {frec['median_tri_err_m']} m")
    if frec["n_fused"] < MIN_FUSED_FISHEYE:
        failures.append(f"fisheye mapper: {frec['n_fused']} points fused < {MIN_FUSED_FISHEYE}")
    if np.median(t_errs) > MAX_MEDIAN_T_ERR_M:
        failures.append(f"median translation error {np.median(t_errs)} m")
    if np.median(r_errs) > MAX_MEDIAN_R_ERR_DEG:
        failures.append(f"median rotation error {np.median(r_errs)} deg")
    lap()
    # (in order: the build; paths 1-8; path 10 with path 9's lane made; paths
    # 11 and 12; the lanes' phase, until the battery's lanes end, with their
    # checks; the rest of path 9's lane and its checks; path 14's; path 15's
    # with the A/B polish; the kernel phases; the results)
    print("seconds of the build, paths 1-15, the kernel phases and the results:",
          json.dumps(phase_s))
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
