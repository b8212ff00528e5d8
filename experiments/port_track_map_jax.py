"""chip_smoke.py's track-map path through the JAX package, on the CPU.

Runs the JAX package's `System` in sync mode (no vocabulary, no init
extractor) with the configuration of `chip_smoke.TRACK_MAP_CONFIG` and every
capacity at its default, over the same rendered frames and IMU samples
(`chip_smoke.track_map_stream`, here with the JAX package's ImageWorld and
camera), and prints what `chip_smoke.track_map` records: per frame the
tracking state, the tracked count, the host time of `System.track` (the
extractor included, the mapper's steps taken out) and the fetches; per
mapper step its host time and fetches; and the summary
(`chip_smoke.track_map_summary`): the bootstrap frame, the OK ratio after
it, the inertial init, the keyframe ATE, the keyframe and point counts.
These are the sources of chip_smoke's JAX_TRACK_MAP bounds (PERF.md
records the run).

The fetches are counted by wrapping the `fetch` names that
`frontend.tracking`, `frontend.local_mapping` and `backend.problems` import
(the names are patched here, in this process; no file changes). The mapper
step is timed and counted by standing between `System._on_new_kf` and
`LocalMapping.process`.

`System.track` differs from the port's wiring (`Tracking.track_feats`
with `new_kf_callback = mapper.process`) only in `_handle_lost`, which
does nothing on a run without a LOST frame (the summary's `n_lost`).

    python experiments/port_track_map_jax.py [--frames 100]

Prints one JSON record per frame, one per mapper step, and the summary
last. About 4 minutes on one CPU (the extractor and the window BAs
compile once).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import tests.conftest  # noqa: F401  (JAX on the CPU backend)

import chip_smoke as cs
from monoorbslam3_tpu import config
from monoorbslam3_tpu.backend import problems
from monoorbslam3_tpu.evaluation.ate import umeyama_align
from monoorbslam3_tpu.frontend import local_mapping, tracking
from monoorbslam3_tpu.models.imu import ImuCalib
from monoorbslam3_tpu.ops.orb import OrbExtractor
from monoorbslam3_tpu.sim import ImageWorld
from monoorbslam3_tpu.system import System

FETCHES = collections.Counter()


def _counted(mod):
    inner = mod.fetch

    def fetch(*trees):
        FETCHES[mod.__name__.rsplit(".", 1)[-1]] += 1
        return inner(*trees)

    mod.fetch = fetch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=cs.TRACK_MAP_FRAMES)
    n_frames = ap.parse_args().frames
    for mod in (tracking, local_mapping, problems):
        _counted(mod)
    count = lambda: sum(FETCHES.values())

    cam = config.build_camera(config.load_settings(str(cs.SETTINGS / cs.EUROC_PROFILE)))
    ext = OrbExtractor(cam.height, cam.width, n_features=cs.N_FEAT, n_levels=cs.N_LEVELS,
                       scale=cs.SCALE)
    syst = System(cam, cs.store_calibration(ImuCalib),
                  config=dict(cs.TRACK_MAP_CONFIG, max_kf=cs.TRACK_MAP_MAX_KF), extractor=ext)
    meter = cs.MapperMeter(syst.mapper.process, count)
    syst.mapper.process = meter  # System._on_new_kf calls self.mapper.process
    world = ImageWorld()
    records = []
    t_start = time.perf_counter()
    for i, t, img, imu in cs.track_map_stream(world, cam, n_frames):
        meter.frame = i
        n_steps, n0, t0 = len(meter.steps), count(), time.perf_counter()
        state = syst.track(t, img, imu)
        dt = 1e3 * (time.perf_counter() - t0)
        mine = meter.steps[n_steps:]
        rec = dict(frame=i, t=t, state=int(state),
                   n_tracked=int(syst.tracking.last_frame.n_tracked),
                   imu_state=int(syst.mapper.imu_state),
                   frame_ms=dt - sum(m["host_ms"] for m in mine),
                   fetches=count() - n0 - sum(m["fetches"] for m in mine),
                   n_kf=syst.store.n_keyframes(), n_points=int(syst.store.n_points()))
        print(json.dumps(rec), flush=True)
        for m in mine:
            print(json.dumps({"mapper_step": m}), flush=True)
        records.append(rec)
    summary = cs.track_map_summary(records, meter.steps, syst.store, world.traj, umeyama_align)
    summary["fetches_by_module"] = dict(FETCHES)
    summary["seconds"] = time.perf_counter() - t_start
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
