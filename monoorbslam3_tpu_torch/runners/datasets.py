"""Sequence runner (counterpart of `run_sequence` in
`monoorbslam3_tpu/runners/datasets.py`).

The disk loaders and the command line wait for the native dataset loader
(ROADMAP Queue 1 item 9); `run_sequence` drives a System over any dataset
with `frames()`, such as `runners.synth.SyntheticDataset`.
"""

from __future__ import annotations

import time

import numpy as np


def run_sequence(system, dataset, realtime_fps: float | None = None,
                 max_frames: int | None = None, progress_every: int = 100, log=print):
    """Drive a System over a dataset (the demo main loop,
    eurocDemo.cpp:44-74). Returns the per-frame states."""
    if realtime_fps:
        # real-time pacing cannot absorb a first use mid-stream
        log("warmup: the first call of every device path...")
        system.warmup()
    states = []
    t_start = time.perf_counter()
    for i, (t, img, imu) in enumerate(dataset.frames()):
        if max_frames is not None and i >= max_frames:
            break
        step_start = time.perf_counter()
        state = system.track(t, img, imu)
        states.append(state)
        if realtime_fps:
            budget = 1.0 / realtime_fps
            spent = time.perf_counter() - step_start
            if spent < budget:
                time.sleep(budget - spent)
        if progress_every and i % progress_every == 0:
            log(f"frame {i}: t={t:.2f} state={state} "
                f"kf={system.store.n_keyframes()} pts={system.store.n_points()}")
    wall = time.perf_counter() - t_start
    n = len(states)
    log(f"done: {n} frames in {wall:.1f}s ({n / max(wall, 1e-9):.1f} fps)")
    return np.asarray(states)
