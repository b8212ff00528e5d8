"""chip_smoke.py's battery worlds through the JAX package, on the CPU.

Runs run_validation.py's fastspin30 and corridor60 worlds through the JAX
package's public path, as `run_validation.run_world` runs them
(`config.build_system` of the world's settings, `runners.synth.
SyntheticDataset` of its spec, `runners.datasets.run_sequence`,
`shutdown`, the keyframe trajectory scored by `evaluation.metrics.
evaluate_sequences` with max_dt 0.05), once a seed of the tracker's RANSAC
draws (the `seed` knob of `Tracking`, passed through `build_system`'s
`config_overrides`; patched in this process, no file changes; seed 0 is
the default). For each run it prints what `chip_smoke.battery` records of
the port on the card: run_validation.py's row (frames, OK frames, LOST
events, keyframes kept and created, imu_state, ATE, scale error, the
verdict against the world's bounds), the RECENTLY_LOST frames, the
counters of the port runner's `BatteryMeter` (full polishes by branch,
reference-keyframe matches, keyframe slots recycled, keyframes and points
evicted) and the fetches a tracked frame and a mapper step, counted as
experiments/port_system_jax.py counts them (the `fetch` names of the JAX
package's tracking, local_mapping and problems modules, wrapped; the
reference-keyframe match reads its result with `np.asarray`, which this
count misses). The host times are this CPU's and are not printed. These
runs are the sources of chip_smoke's JAX_BATTERY; `--worlds circlebow30`
gives the system world's spread over seeds (PERF.md §7).

    python experiments/port_battery_jax.py [--worlds fastspin30,corridor60]
        [--seeds 0,1,2,3] [--out-dir DIR]

About 15 minutes a world and seed on a CPU, two processes at a time.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import tests.conftest  # noqa: F401  (JAX on the CPU backend)

import numpy as np

import chip_smoke as cs
import run_validation
from monoorbslam3_tpu.backend import problems
from monoorbslam3_tpu.config import build_system
from monoorbslam3_tpu.evaluation.metrics import evaluate_sequences
from monoorbslam3_tpu.frontend import local_mapping, tracking
from monoorbslam3_tpu.runners.datasets import run_sequence
from monoorbslam3_tpu.runners.synth import SyntheticDataset
from monoorbslam3_tpu_torch.runners.validation import BatteryMeter

FETCHES = collections.Counter()


def _counted(mod):
    inner = mod.fetch

    def fetch(*trees):
        FETCHES[mod.__name__.rsplit(".", 1)[-1]] += 1
        return inner(*trees)

    mod.fetch = fetch


def run(name, seed, out_dir):
    """One world at one tracker seed: the row and the counters."""
    settings, spec, ate_bound, scale_bound = run_validation.WORLDS[name]
    count = lambda: sum(FETCHES.values())
    syst = build_system(os.path.join(ROOT, settings), config_overrides={"seed": seed})
    battery = BatteryMeter(syst)
    meter = cs.MapperMeter(syst.mapper.process, count)
    syst.mapper.process = meter  # System._on_new_kf calls self.mapper.process
    frames = cs.FrameMeter(syst, meter, count)
    syst.track = frames
    dataset = SyntheticDataset(spec, syst.camera, syst.calib)
    t0 = time.perf_counter()
    states = run_sequence(syst, dataset, progress_every=0)
    syst.shutdown()
    est = os.path.join(out_dir, f"{name}_s{seed}_est.txt")
    gt = os.path.join(out_dir, f"{name}_s{seed}_gt.txt")
    syst.save_keyframe_trajectory(est)
    dataset.save_ground_truth(gt)
    (ate,) = evaluate_sequences([(name, est, gt)], max_dt=0.05)
    sw = cs.system_world_summary(frames.records, meter.steps, syst, ate)
    lost = int((states == 4).sum())
    row = dict(
        world=name, seed=seed, frames=len(states), ok_frames=int((states == 2).sum()),
        ok_ratio=float((states == 2).mean()), lost_events=lost,
        n_keyframes=syst.store.n_keyframes(), kf_created_total=int(syst.store.kf_created_total),
        imu_state=int(syst.mapper.imu_state), imu_init_t=sw["imu_init_t"],
        ate_rmse=float(ate["rmse"]), scale_err=abs(float(ate["scale"]) - 1.0),
        bound_ate=ate_bound, bound_scale=scale_bound,
        **{"pass": bool(ate["rmse"] <= ate_bound and abs(ate["scale"] - 1.0) <= scale_bound
                        and lost == 0)},
        bootstrap_frame=sw["bootstrap_frame"], n_points=sw["n_points"],
        fetches_per_tracked_frame=sw["fetches_per_tracked_frame"],
        fetches_per_mapper_step=sw["fetches_per_mapper_step"],
        max_fetches_any_frame=int(max(r["fetches"] for r in frames.records)),
        **battery.counters(), seconds=time.perf_counter() - t0)
    return row


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", default="fastspin30,corridor60")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--out-dir", default=None,
                    help="directory for the trajectory files (a temporary one by default)")
    args = ap.parse_args()
    for mod in (tracking, local_mapping, problems):
        _counted(mod)
    out = args.out_dir or tempfile.mkdtemp()
    os.makedirs(out, exist_ok=True)
    rows = []
    for name in args.worlds.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            rows.append(run(name, seed, out))
            print(json.dumps(rows[-1]), flush=True)
    for name in args.worlds.split(","):
        mine = [r for r in rows if r["world"] == name]
        print(json.dumps({"world": name, "seeds": [r["seed"] for r in mine],
                          "ate_rmse": [r["ate_rmse"] for r in mine],
                          "max_ate_rmse": float(np.max([r["ate_rmse"] for r in mine]))}),
              flush=True)


if __name__ == "__main__":
    main()
