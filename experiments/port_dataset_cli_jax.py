"""chip_smoke.py's dataset CLI path through the JAX package, on the CPU.

Writes chip_smoke's EuRoC-layout dataset (`chip_smoke.write_dataset(root, "euroc")`:
200 frames of the track map's world and stream, the PNGs, `imu.txt`, the
ground truth and the settings file; its renderer is the port's, whose
frames are the JAX package's to the byte) and runs the JAX package's user
entry point over it, as `chip_smoke.dataset_cli` runs the port's:

    runners.datasets.main(["euroc", settings, root, traj, "--vocab",
        settings/synthetic_voc_100k.txt.gz, "--velocity-out", ...,
        "--map-out", ..., "--depth-out", ..., "--save-state", ...])

The System that `main` builds is metered as chip_smoke meters the port's
(`config.build_system` is wrapped in this process: `FrameMeter` on
`System.track`, `MapperMeter` on the mapper's steps), and the fetches are
counted as experiments/port_system_jax.py counts them, by wrapping the
`fetch` names that `frontend.tracking`, `frontend.local_mapping` and
`backend.problems` import. It prints the native loader's branch, the
per-frame records, and the summary that chip_smoke's JAX_DATASET_CLI
bounds come from (`chip_smoke.system_world_summary` of the run and the
keyframe ATE of the exported trajectory against the written ground truth,
`evaluate_sequences` with max_dt 0.05): OK and LOST counts, the inertial
init, keyframes and points, fetches a tracked frame and a mapper step.

    python experiments/port_dataset_cli_jax.py [--frames 200] [--out DIR]

About 3 minutes on a CPU (the dataset written first: ~2 more).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import tests.conftest  # noqa: F401  (JAX on the CPU backend)

import chip_smoke as cs
from monoorbslam3_tpu import config, native
from monoorbslam3_tpu.backend import problems
from monoorbslam3_tpu.evaluation.metrics import evaluate_sequences
from monoorbslam3_tpu.frontend import local_mapping, tracking
from monoorbslam3_tpu.runners import datasets

FETCHES = collections.Counter()


def _counted(mod):
    inner = mod.fetch

    def fetch(*trees):
        FETCHES[mod.__name__.rsplit(".", 1)[-1]] += 1
        return inner(*trees)

    mod.fetch = fetch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=cs.DATASET_FRAMES)
    ap.add_argument("--out", default=None, help="directory for the dataset and the exports "
                    "(a temporary one by default)")
    args = ap.parse_args()
    for mod in (tracking, local_mapping, problems):
        _counted(mod)
    count = lambda: sum(FETCHES.values())

    out = args.out or tempfile.mkdtemp()
    root = os.path.join(out, "euroc")
    if not os.path.exists(os.path.join(root, "done")):
        cs.write_dataset(root, "euroc", args.frames)
    print("native dataloader:", "native" if native.get_ext("dataloader") is not None
          else "fallback", flush=True)

    built = {}
    inner_build = config.build_system

    def build_system(*a, **k):
        syst = inner_build(*a, **k)
        meter = cs.MapperMeter(syst.mapper.process, count)
        syst.mapper.process = meter
        frames = cs.FrameMeter(syst, meter, count, log=lambda line: print(line, flush=True))
        syst.track = frames
        built.update(system=syst, meter=meter, frames=frames)
        return syst

    config.build_system = build_system
    files = {flag: os.path.join(out, f"jax_{name}") for flag, name in cs.DATASET_EXPORTS.items()}
    traj = os.path.join(out, "jax_trajectory.txt")
    argv = ["euroc", os.path.join(root, cs.DATASET_SETTINGS_NAME), root, traj,
            "--vocab", str(cs.SETTINGS / cs.DATASET_VOCAB)]
    for flag, path in files.items():
        argv += [flag, path]
    t_start = time.perf_counter()
    datasets.main(argv)
    seconds = time.perf_counter() - t_start
    syst, meter, frames = built["system"], built["meter"], built["frames"]
    (ate,) = evaluate_sequences([("dataset", traj, os.path.join(root, cs.DATASET_GT_NAME))],
                                max_dt=cs.SYSTEM_WORLD_MAX_DT)
    summary = cs.system_world_summary(frames.records, meter.steps, syst, ate)
    summary["fetches_by_module"] = dict(FETCHES)
    summary["seconds"] = seconds
    print(json.dumps({"mapper_steps": [(m["frame"], m["kf"], m["initial"], round(m["host_ms"], 1),
                                        m["fetches"]) for m in meter.steps]}), flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
