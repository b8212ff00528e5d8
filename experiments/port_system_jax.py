"""chip_smoke.py's system world through the JAX package, on the CPU.

Runs run_validation.py's circlebow30 world through the JAX package's
public path, as `chip_smoke.system_world` runs it through the port:
`config.build_system(settings/synthetic_vocab.yaml)` (the reference-scale
vocabulary, sync mapper), `runners.synth.SyntheticDataset` of
`chip_smoke.SYSTEM_WORLD_SPEC` (the first 600 frames are the t_end=30
stream's), `runners.datasets.run_sequence(..., max_frames=600)`,
`shutdown`, the keyframe trajectory and the ground truth written and
scored by `evaluation.metrics.evaluate_sequences` (max_dt 0.05, as
run_validation.py scores it). It prints what `chip_smoke.system_world`
records: per frame the state, the tracked count, the host time of
`System.track` without the mapper's steps and the fetches; per mapper
step its host time and fetches; the keyframe count of every full polish;
the tracker's fallbacks to the node-gated reference-keyframe match; and
the summary (`chip_smoke.system_world_summary`): OK frames, LOST
events, the inertial init, the keyframe ATE and scale error, the keyframe
and point counts, the fetches a tracked frame and a mapper step. These
are the sources of chip_smoke's JAX_SYSTEM_WORLD bounds (PERF.md records
the run).

The fetches are counted as experiments/port_track_map_jax.py counts them:
by wrapping the `fetch` names that `frontend.tracking`,
`frontend.local_mapping` and `backend.problems` import (patched in this
process; no file changes).

    python experiments/port_system_jax.py [--frames 600] [--out DIR]

About 7 minutes on a CPU.
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
from monoorbslam3_tpu.backend import problems
from monoorbslam3_tpu.config import build_system
from monoorbslam3_tpu.evaluation.metrics import evaluate_sequences
from monoorbslam3_tpu.frontend import local_mapping, tracking
from monoorbslam3_tpu.runners.datasets import run_sequence
from monoorbslam3_tpu.runners.synth import SyntheticDataset

FETCHES = collections.Counter()


def _counted(mod):
    inner = mod.fetch

    def fetch(*trees):
        FETCHES[mod.__name__.rsplit(".", 1)[-1]] += 1
        return inner(*trees)

    mod.fetch = fetch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=cs.SYSTEM_WORLD_FRAMES)
    ap.add_argument("--out", default=None, help="directory for the trajectory files "
                    "(a temporary one by default)")
    args = ap.parse_args()
    for mod in (tracking, local_mapping, problems):
        _counted(mod)
    count = lambda: sum(FETCHES.values())

    out = args.out or tempfile.mkdtemp()
    syst = build_system(str(cs.SETTINGS / cs.SYSTEM_WORLD_SETTINGS))
    meter = cs.MapperMeter(syst.mapper.process, count)
    syst.mapper.process = meter  # System._on_new_kf calls self.mapper.process
    polishes, ref_kf = [], []
    cs.on_call(syst.problems, "full_inertial_optimize",
               lambda store, *a, **k: polishes.append(store.n_keyframes()))
    cs.on_call(syst.tracking, "_match_against_ref_kf", lambda *a: ref_kf.append(1))
    frames = cs.FrameMeter(syst, meter, count, log=lambda line: print(line, flush=True))
    syst.track = frames
    dataset = SyntheticDataset(cs.SYSTEM_WORLD_SPEC, syst.camera, syst.calib)
    t_start = time.perf_counter()
    run_sequence(syst, dataset, max_frames=args.frames, progress_every=0)
    syst.shutdown()
    est, gt = os.path.join(out, "est.txt"), os.path.join(out, "gt.txt")
    syst.save_keyframe_trajectory(est)
    dataset.save_ground_truth(gt)
    (ate,) = evaluate_sequences([("circlebow30", est, gt)], max_dt=cs.SYSTEM_WORLD_MAX_DT)
    summary = cs.system_world_summary(frames.records, meter.steps, syst, ate)
    summary["polish_kf_counts"] = polishes
    summary["ref_kf_matches"] = len(ref_kf)
    summary["fetches_by_module"] = dict(FETCHES)
    summary["seconds"] = time.perf_counter() - t_start
    print(json.dumps({"mapper_steps": [(m["frame"], m["kf"], m["initial"], round(m["host_ms"], 1),
                                        m["fetches"]) for m in meter.steps]}), flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
