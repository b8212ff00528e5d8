"""The port's battery worlds over the tracker's RANSAC seeds.

Runs `monoorbslam3_tpu_torch.runners.validation.run_world` and
`score_world` once a world and seed of the tracker's RANSAC draws (the
`seed` knob of `Tracking`, passed through `config.build_system`'s
`config_overrides`; patched in the child, no file changes; seed 0 is the
default and the battery's), each in a process of its own, `--jobs` at a
time, on `--device` (the card by default). Prints one JSON line a run:
frames, OK frames, LOST events, RECENTLY_LOST frames, keyframes kept and
created, imu_state, ATE, scale error, the verdict against the world's
bounds, and the reference-keyframe matches; then the ATE over the seeds a
world. The JAX package's counterpart is experiments/port_battery_jax.py
(CPU); together they give the spread over seeds that PERF.md §7 compares.
Imports nothing of jax: it runs on the card's machine.

    python experiments/port_battery_seeds.py [--worlds fastspin30,corridor60,circlebow30]
        [--seeds 1,2,3] [--device cuda] [--jobs 3] [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
KEYS = ("frames", "ok_frames", "lost_events", "recently_lost_frames", "n_keyframes",
        "kf_created_total", "imu_state", "ate_rmse", "scale_err", "pass", "ref_kf_matches")

_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
from monoorbslam3_tpu_torch import config
from monoorbslam3_tpu_torch.runners import validation
inner = config.build_system
config.build_system = lambda *a, **k: inner(*a, config_overrides={{"seed": {seed!r}}}, **k)
settings, spec, _, _ = validation.WORLDS[{world!r}]
row = validation.score_world({world!r}, validation.run_world({world!r}, settings, spec,
                                                               {out!r}, {device!r}))
print("ROW " + json.dumps({{k: row[k] for k in {keys!r}}}), flush=True)
"""


def run(world, seed, device, out_dir):
    out = os.path.join(out_dir, f"{world}_s{seed}")
    os.makedirs(out, exist_ok=True)
    code = _CHILD.format(root=ROOT, seed=seed, world=world, out=out, device=device, keys=KEYS)
    with open(os.path.join(out, "log.txt"), "w") as log:
        proc = subprocess.run([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=log, text=True, cwd=ROOT)
    rows = [line[4:] for line in proc.stdout.splitlines() if line.startswith("ROW ")]
    if proc.returncode or not rows:
        return dict(world=world, seed=seed, failed=proc.returncode)
    return dict(world=world, seed=seed, **json.loads(rows[-1]))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worlds", default="fastspin30,corridor60,circlebow30")
    ap.add_argument("--seeds", default="1,2,3")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--out-dir", default=None)
    args = ap.parse_args()
    out_dir = args.out_dir or tempfile.mkdtemp()
    runs = [(w, int(s)) for w in args.worlds.split(",") for s in args.seeds.split(",")]
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        rows = list(ex.map(lambda ws: run(*ws, args.device, out_dir), runs))
    for row in rows:
        print(json.dumps(row), flush=True)
    for w in args.worlds.split(","):
        ates = {r["seed"]: r.get("ate_rmse") for r in rows if r["world"] == w}
        print(json.dumps({"world": w, "device": args.device, "ate_rmse_by_seed": ates}),
              flush=True)
    return 1 if any("failed" in r for r in rows) else 0


if __name__ == "__main__":
    sys.exit(main())
