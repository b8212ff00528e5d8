"""chip_smoke.py's profiles paths (paths 14 and 15) through the JAX package, on the CPU.

Writes chip_smoke's profile datasets (`chip_smoke.write_dataset` of each
profile: "kitti" and "tumvi", path 14's; "phone", "kaist", "ntu" and
"recttum", path 15's; the port's renderer, whose frames are the JAX
package's to the byte; PNGs in each profile's layout, the IMU rows, the
ground truth and the settings file) and runs the JAX package's user entry
point over each, as `chip_smoke.dataset_cli` runs the port's:

    runners.datasets.main([layout kind, settings, root, traj, "--vocab",
        settings/synthetic_voc_100k.txt.gz, "--velocity-out", ...,
        "--map-out", ..., "--depth-out", ..., "--save-state", ...
        (, "--realtime" for the phone)])

once a seed of the tracker's RANSAC draws (the `seed` knob of `Tracking`,
passed through `build_system`'s `config_overrides`; patched in this
process, no file changes; seed 0 is the default). The System that `main`
builds is metered as experiments/port_dataset_cli_jax.py meters it
(`FrameMeter`, `MapperMeter`, fetches counted by wrapping the `fetch`
names of `frontend.tracking`, `frontend.local_mapping` and
`backend.problems`). Each run prints the native loader's branch, the
digest of the files it read (`chip_smoke.dataset_digest`; the parent
writes each folder's and each PNG's into experiments/port_profiles_digests.json,
chip_smoke.PROFILE_DIGESTS), the per-frame
records and the summary that chip_smoke's JAX_PROFILES bounds come from
(`chip_smoke.system_world_summary` and the keyframe ATE of the exported
trajectory against the written ground truth, `evaluate_sequences` with
max_dt 0.05; with the time of the first frame at imu_state 2 and of the
last frame), and writes it to OUT/<profile>_s<seed>.json.

    python experiments/port_profiles_jax.py [--kinds kitti,tumvi] [--seeds 0]
        [--jobs 2] [--out DIR] [--count-pixels DIR]
    python experiments/port_profiles_jax.py --kinds phone,kaist,ntu,recttum \
        --seeds 0,1,2,3 --jobs 4
    python experiments/port_profiles_jax.py --kinds ntu --collect DIR

Every run's summary is also merged into experiments/port_profiles_runs.json
(profile -> seed -> summary: the record chip_smoke's JAX_PROFILES of path
15 is built from); `--collect DIR` runs nothing and merges the summaries of
`--kinds` that DIR already holds.

`--count-pixels DIR` runs nothing: it counts, PNG by PNG, the pixels in
which the PNGs under DIR/<kind>/ (those of another host's render that
chip_smoke's path 14 found to differ from the digests and copied to
chip_smoke.PROFILE_PNGS_OUT) differ from this host's render of the same
files in OUT.

Each (profile, seed) runs in a process of its own, `--jobs` at a time. About
10-20 minutes a run on a CPU (the datasets are written first, ~3 minutes,
~5 for the phone's 1280x720 frames, and reused when OUT already holds
them).
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
RUNS = os.path.join(ROOT, "experiments", "port_profiles_runs.json")


def run(kind, seed, out):
    """One profile at one tracker seed through the JAX package's main."""
    import tests.conftest  # noqa: F401  (JAX on the CPU backend)

    import chip_smoke as cs
    from monoorbslam3_tpu import config, native
    from monoorbslam3_tpu.backend import problems
    from monoorbslam3_tpu.evaluation.metrics import evaluate_sequences
    from monoorbslam3_tpu.frontend import local_mapping, tracking
    from monoorbslam3_tpu.runners import datasets

    fetches = collections.Counter()
    for mod in (tracking, local_mapping, problems):
        inner = mod.fetch

        def fetch(*trees, _inner=inner, _name=mod.__name__.rsplit(".", 1)[-1]):
            fetches[_name] += 1
            return _inner(*trees)

        mod.fetch = fetch
    count = lambda: sum(fetches.values())

    root = os.path.join(out, kind)
    digest, _ = cs.dataset_digest(root, kind)
    print(f"{kind} seed {seed}: dataset digest {digest}", flush=True)
    print("native dataloader:", "native" if native.get_ext("dataloader") is not None
          else "fallback", flush=True)
    built = {}
    inner_build = config.build_system

    def build_system(*a, **k):
        syst = inner_build(*a, config_overrides={"seed": seed}, **k)
        meter = cs.MapperMeter(syst.mapper.process, count)
        syst.mapper.process = meter
        polishes = []
        cs.on_call(syst.problems, "full_inertial_optimize",
                   lambda store, *a, **k: polishes.append(store.n_keyframes()))
        frames = cs.FrameMeter(syst, meter, count,
                               log=lambda line: print(line, flush=True))
        syst.track = frames
        built.update(system=syst, meter=meter, frames=frames, polishes=polishes)
        return syst

    config.build_system = build_system
    tag = f"jax_{kind}_s{seed}"
    files = {flag: os.path.join(out, f"{tag}_{name}") for flag, name in cs.DATASET_EXPORTS.items()}
    traj = os.path.join(out, f"{tag}_trajectory.txt")
    prof = cs.DATASET_PROFILES[kind]
    argv = [prof["layout"], os.path.join(root, cs.DATASET_SETTINGS_NAME), root, traj,
            "--vocab", str(cs.SETTINGS / cs.DATASET_VOCAB)]
    for flag, path in files.items():
        argv += [flag, path]
    if prof.get("realtime"):
        argv.append("--realtime")
    t_start = time.perf_counter()
    datasets.main(argv)
    seconds = time.perf_counter() - t_start
    syst, meter, frames = built["system"], built["meter"], built["frames"]
    (ate,) = evaluate_sequences([(kind, traj, os.path.join(root, cs.DATASET_GT_NAME))],
                                max_dt=cs.SYSTEM_WORLD_MAX_DT)
    summary = cs.system_world_summary(frames.records, meter.steps, syst, ate)
    state2 = [r["t"] for r in frames.records if r["imu_state"] >= 2]
    summary.update(kind=kind, seed=seed, digest=digest, fetches_by_module=dict(fetches),
                   polish_kf_counts=built["polishes"], seconds=seconds,
                   imu_state2_t=state2[0] if state2 else None, end_t=frames.records[-1]["t"])
    print(json.dumps({"mapper_steps": [(m["frame"], m["kf"], m["initial"], round(m["host_ms"], 1),
                                        m["fetches"]) for m in meter.steps]}), flush=True)
    print(json.dumps(summary), flush=True)
    with open(os.path.join(out, f"{kind}_s{seed}.json"), "w") as f:
        json.dump(summary, f)


def collect(out, kinds):
    """Merges the summaries OUT/<profile>_s<seed>.json of `kinds` into RUNS."""
    record = json.load(open(RUNS)) if os.path.exists(RUNS) else {}
    for kind in kinds:
        for name in sorted(os.listdir(out)):
            if name.startswith(kind + "_s") and name.endswith(".json"):
                with open(os.path.join(out, name)) as f:
                    s = json.load(f)
                record.setdefault(kind, {})[str(s["seed"])] = s
    with open(RUNS, "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")


def count_pixels(pngs_dir, out):
    """Prints, for each PNG under pngs_dir/<kind>/, the number of pixels in
    which it differs from the same file of this host's render in out/<kind>
    (and the largest difference)."""
    import numpy as np

    import chip_smoke as cs

    for kind_dir in sorted(p for p in os.scandir(pngs_dir) if p.is_dir()):
        layout = cs.DATASET_LAYOUTS[cs.DATASET_PROFILES[kind_dir.name]["layout"]]
        image_dir = os.path.join(out, kind_dir.name, layout[1])
        for name in sorted(os.listdir(kind_dir.path)):
            with open(os.path.join(kind_dir.path, name), "rb") as f:
                other = cs.png_gray_pixels(f.read()).astype(np.int32)
            with open(os.path.join(image_dir, name), "rb") as f:
                mine = cs.png_gray_pixels(f.read()).astype(np.int32)
            diff = np.abs(other - mine)
            print(f"{kind_dir.name} {name}: {int((diff > 0).sum())} of {diff.size} pixels differ "
                  f"(largest difference {int(diff.max())})", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kinds", default="kitti,tumvi")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--out", default=None, help="directory for the datasets and the exports "
                    "(a temporary one by default)")
    ap.add_argument("--count-pixels", default=None, metavar="DIR",
                    help="count the pixels of the PNGs under DIR/<kind>/ that differ from this "
                    "host's render, and run nothing")
    ap.add_argument("--collect", default=None, metavar="DIR",
                    help="merge the summaries of --kinds under DIR into "
                    "experiments/port_profiles_runs.json, and run nothing")
    ap.add_argument("--one", default=None, help=argparse.SUPPRESS)  # KIND:SEED, a child's run
    args = ap.parse_args()
    out = args.out or tempfile.mkdtemp()
    if args.one:
        kind, seed = args.one.split(":")
        run(kind, int(seed), out)
        return

    if args.collect:
        collect(args.collect, args.kinds.split(","))
        return

    import chip_smoke as cs

    kinds = (sorted(p.name for p in os.scandir(args.count_pixels) if p.is_dir())
             if args.count_pixels else args.kinds.split(","))
    writers = [cs.DatasetWriter(os.path.join(out, k), k) for k in kinds
               if not os.path.exists(os.path.join(out, k, "done"))]
    for w in writers:
        w.wait(timeout=3600)
        print(f"wrote {w.out} in {w.seconds:.1f} s", flush=True)
    if args.count_pixels:
        count_pixels(args.count_pixels, out)
        return
    # the files' digests, which chip_smoke's path 14 holds the card host's to
    record = json.loads(cs.PROFILE_DIGESTS.read_text()) if cs.PROFILE_DIGESTS.exists() else {}
    for kind in kinds:
        digest, pngs = cs.dataset_digest(os.path.join(out, kind), kind)
        record[kind] = dict(digest=digest, pngs={n: h[:16] for n, h in pngs.items()})
        print(f"{kind}: dataset digest {digest}", flush=True)
    cs.PROFILE_DIGESTS.write_text(json.dumps(record, indent=0, sort_keys=True) + "\n")
    todo = [(k, int(s)) for s in args.seeds.split(",") for k in kinds]
    running, rcs = [], {}
    while todo or running:
        while todo and len(running) < args.jobs:
            kind, seed = todo.pop(0)
            log = open(os.path.join(out, f"{kind}_s{seed}.log"), "w")
            running.append(((kind, seed), log, subprocess.Popen(
                [sys.executable, __file__, "--one", f"{kind}:{seed}", "--out", out],
                stdout=log, stderr=subprocess.STDOUT)))
        time.sleep(5)
        for item in list(running):
            key, log, proc = item
            if proc.poll() is not None:
                log.close()
                rcs[key] = proc.returncode
                running.remove(item)
                path = os.path.join(out, f"{key[0]}_s{key[1]}.json")
                print(f"{key[0]} seed {key[1]}: rc {proc.returncode}; "
                      + (open(path).read() if os.path.exists(path) else "no summary"), flush=True)
    collect(out, kinds)
    sys.exit(max(rcs.values(), default=0))


if __name__ == "__main__":
    main()
