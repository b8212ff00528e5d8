"""The port and the JAX package in lock step: the same world, the same seed.

Runs one battery world (`monoorbslam3_tpu_torch.runners.validation.WORLDS`,
the table of run_validation.py) through each package's public path on the
CPU: `config.build_system` of the world's settings with the tracker's
`seed` in `config_overrides`, `runners.synth.SyntheticDataset` of its spec,
`runners.datasets.run_sequence`, `shutdown`, the keyframe trajectory scored
by `evaluation.metrics.evaluate_sequences` (max_dt 0.05, as
run_validation.py scores it). Since the port draws the JAX package's RANSAC
samples (`utils.prng`), a seed names the same bootstrap in both, and no
draw is injected. Each run is a process of its own (`--jobs` at a time);
the port's half imports nothing of JAX.

`Recorder` stands in front of either package's `System` and records, per
frame: the state, n_tracked, the keyframe count, `imu_state`, the frame's
position when it tracks, whether the frame made a keyframe, and the
scale of any gauge rewrite; per mapper step: each call of the named
problems (`initial_optimize`, the local BAs, `inertial_optimize`, the full
polish `full_inertial_optimize`) with its costs and, for the inertial
init, its scale. `first_parting` reads two records and returns the first
frame at which the runs part:

- the state differs;
- the keyframe counts are more than 1 apart, or stay 1 apart for more
  than 10 frames;
- n_tracked differs by more than 10% of the JAX run's;
- the positions are further apart than 1% of the distance the JAX run
  travelled since its first keyframe (its path in its own gauge, rescaled
  at each gauge rewrite).

Prints one JSON line a seed (the first parting frame and rule, the first
break of each rule and how many frames break it, each run's
keyframe ATE and scale error, the inertial init's frame, scale and costs,
the agreement counts) and writes each run's record to `--out`
(`<world>_s<seed>_<jax|port>.json`, beside its trajectory files).

Each run's numpy BLAS and torch run at `--threads` threads (1 by default):
the JAX package's own outcome moves with numpy's BLAS thread count (its
host solves sum in another order), so both halves run at one setting.
`--child jax|port` runs one half alone in this process, under the
environment's BLAS threads, and writes its record; `compare(world, seed,
ref, port)` holds any two records against each other (a JAX run against
another JAX run, too).

    python experiments/port_lockstep_jax.py [--world circlebow30] [--seeds 0]
        [--frames N] [--out DIR] [--jobs 2] [--threads 1]
    python experiments/port_lockstep_jax.py --child jax --world circlebow30 --seed 0 --out DIR

A 600-frame world takes 25-30 minutes a JAX run and 35-45 a port run at
one thread, six runs at a time on an 8-core CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

OK = 2
KF_GAP, KF_GAP_FRAMES, N_TRACKED_RTOL, POS_RTOL = 1, 10, 0.10, 0.01
# the named problems a run's record follows, and the fields kept of each
PROBLEMS = ("initial_optimize", "local_bundle_adjustment", "local_full_bundle_adjustment",
            "inertial_optimize", "full_inertial_optimize")
FIELDS = ("cost0", "cost", "scale")


def _vec(x):
    return [float(v) for v in np.asarray(x, np.float64).reshape(-1)]


class Recorder:
    """Stands in front of a `System` of either package: its entry `entry`
    (`track` or `track_features`), its mapper's `process`, the named
    problems of its `Problems` and its store's `apply_scale_rotation`, all
    on the instance. `frames` and `steps` hold the records (module
    docstring)."""

    def __init__(self, syst, entry="track"):
        self.syst = syst
        self.frames, self.steps = [], []
        self._calls = None  # the list the named problems append to
        self._store = None
        self._kf0 = None
        inner = getattr(syst, entry)
        setattr(syst, entry, lambda *a, **k: self._frame(inner, *a, **k))
        process = syst.mapper.process
        syst.mapper.process = lambda *a, **k: self._step(process, *a, **k)
        for name in PROBLEMS:
            self._note(syst.problems, name)

    def _note(self, problems, name):
        inner = getattr(problems, name)

        def wrapped(*a, **k):
            out = inner(*a, **k)
            row = dict(name=name)
            if isinstance(out, dict):
                row.update({f: float(out[f]) for f in FIELDS if f in out})
            if self._calls is not None:
                self._calls.append(row)
            return out

        setattr(problems, name, wrapped)

    def _watch_store(self):
        store = self.syst.store
        if store is self._store:
            return
        self._store = store
        inner = store.apply_scale_rotation

        def wrapped(R, scale, *a, **k):
            self._gauge *= float(scale)
            return inner(R, scale, *a, **k)

        store.apply_scale_rotation = wrapped

    def _frame(self, track, *args, **kwargs):
        self._watch_store()
        syst, store = self.syst, self.syst.store
        self._gauge, created = 1.0, int(store.kf_created_total)
        calls = self._calls = []
        state = int(track(*args, **kwargs))
        self._calls = None
        self._watch_store()
        store = syst.store
        last = syst.tracking.last_frame  # None after a reset inside the frame
        ok = state == OK and last is not None
        rec = dict(frame=len(self.frames), state=state,
                   n_tracked=int(last.n_tracked) if last is not None else 0,
                   n_kf=int(store.n_keyframes()), imu_state=int(syst.mapper.imu_state),
                   kf_made=int(store.kf_created_total) > created,
                   pos=_vec(last.state.t_wb) if ok else None,
                   gauge=self._gauge if self._gauge != 1.0 else None, calls=calls)
        if ok and self._kf0 is None:
            self._kf0 = rec["kf0"] = _vec(store.kf_t[store.keyframe_ids()[0]])
        self.frames.append(rec)
        return state

    def _step(self, process, k, *args, **kwargs):
        outer = self._calls
        self._calls = []
        step = dict(frame=len(self.frames), kf=int(k), calls=self._calls)
        try:
            return process(k, *args, **kwargs)
        finally:
            self.steps.append(step)
            self._calls = outer

    def record(self):
        return dict(frames=self.frames, steps=self.steps)


def travelled(frames):
    """Per frame, the distance the run travelled since its first keyframe,
    in the run's gauge of that frame (None before the bootstrap): the path
    of its tracked positions, rescaled by each gauge rewrite's scale; a
    frame that rewrote the gauge adds no step."""
    out, dist, prev = [], None, None
    for r in frames:
        if dist is not None and r["gauge"] is not None:
            dist, prev = dist * r["gauge"], None
        if r["pos"] is not None:
            p = np.asarray(r["pos"])
            if dist is None and "kf0" in r:
                dist = float(np.linalg.norm(p - np.asarray(r["kf0"])))
            elif dist is not None and prev is not None:
                dist += float(np.linalg.norm(p - prev))
            prev = p
        out.append(dist)
    return out


def _breaks(ref, port):
    """Each frame at which the port's record `port` breaks a rule of the
    module docstring against the JAX run's `ref`, in frame order: a dict of
    the frame, the rule and both values."""
    gap_run = 0
    dist = travelled(ref["frames"])
    for a, b, d in zip(ref["frames"], port["frames"], dist):
        i = a["frame"]
        if a["state"] != b["state"]:
            yield dict(frame=i, rule="state", jax=a["state"], port=b["state"])
        gap = abs(a["n_kf"] - b["n_kf"])
        gap_run = gap_run + 1 if gap == KF_GAP else 0
        if gap > KF_GAP or gap_run > KF_GAP_FRAMES:
            yield dict(frame=i, rule="keyframes", jax=a["n_kf"], port=b["n_kf"],
                       frames_apart=gap_run)
        if a["state"] != OK or b["state"] != OK:
            continue
        if abs(a["n_tracked"] - b["n_tracked"]) > N_TRACKED_RTOL * a["n_tracked"]:
            yield dict(frame=i, rule="n_tracked", jax=a["n_tracked"], port=b["n_tracked"])
        if a["pos"] is not None and b["pos"] is not None and d is not None:
            sep = float(np.linalg.norm(np.asarray(a["pos"]) - np.asarray(b["pos"])))
            if sep > POS_RTOL * d:
                yield dict(frame=i, rule="position", gap=sep, travelled=d)
    if len(ref["frames"]) != len(port["frames"]):
        yield dict(frame=min(len(ref["frames"]), len(port["frames"])), rule="length")


def first_parting(ref, port):
    """The first frame at which the two runs part (`_breaks`), or None if
    they keep together."""
    return next(_breaks(ref, port), None)


def partings(ref, port):
    """The first break of each rule, and how many frames break it."""
    out = {}
    for br in _breaks(ref, port):
        first = out.setdefault(br["rule"], dict(br, frames=0))
        first["frames"] += 1
    return out


def _init(rec):
    """The inertial init of a record: its frame and the accepted call's
    scale and costs (None if the run never initialized)."""
    frame = next((r["frame"] for r in rec["frames"] if r["imu_state"] >= 1), None)
    if frame is None:
        return None
    calls = [c for s in rec["steps"] if s["frame"] == frame for c in s["calls"]
             if c["name"] == "inertial_optimize"]
    return dict(frame=frame, **(calls[-1] if calls else {}))


def agreement(ref, port):
    """Counts over the frames both runs have: equal states, equal keyframe
    counts, the largest n_tracked gap (relative to the JAX run's), the
    largest position gap (metres after the init, the map's units before)
    and the largest gap over the distance travelled."""
    rows = list(zip(ref["frames"], port["frames"], travelled(ref["frames"])))
    both = [(a, b, d) for a, b, d in rows
            if a["pos"] is not None and b["pos"] is not None]
    gaps = [float(np.linalg.norm(np.asarray(a["pos"]) - np.asarray(b["pos"]))) for a, b, _ in both]
    rel = [g / d for g, (_, _, d) in zip(gaps, both) if d]
    nt = [abs(a["n_tracked"] - b["n_tracked"]) / a["n_tracked"] for a, b, _ in both
          if a["n_tracked"]]
    return dict(frames=len(rows), states_equal=sum(a["state"] == b["state"] for a, b, _ in rows),
                n_kf_equal=sum(a["n_kf"] == b["n_kf"] for a, b, _ in rows),
                n_tracked_equal=sum(a["n_tracked"] == b["n_tracked"] for a, b, _ in both),
                n_tracked_max_rel=max(nt, default=None), pos_gap_max=max(gaps, default=None),
                pos_gap_max_rel=max(rel, default=None))


# ---------------------------------------------------------------------------
# the two halves: each runs in a process of its own
# ---------------------------------------------------------------------------


def _drive(syst, dataset, frames, est, gt, evaluate_sequences, run_sequence):
    rec = Recorder(syst)
    t0 = time.perf_counter()
    run_sequence(syst, dataset, max_frames=frames, progress_every=0)
    syst.shutdown()
    syst.save_keyframe_trajectory(est)
    dataset.save_ground_truth(gt)
    if os.path.getsize(est) == 0:
        ate = dict(rmse=float("inf"), scale=0.0, n=0)
    else:
        (ate,) = evaluate_sequences([("lockstep", est, gt)], max_dt=0.05)
    out = rec.record()
    out.update(ate_m=float(ate["rmse"]), scale_err=abs(float(ate["scale"]) - 1.0),
               ate_matched=int(ate["n"]), n_kf=int(syst.store.n_keyframes()),
               seconds=time.perf_counter() - t0)
    return out


def run_port(world, seed, frames, out_dir, threads):
    """The port's run of `world` at `seed` on the CPU (imports no JAX)."""
    import torch

    from monoorbslam3_tpu_torch.config import build_system
    from monoorbslam3_tpu_torch.evaluation.metrics import evaluate_sequences
    from monoorbslam3_tpu_torch.runners.datasets import run_sequence
    from monoorbslam3_tpu_torch.runners.synth import SyntheticDataset
    from monoorbslam3_tpu_torch.runners.validation import WORLDS

    torch.set_num_threads(threads)
    settings, spec = WORLDS[world][:2]
    syst = build_system(os.path.join(ROOT, settings), device="cpu",
                        config_overrides={"seed": seed})
    dataset = SyntheticDataset(spec, syst.camera, syst.calib)
    tag = os.path.join(out_dir, f"{world}_s{seed}_port")
    return _drive(syst, dataset, frames, tag + "_est.txt", tag + "_gt.txt",
                  evaluate_sequences, run_sequence)


def run_jax(world, seed, frames, out_dir):
    """The JAX package's run of `world` at `seed` on the CPU."""
    import tests.conftest  # noqa: F401  (JAX on the CPU backend)
    from monoorbslam3_tpu.config import build_system
    from monoorbslam3_tpu.evaluation.metrics import evaluate_sequences
    from monoorbslam3_tpu.runners.datasets import run_sequence
    from monoorbslam3_tpu.runners.synth import SyntheticDataset
    from monoorbslam3_tpu_torch.runners.validation import WORLDS

    settings, spec = WORLDS[world][:2]
    syst = build_system(os.path.join(ROOT, settings), config_overrides={"seed": seed})
    dataset = SyntheticDataset(spec, syst.camera, syst.calib)
    tag = os.path.join(out_dir, f"{world}_s{seed}_jax")
    return _drive(syst, dataset, frames, tag + "_est.txt", tag + "_gt.txt",
                  evaluate_sequences, run_sequence)


def _child(args):
    if args.child == "port":
        rec = run_port(args.world, args.seed, args.frames, args.out, args.threads)
    else:
        rec = run_jax(args.world, args.seed, args.frames, args.out)
    path = os.path.join(args.out, f"{args.world}_s{args.seed}_{args.child}.json")
    with open(path, "w") as f:
        json.dump(rec, f)
    print(path, flush=True)


def _spawn(package, world, seed, args):
    cmd = [sys.executable, os.path.abspath(__file__), "--child", package, "--world", world,
           "--seed", str(seed), "--out", args.out, "--threads", str(args.threads)]
    if args.frames is not None:
        cmd += ["--frames", str(args.frames)]
    env = dict(os.environ, OMP_NUM_THREADS=str(args.threads))
    log = os.path.join(args.out, f"{world}_s{seed}_{package}.log")
    with open(log, "w") as f:
        proc = subprocess.run(cmd, stdout=f, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    path = os.path.join(args.out, f"{world}_s{seed}_{package}.json")
    if proc.returncode or not os.path.exists(path):
        raise RuntimeError(f"{package} run of {world} seed {seed} failed "
                           f"(exit {proc.returncode}); see {log}")
    with open(path) as f:
        return json.load(f)


def compare(world, seed, ref, port):
    """One seed's line: the first parting, both runs' outcomes and the
    agreement counts."""
    return dict(world=world, seed=seed, parting=first_parting(ref, port),
                partings=partings(ref, port),
                jax=dict(ate_m=ref["ate_m"], scale_err=ref["scale_err"], n_kf=ref["n_kf"],
                         init=_init(ref), seconds=ref["seconds"]),
                port=dict(ate_m=port["ate_m"], scale_err=port["scale_err"], n_kf=port["n_kf"],
                          init=_init(port), seconds=port["seconds"]),
                ate_ratio=port["ate_m"] / ref["ate_m"] if ref["ate_m"] else None,
                agreement=agreement(ref, port))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", default="circlebow30")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames a run (the whole world by default)")
    ap.add_argument("--out", default=None, help="directory of the records (a temporary one "
                    "by default)")
    ap.add_argument("--jobs", type=int, default=2, help="runs at a time")
    ap.add_argument("--threads", type=int, default=1,
                    help="numpy BLAS and torch threads of each run")
    ap.add_argument("--child", choices=("port", "jax"), default=None,
                    help="run this package's half alone (at --seed) and write its record")
    ap.add_argument("--seed", type=int, default=0, help="the seed of a --child run")
    args = ap.parse_args(argv)
    args.out = os.path.abspath(args.out or tempfile.mkdtemp())
    os.makedirs(args.out, exist_ok=True)
    if args.child:
        _child(args)
        return 0
    seeds = [int(s) for s in args.seeds.split(",")]
    runs = [(p, s) for s in seeds for p in ("jax", "port")]
    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        recs = dict(zip(runs, ex.map(lambda ps: _spawn(ps[0], args.world, ps[1], args), runs)))
    for s in seeds:
        print(json.dumps(compare(args.world, s, recs[("jax", s)], recs[("port", s)])),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
