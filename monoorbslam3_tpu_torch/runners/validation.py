"""Scale-stress validation battery of the port (counterpart of the
repository's `run_validation.py`, the evaluation/result.sh analog).

Runs the synthetic worlds that match a real dataset's shape (60 s+
streams, KITTI-like forward motion, aggressive rotation, low-texture
stretches) end to end through the port's public path (`config.build_system`,
`runners.synth.SyntheticDataset`, `runners.datasets.run_sequence`) on one
device, scores each keyframe trajectory with `evaluation.metrics.
evaluate_sequences` and writes `VALIDATION_<tag>.json` and
`VALIDATION.md` into the output directory, in `run_validation.py`'s schema.
The world table and its bounds are that script's.

Usage:  python -m monoorbslam3_tpu_torch.runners.validation [--out-tag t]
            [--worlds circle60,corridor60,...] [--device cuda|cpu] [--jobs N]
            [--out-dir DIR]
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import resource
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..frontend.tracking import RECENTLY_LOST

# name: (settings, spec, ATE bound [m], scale-error bound), as
# run_validation.py:34-74 fixes them: the bounds are set for the
# no-loop-closure regime (drift of ~1-2% of the path over several laps)
# and were fixed before the battery ran
WORLDS = {
    "circle60": ("settings/synthetic.yaml", "circle:t_end=60,fps=20", 0.8, 0.12),
    "fastspin30": ("settings/synthetic.yaml", "fastspin:t_end=30,fps=20", 0.4, 0.10),
    "lowtex60": ("settings/synthetic.yaml", "lowtex:t_end=60,fps=20", 0.8, 0.20),
    "corridor60": ("settings/synthetic_forward.yaml", "corridor:t_end=60,fps=10", 4.5, 0.25),
    "circlebow30": ("settings/synthetic_vocab.yaml", "circle:t_end=30,fps=20", 0.4, 0.12),
    "circle180": ("settings/synthetic.yaml", "circle:t_end=180,fps=20", 2.5, 0.15),
    "corridor120": ("settings/synthetic_forward.yaml", "corridor:t_end=120,fps=10", 8.0, 0.25),
    "corridor180": ("settings/synthetic_forward.yaml", "corridor:t_end=180,fps=10", 12.0, 0.25),
    "noisy60": ("settings/synthetic.yaml", "noisy:t_end=60,fps=20", 1.2, 0.15),
}

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def _stats(xs):
    """p50, p99, mean, max and n of a list of host times (None if empty)."""
    if not xs:
        return None
    xs = np.asarray(xs, np.float64)
    return dict(p50=float(np.percentile(xs, 50)), p99=float(np.percentile(xs, 99)),
                mean=float(xs.mean()), max=float(xs.max()), n=len(xs))


def _wrap(obj, name, make):
    """Replace obj.name (an instance attribute shadows the class's method,
    so the object's own calls of self.name come through it too) by
    make(the bound original)."""
    setattr(obj, name, make(getattr(obj, name)))


class BatteryMeter:
    """The battery's counters on one System (either package's: every name
    it wraps exists in both). Each is read off host state the run already
    keeps, so counting adds no host sync:

    - each `System.track` call's host time, the mapper steps it ran on its
      own thread taken out, and each mapper step's (`mapper.process`); the
      frames it returns RECENTLY_LOST;
    - the full polishes (`Problems.full_inertial_optimize`) with the
      keyframe count at the call, which picks the branch: the regular
      window up to `local_k` keyframes, the grouped problem up to `full_k`,
      the subsample beyond it (`branch`);
    - the tracker's reference-keyframe matches (`_match_against_ref_kf`);
    - the map store's keyframe slots: culled slots recycled
      (`_alloc_kf_slot` once every slot has been used, with a free one),
      keyframes evicted at capacity (`_evict_for_slot`), and the point
      evictions at capacity (`_evict_points`: calls and points);
    - the memory census of the progress lines (`census`), which the runner
      appends to."""

    def __init__(self, system):
        self.frame_ms, self.steps = [], []  # steps: (host ms, initial)
        self.recently_lost_frames = 0
        self.polish_kf, self.ref_kf_matches = [], 0
        self.kf_slots_recycled = self.kf_evicted = 0
        self.pt_evictions = self.pts_evicted = 0
        self.census = []
        self.local_k, self.full_k = system.problems.local_k, system.problems.full_k
        self.polish_mode = system.problems.full_polish_mode
        self._step_ms_in_frame, self._frame_thread = 0.0, None
        store = system.store

        def track(inner):
            def timed(*a, **k):
                self._step_ms_in_frame, self._frame_thread = 0.0, threading.get_ident()
                t0 = time.perf_counter()
                try:
                    state = inner(*a, **k)
                finally:
                    self.frame_ms.append(1e3 * (time.perf_counter() - t0)
                                         - self._step_ms_in_frame)
                    self._frame_thread = None
                self.recently_lost_frames += state == RECENTLY_LOST
                return state
            return timed

        def process(inner):
            def timed(k, initial=False, **kw):
                t0 = time.perf_counter()
                try:
                    return inner(k, initial=initial, **kw)
                finally:
                    ms = 1e3 * (time.perf_counter() - t0)
                    self.steps.append((ms, bool(initial)))
                    if self._frame_thread == threading.get_ident():
                        self._step_ms_in_frame += ms
            return timed

        def polish(inner):
            def counted(st, *a, **k):
                self.polish_kf.append(st.n_keyframes())
                return inner(st, *a, **k)
            return counted

        def ref_kf(inner):
            def counted(*a, **k):
                self.ref_kf_matches += 1
                return inner(*a, **k)
            return counted

        def alloc(inner):
            def counted():
                if store._next_kf_slot >= store.max_kf and store._free_kf:
                    self.kf_slots_recycled += 1
                return inner()
            return counted

        def evict_kf(inner):
            def counted():
                self.kf_evicted += 1
                return inner()
            return counted

        def evict_pts(inner):
            def counted(*a, **k):
                n0 = int(store.pt_valid.sum())
                out = inner(*a, **k)
                self.pt_evictions += 1
                self.pts_evicted += n0 - int(store.pt_valid.sum())
                return out
            return counted

        _wrap(system, "track", track)
        _wrap(system.mapper, "process", process)
        _wrap(system.problems, "full_inertial_optimize", polish)
        _wrap(system.tracking, "_match_against_ref_kf", ref_kf)
        _wrap(store, "_alloc_kf_slot", alloc)
        _wrap(store, "_evict_for_slot", evict_kf)
        _wrap(store, "_evict_points", evict_pts)

    def branch(self, n_kf):
        """The branch a full polish over n_kf keyframes takes
        (`Problems.full_inertial_optimize`): "window", "grouped" (K4's
        large-D route at D = 15 full_k) or "subsampled" (beyond full_k; in
        the "hybrid" mode the stride subsample capped at local_k)."""
        if n_kf <= self.local_k:
            return "window"
        return "grouped" if n_kf <= self.full_k else "subsampled"

    def counters(self):
        """The counts, as a row's fields."""
        by = collections.Counter(self.branch(n) for n in self.polish_kf)
        return {
            "polishes": dict(n=len(self.polish_kf), mode=self.polish_mode,
                             window=by["window"], grouped=by["grouped"],
                             subsampled=by["subsampled"], kf_counts=list(self.polish_kf)),
            "kf_slots_recycled": self.kf_slots_recycled, "kf_evicted": self.kf_evicted,
            "pt_evictions": self.pt_evictions, "pts_evicted": self.pts_evicted,
            "recently_lost_frames": self.recently_lost_frames,
            "ref_kf_matches": self.ref_kf_matches,
            "n_mapper_steps": sum(1 for _, initial in self.steps if not initial),
        }

    def times(self):
        """Frame and mapper-step host times (ms; the bootstrap's initial
        steps left out of the steps)."""
        return {"frame_ms": _stats(self.frame_ms),
                "mapper_ms": _stats([ms for ms, initial in self.steps if not initial])}


def run_world(name, settings, spec, out_dir, device="cuda", frames=None, instrument=None):
    """One world through the public path on `device`; writes its estimate
    and ground truth into out_dir and returns run_validation.py's row
    fields (frames, OK frames, LOST events and their times, keyframes,
    imu_state, wall seconds) and the battery's own (`BatteryMeter`'s
    counters and, on the card, its times; the memory
    census of the first and last progress lines and the peak host RSS;
    the hand kernels' launches, and their builds after the warm-up).
    `frames`: where the frames come from, an object with the dataset's
    `frames()` (by default the dataset itself). `instrument(system)`, if
    given, runs after the warm-up and the meter and may return a context
    manager, which is entered around the stream."""
    import torch

    from ..config import build_system
    from ..measure.timing import NOT_MEASURED, device_identity
    from ..ops import cuda_lib
    from .datasets import run_sequence
    from .synth import SyntheticDataset

    est = os.path.join(out_dir, f"{name}_est.txt")
    gt = os.path.join(out_dir, f"{name}_gt.txt")
    system = build_system(os.path.join(REPO, settings), device=device)
    dataset = SyntheticDataset(spec, system.camera, system.calib)
    dataset.save_ground_truth(gt)
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter()
    system.warmup()
    warmup_s = time.perf_counter() - t0
    meter = BatteryMeter(system)
    ctx = (instrument(system) if instrument is not None else None) or contextlib.nullcontext()
    built, launches0 = dict(cuda_lib.builds), dict(cuda_lib.launches)

    def log(msg):
        # the host and device memory census of every progress line (the
        # allocator's own counters: no device sync)
        row = dict(frame=len(meter.frame_ms) - 1, rss_mb=_rss_mb())
        dev = ""
        if on_card:
            row.update(alloc_mb=torch.cuda.memory_allocated() / 2**20,
                       reserved_mb=torch.cuda.memory_reserved() / 2**20)
            dev = f" cuda_alloc={row['alloc_mb']:.0f}MB cuda_reserved={row['reserved_mb']:.0f}MB"
        if msg.startswith("frame "):
            meter.census.append(row)
        print(f"{msg} | rss={row['rss_mb']:.0f}MB{dev}", flush=True)

    t0 = time.perf_counter()
    with ctx:
        states = run_sequence(system, dataset if frames is None else frames,
                              progress_every=100, log=log)
    wall = time.perf_counter() - t0
    system.shutdown()
    system.save_keyframe_trajectory(est)
    lost_at = [float(dataset.times[i]) for i in list(np.nonzero(states == 4)[0])]
    if lost_at:
        print(f"  lost/reset events at t = {lost_at}")
    census = meter.census
    return {
        "est": est, "gt": gt, "frames": len(states),
        "ok_frames": int((states == 2).sum()),
        "lost_events": int((states == 4).sum()),
        "lost_at": lost_at,
        "n_keyframes": system.store.n_keyframes(),
        "kf_created_total": system.store.kf_created_total,
        "imu_state": int(system.mapper.imu_state),
        "wall_s": wall,
        "device": device_identity(device),
        "warmup_s": warmup_s if on_card else NOT_MEASURED,
        **meter.counters(),
        **(meter.times() if on_card else {"frame_ms": NOT_MEASURED, "mapper_ms": NOT_MEASURED}),
        "memory": dict(first=census[0] if census else None, last=census[-1] if census else None,
                       census=census),
        "peak_rss_mb": resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024,
        "launches": {k: cuda_lib.launches[k] - launches0[k] for k in launches0},
        "kernel_builds_after_warmup": {k: cuda_lib.builds[k] - built[k] for k in built},
    }


def _path_length(gt_file: str) -> float:
    """Ground-truth path length [m] for the %-of-path drift."""
    pos = np.loadtxt(gt_file, usecols=(1, 2, 3))
    return float(np.linalg.norm(np.diff(pos, axis=0), axis=1).sum())


def score_world(name, info):
    """run_validation.py's row: the ATE (evaluate_sequences, max_dt 0.05),
    the scale error, the %-of-path drift and the pass verdict."""
    from ..evaluation.metrics import evaluate_sequences

    settings, spec, ate_bound, scale_bound = WORLDS[name]
    if os.path.getsize(info["est"]) == 0:
        res = {"rmse": float("inf"), "scale": 0.0, "n": 0}
    else:
        (res,) = evaluate_sequences([(name, info["est"], info["gt"])], max_dt=0.05)
    scale_err = abs(res["scale"] - 1.0)
    path_len = _path_length(info["gt"])
    ok = res["rmse"] <= ate_bound and scale_err <= scale_bound and info["lost_events"] == 0
    return {**info, "name": name, "spec": spec, "ate_rmse": res["rmse"], "scale_err": scale_err,
            "path_len_m": round(path_len, 1),
            "ate_pct_of_path": round(100.0 * res["rmse"] / max(path_len, 1e-9), 3),
            "matched": res["n"], "bound_ate": ate_bound, "bound_scale": scale_bound,
            "pass": bool(ok)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out-tag", default="torch")
    ap.add_argument("--worlds", default=",".join(WORLDS))
    ap.add_argument("--device", default="cuda",
                    help="torch device of every world (default: the CUDA card)")
    ap.add_argument("--out-dir", default=os.path.join(tempfile.gettempdir(), "validation_torch"),
                    help="where the trajectories, the logs, VALIDATION_<tag>.json and "
                         "VALIDATION.md go")
    ap.add_argument("--jobs", type=int, default=1,
                    help="run worlds in N parallel subprocesses (each world is an independent "
                         "deterministic process; the merged artifact is a sequential run's)")
    ap.add_argument("--no-md", action="store_true",
                    help="suppress VALIDATION.md (used by --jobs children)")
    args = ap.parse_args(argv)
    for name in args.worlds.split(","):
        if name not in WORLDS:
            raise SystemExit(f"unknown world {name!r}; known: {', '.join(WORLDS)}")
    os.makedirs(args.out_dir, exist_ok=True)
    if args.jobs > 1:
        return _main_parallel(args)

    rows = []
    for name in args.worlds.split(","):
        settings, spec, _, _ = WORLDS[name]
        print(f"=== {name}: {spec} ({settings}) on {args.device} ===", flush=True)
        row = score_world(name, run_world(name, settings, spec, args.out_dir, args.device))
        rows.append(row)
        print(f"  -> ATE {row['ate_rmse'] * 100:.1f} cm ({row['ate_pct_of_path']:.2f}% of "
              f"{row['path_len_m']:.0f} m path), scale err {row['scale_err'] * 100:.1f}%, "
              f"lost {row['lost_events']}, {'PASS' if row['pass'] else 'FAIL'}", flush=True)
    _finish(args, rows)
    return rows


def _finish(args, rows, jobs=1):
    with open(os.path.join(args.out_dir, f"VALIDATION_{args.out_tag}.json"), "w") as f:
        json.dump(rows, f, indent=1)
    if not args.no_md:
        _write_md(os.path.join(args.out_dir, "VALIDATION.md"), args, rows, jobs)
    print(json.dumps({"metric": "validation_pass_rate",
                      "value": sum(r["pass"] for r in rows) / len(rows),
                      "unit": "fraction", "worlds": len(rows)}))


def _write_md(path, args, rows, jobs=1):
    with open(path, "w") as f:
        f.write("# Scale-stress validation battery\n\n")
        f.write(f"Generated by `python -m monoorbslam3_tpu_torch.runners.validation --out-tag "
                f"{args.out_tag} --device {args.device}` (the PyTorch port; worlds stream "
                f"through the runner path `runners.datasets.run_sequence`"
                f"{f'; {jobs} parallel world subprocesses' if jobs > 1 else ''}).\n\n")
        f.write("| world | spec | frames | tracked | lost | KFs (created) | "
                "ATE RMSE | % of path | scale err | bound | result |\n")
        f.write("|---|---|---|---|---|---|---|---|---|---|---|\n")
        for r in rows:
            f.write(f"| {r['name']} | `{r['spec']}` | {r['frames']} | {r['ok_frames']} | "
                    f"{r['lost_events']} | {r['n_keyframes']} ({r['kf_created_total']}) | "
                    f"{r['ate_rmse'] * 100:.1f} cm | {r.get('ate_pct_of_path', 0):.2f}% of "
                    f"{r.get('path_len_m', 0):.0f} m | {r['scale_err'] * 100:.1f}% | "
                    f"{r['bound_ate'] * 100:.0f} cm | {'PASS' if r['pass'] else 'FAIL'} |\n")


def _failed_row(name):
    return {"name": name, "spec": WORLDS[name][1], "frames": 0, "ok_frames": 0,
            "lost_events": -1, "n_keyframes": 0, "kf_created_total": 0, "imu_state": 0,
            "wall_s": 0.0, "est": "", "gt": "", "ate_rmse": float("inf"), "scale_err": 1.0,
            "matched": 0, "bound_ate": WORLDS[name][2], "bound_scale": WORLDS[name][3],
            "pass": False}


def _main_parallel(args):
    """Each world in its own subprocess, N at a time, then the per-world
    artifacts merged into the battery's (the same rows as a sequential
    run: each world is an independent deterministic process)."""
    names = args.worlds.split(",")

    def run_one(name):
        tag = f"{args.out_tag}__{name}"
        cmd = [sys.executable, "-m", "monoorbslam3_tpu_torch.runners.validation",
               "--out-tag", tag, "--worlds", name, "--device", args.device,
               "--out-dir", args.out_dir, "--no-md"]
        log_path = os.path.join(args.out_dir, f"{name}.log")
        with open(log_path, "w") as lf:
            rc = subprocess.call(cmd, stdout=lf, stderr=subprocess.STDOUT, cwd=REPO)
        if rc != 0:
            print(f"!! world {name} subprocess failed rc={rc} (log: {log_path})", flush=True)
            return [_failed_row(name)]
        part = os.path.join(args.out_dir, f"VALIDATION_{tag}.json")
        with open(part) as f:
            rows = json.load(f)
        os.remove(part)
        for r in rows:
            print(f"[{name}] ATE {r['ate_rmse'] * 100:.1f} cm, scale err "
                  f"{r['scale_err'] * 100:.1f}%, lost {r['lost_events']}, "
                  f"{'PASS' if r['pass'] else 'FAIL'}", flush=True)
        return rows

    with ThreadPoolExecutor(max_workers=args.jobs) as ex:
        results = list(ex.map(run_one, names))
    rows = [r for rs in results for r in rs]
    _finish(args, rows, jobs=args.jobs)
    return rows


if __name__ == "__main__":
    main()
