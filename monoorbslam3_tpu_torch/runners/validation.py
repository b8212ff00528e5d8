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
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

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

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _rss_mb() -> float:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 2**20


def run_world(name, settings, spec, out_dir, device="cuda"):
    """One world through the public path on `device`; writes its estimate
    and ground truth into out_dir and returns run_validation.py's row
    fields (frames, OK frames, LOST events and their times, keyframes,
    imu_state, wall seconds)."""
    import torch

    from ..config import build_system
    from .datasets import run_sequence
    from .synth import SyntheticDataset

    est = os.path.join(out_dir, f"{name}_est.txt")
    gt = os.path.join(out_dir, f"{name}_gt.txt")
    system = build_system(os.path.join(_REPO, settings), device=device)
    dataset = SyntheticDataset(spec, system.camera, system.calib)
    dataset.save_ground_truth(gt)
    on_card = torch.device(device).type == "cuda"

    def log(msg):
        # the host and device memory census of every progress line
        dev = (f" cuda_alloc={torch.cuda.memory_allocated() / 2**20:.0f}MB"
               if on_card else "")
        print(f"{msg} | rss={_rss_mb():.0f}MB{dev}", flush=True)

    t0 = time.perf_counter()
    states = run_sequence(system, dataset, progress_every=100, log=log)
    wall = time.perf_counter() - t0
    system.shutdown()
    system.save_keyframe_trajectory(est)
    lost_at = [float(dataset.times[i]) for i in list(np.nonzero(states == 4)[0])]
    if lost_at:
        print(f"  lost/reset events at t = {lost_at}")
    return {
        "est": est, "gt": gt, "frames": len(states),
        "ok_frames": int((states == 2).sum()),
        "lost_events": int((states == 4).sum()),
        "lost_at": lost_at,
        "n_keyframes": system.store.n_keyframes(),
        "kf_created_total": system.store.kf_created_total,
        "imu_state": int(system.mapper.imu_state),
        "wall_s": wall,
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
            rc = subprocess.call(cmd, stdout=lf, stderr=subprocess.STDOUT, cwd=_REPO)
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
