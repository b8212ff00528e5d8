"""Local-BA iteration rate and tracking-step rate on the card (counterpart
of the repository's `bench.py`).

Prints one JSON line:

    {"metric": "local_ba_iters_per_s", "value": N, "unit": "iters/s",
     "vs_baseline": R, "cost0": ..., "cost": ..., "grouped_polish_iters_per_s": ...,
     "frontend_fps": ..., "frontend_vs_20hz": ..., "timing": {...},
     "setup_s": ..., "device": {card name, count, power limit}}

The window is `bench_window.build_problem(seed=0)`: 24 optimized + 8
fixed keyframes, 2,048 points, 6,144 observations, inertial and
bias-walk edges (the reference's local-BA shape). An iteration is a full
relinearization, the landmark Schur elimination, the reduced-camera
solve (K4) and the retraction: one g2o LM iteration's work. The headline
is the flat layout; the grouped layout (`grouped_obs=192`, the full
polish's) is secondary. The frontend rate is the graft entry's tracking
step (752x480, 1,024 features: extraction with K1, the gated match K2,
the pose LM) on its seeded inputs.

Timing: the JAX script times N whole solves inside one `lax.scan`;
eager torch has no such dispatch, so each solve (or step) is timed on the
host clock up to `torch.cuda.synchronize()` (`timing.step_time`), after a
warm-up, over `reps` samples: the median, the quartiles and n. A solve is
~570 launches an iteration with the device mostly idle, so these are
host-bound rates and spread between calls; compare two codes only within
one call. The first solve and the warm-ups (with the kernels' nvcc build
at first use) are reported as `setup_s`, outside every rate.

The baseline is the desktop reference of the JAX script: single-thread
g2o runs this window at roughly 25-50 LM iterations/s, taken as 40.

    python -m monoorbslam3_tpu_torch.measure.bench            # the card
    python -m monoorbslam3_tpu_torch.measure.bench --device cpu   # costs only

With `--device cpu` every device metric reads "not measured"; the costs are
computed all the same. Without a card and without `--device cpu` it raises.
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from ..backend.solver import schur_ba
from ..bench_window import build_problem
from ..graft_entry import flagship, seeded_inputs, upload
from ..utils.device import CARD, resolve
from ..utils.fetch import SyncCounter, fetch
from .timing import NOT_MEASURED, device_identity, step_time

G2O_BASELINE_ITERS_PER_S = 40.0
N_ITERS = 10
REPS = 15
WINDOW = dict(n_kf=32, n_fixed=8, n_pts=2048, obs_per_kf=192)
FRONTEND = (480, 752, 1024)  # H, W, features of the graft entry's step


def _rate(timing, work=1.0):
    """`work` per second at a `step_time` result's median and quartiles (the
    slow quartile first)."""
    return dict(median=1e3 * work / timing["median_ms"], q25=1e3 * work / timing["q75_ms"],
                q75=1e3 * work / timing["q25_ms"], n=timing["n"])


def bench(device=CARD, window=None, frontend=FRONTEND, reps=REPS) -> dict:
    """The bench's JSON object on `device`, for `window`
    (`bench_window.build_problem`'s sizes; the bench window by default)
    and the tracking step at `frontend` = (H, W, features)."""
    dev = resolve(device)
    on_card = dev.type == "cuda"
    win = dict(WINDOW, **(window or {}))
    t_setup = time.perf_counter()
    problem, cam = build_problem(seed=0, device=dev, **win)
    R_cb, t_cb = torch.eye(3, device=dev), torch.zeros(3, device=dev)

    def solve():
        return schur_ba(problem, cam, R_cb, t_cb, n_iters=N_ITERS)

    def solve_grouped():
        return schur_ba(problem, cam, R_cb, t_cb, n_iters=N_ITERS, grouped_obs=win["obs_per_kf"])

    _, _, info = solve()
    costs = fetch(dict(cost0=info["cost0"], cost=info["cost"]), SyncCounter())
    step, _ = flagship(dev, *frontend)
    args = upload(seeded_inputs(*frontend), dev)
    _, _, n_inl = step(*args)  # a failure of the frontend raises here
    out = {
        "metric": "local_ba_iters_per_s", "value": NOT_MEASURED, "unit": "iters/s",
        "vs_baseline": NOT_MEASURED, "baseline_iters_per_s": G2O_BASELINE_ITERS_PER_S,
        "window": (f"{win['n_kf'] - win['n_fixed']} opt + {win['n_fixed']} fixed KFs, "
                   f"{win['n_pts']} pts, {win['n_kf'] * win['obs_per_kf']} obs, VI edges"),
        "n_iters": N_ITERS, "cost0": float(costs["cost0"]), "cost": float(costs["cost"]),
        "grouped_polish_iters_per_s": NOT_MEASURED,
        "frontend": f"{frontend[1]}x{frontend[0]}, {frontend[2]} features",
        "frontend_inliers": int(n_inl), "frontend_fps": NOT_MEASURED,
        "frontend_vs_20hz": NOT_MEASURED, "timing": NOT_MEASURED, "setup_s": NOT_MEASURED,
        "device": device_identity(dev),
    }
    if not on_card:
        return out
    solve_grouped()
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t_setup
    flat = step_time(solve, 1, reps)
    grouped = step_time(solve_grouped, 1, reps)
    front = step_time(lambda: step(*args), 1, reps)
    flat["iters_per_s"] = _rate(flat, N_ITERS)
    grouped["iters_per_s"] = _rate(grouped, N_ITERS)
    front["fps"] = _rate(front)
    ips = flat["iters_per_s"]["median"]
    fps = front["fps"]["median"]
    out.update(value=ips, vs_baseline=ips / G2O_BASELINE_ITERS_PER_S,
               grouped_polish_iters_per_s=grouped["iters_per_s"]["median"],
               frontend_fps=fps, frontend_vs_20hz=fps / 20.0,
               timing=dict(local_ba=flat, grouped_polish=grouped, frontend=front))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=CARD.type, help="cuda (the card, default) or cpu")
    ap.add_argument("--reps", type=int, default=REPS, help="timed samples of each rate (>= 10)")
    args = ap.parse_args(argv)
    if args.reps < 10:
        ap.error("--reps must be at least 10")
    out = bench(args.device, reps=args.reps)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
