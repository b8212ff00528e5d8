"""Trajectory comparison plots + CLI (counterpart of
`monoorbslam3_tpu/evaluation/plots.py`, over the port's own `ate` and
`metrics`).

Offline analog of the reference's plotters (evaluation/plot_results.py:26-40,
plot_trajectory.py, plot_phone_trajectory.py): overlay ground truth against
one or more estimated trajectories (e.g. this framework vs a saved official
ORB-SLAM3 run), each Sim(3)-aligned to the truth, and print the per-estimate
scale error + ATE RMSE the same way compare.py:177-180 does. Pure
numpy/matplotlib — offline tooling, not a hot path.

Usage:
    python -m monoorbslam3_tpu_torch.evaluation.plots GT_TUM EST_TUM [EST_TUM ...]
        [-o out.png] [--labels A B ...] [--max-dt 0.02] [--no-scale]
        [--save-aligned DIR]
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .ate import ate_rmse
from .metrics import load_tum


def compare_trajectories(gt_path: str, est_paths, labels=None,
                         max_dt: float = 0.02, with_scale: bool = True):
    """Align every estimate to the ground truth. Returns
    (t_gt, p_gt, [(label, result-dict), ...]) with each result as returned
    by `ate_rmse` (aligned positions, per-pose errors, rmse, scale)."""
    t_gt, p_gt, _ = load_tum(gt_path)
    basenames = [os.path.splitext(os.path.basename(p))[0] for p in est_paths]
    labels = list(labels) if labels else []
    if len(labels) > len(est_paths):
        raise ValueError(f"{len(labels)} labels for {len(est_paths)} estimates")
    labels = labels + basenames[len(labels):]  # pad missing with basenames
    # uniquify (duplicate labels would overwrite each other's outputs)
    seen: dict[str, int] = {}
    for i, lb in enumerate(labels):
        n = seen.get(lb, 0)
        seen[lb] = n + 1
        if n:
            labels[i] = f"{lb}_{n + 1}"
    out = []
    for label, path in zip(labels, est_paths):
        t_e, p_e, _ = load_tum(path)
        res = ate_rmse(t_e, p_e, t_gt, p_gt, max_dt=max_dt,
                       with_scale=with_scale)
        out.append((label, res))
    return t_gt, p_gt, out


def plot_comparison(gt_path: str, est_paths, out_path: str, labels=None,
                    max_dt: float = 0.02, with_scale: bool = True,
                    save_aligned_dir: str | None = None):
    """Render the truth-vs-estimates x/y overlay (plot_results.py:26-40's
    figure) and return the per-estimate results. Also writes each aligned
    trajectory next to the estimate when `save_aligned_dir` is set (the
    compare.py save-aligned behavior)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    t_gt, p_gt, results = compare_trajectories(
        gt_path, est_paths, labels, max_dt, with_scale)

    fig, ax = plt.subplots(figsize=(7, 7))
    ax.plot(p_gt[:, 0], p_gt[:, 1], "k--", lw=1.2, label="ground truth")
    for label, res in results:
        if "aligned" not in res:
            continue
        a = res["aligned"]
        ax.plot(a[:, 0], a[:, 1], lw=1.0,
                label=f"{label} (ATE {res['rmse']*100:.1f} cm)")
        if save_aligned_dir:
            os.makedirs(save_aligned_dir, exist_ok=True)
            # valid TUM rows (identity quaternions) so the aligned file can
            # be re-fed to the evaluator/plotter
            rows = np.zeros((len(a), 8))
            rows[:, 0] = res["t_matched"]
            rows[:, 1:4] = a
            rows[:, 7] = 1.0
            np.savetxt(os.path.join(save_aligned_dir, f"{label}_aligned.txt"),
                       rows, fmt="%.6f")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_aspect("equal", adjustable="datalim")
    ax.legend(loc="best", fontsize=8)
    ax.set_title("trajectory comparison (Sim(3)-aligned)")
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("gt", help="ground-truth trajectory (TUM format)")
    ap.add_argument("estimates", nargs="+", help="estimated trajectories")
    ap.add_argument("-o", "--out", default="trajectories.png")
    ap.add_argument("--labels", nargs="*", default=None)
    ap.add_argument("--max-dt", type=float, default=0.02)
    ap.add_argument("--no-scale", action="store_true",
                    help="SE(3) alignment instead of Sim(3)")
    ap.add_argument("--save-aligned", default=None, metavar="DIR")
    args = ap.parse_args(argv)

    results = plot_comparison(
        args.gt, args.estimates, args.out, labels=args.labels,
        max_dt=args.max_dt, with_scale=not args.no_scale,
        save_aligned_dir=args.save_aligned)
    for label, res in results:
        # same two lines compare.py prints per run (compare.py:177-180);
        # the scale field only makes sense for a Sim(3) fit that happened
        scale = (f"scale {res['scale']:.4f}  "
                 if not args.no_scale and res.get("n_matches", 0) >= 3 else "")
        print(f"{label}: {scale}ATE RMSE {res['rmse']:.4f} m  "
              f"({res.get('n_matches', 0)} matched poses)")
    print(f"wrote {args.out}")
    return results


if __name__ == "__main__":
    main()
