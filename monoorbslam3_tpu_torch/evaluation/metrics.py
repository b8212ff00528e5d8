"""Offline metrics and batch evaluation (counterpart of
`monoorbslam3_tpu/evaluation/metrics.py`, the port's own copy).

- velocity accuracy (test/computeVeloAccuracy.cpp:60-93): the mean |v|
  error of the saved per-KF velocities against ground truth;
- trajectory file I/O in TUM format (t x y z qx qy qz qw);
- a batch evaluator like evaluation/result.sh: ATE over a list of
  (estimate, ground-truth) pairs, one table.

Pure numpy on `evaluation/ate.py`.
"""

from __future__ import annotations

import numpy as np

from .ate import associate, ate_rmse


def load_tum(path: str):
    """TUM trajectory: t x y z qx qy qz qw. Returns (t [N], p [N, 3],
    q [N, 4] as (w, x, y, z))."""
    rows = np.atleast_2d(np.loadtxt(path))
    t = rows[:, 0]
    p = rows[:, 1:4]
    q = np.concatenate([rows[:, 7:8], rows[:, 4:7]], axis=1)
    return t, p, q


def load_velocity_file(path: str):
    """Per-KF velocity + bias file (System.cpp:146-165 format):
    t vx vy vz bgx bgy bgz bax bay baz."""
    rows = np.atleast_2d(np.loadtxt(path))
    return rows[:, 0], rows[:, 1:4], rows[:, 4:7], rows[:, 7:10]


def velocity_accuracy(t_est, v_est, t_gt, v_gt, max_dt: float = 0.02):
    """Mean velocity-magnitude error (computeVeloAccuracy.cpp:60-93)."""
    ie, ig = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    if len(ie) == 0:
        return {"mean_speed_err": float("inf"), "n": 0}
    sp_e = np.linalg.norm(np.asarray(v_est)[ie], axis=1)
    sp_g = np.linalg.norm(np.asarray(v_gt)[ig], axis=1)
    vec_err = np.linalg.norm(np.asarray(v_est)[ie] - np.asarray(v_gt)[ig], axis=1)
    return {
        "mean_speed_err": float(np.abs(sp_e - sp_g).mean()),
        "mean_vector_err": float(vec_err.mean()),
        "n": len(ie),
    }


def evaluate_sequences(pairs, max_dt: float = 0.02, with_scale: bool = True, log=print):
    """Batch ATE table (evaluation/result.sh analog). pairs: a list of
    (name, est_path, gt_path) of TUM-format files. Returns a list of dicts
    (name, rmse, scale, n)."""
    results = []
    for name, est_path, gt_path in pairs:
        t_e, p_e, _ = load_tum(est_path)
        t_g, p_g, _ = load_tum(gt_path)
        out = ate_rmse(t_e, p_e, t_g, p_g, max_dt=max_dt, with_scale=with_scale)
        results.append({"name": name, "rmse": out["rmse"], "scale": out.get("scale", 0.0),
                        "n": out["n_matches"]})
        log(f"{name}: ATE RMSE {out['rmse']:.4f} m, scale {out.get('scale', 0):.4f}, "
            f"{out['n_matches']} poses")
    return results
