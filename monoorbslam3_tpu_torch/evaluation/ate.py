"""Trajectory evaluation: association + Horn/Umeyama alignment + ATE RMSE
(counterpart of `monoorbslam3_tpu/evaluation/ate.py`, the port's own copy).

The analog of the reference's offline evaluator (evaluation/compare.py:
6-211): timestamp association, closed-form Sim(3) alignment (with the
monocular scale correction) and ATE RMSE. Pure numpy, the same arithmetic
as the JAX package's file: offline tooling, not a hot path.
"""

from __future__ import annotations

import numpy as np


def associate(t_est: np.ndarray, t_gt: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association (compare.py:6-61). Returns
    (idx_est, idx_gt) index arrays."""
    ie, ig = [], []
    j = 0
    for i, t in enumerate(t_est):
        while j + 1 < len(t_gt) and abs(t_gt[j + 1] - t) < abs(t_gt[j] - t):
            j += 1
        if abs(t_gt[j] - t) <= max_dt:
            ie.append(i)
            ig.append(j)
    return np.asarray(ie, int), np.asarray(ig, int)


def kitti_associate(t_est: np.ndarray, t_gt: np.ndarray,
                    max_dt: float = 0.05):
    """KITTI-style bracketing association (the compare.py:36-60 analog,
    used by the reference's batch evaluation kitti_result.sh): each
    estimate timestamp matches the first ground-truth row at-or-after it,
    falling back to the row just before; ground-truth rows MAY be reused
    by several estimates (KITTI GPS/OXTS rows are sparser than frames).
    Vectorized bracketing instead of the reference's index walk. Returns
    (idx_est, idx_gt)."""
    t_est = np.asarray(t_est)
    t_gt = np.asarray(t_gt)
    j = np.searchsorted(t_gt, t_est)  # first gt >= t
    j_hi = np.clip(j, 0, len(t_gt) - 1)
    j_lo = np.clip(j - 1, 0, len(t_gt) - 1)
    d_hi = np.abs(t_gt[j_hi] - t_est)
    d_lo = np.abs(t_gt[j_lo] - t_est)
    # the reference prefers the at-or-after row, then the predecessor
    use_hi = (j < len(t_gt)) & (d_hi <= max_dt)
    pick = np.where(use_hi, j_hi, j_lo)
    ok = use_hi | (d_lo <= max_dt)
    return np.nonzero(ok)[0], pick[ok]


def umeyama_align(src: np.ndarray, dst: np.ndarray, with_scale: bool = True):
    """Closed-form similarity aligning src -> dst (compare.py:92-137's Horn
    method, in Umeyama form). Returns (s, R, t) with dst ~= s R src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(t_est, p_est, t_gt, p_gt, max_dt: float = 0.02,
             with_scale: bool = True):
    """Associate, align, and compute ATE RMSE (compare.py:159-180).

    Returns dict: rmse, scale, n_matches, errors (per-pose), aligned."""
    ie, ig = associate(np.asarray(t_est), np.asarray(t_gt), max_dt)
    if len(ie) < 3:
        return {"rmse": float("inf"), "scale": 0.0, "n_matches": len(ie)}
    src = np.asarray(p_est)[ie]
    dst = np.asarray(p_gt)[ig]
    s, R, t = umeyama_align(src, dst, with_scale)
    aligned = (s * (R @ src.T)).T + t
    err = np.linalg.norm(aligned - dst, axis=1)
    return {
        "rmse": float(np.sqrt((err**2).mean())),
        "scale": s,
        "n_matches": len(ie),
        "errors": err,
        "aligned": aligned,
        "gt": dst,
        # matched estimate timestamps: lets callers re-emit the aligned
        # trajectory as a valid (re-evaluatable) TUM file
        "t_matched": np.asarray(t_est)[ie],
    }
