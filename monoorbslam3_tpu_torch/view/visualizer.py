"""Offline visualization, the reference View layer without Pangolin
(counterpart of `monoorbslam3_tpu/view/visualizer.py`).

The reference renders live through a Pangolin GL thread (modules/View/
Viewer.cpp, MapDrawer.cpp, FrameDrawer.cpp); a headless runtime renders
artifacts instead:

- `draw_frame`      <- FrameDrawer::DrawFrame (keypoint boxes + status text)
- `draw_map`        <- MapDrawer (map points, keyframe directions,
  covisibility), drawn from a `map_snapshot`: host numpy copies of what the
  drawer needs, so that a caller can take the snapshot under the map lock
  and render outside it
- `draw_trajectory` -> 2D truth-vs-estimate plot (evaluation/plot_*.py)

The drawers return matplotlib figures (callers save PNGs); matplotlib is
imported lazily, so the runtime does not depend on it. Host numpy only: no
device tensor is read here (`host_extrinsics` reads the calibration's
once).
"""

from __future__ import annotations

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def host_extrinsics(calib):
    """(R_cb, t_cb) of an `ImuCalib` as host numpy (one read each)."""
    return calib.R_cb.cpu().numpy(), calib.t_cb.cpu().numpy()


def draw_frame(image: np.ndarray, xy: np.ndarray, tracked: np.ndarray, state_text: str = ""):
    """Keypoint overlay: green boxes for tracked features, blue for
    untracked (FrameDrawer.cpp:17-109)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(9, 6))
    ax.imshow(image, cmap="gray", vmin=0, vmax=255)
    unt = ~tracked
    ax.scatter(xy[unt, 0], xy[unt, 1], s=12, facecolors="none",
               edgecolors="tab:blue", linewidths=0.8, label="detected")
    ax.scatter(xy[tracked, 0], xy[tracked, 1], s=14, facecolors="none",
               edgecolors="tab:green", linewidths=1.0, label="tracked")
    ax.set_title(state_text)
    ax.legend(loc="upper right")
    ax.set_axis_off()
    fig.tight_layout()
    return fig


def map_snapshot(store, R_cb, t_cb, show_covisibility: bool = True) -> dict:
    """Copies of what `draw_map_snapshot` draws: the valid points [P, 3],
    the keyframe camera centres [K, 3] and viewing directions [K, 3], and
    the covisibility edges (index pairs into the centres, each keyframe to
    its top 5)."""
    pts = store.pt_xyz[store.pt_valid].copy()
    ids = store.keyframe_ids()
    centers, dirs = [], []
    for k in ids:
        R_cw, t_cw = store.kf_pose_cw(k, R_cb, t_cb)
        centers.append(-R_cw.T @ t_cw)
        dirs.append(R_cw.T[:, 2])  # viewing direction
    edges = []
    if show_covisibility and len(ids) > 1:
        index = {k: i for i, k in enumerate(ids)}
        for i, k in enumerate(ids):
            edges += [(i, index[j]) for j in store.covisible_keyframes(k, top=5) if j in index]
    return dict(points=pts, centers=np.asarray(centers, np.float64).reshape(-1, 3),
                dirs=np.asarray(dirs, np.float64).reshape(-1, 3), edges=edges)


def draw_map_snapshot(snap: dict):
    """Top-down map view of a `map_snapshot`: points, keyframe directions,
    covisibility edges (MapDrawer.cpp)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    pts, centers = snap["points"], snap["centers"]
    ax.scatter(pts[:, 0], pts[:, 1], s=2, c="k", alpha=0.4, label="map points")
    for C, z in zip(centers, snap["dirs"]):
        ax.plot([C[0], C[0] + 0.3 * z[0]], [C[1], C[1] + 0.3 * z[1]], c="tab:red", lw=0.8)
    if len(centers):
        ax.plot(centers[:, 0], centers[:, 1], c="tab:blue", lw=1.2, label="keyframes")
    for i, j in snap["edges"]:
        ax.plot(centers[[i, j], 0], centers[[i, j], 1], c="tab:green", lw=0.3, alpha=0.5)
    ax.set_aspect("equal")
    ax.legend(loc="best")
    fig.tight_layout()
    return fig


def draw_map(store, calib, show_covisibility: bool = True):
    """`draw_map_snapshot` of the store's map now, with the extrinsics of
    `calib` (an `ImuCalib`)."""
    return draw_map_snapshot(map_snapshot(store, *host_extrinsics(calib), show_covisibility))


def draw_trajectory(t_est, p_est, t_gt=None, p_gt=None, aligned=None, title="trajectory"):
    """Truth vs estimate 2D plot (evaluation/plot_results.py:26-40)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 8))
    p_est = np.asarray(p_est)
    src = aligned if aligned is not None else p_est
    ax.plot(src[:, 0], src[:, 1], c="tab:blue", lw=1.2, label="ours")
    if p_gt is not None:
        p_gt = np.asarray(p_gt)
        ax.plot(p_gt[:, 0], p_gt[:, 1], c="k", lw=1.0, ls="--", label="truth")
    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_title(title)
    ax.legend()
    fig.tight_layout()
    return fig
