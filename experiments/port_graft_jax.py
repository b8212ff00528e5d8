"""The graft entry's tracking step through the JAX package, on the CPU.

Runs `__graft_entry__.entry()` (the jitted flagship step: ORB extraction
on a 752x480 image with 1,024 features, projection, the gated match, the
4x10 pose LM) on two input sets, as `chip_smoke.py`'s measure path runs
the port's `graft_entry` on the card:

1. the flagship's own seeded inputs (`__graft_entry__._flagship`'s
   random image and map: few matches pass the descriptor gate, so the LM
   barely moves);
2. the rendered set (`chip_smoke.graft_frames`): the map is the first
   rendered frame's keypoints from the JAX package's extraction, lifted to
   their true world points; the step tracks the second frame from the
   first frame's camera pose.

It prints the JAX_GRAFT anchors (R, t and the inlier count of each set)
and writes the rendered set's map (pt_xyz, pt_desc, pt_valid, R0, t0, and
the tracked image's float64 sum, which the card's re-render must give)
into `chip_smoke.GRAFT_RENDERED`.

    python experiments/port_graft_jax.py

About a minute on a CPU.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import tests.conftest  # noqa: F401  (JAX on the CPU backend)

import jax.numpy as jnp
import numpy as np

import __graft_entry__ as ge
import chip_smoke as cs
from monoorbslam3_tpu.ops.orb import OrbExtractor


def _run(fn, args):
    R, t, n = fn(*(jnp.asarray(a) for a in args))
    return dict(R=np.asarray(R).tolist(), t=np.asarray(t).tolist(), n_inliers=int(n))


def main():
    fn, args = ge.entry()
    anchors = {"seeded": _run(fn, [np.asarray(a) for a in args])}
    img_map, img_track, world, cam = cs.graft_frames()
    feats = OrbExtractor(img_map.shape[0], img_map.shape[1], n_features=1024)(
        jnp.asarray(img_map))
    pt_xyz, pt_desc, pt_valid, R0, t0 = cs.graft_rendered_inputs(
        np.asarray(feats["xy"]), np.asarray(feats["desc"]), np.asarray(feats["valid"]), world, cam)
    anchors["rendered"] = _run(fn, (img_track, pt_xyz, pt_desc, pt_valid, R0, t0))
    R_true, t_true = cs.graft_camera_pose(world, cs.GRAFT_T[1])
    anchors["rendered"].update(
        start_t_err_m=float(np.linalg.norm(t0 - t_true)),
        t_err_m=float(np.linalg.norm(np.asarray(anchors["rendered"]["t"]) - t_true)),
        n_map_points=int(pt_valid.sum()))
    np.savez_compressed(cs.GRAFT_RENDERED, pt_xyz=pt_xyz, pt_desc=pt_desc, pt_valid=pt_valid,
                        R0=R0, t0=t0, image_sum=np.float64(img_track.astype(np.float64).sum()))
    print("JAX_GRAFT =", json.dumps(anchors))
    print(f"wrote {cs.GRAFT_RENDERED}")


if __name__ == "__main__":
    main()
