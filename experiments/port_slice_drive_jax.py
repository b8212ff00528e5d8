"""The chip_smoke.py slice drive through the JAX package, on the CPU.

Runs the same rendered EuRoC-size sequence, the same map seeding and the
same per-frame candidate construction as `chip_smoke.drive`, but extracts
and tracks with `monoorbslam3_tpu` (OrbExtractor, finish_features,
_coarse_track_kernel, _local_track_kernel). Its median pose errors set the
bounds that chip_smoke.py holds the port to (PERF.md records the run).

    python experiments/port_slice_drive_jax.py [--frames 40]

Prints one JSON record per frame and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import tests.conftest  # noqa: F401  (JAX on the CPU backend)

import jax.numpy as jnp
import numpy as np

import chip_smoke as cs
from monoorbslam3_tpu.backend.problems import _identity_edge
from monoorbslam3_tpu.backend.residuals import KfState
from monoorbslam3_tpu.frontend import tracking as jt
from monoorbslam3_tpu.frontend.frame import features_from_extractor
from monoorbslam3_tpu.models.camera import Pinhole
from monoorbslam3_tpu.ops.orb import OrbExtractor


class JaxPipe:
    """chip_smoke's pipe interface over the JAX package."""

    def __init__(self):
        self.cam = Pinhole.create(**cs.EUROC_CAM)
        self.ext = OrbExtractor(cs.EUROC_CAM["height"], cs.EUROC_CAM["width"],
                                n_features=cs.N_FEAT, n_levels=cs.N_LEVELS, scale=cs.SCALE)
        self.R_cb, self.t_cb = jnp.asarray(cs.R_CB), jnp.asarray(cs.T_CB)
        self._feats = None

    def features(self, img):
        f = features_from_extractor(self.ext(img), self.cam, self.ext.scale_factors)
        f = {k: np.asarray(v) for k, v in f.items()}
        self._feats = f
        return f

    def coarse(self, img, state, cand):
        f = self.features(img)
        c = {k: jnp.asarray(v) for k, v in cand.items()}
        st, ci, n_match, n_inl = jt._coarse_track_kernel(
            KfState(*map(jnp.asarray, state)), c["cand_xyz"], c["cand_desc"],
            c["cand_valid"], c["cand_ang"], c["cand_extra2"], jnp.asarray(f["xy"]),
            jnp.asarray(f["desc"]), jnp.asarray(f["valid"]), jnp.asarray(f["angle"]),
            jnp.asarray(f["sigma2"]), self.cam, self.R_cb, self.t_cb, c["radius"],
            jnp.int32(cs.RETRY), use_rotation=True)
        return dict(state=(np.asarray(st.R_wb), np.asarray(st.t_wb)), ci=np.asarray(ci),
                    n_match=int(n_match), n_inl=int(n_inl), feats=f)

    def local(self, state, cand):
        f = self._feats
        c = {k: jnp.asarray(v) for k, v in cand.items()}
        z = KfState.zeros()
        st, lci, keep, hit, n_inl = jt._local_track_kernel(
            KfState(*map(jnp.asarray, state)), c["cand_xyz"], c["cand_desc"],
            c["cand_valid"], c["cand_normal"], c["cand_use_vcos"], c["cand_extra2"],
            c["radius"], c["blockrow"], c["coarse_pts"], c["coarse_inv_s2"],
            c["coarse_valid"], jnp.asarray(f["xy"]), jnp.asarray(f["desc"]),
            jnp.asarray(f["valid"]), jnp.asarray(f["sigma2"]), self.cam, self.R_cb,
            self.t_cb, jnp.asarray(cs.T_BC, jnp.float32), jnp.float32(cs.VIEW_COS_GATE),
            jnp.int32(cs.RETRY), _identity_edge(), z, jnp.float32(0.0), use_inertial=False)
        return dict(state=(np.asarray(st.R_wb), np.asarray(st.t_wb)), lci=np.asarray(lci),
                    keep_coarse=np.asarray(keep), hit=np.asarray(hit), n_inl=int(n_inl))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()
    recs = cs.drive(JaxPipe(), n_frames=args.frames)
    t = [r["t_err_m"] for r in recs]
    r = [r["r_err_deg"] for r in recs]
    print(json.dumps(dict(
        frames=len(recs), median_t_err_m=float(np.median(t)), max_t_err_m=float(max(t)),
        median_r_err_deg=float(np.median(r)), max_r_err_deg=float(max(r)),
        min_inliers=min(x["n_inliers"] for x in recs))))


if __name__ == "__main__":
    main()
