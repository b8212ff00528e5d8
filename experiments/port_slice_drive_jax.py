"""The chip_smoke.py slice drive through the JAX package, on the CPU.

Runs the same rendered EuRoC-size sequence, the same map seeding and the
same per-frame candidate construction as `chip_smoke.drive`, but extracts
and tracks with `monoorbslam3_tpu` (OrbExtractor, finish_features,
_coarse_track_kernel, _local_track_kernel). With `--inertial` it runs
`chip_smoke.vi_drive` instead: the same IMU samples and keyframe windows,
preintegrated by the JAX package's tree (`ImuBuffer.integrate`), its
`_predict_deltas`, the inertial branch of `Tracking._predict_state`
(called on stand-ins for the tracker and the frame), and the local stage with the whitened edge
(`PreintEdge.from_preintegrated`, `use_inertial=True`). Its median pose
and prediction errors set the bounds that chip_smoke.py holds the port to
(PERF.md records the run).

    python experiments/port_slice_drive_jax.py [--frames 40] [--inertial]

Prints one JSON record per frame and a summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from types import SimpleNamespace

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import tests.conftest  # noqa: F401  (JAX on the CPU backend)

import jax
import jax.numpy as jnp
import numpy as np

import chip_smoke as cs
from monoorbslam3_tpu import config
from monoorbslam3_tpu.backend.problems import _identity_edge
from monoorbslam3_tpu.backend.residuals import KfState, PreintEdge
from monoorbslam3_tpu.frontend import tracking as jt
from monoorbslam3_tpu.frontend.frame import features_from_extractor
from monoorbslam3_tpu.models.imu import preintegrate_tree_jit
from monoorbslam3_tpu.ops.orb import OrbExtractor

_whiten = jax.jit(PreintEdge.from_preintegrated)


def predict_state(kf_state, pre_kf, deltas):
    """`Tracking._predict_state` of the JAX package, its inertial branch:
    the tracker and the frame are stand-ins that hold the keyframe's state
    (as keyframe 0 of the store), its preintegrated window and the
    deltas."""
    store = SimpleNamespace(**{f"kf_{k}": [np.asarray(v)]
                               for k, v in zip(("R", "t", "v", "bg", "ba"), kf_state)})
    tracker = SimpleNamespace(imu_ready=True, last_kf_id=0, store=store)
    frame = SimpleNamespace(pre_from_kf=pre_kf, _pred_deltas=deltas)
    return jt.Tracking._predict_state(tracker, frame)


class JaxPipe:
    """chip_smoke's pipe interface over the JAX package."""

    def __init__(self):
        self.profile = cs.EUROC_PROFILE
        settings = config.load_settings(str(cs.SETTINGS / self.profile))
        self.cam = config.build_camera(settings)
        self.calib = config.build_imu_calib(settings)
        self.ext = OrbExtractor(self.cam.height, self.cam.width,
                                n_features=cs.N_FEAT, n_levels=cs.N_LEVELS, scale=cs.SCALE)
        self.R_cb, self.t_cb = jnp.asarray(cs.R_CB), jnp.asarray(cs.T_CB)
        self._feats = None
        self._vi = None

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

    def vi_coarse(self, img, fr_buf, kf_buf, kf_state, cand):
        """Both windows through the tree at the keyframe's biases (the
        package's ImuBuffer.integrate), the deltas, the prediction of
        Tracking._predict_state's inertial branch, then the coarse stage."""
        bg, ba = jnp.asarray(kf_state[3]), jnp.asarray(kf_state[4])
        preintegrate_tree_jit(*fr_buf.padded(), bg, ba, self.calib)
        pre_kf = preintegrate_tree_jit(*kf_buf.padded(), bg, ba, self.calib)
        pred = tuple(predict_state(kf_state, pre_kf, jt._predict_deltas(pre_kf, bg, ba)))
        self._vi = dict(kf=KfState(*map(jnp.asarray, kf_state)), pre_kf=pre_kf)
        f = self.features(img)
        c = {k: jnp.asarray(v) for k, v in cand.items()}
        st, ci, n_match, n_inl = jt._coarse_track_kernel(
            KfState(*map(jnp.asarray, pred)), c["cand_xyz"], c["cand_desc"],
            c["cand_valid"], c["cand_ang"], c["cand_extra2"], jnp.asarray(f["xy"]),
            jnp.asarray(f["desc"]), jnp.asarray(f["valid"]), jnp.asarray(f["angle"]),
            jnp.asarray(f["sigma2"]), self.cam, self.R_cb, self.t_cb, c["radius"],
            jnp.int32(cs.RETRY), use_rotation=True)
        return dict(state=tuple(np.asarray(a) for a in st), pred=pred, ci=np.asarray(ci),
                    n_match=int(n_match), n_inl=int(n_inl), feats=f)

    def vi_local(self, state, cand):
        f = self._feats
        c = {k: jnp.asarray(v) for k, v in cand.items()}
        st, lci, keep, hit, n_inl = jt._local_track_kernel(
            KfState(*map(jnp.asarray, state)), c["cand_xyz"], c["cand_desc"],
            c["cand_valid"], c["cand_normal"], c["cand_use_vcos"], c["cand_extra2"],
            c["radius"], c["blockrow"], c["coarse_pts"], c["coarse_inv_s2"],
            c["coarse_valid"], jnp.asarray(f["xy"]), jnp.asarray(f["desc"]),
            jnp.asarray(f["valid"]), jnp.asarray(f["sigma2"]), self.cam, self.R_cb,
            self.t_cb, jnp.asarray(cs.T_BC, jnp.float32), jnp.float32(cs.VIEW_COS_GATE),
            jnp.int32(cs.RETRY), _whiten(self._vi["pre_kf"]), self._vi["kf"],
            jnp.float32(1.0), use_inertial=True)
        return dict(state=tuple(np.asarray(a) for a in st), lci=np.asarray(lci),
                    keep_coarse=np.asarray(keep), hit=np.asarray(hit), n_inl=int(n_inl))


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--inertial", action="store_true",
                    help="chip_smoke.vi_drive: IMU prediction, 15-dim local LM")
    args = ap.parse_args()
    if args.inertial:
        recs, _ = cs.vi_drive(JaxPipe(), n_frames=args.frames)
    else:
        recs = cs.drive(JaxPipe(), n_frames=args.frames)
    keys = ["t_err_m", "r_err_deg"]
    if args.inertial:
        keys += ["v_err_mps", "pred_t_err_m", "pred_r_err_deg"]
    summary = dict(frames=len(recs), min_inliers=min(x["n_inliers"] for x in recs))
    for k in keys:
        xs = [r[k] for r in recs]
        summary[f"median_{k}"] = float(np.median(xs))
        summary[f"max_{k}"] = float(max(xs))
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
