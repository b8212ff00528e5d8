"""The comparisons that decide `correct`: each takes the inputs of a call
the timed path made (or the benchmark's own inputs) and what the port
returned, recomputes the answer with the frozen plain reference, and gives
one number. Imports nothing of the port: the port's records (its camera,
KfState, PreintEdge, BAProblem) come in as plain tuples and tensors, and
the reference builds its own camera and calibration from the settings.

With `control` set the reference in the nearest precision below the
configuration's (float32 with TF32 off: TF32 for every matmul and
convolution) stands in the port's place: its answer is judged instead of
the port's. That is the control each limit was set against.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import match, orb, pose_lm, solver
from .camera import Fisheye, Pinhole
from .residuals import KfState, PreintEdge
from .vocab import TreeVocabulary


@contextlib.contextmanager
def precision(control: bool):
    """float32 with TF32 off for the reference; TF32 on for the control."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = control
    torch.backends.cudnn.allow_tf32 = control
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


class Reference:
    """The plain reference of one configuration on one device."""

    def __init__(self, cfg: dict, device, vocab_path=None):
        s = cfg["settings"]
        cam, orb_node, imu = s["Camera"], s.get("ORB", {}), s["IMU"]
        K = cam["CameraMatrix"]
        model = cam.get("DistortionModel") or cam.get("Distortion_Model") or "radtan"
        make = Pinhole.create if model == "radtan" else Fisheye.create
        dist = cam.get("Distortion", [0, 0, 0, 0])
        self.camera = make(K[0], K[4], K[2], K[5], dist=dist if model == "radtan" else dist[:4],
                           width=int(cam["Width"]), height=int(cam["Height"]), device=device)
        Rbc = np.asarray(imu["Rbc"], np.float64).reshape(3, 3)
        tbc = np.asarray(imu["tbc"], np.float64).reshape(3)
        self.R_cb = torch.as_tensor(Rbc.T.astype(np.float32), device=device)
        self.t_cb = torch.as_tensor((-Rbc.T @ tbc).astype(np.float32), device=device)
        self.orb_args = dict(n_features=int(orb_node.get("Features", 1024)),
                             n_levels=int(orb_node.get("Levels", 8)),
                             scale=float(orb_node.get("ScaleFactor", 1.2)),
                             ini_th_fast=float(orb_node.get("IniThFAST", 20)),
                             min_th_fast=float(orb_node.get("MinThFAST", 7)))
        self.device = device
        self._extractors = {}
        self.vocab = (TreeVocabulary(vocab_path, int(cfg["vocabulary"]["group_level"]), device)
                      if vocab_path else None)

    # -- conversions of the port's records -------------------------------

    def ref(self, x):
        """The port's records as the reference's: KfState and PreintEdge by
        their fields, a camera replaced by the reference's own."""
        kind = type(x).__name__
        if kind == "KfState":
            return KfState(*(self.ref(v) for v in x))
        if kind == "PreintEdge":
            return PreintEdge(*(self.ref(v) for v in x))
        if kind == "BAProblem":
            return solver.BAProblem(*(self.ref(v) for v in x))
        if kind in ("Pinhole", "Fisheye"):
            return self.camera
        if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
            return type(x)(self.ref(v) for v in x)
        return x

    # -- the checks ------------------------------------------------------

    def extract(self, image, n_features, out, control=False):
        """Share of the port's keypoint rows that the reference does not
        reproduce: validity, level, position (1e-3 px) and descriptor."""
        ext = self._extractors.get(n_features)
        if ext is None:
            args = dict(self.orb_args, n_features=n_features)
            ext = self._extractors[n_features] = orb.OrbExtractor(
                int(self.camera.height), int(self.camera.width), device=self.device, **args)
        with precision(False):
            ref = ext(image)
        if control:
            with precision(True):
                out = ext(image)
        same = ((out["valid"] == ref["valid"]) & (out["level"] == ref["level"])
                & (torch.abs(out["xy"] - ref["xy"]).amax(-1) < 1e-3)
                & (out["desc"] == ref["desc"]).all(-1))
        rows = out["valid"] | ref["valid"]
        return float((rows & ~same).sum()) / max(1, int(rows.sum()))

    def bow(self, desc, valid, word, group):
        """Rows whose word or group differs from the tree descent's."""
        w, g = self.vocab.transform(desc, valid)
        return int(((w != word) | (g != group)).sum())

    def match_rows(self, args, out, control=False):
        """K2: rows whose best, second or index differs from the plain
        gated match."""
        with precision(control):
            cand = match._match_rows_plain(*args) if control else out
        with precision(False):
            ref = match._match_rows_plain(*args)
        diff = (cand[0] != ref[0]) | (cand[1] != ref[1]) | (cand[2] != ref[2])
        return int(diff.sum())

    def hamming(self, a, b, out, control=False):
        """K3: entries of the distance block that differ from the plain
        product's."""
        with precision(control):
            cand = match.hamming_matrix_plain(a, b) if control else out
        with precision(False):
            ref = match.hamming_matrix_plain(a, b)
        return int((cand != ref).sum())

    def pose(self, args, kwargs, out, control=False):
        """The frame LM: the largest gap (m) between the port's position
        and the reference's, on the same inputs."""
        args = [self.ref(a) for a in args]
        args[6], args[7] = self.R_cb, self.t_cb
        with precision(control):
            cand = pose_lm._pose_optimize_impl(*args, **kwargs)[0] if control else out[0]
        with precision(False):
            ref = pose_lm._pose_optimize_impl(*args, **kwargs)[0]
        return float(torch.linalg.norm(cand[1] - ref.t_wb))

    def window_ba(self, problem, kwargs, out, R_cb=None, t_cb=None, control=False):
        """A window BA: (cost excess, first-step gap, pose gap).

        - cost excess: the reference's cost of the port's solution above
          the reference's own final cost, relative (0 where the port's is
          as low or lower);
        - first-step gap: the port's cost after its first LM step (its
          `cost_hist[1]`) against the reference's, relative: one reduced
          solve (K4) and the assembly around it, before the LM's
          accept/reject decisions can part the two paths;
        - pose gap: the largest distance (m) between the port's free
          keyframe positions and the reference's."""
        problem = self.ref(problem)
        R_cb = self.R_cb if R_cb is None else R_cb
        t_cb = self.t_cb if t_cb is None else t_cb
        with precision(control):
            cand = solver.schur_ba(problem, self.camera, R_cb, t_cb, **kwargs) if control else out
        with precision(False):
            kf, pts, info = solver.schur_ba(problem, self.camera, R_cb, t_cb, **kwargs)
            c_kf, c_pts = KfState(*cand[0]), cand[1]
            huber = kwargs.get("huber_delta2", solver.CHI2_MONO)
            c_cost = solver._total_cost(problem._replace(kf=c_kf, points=c_pts), self.camera,
                                        R_cb, t_cb, huber)
            r_cost = solver._total_cost(problem._replace(kf=kf, points=pts), self.camera,
                                        R_cb, t_cb, huber)
        excess = _finite(torch.clamp(c_cost - r_cost, min=0.0)
                         / torch.clamp(torch.abs(r_cost), min=1e-12))
        c1, r1 = cand[2]["cost_hist"][1], info["cost_hist"][1]
        step = _finite(torch.abs(c1 - r1) / torch.clamp(torch.abs(r1), min=1e-12))
        free = problem.kf_dof.amax(-1) > 0
        pose_gap = _finite(torch.linalg.norm(c_kf.t_wb - kf.t_wb, dim=-1)[free].max())
        return excess, step, pose_gap


def _finite(x) -> float:
    """A number compared; NaN (a diverged solution) reads as infinitely far."""
    x = float(x)
    return x if x == x else float("inf")


def ate(times, positions, gt_t, gt_p) -> float:
    """The keyframe trajectory's RMSE (m) against the ground truth at the
    same times, after the least-squares similarity alignment (Umeyama):
    a monocular map is known up to scale."""
    idx = np.searchsorted(gt_t, times)
    idx = np.clip(idx, 0, len(gt_t) - 1)
    ok = np.abs(gt_t[idx] - times) < 1e-6
    X = np.asarray(positions, np.float64)[ok]
    Y = gt_p[idx[ok]]
    if len(X) < 3:
        return float("inf")
    mx, my = X.mean(0), Y.mean(0)
    Xc, Yc = X - mx, Y - my
    U, S, Vt = np.linalg.svd(Yc.T @ Xc / len(X))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    s = np.trace(np.diag(S) @ D) / (Xc ** 2).sum(1).mean()
    err = Y - (s * X @ R.T + (my - s * R @ mx))
    return float(np.sqrt((err ** 2).sum(1).mean()))
