"""Per-image Frame record (host side) and feature finishing (counterpart of
`monoorbslam3_tpu/frontend/frame.py`).

`Frame` is a plain host record, as in the JAX package: fixed-capacity
numpy feature arrays filled by the frame's single fetch
(`Tracking.track_feats`), the body state, per-feature map point ids, and
the two preintegrated windows (since the last frame and since the last
keyframe) with the bias-corrected deltas of the second, all fetched.

`finish_features` undistorts the extractor's keypoints and attaches the
per-level measurement variance, on the device, with no host read.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend.residuals import KfState
from ..models.imu import Preintegrated
from ..utils.device import constant
from ..utils.fetch import SyncCounter, fetch


@dataclass
class Frame:
    time: float
    # fixed-capacity feature arrays (undistorted pixel coords)
    xy: np.ndarray  # [N, 2]
    level: np.ndarray  # [N]
    angle: np.ndarray  # [N]
    desc: np.ndarray  # [N, 8] uint32
    valid: np.ndarray  # [N]
    sigma2: np.ndarray  # [N] measurement variance scale
    # vocabulary node id per feature (-1 = no BoW info)
    group: np.ndarray | None = None
    # body state (world frame)
    state: KfState | None = None
    # map point id per feature (-1 = none)
    pt_ids: np.ndarray | None = None
    # preintegration from the previous frame / keyframe (fetched)
    pre_from_frame: Preintegrated | None = None
    pre_from_kf: Preintegrated | None = None
    # bias-corrected (dR, dV, dP) of pre_from_kf, fetched with the frame's
    # single read for the host-side prediction
    _pred_deltas: tuple | None = None
    ref_kf: int = -1
    n_tracked: int = 0
    # device copies the tracker keeps beside the host record: the feature
    # tensors (xy, desc, valid, angle, sigma2) it matches against, and the
    # since-keyframe window it whitens (None until needed)
    _dev: dict | None = None
    _pre_kf_dev: Preintegrated | None = None

    def __post_init__(self):
        if self.pt_ids is None:
            self.pt_ids = np.full(len(self.xy), -1, np.int64)

    @property
    def n_features(self) -> int:
        return int(self.valid.sum())


def finish_features(out: dict, camera, scale_factors) -> dict:
    """Undistortion (Frame.cpp:28) + per-level measurement variance
    (Frame.cpp:24-26). Returns tensors on the extractor's device."""
    xy_raw = out["xy"].to(torch.float32)
    level = out["level"].to(torch.int32)
    sf_host = np.asarray(scale_factors, np.float32).reshape(-1)
    sf = constant(("frame.scale_factors", sf_host.tobytes()), xy_raw.device, lambda: sf_host)
    und = camera.undistort_points(xy_raw)
    unc = camera.uncertainty(xy_raw)
    sigma2 = (sf[level.long()] * unc) ** 2
    return {
        "xy": und,
        "xy_raw": xy_raw,
        "level": level,
        "angle": out["angle"].to(torch.float32),
        "desc": out["desc"],
        "valid": out["valid"],
        "sigma2": sigma2,
    }


def features_from_extractor(out, camera, scale_factors, counter: SyncCounter | None = None) -> dict:
    """Host-array version of finish_features (one blocking fetch, counted
    on `counter`): the descriptors come home as uint32, as the JAX
    package's."""
    feats = fetch(finish_features(out, camera, scale_factors), counter or SyncCounter())
    feats["xy"] = feats["xy"].astype(np.float32)
    feats["desc"] = feats["desc"].view(np.uint32)
    feats["level"] = feats["level"].astype(np.int32)
    feats["sigma2"] = feats["sigma2"].astype(np.float32)
    return feats


def make_frame(time: float, feats: dict) -> Frame:
    return Frame(
        time=time,
        xy=feats["xy"], level=feats["level"], angle=feats["angle"],
        desc=feats["desc"], valid=feats["valid"], sigma2=feats["sigma2"],
        group=feats.get("group"),
    )
