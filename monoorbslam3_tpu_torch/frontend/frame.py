"""Per-image Frame record and feature finishing (counterpart of
`monoorbslam3_tpu/frontend/frame.py`).

`finish_features` undistorts the extractor's keypoints and attaches the
per-level measurement variance, on the device, with no host read. A
frame carries its two preintegrated windows (since the last frame and
since the last keyframe) and the bias-corrected deltas of the second.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..backend.residuals import KfState
from ..models.imu import Preintegrated


@dataclass
class Frame:
    time: float
    # fixed-capacity feature arrays (undistorted pixel coords), on one device
    xy: torch.Tensor  # [N, 2]
    level: torch.Tensor  # [N] i32
    angle: torch.Tensor  # [N]
    desc: torch.Tensor  # [N, 8] i32
    valid: torch.Tensor  # [N] bool
    sigma2: torch.Tensor  # [N] measurement variance scale
    # vocabulary node id per feature (-1 = no BoW info)
    group: torch.Tensor | None = None
    # body state (world frame)
    state: KfState | None = None
    # map point id per feature (-1 = none)
    pt_ids: torch.Tensor | None = None
    # preintegration from the previous frame / keyframe
    pre_from_frame: Preintegrated | None = None
    pre_from_kf: Preintegrated | None = None
    # bias-corrected (dR, dV, dP) of pre_from_kf, for the IMU prediction
    _pred_deltas: tuple | None = None
    ref_kf: int = -1
    n_tracked: int = 0

    def __post_init__(self):
        if self.pt_ids is None:
            self.pt_ids = torch.full((self.xy.shape[0],), -1, dtype=torch.int64,
                                     device=self.xy.device)


def finish_features(out: dict, camera, scale_factors) -> dict:
    """Undistortion (Frame.cpp:28) + per-level measurement variance
    (Frame.cpp:24-26). Returns tensors on the extractor's device."""
    xy_raw = out["xy"].to(torch.float32)
    level = out["level"].to(torch.int32)
    sf = torch.as_tensor(scale_factors, dtype=torch.float32, device=xy_raw.device)
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


def make_frame(time: float, feats: dict) -> Frame:
    return Frame(
        time=time,
        xy=feats["xy"], level=feats["level"], angle=feats["angle"],
        desc=feats["desc"], valid=feats["valid"], sigma2=feats["sigma2"],
        group=feats.get("group"),
    )
