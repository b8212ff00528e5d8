"""Settings loader: camera and IMU calibration from a dataset profile
(counterpart of `load_settings`, `build_camera` and `build_imu_calib` in
`monoorbslam3_tpu/config.py`).

Parses plain YAML and the reference's OpenCV-style YAML (the `%YAML:1.0`
directive and `!!opencv-matrix` tags are normalized away) and accepts both
`DistortionModel` and `Distortion_Model`. The factories return the port's
records on a device, the card unless the caller names another
(`utils/device.py`).
"""

from __future__ import annotations

import re

import numpy as np
import yaml

from .models.camera import Fisheye, Pinhole
from .models.imu import ImuCalib
from .utils.device import CARD


def _normalize_opencv_yaml(text: str) -> str:
    text = re.sub(r"^%YAML:[\d.]+\s*\n(---\s*\n)?", "", text)
    return text.replace("!!opencv-matrix", "")


def _as_matrix(node):
    """OpenCV-matrix node or plain list -> numpy array."""
    if isinstance(node, dict) and "data" in node:
        arr = np.asarray(node["data"], np.float64)
        r, c = int(node.get("rows", len(arr))), int(node.get("cols", 1))
        return arr.reshape(r, c)
    return np.asarray(node, np.float64)


def load_settings(path: str) -> dict:
    with open(path) as f:
        text = f.read()
    return yaml.safe_load(_normalize_opencv_yaml(text))


def build_camera(settings: dict, device=CARD):
    """The `Camera` node -> Pinhole (radtan) or Fisheye (equidistant)."""
    cam = settings["Camera"]
    K = _as_matrix(cam["CameraMatrix"]).reshape(3, 3)
    dist = _as_matrix(cam.get("Distortion", [0, 0, 0, 0])).reshape(-1)
    model = cam.get("DistortionModel") or cam.get("Distortion_Model") or "radtan"
    width, height = int(cam["Width"]), int(cam["Height"])
    if model == "radtan":
        return Pinhole.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], dist=dist,
                              width=width, height=height, device=device)
    if model == "equidistant":
        return Fisheye.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], dist=dist[:4],
                              width=width, height=height, device=device)
    raise ValueError(f"unknown distortion model {model!r}")


def build_imu_calib(settings: dict, device=CARD) -> ImuCalib:
    """The `IMU` node (Rbc/tbc, or Rcb/tcb) -> ImuCalib."""
    imu = settings["IMU"]
    if "Rcb" in imu:
        R_cb = _as_matrix(imu["Rcb"]).reshape(3, 3)
        t_cb = _as_matrix(imu["tcb"]).reshape(3)
        R_bc = R_cb.T
        t_bc = -R_bc @ t_cb
    else:
        R_bc = _as_matrix(imu["Rbc"]).reshape(3, 3)
        t_bc = _as_matrix(imu["tbc"]).reshape(3)
    return ImuCalib.create(
        R_bc=R_bc, t_bc=t_bc,
        noise_gyro=float(imu["NoiseGyro"]), noise_acc=float(imu["NoiseAcc"]),
        walk_gyro=float(imu["WalkGyro"]), walk_acc=float(imu["WalkAcc"]),
        bg0=_as_matrix(imu.get("GyroBias", [0, 0, 0])).reshape(3),
        ba0=_as_matrix(imu.get("AccBias", [0, 0, 0])).reshape(3),
        freq=float(imu.get("Frequency", 200.0)), device=device)
