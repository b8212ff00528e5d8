"""Settings loader and system factory (counterpart of
`monoorbslam3_tpu/config.py`): camera and IMU calibration from a dataset
profile, the optional vocabulary, and `build_system`.

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


def build_vocabulary(settings: dict, vocab_path: str | None = None,
                     base_dir: str | None = None, device=CARD):
    """The optional vocabulary of the `Vocabulary` node (a path or `{File:
    path, GroupLevel: l}`) or an explicit path, on `device`; None when
    unset (dense matching needs none). A relative `File:` resolves against
    the settings file's directory (`base_dir`)."""
    import os

    from .ops.vocab import load_dbow2_text

    node = settings.get("Vocabulary")
    group_level = 1
    if isinstance(node, dict):
        group_level = int(node.get("GroupLevel", 1))
        node = node.get("File")
    path = vocab_path or node
    if not path:
        return None
    path = str(path)
    if base_dir and not os.path.isabs(path) and not os.path.exists(path):
        path = os.path.join(base_dir, path)
    return load_dbow2_text(path, group_level=group_level, device=device)


def build_system(settings_path: str, use_extractor: bool = True,
                 config_overrides: dict | None = None, vocab_path: str | None = None,
                 viewer_dir: str | None = None, async_mapper: bool = False, device=CARD):
    """A `System` from a settings file, on `device` (the System
    constructor analog, System.cpp:19-68): the camera, the IMU calibration,
    the extractor (and the `init_features_mult` init extractor), the
    vocabulary, and the `System:` node's knobs (the caller's overrides
    win)."""
    import os

    from .ops.orb import OrbExtractor
    from .system import System
    from .utils.device import resolve

    device = resolve(device)
    settings = load_settings(settings_path)
    camera = build_camera(settings, device)
    calib = build_imu_calib(settings, device)
    orb = settings.get("ORB", {})
    n_feat = int(orb.get("Features", 1024))
    cfg = {"n_features": n_feat, "fps": float(settings["Camera"].get("fps", 20))}
    cfg.update(settings.get("System") or {})
    cfg.update(config_overrides or {})
    extractor = init_extractor = None
    if use_extractor:
        ext_args = dict(n_levels=int(orb.get("Levels", 8)),
                        scale=float(orb.get("ScaleFactor", 1.2)),
                        ini_th_fast=float(orb.get("IniThFAST", 20)),
                        min_th_fast=float(orb.get("MinThFAST", 7)), device=device)
        extractor = OrbExtractor(camera.height, camera.width, n_features=n_feat, **ext_args)
        # the reference doubles the features while initializing
        # (Tracking.cpp:24); off by default (see the JAX package's config)
        mult = int(cfg.get("init_features_mult", 1))
        if mult > 1:
            init_extractor = OrbExtractor(camera.height, camera.width,
                                          n_features=mult * n_feat, **ext_args)
            # the oversized init population needs the conditioning gate
            cfg.setdefault("init_max_rel_sigma", 0.12)
    vocab = build_vocabulary(settings, vocab_path,
                             base_dir=os.path.dirname(os.path.abspath(settings_path)),
                             device=device)
    return System(camera, calib, config=cfg, extractor=extractor, vocab=vocab,
                  viewer_dir=viewer_dir, init_extractor=init_extractor,
                  async_mapper=async_mapper, device=device)
