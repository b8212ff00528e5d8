"""PyTorch port: the last four settings profiles (settings/phone.yaml,
kaist_vio.yaml, ntu_viral.yaml, rect_tum.yaml) against the JAX package on
the CPU, on the datasets `chip_smoke.write_dataset` renders (the files
chip_smoke.py's path 15 runs on the card):

(a) both packages' loaders read each profile's folder (3 frames, in the
    layout the card runs it from) to the same images, times and IMU rows,
    the images the rendered 8-bit values; each frame's rows span its period
    (NTU-VIRAL's 385 Hz: 39 rows a 100 ms frame, the last cut at the frame's
    time);
(b) the tracker's preintegration (`ImuBuffer.integrate`, the tree) of
    NTU's rows and of the phone's rows, which lie in the phone's own IMU
    frame P (`chip_smoke.phone_body`), agrees with JAX's within
    tests/test_torch_imu.py's tolerances; and the phone's rows, integrated
    at the true bias seen in P, give the trajectory's true relative motion
    seen through R_BP (dR within TRUTH_R_RAD, dV within TRUTH_V, dP within
    TRUTH_P), while the same rows read as body rows miss it by gravity;
(c) the extractor at the phone's full shape (1280x720, 1,024 features, 8
    levels) on its rendered frame: at least 95% of JAX's keypoints at the
    same (x, y, level), at most 0.1% of descriptor bits apart, and K1's
    atlas (3379x1536); rectified TUM-VI's zero-coefficient radtan camera:
    the undistorted-pixel bounds and `undistort_points` over a grid of the
    whole 512x512 image within UNDISTORT_ATOL of JAX's and of the pixels
    themselves.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from monoorbslam3_tpu import config as jconfig
from monoorbslam3_tpu.models import imu as jimu
from monoorbslam3_tpu.ops import orb as jorb
from monoorbslam3_tpu.runners import datasets as jdatasets
from monoorbslam3_tpu_torch import config as tconfig
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch.models import imu as timu
from monoorbslam3_tpu_torch.ops import orb as torb
from monoorbslam3_tpu_torch.runners import datasets as tdatasets
from monoorbslam3_tpu_torch.runners.synth import SyntheticDataset
from monoorbslam3_tpu_torch.sim import G_W

from tests.test_torch_imu import assert_pre_close
from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

UNDISTORT_ATOL = 1e-3
# the phone's two frame intervals (66.7 ms, 7 rows at 100 Hz) against the
# trajectory: the sensor noise of 7 samples and the rows' 9 decimals
TRUTH_R_RAD, TRUTH_V, TRUTH_P = 1e-3, 5e-3, 5e-4
PROFILES = ("phone", "kaist", "ntu", "recttum")
LOADERS = {"euroc": (jdatasets.euroc_dataset, tdatasets.euroc_dataset),
           "tumvi": (jdatasets.tumvi_dataset, tdatasets.tumvi_dataset)}


@pytest.fixture(scope="module")
def disks(tmp_path_factory):
    """The writer's folders of the four profiles, 3 frames each."""
    root = tmp_path_factory.mktemp("profiles_vio")
    for profile in PROFILES:
        cs.write_dataset(root / profile, profile, 3)
    return root


def _settings(profile):
    return jconfig.load_settings(str(cs.SETTINGS / cs.DATASET_PROFILES[profile]["settings"]))


def _frames(disks, profile):
    j_load, t_load = LOADERS[cs.DATASET_PROFILES[profile]["layout"]]
    return (list(j_load(str(disks / profile)).frames()),
            list(t_load(str(disks / profile)).frames()))


@pytest.mark.parametrize("profile", PROFILES)
def test_loaders_read_the_writer_alike(disks, profile):
    jf, tf = _frames(disks, profile)
    rows, _, _, _ = cs._dataset_stream(profile, 3)
    s = _settings(profile)
    assert len(jf) == len(tf) == 3
    for (tj, ij, mj), (tt, it, mt), (t, img, imu) in zip(jf, tf, rows):
        assert tj == tt and abs(tt - t) < 1e-6
        assert it.shape == (int(s["Camera"]["Height"]), int(s["Camera"]["Width"]))
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(it, np.clip(np.asarray(img), 0, 255).astype(np.uint8))
        assert (mj is None) == (mt is None) == (imu is None)
        if mt is not None:
            np.testing.assert_array_equal(mt, mj)
            np.testing.assert_allclose(mt, imu, rtol=0, atol=1e-8)
    # each frame's rows span its period: the generator's samples from the
    # last frame's time at the IMU's rate, the last row at the frame's time
    per_frame = float(s["IMU"]["Frequency"]) / cs.profile_fps(profile)
    for (t_prev, _, _), (t, _, m) in zip(tf, tf[1:]):
        assert len(m) == int(np.ceil(per_frame - 1e-9)), (len(m), per_frame)
        assert t_prev < m[0, 0] and abs(m[-1, 0] - t) < 1e-6
    if profile == "ntu":
        assert per_frame == 38.5 and len(tf[1][2]) == 39


def _buffers(rows, t0):
    """Each package's ImuBuffer over IMU rows after time t0, with the
    tracker's dt (`Tracking.track_feats`: each row's time less the one
    before)."""
    jb, tb = jimu.ImuBuffer(), timu.ImuBuffer()
    prev = t0
    for row in rows:
        dt = max(float(row[0]) - prev, 0.0)
        prev = float(row[0])
        jb.add(row[1:4], row[4:7], dt)
        tb.add(row[1:4], row[4:7], dt)
    return jb, tb


@pytest.mark.parametrize("profile, frames", [("ntu", (1,)), ("ntu", (1, 2)), ("phone", (1,)),
                                             ("phone", (1, 2))])
def test_preintegration_matches_jax(disks, profile, frames):
    """One frame's window (NTU: 39 rows, the 64-sample bucket) and two
    frames' (78 rows, the 128 bucket), at a nonzero bias."""
    _, tf = _frames(disks, profile)
    rows = np.concatenate([tf[i][2] for i in frames])
    jb, tb = _buffers(rows, tf[frames[0] - 1][0])
    s = _settings(profile)
    jc, tc = jconfig.build_imu_calib(s), tconfig.build_imu_calib(s, device="cpu")
    bg = np.array([0.002, -0.001, 0.003], np.float32)
    ba = np.array([0.01, 0.02, -0.015], np.float32)
    jpre = jb.integrate(bg, ba, jc)
    tpre = tb.integrate(bg, ba, tc)
    assert jb.padded()[0].shape[0] == tb.padded()[0].shape[0] == (64 if len(rows) < 64 else 128)
    assert_pre_close(tpre, jpre)


def _truth(traj, R_BP, t0, t1):
    """The trajectory's (dR, dV, dP) from t0 to t1 in the IMU frame P,
    body B turned by R_BP (the preintegration's definitions, gravity
    G_W)."""
    R0, R1 = traj.R_wb(t0) @ R_BP, traj.R_wb(t1) @ R_BP
    v0, v1, p0, p1 = traj.vel(t0), traj.vel(t1), traj.pos(t0), traj.pos(t1)
    dt = t1 - t0
    return (R0.T @ R1, R0.T @ (v1 - v0 - G_W * dt),
            R0.T @ (p1 - p0 - v0 * dt - 0.5 * G_W * dt * dt))


def test_phone_rows_are_the_truth_seen_in_its_frame(disks):
    _, tf = _frames(disks, "phone")
    R_BP = cs.phone_body("phone")
    # gravity lies on the phone's x axis, as for a phone filming in landscape
    np.testing.assert_allclose(R_BP.T @ np.array([0.0, 0.0, 1.0]), [1.0, 0.0, 0.0], atol=1e-12)
    _, traj, R_bc, t_bc = cs._dataset_stream("phone", 3)
    np.testing.assert_allclose(R_bc, cs._settings_rbc("synthetic.yaml"), atol=1e-12)
    assert not t_bc.any()
    rows = np.concatenate([tf[1][2], tf[2][2]])
    t0, t1 = tf[0][0], tf[2][0]
    assert abs(rows[-1, 0] - t1) < 1e-6
    # the dataset's biases, in the body frame B; in P, R_BP^T b
    params = inspect.signature(SyntheticDataset).parameters
    bg_b, ba_b = (np.asarray(params[k].default) for k in ("bg", "ba"))
    calib = tconfig.build_imu_calib(_settings("phone"), device="cpu")

    def errors(rows, R):
        _, tb = _buffers(rows, t0)
        pre = tb.integrate((bg_b @ R).astype(np.float32), (ba_b @ R).astype(np.float32), calib)
        dR, dV, dP = _truth(traj, R, t0, t1)
        rot = np.linalg.norm(cv_log(pre.dR.double().numpy().T @ dR))
        return rot, np.abs(pre.dV.numpy() - dV).max(), np.abs(pre.dP.numpy() - dP).max()

    got = errors(rows, R_BP)
    print(f"phone rows over {t1 - t0:.4f} s against the truth in P: dR {got[0]:.2e} rad, dV "
          f"{got[1]:.2e} m/s, dP {got[2]:.2e} m")
    assert got[0] <= TRUTH_R_RAD and got[1] <= TRUTH_V and got[2] <= TRUTH_P
    # the same rows taken as the body's own miss the truth by gravity's turn
    wrong = errors(rows, np.eye(3))
    assert wrong[1] > 0.3, wrong


def cv_log(R):
    """The rotation vector of R (its angle times its axis)."""
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    th = np.arccos(c)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return w * (0.5 if th < 1e-8 else th / (2.0 * np.sin(th)))


def _bits(desc_u32):
    return np.unpackbits(np.ascontiguousarray(desc_u32).view(np.uint8), axis=1)


def test_extractor_at_phone_shape(disks):
    _, tf = _frames(disks, "phone")
    image = tf[0][1]
    assert image.shape == (720, 1280)
    ref = {k: np.asarray(v) for k, v in
           jorb.OrbExtractor(720, 1280, n_features=1024, n_levels=8)(image).items()}
    ext = torb.OrbExtractor(720, 1280, n_features=1024, n_levels=8, device="cpu")
    out = ext(image)
    assert out["desc"].shape == (1024, 8)
    # K1's atlas at the phone's shape: the largest of any profile
    atlas, ys, xs, _ = ext._detect(torch.as_tensor(image))
    assert tuple(atlas.shape) == (ext.atlas_h, ext.atlas_w) == (3379, 1536)
    Ha, Wa = atlas.shape
    assert 0 <= int(ys.min()) and int(ys.max()) <= Ha - 56
    assert 0 <= int(xs.min()) and int(xs.max()) <= Wa - 256
    key_j = {(float(x), float(y), int(lv)): i for i, ((x, y), lv, v) in
             enumerate(zip(ref["xy"], ref["level"], ref["valid"])) if v}
    xy_t, lv_t, va_t = out["xy"].numpy(), out["level"].numpy(), out["valid"].numpy()
    pairs = [(key_j[k], i) for i, k in enumerate(
        (float(x), float(y), int(lv)) for (x, y), lv in zip(xy_t, lv_t)) if va_t[i] and k in key_j]
    overlap = len(pairs) / max(len(key_j), 1)
    assert len(key_j) > 900 and overlap >= 0.95, (len(key_j), overlap)
    ij, it = map(np.asarray, zip(*pairs))
    frac = (_bits(convert.desc_to_numpy(out["desc"])[it]) != _bits(ref["desc"][ij])).mean()
    print(f"phone extractor: {len(key_j)} keypoints, overlap {overlap:.4f}, {frac:.2e} of bits")
    assert frac <= 1e-3, frac


def test_rect_tum_zero_distortion_camera():
    s = _settings("recttum")
    j, t = jconfig.build_camera(s), tconfig.build_camera(s, device="cpu")
    assert (t.width, t.height) == (512, 512) and not t.dist.any()
    for name in ("min_x", "max_x", "min_y", "max_y"):
        np.testing.assert_allclose(float(getattr(t, name)), float(getattr(j, name)),
                                   rtol=0, atol=1e-3, err_msg=name)
    gx = np.concatenate([np.arange(0.0, 512.0, 4.0), [511.0]])
    uv = np.stack(np.meshgrid(gx, gx), -1).reshape(-1, 2).astype(np.float32)
    got = t.undistort_points(torch.as_tensor(uv)).numpy()
    ref = np.asarray(j.undistort_points(jnp.asarray(uv)))
    print(f"rect TUM undistort_points over {len(uv)} pixels: largest difference from JAX's "
          f"{np.abs(got - ref).max():.3e} px, from the pixels {np.abs(got - uv).max():.3e} px")
    assert np.abs(got - ref).max() <= UNDISTORT_ATOL
    assert np.abs(got - uv).max() <= UNDISTORT_ATOL
