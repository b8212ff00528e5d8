"""PyTorch port, the cameras, the small math and the settings loader against
the JAX package on the CPU, plus `fetch` on records.

- Pinhole keeps a distortion vector longer than five terms and reads its
  first five (bounds and projections as JAX's); `distort_normalized`.
- Fisheye (KB4): every method against JAX on the same points and pixels;
  the port's closed-form Jacobian against JAX's jacfwd.
- `project_np` / `_host_intrinsics` (host numpy) for both models.
- Quaternions and `se3.Pose`.
- Every profile under `settings/` loads, and `build_camera` /
  `build_imu_calib` give JAX's values.
"""

import glob
import os
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoorbslam3_tpu import config as jconfig
from monoorbslam3_tpu.models import camera as jcam
from monoorbslam3_tpu.utils import lie as jlie
from monoorbslam3_tpu.utils import se3 as jse3
from monoorbslam3_tpu_torch import config as tconfig
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch.backend.residuals import KfState
from monoorbslam3_tpu_torch.models import camera as tcam
from monoorbslam3_tpu_torch.utils import lie as tlie
from monoorbslam3_tpu_torch.utils import se3 as tse3
from monoorbslam3_tpu_torch.utils.fetch import SyncCounter, fetch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
PROFILES = sorted(glob.glob(os.path.join(ROOT, "settings", "*.yaml")))
# eight coefficients: radtan's five, then three terms the model does not read
DIST8 = [-0.28, 0.07, 0.0002, 1.7e-5, 0.0, 0.1, 0.2, 0.3]
DIST_K3 = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05, 0.011]
# TUM-VI cam0 (settings/tum_vi.yaml:3-8)
TUM_VI = dict(fx=190.97847715128717, fy=190.9733070521226, cx=254.93170605935475,
              cy=256.8974428996504, width=512, height=512,
              dist=[0.0034823894022493434, 0.0007150348452162257,
                    -0.0020532361418706202, 0.00020293673591811182])


def _t(x):
    return torch.as_tensor(np.array(x, np.float32))


def seeded_points(n, seed, r_max=2.0):
    """Camera-frame points in front of the camera, off-axis up to r_max
    times their depth, with a few on the axis."""
    rng = np.random.default_rng(seed)
    z = rng.uniform(0.5, 8.0, n)
    xy = rng.uniform(-r_max, r_max, (n, 2)) * z[:, None]
    pc = np.concatenate([xy, z[:, None]], -1).astype(np.float32)
    pc[:3, :2] = 0.0
    return pc


# ---------------------------------------------------------------------------
# fetch on records (Queue 3 fault)
# ---------------------------------------------------------------------------


class _Pre(NamedTuple):
    dR: torch.Tensor
    dt: torch.Tensor


def test_fetch_returns_named_tuples_whole():
    """A KfState, a record like Preintegrated and nested containers come
    back with their types, fields and values (fetch rebuilt tuples from a
    generator, which a named tuple's constructor does not take)."""
    st = KfState.zeros((2,), device="cpu")
    pre = _Pre(torch.eye(3), torch.tensor(0.25))
    t = torch.arange(3.0)
    out = fetch((st, pre, {"a": [t, (t, t)]}), SyncCounter())
    st_h, pre_h, d = out
    assert type(out) is tuple and type(st_h) is KfState and type(pre_h) is _Pre
    assert st_h._fields == KfState._fields and st_h.R_wb.shape == (2, 3, 3)
    np.testing.assert_array_equal(st_h.R_wb, np.broadcast_to(np.eye(3), (2, 3, 3)))
    assert isinstance(pre_h.dR, np.ndarray) and float(pre_h.dt) == 0.25
    assert type(d["a"]) is list and type(d["a"][1]) is tuple
    np.testing.assert_array_equal(d["a"][1][0], [0.0, 1.0, 2.0])


# ---------------------------------------------------------------------------
# Pinhole
# ---------------------------------------------------------------------------


def test_pinhole_keeps_more_than_five_coefficients():
    """create(458, 457, 367, 248, dist=[8 values], 752x480): the vector is
    kept whole (it raised), the bounds are JAX's (-138.12 .. 898.69 in x),
    the three trailing terms are unread, and project / undistort_points
    agree with JAX's."""
    kw = dict(dist=DIST8, width=752, height=480)
    j = jcam.Pinhole.create(458, 457, 367, 248, **kw)
    t = tcam.Pinhole.create(458, 457, 367, 248, device="cpu", **kw)
    assert t.dist.shape == (8,)
    np.testing.assert_array_equal(t.dist.numpy(), np.asarray(j.dist))
    for name in ("min_x", "max_x", "min_y", "max_y"):
        np.testing.assert_allclose(float(getattr(t, name)), float(getattr(j, name)),
                                   rtol=0, atol=1e-3, err_msg=name)
    assert round(float(t.min_x), 2) == -138.12 and round(float(t.max_x), 2) == 898.69
    t5 = tcam.Pinhole.create(458, 457, 367, 248, dist=DIST8[:5], width=752, height=480,
                             device="cpu")
    for name in ("min_x", "max_x", "min_y", "max_y"):
        assert float(getattr(t5, name)) == float(getattr(t, name))
    rng = np.random.default_rng(1)
    uv = rng.uniform([0, 0], [752, 480], (500, 2)).astype(np.float32)
    np.testing.assert_allclose(t.undistort_points(_t(uv)).numpy(),
                               np.asarray(j.undistort_points(jnp.asarray(uv))), rtol=0, atol=1e-3)
    pc = seeded_points(200, 2, r_max=0.6)
    np.testing.assert_allclose(t.project(_t(pc)).numpy(), np.asarray(j.project(jnp.asarray(pc))),
                               rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(convert.pinhole(j, device="cpu").dist.numpy(), np.asarray(j.dist))
    # fewer than five terms are padded to five, as before
    assert tcam.Pinhole.create(458, 457, 367, 248, dist=[0.1, 0.01], width=752, height=480,
                               device="cpu").dist.shape == (5,)


def test_pinhole_distort_normalized():
    rng = np.random.default_rng(3)
    xy = rng.uniform(-0.8, 0.8, (300, 2)).astype(np.float32)
    for dist in (DIST8, DIST_K3, DIST_K3[:4]):
        j = jcam.Pinhole.create(458, 457, 367, 248, dist=dist, width=752, height=480)
        t = tcam.Pinhole.create(458, 457, 367, 248, dist=dist, width=752, height=480, device="cpu")
        np.testing.assert_allclose(t.distort_normalized(_t(xy)).numpy(),
                                   np.asarray(j.distort_normalized(jnp.asarray(xy))),
                                   rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# Fisheye
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def fisheyes():
    return jcam.Fisheye.create(**TUM_VI), tcam.Fisheye.create(**TUM_VI, device="cpu")


def test_fisheye_project_and_jacobian(fisheyes):
    """project within 1e-4 px; the closed-form Jacobian within 1e-5 of
    the largest entry of JAX's vmap(jacfwd(project)), on-axis points
    (r = 0: diag(fx, fy), zero z column) included."""
    j, t = fisheyes
    pc = seeded_points(2000, 4)
    np.testing.assert_allclose(t.project(_t(pc)).numpy(), np.asarray(j.project(jnp.asarray(pc))),
                               rtol=0, atol=1e-4)
    Jj = np.asarray(j.proj_jacobian(jnp.asarray(pc)))
    Jt = t.proj_jacobian(_t(pc)).numpy()
    assert Jt.shape == Jj.shape == (2000, 2, 3)
    assert np.abs(Jt - Jj).max() <= 1e-5 * np.abs(Jj).max()
    np.testing.assert_allclose(Jt[:3], Jj[:3], rtol=0, atol=1e-3)
    # batched leading axes
    assert t.proj_jacobian(_t(pc.reshape(40, 50, 3))).shape == (40, 50, 2, 3)


def test_fisheye_back_projection(fisheyes):
    """unproject_theta (10 Newton steps) / back_project and uncertainty:
    within 1e-5 relative where the distorted radius is below 1.5 fx, within
    1e-3 over the whole 512x512 image (near theta = pi/2 the ray's
    tan(theta) is ill-conditioned: 9e-4 there, 2e-5 past it);
    undistort_points is the identity; is_in_image."""
    j, t = fisheyes
    u, v = np.meshgrid(np.arange(0, 512, 7, dtype=np.float32), np.arange(0, 512, 5, dtype=np.float32))
    uv = np.stack([u, v], -1).reshape(-1, 2)
    uv[0] = [TUM_VI["cx"], TUM_VI["cy"]]
    rj = np.asarray(j.back_project(jnp.asarray(uv)))
    rt = t.back_project(_t(uv)).numpy()
    np.testing.assert_array_equal(rt, t.unproject_theta(_t(uv)).numpy())
    rel = np.abs(rt - rj).max(-1) / np.maximum(np.abs(rj).max(-1), 1.0)
    theta_d = np.hypot(uv[:, 0] - TUM_VI["cx"], uv[:, 1] - TUM_VI["cy"]) / TUM_VI["fx"]
    assert rel[theta_d < 1.5].max() <= 1e-5 and rel.max() <= 1e-3
    uj = np.asarray(j.uncertainty(jnp.asarray(uv)))
    ut = t.uncertainty(_t(uv)).numpy()
    rel_u = np.abs(ut - uj) / np.maximum(np.abs(uj), 1.0)
    assert rel_u[theta_d < 1.5].max() <= 1e-5 and rel_u.max() <= 1e-3
    # a pixel -> ray -> pixel round trip inside the field of view
    inner = theta_d < 1.3
    back = t.project(_t(rt[inner])).numpy()
    np.testing.assert_allclose(back, uv[inner], rtol=0, atol=2e-3)
    np.testing.assert_array_equal(t.undistort_points(_t(uv)).numpy(), uv)
    probe = np.array([[0, 0], [511.9, 511.9], [-0.1, 5], [512, 5], [5, 512]], np.float32)
    np.testing.assert_array_equal(t.is_in_image(_t(probe)).numpy(),
                                  np.asarray(j.is_in_image(jnp.asarray(probe))))


def test_project_np_and_host_intrinsics(fisheyes):
    jf, tf = fisheyes
    kw = dict(dist=DIST8[:4], width=752, height=480)
    jp = jcam.Pinhole.create(458.654, 457.296, 367.215, 248.375, **kw)
    tp = tcam.Pinhole.create(458.654, 457.296, 367.215, 248.375, device="cpu", **kw)
    pc = seeded_points(3000, 6, r_max=1.2).astype(np.float64)
    pc[::7, 2] *= -1.0  # some behind the camera
    for j, t in ((jp, tp), (jf, tf)):
        hj, ht = jcam._host_intrinsics(j), tcam._host_intrinsics(t)
        assert ht.keys() == hj.keys()
        for k in hj:  # the pinhole bounds: radtan undistortion, 2 ulps apart
            np.testing.assert_allclose(ht[k], hj[k], rtol=0, atol=1e-4, err_msg=k)
        assert tcam._host_intrinsics(t) is ht  # read once per camera
        uv_j, ok_j = jcam.project_np(j, pc)
        uv_t, ok_t = tcam.project_np(t, pc)
        np.testing.assert_array_equal(uv_t, uv_j)
        np.testing.assert_array_equal(ok_t, ok_j)
        assert 0 < ok_t.sum() < len(pc)


# ---------------------------------------------------------------------------
# quaternions and SE(3)
# ---------------------------------------------------------------------------


def test_quaternions_match_jax():
    """rot_to_quat over rotations that pick each of the four Shepperd
    branches (angles near pi about each axis included), and quat_to_rot of
    unnormalized quaternions."""
    rng = np.random.default_rng(8)
    w = rng.normal(size=(200, 3))
    w[:4] = np.array([[0, 0, 0], [3.1, 0, 0], [0, 3.1, 0], [0, 0, 3.1]])
    R = np.asarray(jlie.exp_so3(jnp.asarray(w.astype(np.float32))))
    qj = np.asarray(jlie.rot_to_quat(jnp.asarray(R)))
    qt = tlie.rot_to_quat(_t(R)).numpy()
    np.testing.assert_allclose(qt, qj, rtol=0, atol=2e-6)
    assert (qt[:, 0] >= 0).all()
    q = rng.normal(size=(50, 4)).astype(np.float32) * 3
    np.testing.assert_allclose(tlie.quat_to_rot(_t(q)).numpy(),
                               np.asarray(jlie.quat_to_rot(jnp.asarray(q))), rtol=0, atol=2e-6)
    np.testing.assert_allclose(tlie.quat_to_rot(_t(qt)).numpy(), R, rtol=0, atol=5e-6)


def test_se3_pose_matches_jax():
    rng = np.random.default_rng(9)
    R = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(size=(6, 3)).astype(np.float32))))
    t = rng.normal(size=(6, 3)).astype(np.float32)
    R2 = R[::-1].copy()
    p = rng.normal(size=(6, 3)).astype(np.float32)
    a, b = jse3.Pose(jnp.asarray(R), jnp.asarray(t)), tse3.Pose(_t(R), _t(t))
    a2, b2 = jse3.Pose(jnp.asarray(R2), jnp.asarray(t[::-1].copy())), tse3.Pose(_t(R2), _t(t[::-1]))
    close = lambda x, y: np.testing.assert_allclose(np.asarray(x), np.asarray(y), rtol=0, atol=3e-6)
    close(b.apply(_t(p)), a.apply(jnp.asarray(p)))
    for x, y in zip(b.compose(b2), a.compose(a2)):
        close(x, y)
    for x, y in zip(b.inverse(), a.inverse()):
        close(x, y)
    for x, y in zip(b.normalized(), a.normalized()):
        close(x, y)
    for x, y in zip(b.to_quat_t(), a.to_quat_t()):
        close(x, y)
    q, _ = b.to_quat_t()
    for x, y in zip(tse3.from_quat_t(q, _t(t)), jse3.from_quat_t(jnp.asarray(q.numpy()), t)):
        close(x, y)
    ident = tse3.Pose.identity((2,), device="cpu")
    assert ident.R.shape == (2, 3, 3) and float(ident.t.abs().sum()) == 0.0


# ---------------------------------------------------------------------------
# settings
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", PROFILES, ids=[os.path.basename(p) for p in PROFILES])
def test_settings_profiles_load(path):
    """Every profile loads in both packages to the same dict; its camera
    and IMU calibration are JAX's (tum_vi.yaml is the equidistant one)."""
    sj, st = jconfig.load_settings(path), tconfig.load_settings(path)
    assert st == sj
    cj, ct = jconfig.build_camera(sj), tconfig.build_camera(st, device="cpu")
    assert type(ct).__name__ == type(cj).__name__
    assert isinstance(ct, tcam.Fisheye) == (os.path.basename(path) == "tum_vi.yaml")
    assert (ct.width, ct.height) == (cj.width, cj.height)
    for name in ("fx", "fy", "cx", "cy", "dist"):
        np.testing.assert_array_equal(getattr(ct, name).numpy(), np.asarray(getattr(cj, name)))
    if isinstance(ct, tcam.Pinhole):
        for name in ("min_x", "max_x", "min_y", "max_y"):
            np.testing.assert_allclose(float(getattr(ct, name)), float(getattr(cj, name)),
                                       rtol=0, atol=1e-3)
    ij, it = jconfig.build_imu_calib(sj), tconfig.build_imu_calib(st, device="cpu")
    for name in ("R_bc", "t_bc", "R_cb", "cov_noise", "cov_walk", "bg0", "ba0"):
        np.testing.assert_array_equal(getattr(it, name).numpy(), np.asarray(getattr(ij, name)),
                                      err_msg=name)
    np.testing.assert_allclose(it.t_cb.numpy(), np.asarray(ij.t_cb), rtol=0, atol=1e-7)
    assert it.freq == ij.freq


def test_opencv_yaml_and_rcb(tmp_path):
    """The reference's OpenCV-style YAML (directive, !!opencv-matrix) and an
    IMU node given as Rcb/tcb."""
    text = """%YAML:1.0
---
Camera:
  Width: 64
  Height: 48
  CameraMatrix: !!opencv-matrix
    rows: 3
    cols: 3
    dt: d
    data: [50.0, 0, 32.0, 0, 51.0, 24.0, 0, 0, 1]
  Distortion_Model: radtan
IMU:
  NoiseGyro: 1e-4
  WalkGyro: 1e-5
  NoiseAcc: 1e-3
  WalkAcc: 1e-3
  Rcb: [0, 1, 0, -1, 0, 0, 0, 0, 1]
  tcb: [0.1, 0.2, 0.3]
"""
    path = tmp_path / "cv.yaml"
    path.write_text(text)
    sj, st = jconfig.load_settings(str(path)), tconfig.load_settings(str(path))
    assert st == sj
    ct = tconfig.build_camera(st, device="cpu")
    assert float(ct.fx) == 50.0 and ct.dist.shape == (5,)
    ij, it = jconfig.build_imu_calib(sj), tconfig.build_imu_calib(st, device="cpu")
    np.testing.assert_allclose(it.t_bc.numpy(), np.asarray(ij.t_bc), rtol=0, atol=1e-7)
    np.testing.assert_array_equal(it.R_bc.numpy(), np.asarray(ij.R_bc))
