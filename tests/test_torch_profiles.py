"""PyTorch port: the KITTI-raw and TUM-VI fisheye profiles (settings/kitti.yaml,
settings/tum_vi.yaml) against the JAX package on the CPU, on the datasets
`chip_smoke.write_dataset` renders (the files chip_smoke.py's path 14 runs
on the card):

(a) both packages' loaders read the writer's KITTI and TUM-VI folders (3
    frames each) to the same images, times and IMU rows, and the images are
    the rendered 8-bit values (TUM-VI's through the 16-bit PNG branch);
(b) the KITTI camera: the undistorted-pixel bounds within 1e-3 px and
    `undistort_points` over a grid of the whole 1392x512 image within
    UNDISTORT_ATOL (the radtan fixed-point iteration, FMA contraction on
    one side: the largest difference is printed);
(c) the extractor at KITTI's full shape (1392x512, 1,536 features, 8
    levels) on a rendered corridor frame: the same keypoints (at least 95%
    of JAX's at the same (x, y, level)), at most 0.1% of descriptor bits
    apart, and `finish_features`' undistorted keypoints within
    UNDISTORT_ATOL;
(d) the fisheye bootstrap's ideal-pixel mapping (`tracking.ideal_pixels`)
    on a rendered TUM-VI frame's keypoints and the image's corners, whose
    rays lie past 90 degrees from the axis, within IDEAL_RTOL of the JAX
    tracker's `_ideal`;
(e) a port `System` over the first SYSTEM_FRAMES frames of the TUM-VI
    stream (the writer's files through `runners.datasets.run_sequence`,
    the profile's settings, no vocabulary) beside the JAX package's on the
    same files, held to tests/test_e2e_image_fisheye.py's gates: the
    bootstrap within 20 frames, no LOST frame, keyframes within 30% of
    JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from monoorbslam3_tpu import config as jconfig
from monoorbslam3_tpu.frontend import frame as jframe
from monoorbslam3_tpu.ops import orb as jorb
from monoorbslam3_tpu.runners import datasets as jdatasets
from monoorbslam3_tpu_torch import config as tconfig
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch.frontend import frame as tframe
from monoorbslam3_tpu_torch.frontend import tracking as ttracking
from monoorbslam3_tpu_torch.ops import orb as torb
from monoorbslam3_tpu_torch.runners import datasets as tdatasets

from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

UNDISTORT_ATOL = 1e-3
IDEAL_RTOL = 1e-4
LOADERS = {"kitti": (jdatasets.kitti_dataset, tdatasets.kitti_dataset),
           "tumvi": (jdatasets.tumvi_dataset, tdatasets.tumvi_dataset)}


@pytest.fixture(scope="module")
def disks(tmp_path_factory):
    """The writer's KITTI and TUM-VI folders, 3 frames each."""
    root = tmp_path_factory.mktemp("profiles")
    for kind in LOADERS:
        cs.write_dataset(root / kind, kind, 3)
    return root


def _settings(kind):
    return str(cs.SETTINGS / cs.DATASET_PROFILES[kind]["settings"])


@pytest.mark.parametrize("kind", list(LOADERS))
def test_loaders_read_the_writer_alike(disks, kind):
    j_load, t_load = LOADERS[kind]
    jf, tf = list(j_load(str(disks / kind)).frames()), list(t_load(str(disks / kind)).frames())
    rows, _, _, _ = cs._dataset_stream(kind, 3)
    assert len(jf) == len(tf) == 3
    for (tj, ij, mj), (tt, it, mt), (t, img, imu) in zip(jf, tf, rows):
        assert tj == tt and abs(tt - t) < 1e-6
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(it, np.clip(np.asarray(img), 0, 255).astype(np.uint8))
        assert (mj is None) == (mt is None) == (imu is None)
        if mt is not None:
            np.testing.assert_array_equal(mt, mj)
            np.testing.assert_allclose(mt, imu, rtol=0, atol=1e-8)


def test_kitti_camera_bounds_and_undistortion():
    s = jconfig.load_settings(_settings("kitti"))
    j, t = jconfig.build_camera(s), tconfig.build_camera(s, device="cpu")
    assert (t.width, t.height) == (1392, 512) and t.dist.shape == (5,)
    for name in ("min_x", "max_x", "min_y", "max_y"):
        np.testing.assert_allclose(float(getattr(t, name)), float(getattr(j, name)),
                                   rtol=0, atol=1e-3, err_msg=name)
    # the whole image, its last row and column included
    gx = np.concatenate([np.arange(0.0, 1392.0, 8.0), [1391.0]])
    gy = np.concatenate([np.arange(0.0, 512.0, 8.0), [511.0]])
    uv = np.stack(np.meshgrid(gx, gy), -1).reshape(-1, 2).astype(np.float32)
    got = t.undistort_points(torch.as_tensor(uv)).numpy()
    ref = np.asarray(j.undistort_points(jnp.asarray(uv)))
    err = np.abs(got - ref).max()
    print(f"KITTI undistort_points over {len(uv)} grid pixels: largest difference {err:.3e} px, "
          f"largest move {np.abs(ref - uv).max():.1f} px")
    assert np.isfinite(got).all() and err <= UNDISTORT_ATOL


def _bits(desc_u32):
    return np.unpackbits(np.ascontiguousarray(desc_u32).view(np.uint8), axis=1)


def test_extractor_at_kitti_shape(disks):
    s = jconfig.load_settings(_settings("kitti"))
    _, image, _ = next(iter(tdatasets.kitti_dataset(str(disks / "kitti")).frames()))
    ref = {k: np.asarray(v) for k, v in
           jorb.OrbExtractor(512, 1392, n_features=1536, n_levels=8)(image).items()}
    ext = torb.OrbExtractor(512, 1392, n_features=1536, n_levels=8, device="cpu")
    out = ext(image)
    assert out["desc"].shape == (1536, 8)
    # K1's atlas contract (monoorbslam3_tpu/ops/pallas_kernels.py: ys in
    # [0, Ha - 56], xs in [0, Wa - 256]) on the 1392-wide pyramid, whose
    # levels have odd widths
    atlas, ys, xs, _ = ext._detect(torch.as_tensor(image))
    Ha, Wa = atlas.shape
    assert ys.shape == (1536,) and len({w % 2 for _, w in ext._shapes}) == 2
    assert 0 <= int(ys.min()) and int(ys.max()) <= Ha - 56
    assert 0 <= int(xs.min()) and int(xs.max()) <= Wa - 256
    key_j = {(float(x), float(y), int(lv)): i for i, ((x, y), lv, v) in
             enumerate(zip(ref["xy"], ref["level"], ref["valid"])) if v}
    xy_t, lv_t, va_t = out["xy"].numpy(), out["level"].numpy(), out["valid"].numpy()
    pairs = [(key_j[k], i) for i, k in enumerate(
        (float(x), float(y), int(lv)) for (x, y), lv in zip(xy_t, lv_t)) if va_t[i] and k in key_j]
    overlap = len(pairs) / max(len(key_j), 1)
    assert len(key_j) > 1400 and overlap >= 0.95, (len(key_j), overlap)
    ij, it = map(np.asarray, zip(*pairs))
    frac = (_bits(convert.desc_to_numpy(out["desc"])[it]) != _bits(ref["desc"][ij])).mean()
    print(f"KITTI extractor: {len(key_j)} keypoints, overlap {overlap:.4f}, {frac:.2e} of bits")
    assert frac <= 1e-3, frac
    # finish_features: the undistortion of the keypoints at KITTI's k1
    jcam, tcam = jconfig.build_camera(s), tconfig.build_camera(s, device="cpu")
    fj = jframe.finish_features({k: jnp.asarray(v) for k, v in ref.items()}, jcam,
                                jorb.OrbExtractor(512, 1392, n_features=1536,
                                                  n_levels=8).scale_factors)
    ft = tframe.finish_features(out, tcam, ext.scale_factors)
    got, want = ft["xy"].numpy()[it], np.asarray(fj["xy"])[ij]
    err = np.abs(got - want).max()
    print(f"KITTI finish_features: largest difference {err:.3e} px over {len(it)} keypoints")
    assert err <= UNDISTORT_ATOL
    np.testing.assert_allclose(ft["sigma2"].numpy()[it], np.asarray(fj["sigma2"])[ij], rtol=1e-6)


def _jax_ideal(camera, xy):
    """The JAX tracker's `_ideal` (frontend/tracking.py, the bootstrap)."""
    fx, fy = float(camera.fx), float(camera.fy)
    cx, cy = float(camera.cx), float(camera.cy)
    r = np.asarray(camera.back_project(jnp.asarray(xy)))
    z = np.maximum(r[:, 2], 1e-6)
    uv = np.stack([fx * r[:, 0] / z + cx, fy * r[:, 1] / z + cy], -1)
    return uv.astype(np.float32), r[:, 2] > 1e-6


def test_fisheye_ideal_pixels(disks):
    s = jconfig.load_settings(_settings("tumvi"))
    jcam, tcam = jconfig.build_camera(s), tconfig.build_camera(s, device="cpu")
    _, image, _ = next(iter(tdatasets.tumvi_dataset(str(disks / "tumvi")).frames()))
    out = torb.OrbExtractor(512, 512, n_features=1024, n_levels=8, device="cpu")(image)
    xy = out["xy"].numpy()[out["valid"].numpy()]
    corners = np.array([[0.0, 0.0], [511.0, 0.0], [0.0, 511.0], [511.0, 511.0], [2.0, 256.0]],
                       np.float32)
    xy = np.concatenate([xy, corners]).astype(np.float32)
    got, ok = ttracking.ideal_pixels(tcam, torch.as_tensor(xy))
    ref, ok_ref = _jax_ideal(jcam, xy)
    np.testing.assert_array_equal(ok.numpy(), ok_ref)
    rel = np.abs(got.numpy() - ref) / np.maximum(np.abs(ref), 1.0)
    print(f"TUM-VI ideal pixels: {len(xy)} keypoints, largest relative difference "
          f"{rel.max():.2e}, largest |uv| {np.abs(ref).max():.0f} px")
    np.testing.assert_allclose(got.numpy(), ref, rtol=IDEAL_RTOL, atol=1e-3)
    # rays past 90 degrees map to the opposite side of the principal point
    c = np.array([float(tcam.cx), float(tcam.cy)])
    flipped = ((got.numpy() - c) * (xy - c)).sum(-1) < 0
    assert flipped[-5:-1].all() and len(xy) > 500


# (e)'s frames: tests/test_e2e_image_fisheye.py's bootstrap window (both
# packages bootstrap at frame 1 and keep five keyframes). The fixture takes
# ~90 s on a CPU: the JAX System's first compile (~30 s) and the port's
# ~2 s a frame at one thread; 12 frames would save ~15 s of it
SYSTEM_FRAMES = 20


@pytest.fixture(scope="module")
def fisheye_systems(tmp_path_factory):
    """The first SYSTEM_FRAMES frames of the TUM-VI stream, written by
    `chip_smoke.write_dataset` and read through each package's loader into
    its own `System` (`config.build_system` of the written settings: every
    knob its default, no vocabulary) by `run_sequence`."""
    root = tmp_path_factory.mktemp("tumvi_system") / "tumvi"
    cs.write_dataset(root, "tumvi", SYSTEM_FRAMES)
    settings = str(root / cs.DATASET_SETTINGS_NAME)
    jsys = jconfig.build_system(settings)
    j_states = jdatasets.run_sequence(jsys, jdatasets.tumvi_dataset(str(root)),
                                      progress_every=0, log=lambda line: None)
    tsys = tconfig.build_system(settings, device="cpu")
    t_states = tdatasets.run_sequence(tsys, tdatasets.tumvi_dataset(str(root)),
                                      progress_every=0, log=lambda line: None)
    jsys.shutdown()
    tsys.shutdown()
    return (jsys, np.asarray(j_states)), (tsys, np.asarray(t_states))


def test_fisheye_system_tracks_as_jax(fisheye_systems):
    """tests/test_e2e_image_fisheye.py's gates on the port, beside JAX's run
    of the same files: the bootstrap within 20 frames, no LOST frame, the
    keyframes within 30% of JAX's."""
    (jsys, j_states), (tsys, t_states) = fisheye_systems
    print(f"TUM-VI System over {SYSTEM_FRAMES} frames: JAX {''.join(map(str, j_states))} "
          f"{jsys.store.n_keyframes()} keyframes, the port {''.join(map(str, t_states))} "
          f"{tsys.store.n_keyframes()} keyframes")
    assert len(t_states) == len(j_states) == SYSTEM_FRAMES
    for states in (j_states, t_states):
        ok = states == ttracking.OK
        assert ok.any() and np.nonzero(ok)[0][0] < 20
        assert (states == ttracking.LOST).sum() == 0
    n_j, n_t = jsys.store.n_keyframes(), tsys.store.n_keyframes()
    assert abs(n_t - n_j) <= 0.3 * n_j, (n_t, n_j)
