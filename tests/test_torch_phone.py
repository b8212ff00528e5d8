"""PyTorch port: the phone's own layout (phoneDemo.cpp: `video.mp4` beside
times.txt and imu.txt, decoded by cv2) through both packages' user entry
point on the CPU. (The card's host has no cv2: chip_smoke.py's path 15 runs
the same profile from the EuRoC layout.)

`chip_smoke.write_dataset(root, "phone", VIDEO_FRAMES, layout="phone")`
renders the phone profile's first frames (settings/phone.yaml: 1280x720,
1,024 features, the rig turned onto the circle world's wall,
`chip_smoke.phone_body`) into an mp4v video written by cv2; then:

(d) both packages' `VideoDataset` decode the video to the same frames, the
    same times and the same IMU rows, the first RENDERED_FRAMES each within
    VIDEO_MEAN_ABS gray levels of the rendered 8-bit frame on average (mp4v
    is lossy); and
    `runners.datasets.main(["phone", settings, root, trajectory])` of each
    package (the port with `--device cpu`) tracks the video to
    tests/test_e2e_image_fisheye.py's gates: the bootstrap within 20
    frames, no LOST frame, keyframes within 30% of JAX's.
"""

import time

import numpy as np
import pytest

import chip_smoke as cs
from monoorbslam3_tpu import config as jconfig
from monoorbslam3_tpu.runners import datasets as jdatasets
from monoorbslam3_tpu_torch import config as tconfig
from monoorbslam3_tpu_torch.frontend import tracking as ttracking
from monoorbslam3_tpu_torch.runners import datasets as tdatasets

from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

cv2 = pytest.importorskip("cv2")

# the video's frames: both packages bootstrap at frame 1 or 2 and keep 3
# keyframes by frame 11; ~115 s of one worker (the rendering ~1.7 s a
# 1280x720 frame, each package's main ~45 s: the JAX System's first
# compile, the port's ~3 s a frame at one thread)
VIDEO_FRAMES = 12
RENDERED_FRAMES = 3
VIDEO_MEAN_ABS = 6.0  # mp4v at cv2's default quality: ~4 (an unrelated frame: ~50)


@pytest.fixture(scope="module")
def phone_video(tmp_path_factory):
    root = tmp_path_factory.mktemp("phone_video") / "phone"
    cs.write_dataset(root, "phone", VIDEO_FRAMES, layout="phone")
    return root


def _main(package_config, datasets, root, name, extra=()):
    """`datasets.main(["phone", ...])` with the System it builds wrapped
    to record each frame's state. Returns (system, states)."""
    states, built = [], {}
    inner = package_config.build_system

    def build_system(*a, **k):
        syst = built["system"] = inner(*a, **k)
        track = syst.track

        def tracked(t, image, imu=None):
            state = track(t, image, imu)
            states.append(int(state))
            return state

        syst.track = tracked
        return syst

    package_config.build_system = build_system
    t0 = time.perf_counter()
    try:
        datasets.main(["phone", str(root / cs.DATASET_SETTINGS_NAME), str(root),
                       str(root.parent / f"{name}_trajectory.txt"), *extra])
    finally:
        package_config.build_system = inner
    print(f"{name} main over the phone video: {time.perf_counter() - t0:.1f} s")
    return built["system"], np.asarray(states)


def test_phone_video_decodes_alike(phone_video):
    jf = list(jdatasets.VideoDataset(str(phone_video)).frames())
    tf = list(tdatasets.VideoDataset(str(phone_video)).frames())
    assert len(jf) == len(tf) == VIDEO_FRAMES
    for (tj, ij, mj), (tt, it, mt) in zip(jf, tf):
        assert tj == tt and it.shape == (720, 1280) and it.dtype == np.float32
        np.testing.assert_array_equal(it, ij)
        assert (mj is None) == (mt is None)
        if mt is not None:
            np.testing.assert_array_equal(mt, mj)
    rows, _, _, _ = cs._dataset_stream("phone", RENDERED_FRAMES)
    diffs = []
    for (tt, it, _), (t, img, _) in zip(tf, rows):
        assert abs(tt - t) < 1e-6
        rendered = np.clip(np.asarray(img), 0, 255).astype(np.uint8).astype(np.float32)
        diffs.append(float(np.abs(it - rendered).mean()))
    print(f"phone video: mean absolute difference from the rendered frames "
          f"{min(diffs):.2f}-{max(diffs):.2f} gray levels")
    assert max(diffs) <= VIDEO_MEAN_ABS


def test_phone_main_tracks_as_jax(phone_video):
    jsys, j_states = _main(jconfig, jdatasets, phone_video, "jax")
    tsys, t_states = _main(tconfig, tdatasets, phone_video, "port", ("--device", "cpu"))
    print(f"phone video through main over {VIDEO_FRAMES} frames: JAX "
          f"{''.join(map(str, j_states))} {jsys.store.n_keyframes()} keyframes, the port "
          f"{''.join(map(str, t_states))} {tsys.store.n_keyframes()} keyframes")
    assert len(t_states) == len(j_states) == VIDEO_FRAMES
    for states in (j_states, t_states):
        ok = states == ttracking.OK
        assert ok.any() and np.nonzero(ok)[0][0] < 20
        assert (states == ttracking.LOST).sum() == 0
    n_j, n_t = jsys.store.n_keyframes(), tsys.store.n_keyframes()
    assert abs(n_t - n_j) <= 0.3 * n_j, (n_t, n_j)
    for name in ("jax", "port"):
        assert (phone_video.parent / f"{name}_trajectory.txt").read_text().count("\n") >= 2
