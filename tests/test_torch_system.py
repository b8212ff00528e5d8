"""PyTorch port: the `System` façade (`monoorbslam3_tpu_torch/system.py`)
and `config.build_system` against the JAX package's on the CPU.

- One module-scoped run of the port's `System.track_features` on the CPU
  over 4 s of the feature-injection world of tests/test_e2e_synthetic.py
  (256 features, its configuration), held to that test's gates: the OK
  ratio above 0.95 after the bootstrap, the inertial init, the keyframe
  ATE below 6 cm, and the five exports written.
- From that run's checkpoint, loaded into a port System and a JAX System:
  the four text exports identical to the byte, `keyframe_trajectory`
  equal, both `_handle_lost` branches taken the same way (a young map
  before the init resets at once and reports NOT_INITIALIZED; an older map
  asks for a reset, which archives the segment), the longest-segment
  choice alike; and each package's `load_state` reads the other's
  `save_state`.
- The async mapper's smoke (the twin of tests/test_aux.py's).
- `build_system` on every profile under settings/ gives the JAX package's
  configuration, capacities, camera, calibration and vocabulary (and its
  extractor's parameters on one profile); `viewer_dir` starts the viewer
  and a mesh of another device type raises.
"""

import time
import types
from pathlib import Path

import numpy as np
import pytest

from monoorbslam3_tpu import config as jconfig
from monoorbslam3_tpu.frontend import tracking as JT
from monoorbslam3_tpu.models.camera import Pinhole as JPinhole
from monoorbslam3_tpu.models.imu import ImuCalib as JCalib
from monoorbslam3_tpu.system import System as JSystem
from monoorbslam3_tpu_torch import config as tconfig
from monoorbslam3_tpu_torch import sim as tsim
from monoorbslam3_tpu_torch.evaluation.ate import umeyama_align
from monoorbslam3_tpu_torch.evaluation.metrics import load_tum
from monoorbslam3_tpu_torch.frontend import tracking as T
from monoorbslam3_tpu_torch.models.camera import Pinhole
from monoorbslam3_tpu_torch.models.imu import ImuCalib
from monoorbslam3_tpu_torch.system import System

from tests.test_torch_tracking import (CAM, CONFIG, NOISE, R_BC, T_BC, _stream,
                                      one_torch_thread)  # noqa: F401  (autouse)

SETTINGS = Path(__file__).resolve().parents[1] / "settings"
T_END = 4.0
TEXT_EXPORTS = ("save_keyframe_trajectory", "save_velocity_and_bias", "save_point_cloud",
                "save_keyframe_depth")


def _port_system(**kw):
    cam = Pinhole.create(**CAM, device="cpu")
    calib = ImuCalib.create(R_bc=R_BC, t_bc=T_BC, **NOISE, device="cpu")
    return System(cam, calib, config=dict(CONFIG), device="cpu", **kw)


def _jax_system():
    cam = JPinhole.create(**CAM)
    calib = JCalib.create(R_bc=R_BC, t_bc=T_BC, **NOISE)
    return JSystem(cam, calib, config=dict(CONFIG))


def _exports(syst, out: Path, tag: str) -> dict:
    paths = {}
    for name in TEXT_EXPORTS:
        paths[name] = out / f"{tag}_{name}.txt"
        getattr(syst, name)(str(paths[name]))
    paths["save_state"] = out / f"{tag}_state.npz"
    syst.save_state(str(paths["save_state"]))
    return paths


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    out = tmp_path_factory.mktemp("system")
    syst = _port_system()
    states, times = [], []
    for t, feats, imu, _ in _stream(tsim, syst.camera, int(round(T_END * 20))):
        states.append(syst.track_features(t, feats, imu))
        times.append(t)
    syst.shutdown()
    return dict(syst=syst, states=np.asarray(states), times=np.asarray(times),
                exports=_exports(syst, out, "port"), out=out)


def test_tracks_and_initializes(run):
    """tests/test_e2e_synthetic.py's gates on the port's System."""
    states = run["states"]
    ok = states == T.OK
    assert ok.any(), "never initialized"
    first = int(np.nonzero(ok)[0][0])
    assert run["times"][first] < 2.0, "slow initialization"
    assert (states == T.LOST).sum() == 0
    assert ok[first:].mean() > 0.95, f"tracking OK ratio {ok[first:].mean()}"
    assert run["syst"].mapper.imu_state >= 1, "IMU never initialized"


def test_keyframe_trajectory_accuracy(run):
    """The keyframe trajectory System exports (camera poses, TUM), scaled
    and aligned to the true camera positions: below 6 cm."""
    syst = run["syst"]
    t, p, _ = load_tum(str(run["exports"]["save_keyframe_trajectory"]))
    assert len(t) == syst.store.n_keyframes() >= 5
    traj = tsim.Trajectory()
    R_wb, p_wb = traj.R_wb(t), traj.pos(t)
    gt = p_wb + np.einsum("nij,j->ni", R_wb, T_BC)
    s, R, tt = umeyama_align(p, gt)
    err = np.linalg.norm((s * p @ R.T + tt) - gt, axis=1)
    rmse = float(np.sqrt((err ** 2).mean()))
    assert rmse < 0.06, f"KF-trajectory ATE RMSE {rmse * 100:.1f} cm"


def test_exports_written(run):
    syst, paths = run["syst"], run["exports"]
    for p in paths.values():
        assert p.stat().st_size > 0, p
    lines = paths["save_keyframe_trajectory"].read_text().splitlines()
    assert len(lines) == syst.store.n_keyframes() and len(lines[0].split()) == 8
    assert f"POINTS {syst.store.n_points()}" in paths["save_point_cloud"].read_text()
    assert len(paths["save_velocity_and_bias"].read_text().splitlines()) == len(lines)


@pytest.fixture(scope="module")
def loaded(run):
    """The port run's checkpoint loaded into a fresh port System and a JAX
    System."""
    ckpt = str(run["exports"]["save_state"])
    tsys, jsys = _port_system(), _jax_system()
    tsys.load_state(ckpt)
    jsys.load_state(ckpt)
    return tsys, jsys


def test_exports_identical_from_one_checkpoint(run, loaded):
    tsys, jsys = loaded
    out = run["out"]
    tp, jp = _exports(tsys, out, "tload"), _exports(jsys, out, "jload")
    for name in TEXT_EXPORTS:
        assert tp[name].read_bytes() == jp[name].read_bytes(), name
        # and the reloaded port writes what the live run wrote
        assert tp[name].read_bytes() == run["exports"][name].read_bytes(), name


def _same_traj(a, b):
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_keyframe_trajectory_matches(loaded):
    tsys, jsys = loaded
    _same_traj(tsys.keyframe_trajectory(), jsys.keyframe_trajectory())


def test_checkpoints_cross_packages(run, loaded, tmp_path):
    """The JAX package's save_state read by the port and the port's read by
    the JAX package: the same store arrays and the same resumed scalars."""
    tsys, jsys = loaded
    jsys.save_state(str(tmp_path / "j.npz"))
    back = _port_system()
    back.load_state(str(tmp_path / "j.npz"))
    for key, val in vars(tsys.store).items():
        if isinstance(val, np.ndarray):
            np.testing.assert_array_equal(getattr(back.store, key), val, err_msg=key)
    for obj in ("tracking", "mapper"):
        for key in ("state", "imu_ready", "ref_kf", "last_kf_id", "last_kf_time",
                    "kf_tracked_count", "imu_state", "imu_init_time", "kf_counter"):
            a = getattr(getattr(tsys, obj), key, None)
            assert a == getattr(getattr(jsys, obj), key, None), (obj, key)
            assert a == getattr(getattr(back, obj), key, None), (obj, key)
    assert tsys.tracking.resume_prev_t == jsys.tracking.resume_prev_t
    assert tsys.tracking.resume_prev_t == run["syst"].tracking.last_frame.time
    np.testing.assert_array_equal(tsys.tracking.kf_imu_buffer.gyro,
                                  jsys.tracking.kf_imu_buffer.gyro)


def _both_from(run):
    ckpt = str(run["exports"]["save_state"])
    tsys, jsys = _port_system(), _jax_system()
    tsys.load_state(ckpt)
    jsys.load_state(ckpt)
    return tsys, jsys


def test_handle_lost_young_map_resets(run):
    """A loss before the inertial init of a map younger than 10 s: both
    packages reset at once, report NOT_INITIALIZED and archive the
    segment."""
    tsys, jsys = _both_from(run)
    for s in (tsys, jsys):
        s.mapper.imu_state = 0
    n_kf = tsys.store.n_keyframes()
    rt, rj = tsys._handle_lost(T.LOST), jsys._handle_lost(JT.LOST)
    assert rt == rj == T.NOT_INITIALIZED
    for s in (tsys, jsys):
        assert s.store.n_keyframes() == 0 and s.tracking.state == T.NOT_INITIALIZED
        assert not s._pending_reset and len(s._archived_traj) == 1
        assert len(s.keyframe_trajectory()[0]) == n_kf
    _same_traj(tsys.keyframe_trajectory(), jsys.keyframe_trajectory())


def test_handle_lost_older_map_requests_reset(run):
    """A loss after the inertial init: both return LOST and request a
    reset; the reset archives the segment, which stays the exported
    trajectory; the longest of several segments wins in both."""
    tsys, jsys = _both_from(run)
    assert tsys.mapper.imu_state >= 1
    n_kf = tsys.store.n_keyframes()
    assert tsys._handle_lost(T.LOST) == jsys._handle_lost(JT.LOST) == T.LOST
    for s in (tsys, jsys):
        assert s._pending_reset and s.store.n_keyframes() == n_kf
        s._do_reset()
        assert not s._pending_reset and s.store.n_keyframes() == 0
        assert s.mapper.imu_state == 0 and len(s._archived_traj) == 1
    _same_traj(tsys.keyframe_trajectory(), jsys.keyframe_trajectory())
    # a shorter archived segment before it does not win; a longer one does
    for s in (tsys, jsys):
        seg = s._archived_traj[0]
        s._archived_traj.insert(0, tuple(np.asarray(x)[:2] for x in seg))
        assert len(s.keyframe_trajectory()[0]) == n_kf
        s._archived_traj.append(tuple(np.concatenate([x, x]) for x in seg))
        assert len(s.keyframe_trajectory()[0]) == 2 * n_kf
    _same_traj(tsys.keyframe_trajectory(), jsys.keyframe_trajectory())


def test_async_mapper_smoke():
    """System(async_mapper=True): the host-thread mapper processes a
    keyframe handed to the tracker's callback and shuts down cleanly."""
    rng = np.random.default_rng(12)
    cam = Pinhole.create(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480,
                         device="cpu")
    calib = ImuCalib.create(R_bc=np.eye(3), t_bc=np.zeros(3), noise_gyro=1e-4,
                            noise_acc=1e-3, walk_gyro=1e-5, walk_acc=1e-4, device="cpu")
    syst = System(cam, calib, config={"n_features": 64}, async_mapper=True, device="cpu")
    feats = {"xy": rng.uniform(100, 600, (64, 2)).astype(np.float32),
             "level": np.zeros(64, np.int32), "angle": np.zeros(64, np.float32),
             "desc": rng.integers(0, 2**32, (64, 8), dtype=np.uint32),
             "valid": np.ones(64, bool), "sigma2": np.ones(64, np.float32)}
    z = np.zeros(3, np.float32)
    k0 = syst.store.add_keyframe(0.0, np.eye(3), z, z, z, z, feats)
    syst.tracking.new_kf_callback(k0, initial=True)
    deadline = time.time() + 5.0
    while syst.mapper.kf_counter < 1 and time.time() < deadline:
        time.sleep(0.01)
    assert syst.mapper.kf_counter == 1, "async mapper never processed the KF"
    syst.shutdown()
    assert not syst._thread.is_alive() and syst._queue.empty()


PROFILES = sorted(p.name for p in SETTINGS.glob("*.yaml"))


def _tracker_knobs(tr):
    keys = ("n_feat", "init_min_features", "init_min_matches", "min_track_inliers",
            "kf_tracked_ratio", "kf_many_inliers", "kf_weak_inliers", "kf_max_interval",
            "kf_min_interval", "coarse_weak_inliers", "rotation_check", "view_cos_gate",
            "local_pt_cap", "lost_timeout", "init_max_rel_sigma")
    return {k: getattr(tr, k) for k in keys}


@pytest.mark.parametrize("profile", PROFILES)
def test_build_system_profiles(profile):
    """The same configuration, capacities, camera, calibration and
    vocabulary as the JAX package's build_system (no extractor)."""
    path = str(SETTINGS / profile)
    js = jconfig.build_system(path, use_extractor=False)
    ts = tconfig.build_system(path, use_extractor=False, device="cpu")
    assert ts.device.type == "cpu"
    assert (ts.store.max_kf, ts.store.max_pt, ts.store.n_feat) == (
        js.store.max_kf, js.store.max_pt, js.store.n_feat)
    for key in ("local_k", "local_p", "local_o", "full_k", "full_polish_mode"):
        assert getattr(ts.problems, key) == getattr(js.problems, key), key
    assert _tracker_knobs(ts.tracking) == _tracker_knobs(js.tracking)
    for key in ("imu_init_kfs", "vi_refine_interval", "window", "graduation_rel_sigma"):
        assert getattr(ts.mapper, key) == getattr(js.mapper, key), key
    assert type(ts.camera).__name__ == type(js.camera).__name__
    for key in ("fx", "fy", "cx", "cy", "dist"):
        np.testing.assert_array_equal(np.asarray(getattr(ts.camera, key)),
                                      np.asarray(getattr(js.camera, key)), err_msg=key)
    for key in ("R_bc", "t_bc", "cov_noise"):
        np.testing.assert_allclose(np.asarray(getattr(ts.calib, key)),
                                   np.asarray(getattr(js.calib, key)), rtol=0, atol=0,
                                   err_msg=key)
    assert (ts.vocab is None) == (js.vocab is None)
    if ts.vocab is not None:
        nd, idf = ts.vocab.host_tables()
        np.testing.assert_array_equal(nd, np.asarray(js.vocab.node_desc))
        np.testing.assert_array_equal(idf, np.asarray(js.vocab.word_idf))
        assert (ts.vocab.k, ts.vocab.levels, ts.vocab.group_level) == (
            js.vocab.k, js.vocab.levels, js.vocab.group_level)


def test_build_system_with_extractor():
    """The system world's profile with its extractor: the same extractor
    parameters, the scale factors handed to the tracker, and an
    init_features_mult override building the init extractor."""
    path = str(SETTINGS / "synthetic_vocab.yaml")
    over = {"init_features_mult": 2}
    js = jconfig.build_system(path, config_overrides=over)
    ts = tconfig.build_system(path, config_overrides=over, device="cpu")
    for a, b in ((ts.extractor, js.extractor), (ts.init_extractor, js.init_extractor)):
        assert (a.height, a.width, a.n_features, a.n_levels, a.ini_th, a.min_th) == (
            b.height, b.width, b.n_features, b.n_levels, b.ini_th, b.min_th)
        np.testing.assert_array_equal(a.scale_factors, np.asarray(b.scale_factors))
    assert ts.tracking.init_max_rel_sigma == js.tracking.init_max_rel_sigma == 0.12
    np.testing.assert_array_equal(ts.tracking.scale_factors, np.asarray(js.tracking.scale_factors))


def test_unported_arguments_raise(tmp_path):
    """The two arguments that raised until they were ported: `viewer_dir`
    now starts the viewer thread, which joins at shutdown; `mesh` reaches
    `Problems`, which raises only for a mesh of another device type."""
    syst = _port_system(viewer_dir=str(tmp_path / "view"))
    assert syst.viewer is not None and syst.viewer._thread.is_alive()
    syst.shutdown()
    assert syst.viewer.is_finished() and (tmp_path / "view").is_dir()
    with pytest.raises(ValueError, match="mesh"):
        _port_system(mesh=types.SimpleNamespace(device_type="cuda"))
