"""PyTorch port: the tracker and the mapper together on the CPU, the port
alone. `Tracking` and `LocalMapping` wired in sync mode
(`tracking.new_kf_callback = mapper.process`, as the JAX package's System
wires them) over the feature-injection world of
tests/test_e2e_synthetic.py (256 features, its configuration and
capacities, its IMU noise and bias) for 4 s, held to that test's gates:
the bootstrap within 2 s, an OK ratio above 0.95 after it, the inertial
init (its 2 s span and 11 keyframes fit in 4 s), and the keyframe ATE
below 6 cm after a scaled alignment."""

import numpy as np
import pytest

from monoorbslam3_tpu_torch.backend.problems import Problems
from monoorbslam3_tpu_torch.evaluation.ate import umeyama_align
from monoorbslam3_tpu_torch.frontend import tracking as T
from monoorbslam3_tpu_torch.frontend.local_mapping import LocalMapping
from monoorbslam3_tpu_torch.frontend.tracking import Tracking
from monoorbslam3_tpu_torch.models.camera import Pinhole
from monoorbslam3_tpu_torch.models.imu import ImuCalib
from monoorbslam3_tpu_torch.models.map_state import MapStore
from monoorbslam3_tpu_torch import sim

from tests.test_torch_tracking import (CAM, CAPS, CONFIG, N_FEAT, NOISE, R_BC, T_BC, _stream,
                                      one_torch_thread)  # noqa: F401  (autouse)

T_END = 4.0


@pytest.fixture(scope="module")
def run():
    cam = Pinhole.create(**CAM, device="cpu")
    calib = ImuCalib.create(R_bc=R_BC, t_bc=T_BC, **NOISE, device="cpu")
    store = MapStore(max_kf=512, max_pt=CONFIG["max_pt"], n_feat=N_FEAT)
    problems = Problems(cam, calib, device="cpu", **CAPS)
    tracker = Tracking(cam, calib, store, problems, CONFIG)
    mapper = LocalMapping(store, problems, calib, tracker, CONFIG)
    tracker.new_kf_callback = mapper.process
    states, times = [], []
    for t, feats, imu, _ in _stream(sim, cam, int(round(T_END * 20))):
        state, _ = tracker.track_feats(t, feats, imu)
        states.append(state)
        times.append(t)
    return dict(states=np.asarray(states), times=np.asarray(times), store=store,
                mapper=mapper, tracker=tracker, traj=sim.Trajectory())


def test_bootstraps_and_tracks(run):
    ok = run["states"] == T.OK
    assert ok.any(), "never initialized"
    first = int(np.nonzero(ok)[0][0])
    assert run["times"][first] < 2.0, "slow initialization"
    assert (run["states"] == T.LOST).sum() == 0
    assert ok[first:].mean() > 0.95, f"OK ratio {ok[first:].mean()}"


def test_inertial_init_fires(run):
    assert run["mapper"].imu_state >= 1, "IMU never initialized"
    assert run["tracker"].imu_ready


def test_keyframe_trajectory_accuracy(run):
    """Scale-aligned keyframe ATE below tests/test_e2e_synthetic.py's 6 cm."""
    store = run["store"]
    ids = store.keyframe_ids()
    assert len(ids) >= 5
    kt = np.array([store.kf_time[k] for k in ids])
    kp = np.stack([store.kf_t[k] for k in ids]).astype(np.float64)
    gt = run["traj"].pos(kt)
    s, R, t = umeyama_align(kp, gt)
    err = np.linalg.norm((s * kp @ R.T + t) - gt, axis=1)
    rmse = float(np.sqrt((err ** 2).mean()))
    assert rmse < 0.06, f"KF-trajectory ATE RMSE {rmse * 100:.1f} cm"
