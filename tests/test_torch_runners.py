"""PyTorch port: the synthetic runners, the rest of `sim.py` and the
offline metrics against the JAX package's on the CPU.

- `parse_spec` and `make_world` for every world name.
- The first three frames of `SyntheticDataset` for `circle`, `noisy` and
  `corridor` (each on its battery profile's camera): the images, the IMU
  rows and the ground-truth text identical to the JAX package's;
  `apply_sensor_model` alike.
- `ForwardTrajectory`, `CorridorImageWorld` and `CorridorWorld` bit for
  bit.
- `load_tum`, `load_velocity_file`, `velocity_accuracy` and
  `evaluate_sequences` equal on the same files.
- `run_sequence` over a few frames of a `System(device="cpu")`.
"""

from pathlib import Path

import numpy as np
import pytest

from monoorbslam3_tpu import config as jconfig
from monoorbslam3_tpu import sim as jsim
from monoorbslam3_tpu.evaluation import metrics as jmetrics
from monoorbslam3_tpu.runners import synth as jsynth
from monoorbslam3_tpu_torch import config as tconfig
from monoorbslam3_tpu_torch import sim as tsim
from monoorbslam3_tpu_torch.evaluation import metrics as tmetrics
from monoorbslam3_tpu_torch.runners import synth as tsynth
from monoorbslam3_tpu_torch.runners.datasets import run_sequence

from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

SETTINGS = Path(__file__).resolve().parents[1] / "settings"
SPECS = {"circle": ("synthetic.yaml", "circle:t_end=2,fps=20"),
         "noisy": ("synthetic.yaml", "noisy:t_end=2,fps=20"),
         "corridor": ("synthetic_forward.yaml", "corridor:t_end=2,fps=10")}


def _rigs(profile):
    s = jconfig.load_settings(str(SETTINGS / profile))
    return ((jconfig.build_camera(s), jconfig.build_imu_calib(s)),
            (tconfig.build_camera(s, "cpu"), tconfig.build_imu_calib(s, "cpu")))


def test_parse_spec():
    for spec in ("circle", "circle:t_end=60,fps=20", "corridor:t_end=5,speed=4.5,",
                 "lowtex:sector=0.5"):
        assert tsynth.parse_spec(spec) == jsynth.parse_spec(spec)


@pytest.mark.parametrize("name,kv", [("circle", {}), ("noisy", {"t_end": 3.0}),
                                     ("fastspin", {"omega": 1.1}), ("lowtex", {"sector": 0.7}),
                                     ("corridor", {"t_end": 100.0, "speed": 6.0})])
def test_make_world(name, kv):
    jw, jt, jend = jsynth.make_world(name, dict(kv))
    tw, tt, tend = tsynth.make_world(name, dict(kv))
    assert tend == jend and type(tw).__name__ == type(jw).__name__
    assert type(tt).__name__ == type(jt).__name__
    np.testing.assert_array_equal(tw.texture, jw.texture)
    for key in ("wall_radius", "pillar_ring", "blank_sector", "half_width", "length"):
        assert getattr(tw, key, None) == getattr(jw, key, None), key
    np.testing.assert_array_equal(tw.pillar_xy, jw.pillar_xy)
    ts = np.linspace(0.0, 7.0, 15)
    for f in ("pos", "vel", "acc", "R_wb", "omega_body"):
        np.testing.assert_array_equal(getattr(tt, f)(ts), getattr(jt, f)(ts), err_msg=f)


def test_make_world_unknown_name():
    with pytest.raises(ValueError):
        tsynth.make_world("maze", {})


@pytest.mark.parametrize("name", sorted(SPECS))
def test_dataset_frames_and_ground_truth(name, tmp_path):
    profile, spec = SPECS[name]
    (jcam, jcal), (tcam, tcal) = _rigs(profile)
    jd = jsynth.SyntheticDataset(spec, jcam, jcal)
    td = tsynth.SyntheticDataset(spec, tcam, tcal)
    assert len(td) == len(jd)
    for _, (a, b) in zip(range(3), zip(jd.frames(), td.frames())):
        assert a[0] == b[0]
        assert b[1].dtype == np.float32 and np.array_equal(a[1], b[1])
        assert (a[2] is None) == (b[2] is None)
        if a[2] is not None:
            assert np.array_equal(a[2], b[2])
    jd.save_ground_truth(str(tmp_path / "j.txt"))
    td.save_ground_truth(str(tmp_path / "t.txt"))
    assert (tmp_path / "t.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()


def test_apply_sensor_model():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (48, 64)).astype(np.float32)
    for kw in ({}, {"blur": 0.0}, {"noise": 0.0, "exp_amp": 0.1}, {"blur": 1.7}):
        a = jsynth.apply_sensor_model(img, 4.2, np.random.default_rng(1), **kw)
        b = tsynth.apply_sensor_model(img, 4.2, np.random.default_rng(1), **kw)
        assert b.dtype == np.float32 and np.array_equal(a, b)


def test_forward_trajectory():
    kw = dict(speed=6.5, surge_amp=0.5)
    jt, tt = jsim.ForwardTrajectory(**kw), tsim.ForwardTrajectory(**kw)
    ts = np.linspace(0.0, 30.0, 61)
    for f in ("pos", "vel", "acc", "yaw", "R_wb", "omega_body"):
        np.testing.assert_array_equal(getattr(tt, f)(ts), getattr(jt, f)(ts), err_msg=f)
    a = jt.imu_samples(1.0, 1.1, 200.0, bg=[0.01, 0, 0], ba=[0, 0.02, 0], noise_gyro=1e-4,
                       noise_acc=1e-3, rng=np.random.default_rng(2))
    b = tt.imu_samples(1.0, 1.1, 200.0, bg=[0.01, 0, 0], ba=[0, 0.02, 0], noise_gyro=1e-4,
                       noise_acc=1e-3, rng=np.random.default_rng(2))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_corridor_image_world():
    (jcam, jcal), (tcam, tcal) = _rigs("synthetic_forward.yaml")
    kw = dict(half_width=8.0, length=900.0)
    jw = jsim.CorridorImageWorld(traj=jsim.ForwardTrajectory(), **kw)
    tw = tsim.CorridorImageWorld(traj=tsim.ForwardTrajectory(), **kw)
    R_bc, t_bc = np.asarray(jcal.R_bc, np.float64), np.asarray(jcal.t_bc, np.float64)
    for t in (0.0, 3.3):
        a = jw.render(t, jcam, R_bc, t_bc, rng=np.random.default_rng(5))
        b = tw.render(t, tcam, R_bc, t_bc, rng=np.random.default_rng(5))
        assert np.array_equal(a, b)
    # the blank sector of the low-texture circle
    jl = jsim.ImageWorld(blank_sector=(0.6, 1.7))
    tl = tsim.ImageWorld(blank_sector=(0.6, 1.7))
    np.testing.assert_array_equal(tl.texture, jl.texture)


@pytest.mark.parametrize("sparse_x", [None, (40.0, 120.0)])
def test_corridor_world(sparse_x):
    (jcam, jcal), (tcam, tcal) = _rigs("synthetic_forward.yaml")
    jw = jsim.CorridorWorld(n_points=3000, seed=4, sparse_x=sparse_x)
    tw = tsim.CorridorWorld(n_points=3000, seed=4, sparse_x=sparse_x)
    assert tw.n_points == jw.n_points
    np.testing.assert_array_equal(tw.points, jw.points)
    np.testing.assert_array_equal(tw.desc, jw.desc)
    R_bc, t_bc = np.asarray(jcal.R_bc, np.float64), np.asarray(jcal.t_bc, np.float64)
    for t in (0.0, 2.5):
        a = jw.observe(t, jcam, R_bc, t_bc, max_kps=512, rng=np.random.default_rng(6))
        b = tw.observe(t, tcam, R_bc, t_bc, max_kps=512, rng=np.random.default_rng(6))
        assert b["valid"].sum() > 50
        for k in a:
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)


@pytest.fixture(scope="module")
def trajectories(tmp_path_factory):
    """A ground-truth file of the circle and an estimate at keyframe-like
    times: scaled, rotated, shifted and noisy; and a velocity file."""
    out = tmp_path_factory.mktemp("metrics")
    (_, _), (tcam, tcal) = _rigs("synthetic.yaml")
    ds = tsynth.SyntheticDataset("circle:t_end=6,fps=20", tcam, tcal)
    gt = out / "gt.txt"
    ds.save_ground_truth(str(gt))
    rng = np.random.default_rng(11)
    t = ds.times[::5] + 0.004
    p = ds.traj.pos(t)
    c, s = np.cos(0.4), np.sin(0.4)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])
    est_p = 0.37 * p @ R.T + np.array([1.0, -2.0, 0.5]) + rng.normal(0, 0.01, p.shape)
    est = out / "est.txt"
    with open(est, "w") as f:
        for ti, pi in zip(t, est_p):
            f.write(f"{ti:.6f} {pi[0]:.7f} {pi[1]:.7f} {pi[2]:.7f} 0 0 0 1\n")
    vel = out / "vel.txt"
    v = ds.traj.vel(t) + rng.normal(0, 0.02, p.shape)
    with open(vel, "w") as f:
        for ti, vi in zip(t, v):
            f.write(f"{ti:.6f} " + " ".join(f"{x:.7f}" for x in (*vi, *np.zeros(6))) + "\n")
    return dict(gt=str(gt), est=str(est), vel=str(vel), traj=ds.traj, t=ds.times)


def test_load_tum_and_velocity_file(trajectories):
    for path in (trajectories["gt"], trajectories["est"]):
        for a, b in zip(tmetrics.load_tum(path), jmetrics.load_tum(path)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tmetrics.load_velocity_file(trajectories["vel"]),
                    jmetrics.load_velocity_file(trajectories["vel"])):
        np.testing.assert_array_equal(a, b)


def test_velocity_accuracy(trajectories):
    t_e, v_e, _, _ = tmetrics.load_velocity_file(trajectories["vel"])
    t_g = trajectories["t"]
    v_g = trajectories["traj"].vel(t_g)
    for max_dt in (0.02, 0.001):
        assert (tmetrics.velocity_accuracy(t_e, v_e, t_g, v_g, max_dt)
                == jmetrics.velocity_accuracy(t_e, v_e, t_g, v_g, max_dt))


def test_evaluate_sequences(trajectories):
    pairs = [("circle", trajectories["est"], trajectories["gt"])]
    for kw in ({"max_dt": 0.05}, {"max_dt": 0.02, "with_scale": False}):
        a = tmetrics.evaluate_sequences(pairs, log=lambda line: None, **kw)
        b = jmetrics.evaluate_sequences(pairs, log=lambda line: None, **kw)
        assert a == b
    assert abs(a[0]["rmse"] - b[0]["rmse"]) == 0.0
    (res,) = tmetrics.evaluate_sequences(pairs, max_dt=0.05, log=lambda line: None)
    assert res["n"] == 24 and abs(res["scale"] - 1 / 0.37) < 0.02 and res["rmse"] < 0.1


def test_run_sequence_on_a_cpu_system():
    """build_system on the system world's profile (the 100k vocabulary) on
    the CPU, then run_sequence over its first frames: the states come
    back, the vocabulary's groups reach the tracker's frames."""
    syst = tconfig.build_system(str(SETTINGS / "synthetic_vocab.yaml"), device="cpu")
    ds = tsynth.SyntheticDataset("circle:t_end=1,fps=20", syst.camera, syst.calib)
    lines = []
    states = run_sequence(syst, ds, max_frames=4, progress_every=2, log=lines.append)
    assert states.shape == (4,) and set(states.tolist()) <= {1, 2}
    assert len(lines) == 3 and lines[-1].startswith("done: 4 frames")
    frame = syst.tracking.last_frame
    assert frame.group is not None and (frame.group[frame.valid] >= 0).all()
    assert (frame.group[~frame.valid] == -1).all()
    syst.shutdown()
