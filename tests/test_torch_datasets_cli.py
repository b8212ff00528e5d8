"""PyTorch port: the dataset runner's command line
(`monoorbslam3_tpu_torch/runners/datasets.py`) on the CPU.

- `main([... "--device", "cpu"])` over tests/test_e2e_dataset_cli.py's
  60-frame EuRoC-layout dataset (rendered by that file's fixture): the full
  chain a user runs (settings -> build_system -> native decode and
  prefetch -> System.track -> shutdown exports), held to that file's gates
  (at least 5 keyframes, finite poses, keyframe ATE below 0.25 m against
  the simulator's truth; velocity rows = keyframes, PCD POINTS = its data
  rows > 100, a depth file), plus the checkpoint and the viewer's PNGs.
- The EuRoC, KITTI and TUM-VI layouts through the port's loaders give the
  JAX package's frames, IMU slices and times on the same files.
- `kind=synthetic` with `--gt-out` writes the JAX package's ground truth to
  the byte; `--help` prints the options.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from monoorbslam3_tpu.runners import datasets as jdatasets
from monoorbslam3_tpu_torch.evaluation.ate import ate_rmse
from monoorbslam3_tpu_torch.evaluation.metrics import load_tum, load_velocity_file
from monoorbslam3_tpu_torch.models.checkpoint import load_map
from monoorbslam3_tpu_torch.runners import datasets as tdatasets

from tests.test_e2e_dataset_cli import euroc_disk  # noqa: F401  (the module fixture)
from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def cli_run(euroc_disk, tmp_path_factory):  # noqa: F811
    root, yaml_path, traj = euroc_disk
    out = tmp_path_factory.mktemp("torch_out")
    system = tdatasets.main(["euroc", str(yaml_path), str(root), str(out / "traj.txt"),
                             "--device", "cpu",
                             "--velocity-out", str(out / "vel.txt"),
                             "--map-out", str(out / "map.pcd"),
                             "--depth-out", str(out / "depth.txt"),
                             "--save-state", str(out / "state.npz"),
                             "--viewer-dir", str(out / "viewer")])
    return out, traj, system


def test_cli_trajectory_accuracy(cli_run):
    out, traj, system = cli_run
    assert system.device == torch.device("cpu")
    t_kf, p_kf, q_kf = load_tum(str(out / "traj.txt"))
    assert len(t_kf) >= 5, f"only {len(t_kf)} keyframes exported"
    assert np.isfinite(p_kf).all() and np.isfinite(q_kf).all()
    res = ate_rmse(t_kf, p_kf, t_kf, traj.pos(t_kf))
    assert res["n_matches"] == len(t_kf)
    assert res["rmse"] < 0.25, f"CLI-path KF ATE RMSE {res['rmse'] * 100:.0f} cm"


def test_cli_export_surfaces(cli_run):
    out, _, system = cli_run
    t_v, v, bg, ba = load_velocity_file(str(out / "vel.txt"))
    t_kf, _, _ = load_tum(str(out / "traj.txt"))
    assert len(t_v) == len(t_kf)
    assert np.isfinite(v).all()
    pcd = (out / "map.pcd").read_text().splitlines()
    n_declared = next(int(line.split()[1]) for line in pcd if line.startswith("POINTS"))
    assert n_declared > 100, f"PCD map has only {n_declared} points"
    assert len(pcd) - (pcd.index("DATA ascii") + 1) == n_declared
    assert len((out / "depth.txt").read_text().splitlines()) > 0
    store, extra = load_map(str(out / "state.npz"))
    assert store.n_keyframes() == system.store.n_keyframes() == len(t_kf)
    assert extra["imu_state"] == system.mapper.imu_state


def test_cli_viewer_and_native_loader(cli_run):
    out, _, system = cli_run
    pngs = [p.name for p in (out / "viewer").iterdir()]
    assert any(p.startswith("frame_") for p in pngs), pngs
    assert any(p.startswith("map_") for p in pngs), pngs
    assert system.viewer.is_finished() and system.viewer.last_error is None
    from monoorbslam3_tpu_torch import native

    assert native.branch("dataloader") == "native"


def _write_layout(root, times_rel, data_rel, pattern, imu_rel, shape, n, rng):
    (root / data_rel).mkdir(parents=True)
    (root / imu_rel).parent.mkdir(parents=True, exist_ok=True)
    times = np.arange(n) / 10.0 + 50.0
    (root / times_rel).write_text("".join(f"{t:.6f}\n" for t in times))
    for i in range(n):
        img = rng.integers(0, 255, shape, dtype=np.uint8)
        Image.fromarray(img).save(root / data_rel / (pattern % i))
    ts = np.arange(49.8, times[-1] + 0.01, 0.01)
    (root / imu_rel).write_text("".join(f"{t:.6f} 0.01 0.02 0.03 0.1 0.2 9.7\n" for t in ts))


@pytest.mark.parametrize("kind,layout", [
    ("euroc", ("cam0/times.txt", "cam0/data", "%08d.png", "imu.txt", (48, 75))),
    ("kitti", ("image_00/times.txt", "image_00/data", "%010d.png", "oxts/imu.txt", (37, 123))),
    ("tumvi", ("cam0/times.txt", "cam0/data", "%08d.png", "imu.txt", (51, 51))),
])
def test_layouts_match_jax(tmp_path, kind, layout):
    times_rel, data_rel, pattern, imu_rel, shape = layout
    _write_layout(tmp_path, times_rel, data_rel, pattern, imu_rel, shape, 4,
                  np.random.default_rng(1))
    loader = {"euroc": "euroc_dataset", "kitti": "kitti_dataset", "tumvi": "tumvi_dataset"}[kind]
    ds_t = getattr(tdatasets, loader)(str(tmp_path))
    ds_j = getattr(jdatasets, loader)(str(tmp_path))
    assert len(ds_t) == len(ds_j) == 4
    frames_t, frames_j = list(ds_t.frames()), list(ds_j.frames())
    assert len(frames_t) == 4
    for (tt, it, mt), (tj, ij, mj) in zip(frames_t, frames_j):
        assert tt == tj and it.shape == shape
        np.testing.assert_array_equal(it, ij)
        assert (mt is None) == (mj is None)
        if mt is not None:
            np.testing.assert_array_equal(mt, mj)
    # IMU rows strictly within (prev, t]: ~10 a 0.1 s frame at 100 Hz
    (t0, _, _), (t1, _, imu1) = frames_t[0], frames_t[1]
    assert (imu1[:, 0] > t0).all() and (imu1[:, 0] <= t1).all() and 8 <= len(imu1) <= 12


def test_synthetic_kind_writes_jax_ground_truth(tmp_path):
    spec = "circle:t_end=0.2,fps=20"
    tdatasets.main(["synthetic", "settings/synthetic.yaml", spec, str(tmp_path / "traj.txt"),
                    "--device", "cpu", "--gt-out", str(tmp_path / "gt.txt"), "--max-frames", "2"])
    from monoorbslam3_tpu.config import build_system as jbuild
    from monoorbslam3_tpu.runners.synth import SyntheticDataset as JDataset

    js = jbuild("settings/synthetic.yaml", use_extractor=False)
    JDataset(spec, js.camera, js.calib).save_ground_truth(str(tmp_path / "gt_jax.txt"))
    assert (tmp_path / "gt.txt").read_bytes() == (tmp_path / "gt_jax.txt").read_bytes()
    assert (tmp_path / "traj.txt").exists()


def test_help_lists_the_options(capsys):
    with pytest.raises(SystemExit) as e:
        tdatasets.main(["--help"])
    assert e.value.code == 0
    text = capsys.readouterr().out
    for opt in ("--device", "--vocab", "--viewer-dir", "--save-state", "--load-state",
                "--velocity-out", "--map-out", "--depth-out", "--max-frames", "--realtime",
                "--gt-out"):
        assert opt in text
