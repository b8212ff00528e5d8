"""PyTorch port: `parallel/` (multihost, sharded_ba, frontend_dp) and the
mesh of `Problems` and `System`, on the CPU over gloo process groups.

- `shard_problem_by_point` gives the JAX package's order, capacity and
  mask, bit for bit, on tests/test_sharded_ba.py's padded problem.
- `sharded_schur_ba` at one rank (in this process) and at two ranks
  (spawned processes, a file store in tmp_path) against the JAX package's
  8-device `sharded_schur_ba` and the port's `schur_ba` on that problem, at
  that file's tolerances (cost within 5%, poses within 2e-3).
- `System(mesh=)`: every window BA of the live mapper goes through
  `Problems._solve_sharded` (a spy, as test_live_mapper_dispatches_sharded_ba),
  and the run keeps that test's gates.
- tests/test_multihost.py's checks: a two-process all_reduce over a global
  mesh, the single-process no-op, and the host-major layout of a (2, 2)
  mesh over four processes.
- `make_batch_extractor` over two ranks equals one extraction a frame, and
  an indivisible batch raises.
"""

import os
import pickle
import socket
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import Mesh

from monoorbslam3_tpu.parallel import sharded_ba as jsb
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch.backend import problems as tproblems
from monoorbslam3_tpu_torch.backend.solver import schur_ba as tschur_ba
from monoorbslam3_tpu_torch.ops.orb import OrbExtractor
from monoorbslam3_tpu_torch.parallel import frontend_dp, multihost
from monoorbslam3_tpu_torch.parallel import sharded_ba as tsb

from tests.test_sharded_ba import _pad_problem
from tests.test_solver import CAM as JCAM
from tests.test_solver import R_CB, T_CB, _build_ba_problem
from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

REPO = str(Path(__file__).resolve().parents[1])
OBS = ("obs_kf", "obs_pt", "obs_uv", "obs_inv_sigma2", "obs_valid")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


WORKER = r"""
import os, pickle, sys
mode, rank, world, coord, data, repo = sys.argv[1:7]
rank, world = int(rank), int(world)
sys.path.insert(0, repo)
import numpy as np
import torch
torch.set_num_threads(1)
import torch.distributed as dist
from monoorbslam3_tpu_torch.parallel import multihost

assert multihost.initialize(coordinator=coord, num_processes=world, process_id=rank,
                            device_type="cpu")
info = multihost.process_info()
assert info["process_count"] == world and info["process_index"] == rank, info
out = {}
if mode == "reduce":
    mesh = multihost.global_mesh(("dp",), device_type="cpu")
    assert mesh.size() == world
    # the sharded reduction's pattern: per-rank partial sums, one all_reduce
    x = torch.arange(8.0)
    part = x.reshape(world, -1)[rank].sum()
    dist.all_reduce(part, group=mesh.get_group("dp"))
    out["sum"] = float(part)
elif mode == "layout":
    mesh = multihost.global_mesh(("dp", "mp"), shape=(2, 2), device_type="cpu")
    out["names"] = list(mesh.mesh_dim_names)
    out["ranks"] = mesh.mesh.tolist()
elif mode == "sharded":
    from monoorbslam3_tpu_torch.parallel import sharded_ba as sb
    with open(data, "rb") as f:
        problem, cam = pickle.load(f)
    mesh = multihost.global_mesh(("dp",), device_type="cpu")
    sharded, dropped = sb.shard_problem_by_point(problem, world)
    kf, pts, info = sb.sharded_schur_ba(sharded, cam, torch.eye(3), torch.zeros(3), mesh,
                                        n_iters=8)
    out = dict(dropped=dropped, t=kf.t_wb.numpy(), R=kf.R_wb.numpy(), pts=pts.numpy(),
               cost0=float(info["cost0"]), cost=float(info["cost"]))
elif mode == "extract":
    from monoorbslam3_tpu_torch.ops.orb import OrbExtractor
    from monoorbslam3_tpu_torch.parallel import frontend_dp
    images = np.load(data)
    mesh = multihost.global_mesh(("dp",), device_type="cpu")
    ext = OrbExtractor(images.shape[1], images.shape[2], n_features=128, n_levels=3,
                       device="cpu")
    run = frontend_dp.make_batch_extractor(ext, mesh)
    out = {k: v.numpy() for k, v in run(images).items()}
    try:
        run(images[:3])
        out["indivisible"] = "accepted"
    except ValueError:
        out["indivisible"] = "ValueError"
dist.destroy_process_group()
with open(f"{data}.rank{rank}.pkl", "wb") as f:
    pickle.dump(out, f)
print(f"WORKER_OK {rank}", flush=True)
"""


def _spawn(tmp_path, mode, world, data=None):
    """Runs WORKER in `world` processes of one gloo group; returns each
    rank's result."""
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    data = str(data or tmp_path / "none")
    coord = f"localhost:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), mode, str(r), str(world), coord,
                               data, REPO], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True, env=env)
             for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=240)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"WORKER_OK {r}" in out, f"rank {r}:\n{out}"
    results = []
    for r in range(world):
        with open(f"{data}.rank{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


@pytest.fixture(scope="module")
def cpu_mesh(tmp_path_factory):
    """A one-rank gloo group (a file store) and its ("dp",) mesh, for the
    tests that run in this process."""
    store = tmp_path_factory.mktemp("dist") / "store"
    assert multihost.initialize(coordinator=f"file://{store}", num_processes=1, process_id=0,
                                device_type="cpu")
    yield multihost.global_mesh(("dp",), device_type="cpu")
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def ba_case():
    """tests/test_sharded_ba.py's problem (6 KF, 200 points, padded to 8
    shards) in both packages, with the JAX package's 8-device sharded solve
    and the port's schur_ba on it."""
    problem, _, _ = _build_ba_problem(n_kf=6, n_pts=200)
    problem = _pad_problem(problem, 8)
    mesh = Mesh(np.array(jax.devices()[:8]), ("dp",))
    sharded, dropped = jsb.shard_problem_by_point(problem, 8)
    assert dropped == 0
    kf_j, pts_j, info_j = jsb.sharded_schur_ba(sharded, JCAM, R_CB, T_CB, mesh, n_iters=8)
    tp = convert.ba_problem(problem, device="cpu")
    cam = convert.pinhole(JCAM, device="cpu")
    eye, z = torch.eye(3), torch.zeros(3)
    kf_1, pts_1, info_1 = tschur_ba(tp, cam, eye, z, n_iters=8)
    return dict(jproblem=problem, tproblem=tp, cam=cam,
                jax=dict(t=np.asarray(kf_j.t_wb), R=np.asarray(kf_j.R_wb),
                         cost0=float(info_j["cost0"]), cost=float(info_j["cost"])),
                single=dict(t=kf_1.t_wb.numpy(), R=kf_1.R_wb.numpy(),
                            cost=float(info_1["cost"])))


@pytest.mark.parametrize("n_shards", [1, 2, 8])
def test_shard_problem_by_point_matches_jax(ba_case, n_shards):
    js, jd = jsb.shard_problem_by_point(ba_case["jproblem"], n_shards)
    ts, td = tsb.shard_problem_by_point(ba_case["tproblem"], n_shards)
    assert jd == td == 0
    for f in OBS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                      err_msg=f)
    # and on a host (numpy) problem, as Problems shards it
    host = ba_case["tproblem"]._replace(**{f: getattr(ba_case["tproblem"], f).numpy()
                                           for f in OBS})
    hs, _ = tsb.shard_problem_by_point(host, n_shards)
    for f in OBS:
        np.testing.assert_array_equal(getattr(hs, f), np.asarray(getattr(js, f)), err_msg=f)


def _assert_like_references(got, ba_case):
    """tests/test_sharded_ba.py's tolerances against JAX's 8-device sharded
    solve and the port's schur_ba."""
    assert got["cost"] < got["cost0"] * 0.5
    for ref in (ba_case["jax"], ba_case["single"]):
        assert abs(got["cost"] - ref["cost"]) / ref["cost"] < 0.05
        np.testing.assert_allclose(got["t"], ref["t"], atol=2e-3)
        np.testing.assert_allclose(got["R"], ref["R"], atol=2e-3)
    assert abs(got["cost0"] - ba_case["jax"]["cost0"]) <= 1e-4 * ba_case["jax"]["cost0"]


def test_sharded_schur_ba_one_rank(ba_case, cpu_mesh):
    sharded, _ = tsb.shard_problem_by_point(ba_case["tproblem"], 1)
    kf, pts, info = tsb.sharded_schur_ba(sharded, ba_case["cam"], torch.eye(3), torch.zeros(3),
                                         cpu_mesh, n_iters=8)
    assert pts.shape == ba_case["tproblem"].points.shape
    _assert_like_references(dict(t=kf.t_wb.numpy(), R=kf.R_wb.numpy(),
                                 cost0=float(info["cost0"]), cost=float(info["cost"])), ba_case)


def test_sharded_schur_ba_two_ranks(ba_case, tmp_path):
    data = tmp_path / "problem.pkl"
    with open(data, "wb") as f:
        pickle.dump((ba_case["tproblem"], ba_case["cam"]), f)
    r0, r1 = _spawn(tmp_path, "sharded", 2, data)
    assert r0["dropped"] == 0
    for key in ("t", "R", "pts"):  # every rank returns the same result
        np.testing.assert_array_equal(r0[key], r1[key])
    assert r0["cost"] == r1["cost"]
    _assert_like_references(r0, ba_case)


def test_problems_mesh_dispatches_every_window_ba(cpu_mesh):
    """System(mesh=) on the CPU over 2.5 s of tests/test_e2e_synthetic.py's
    feature-injection world: the live mapper's window BAs all go through
    the sharded solver, and the run keeps
    test_live_mapper_dispatches_sharded_ba's gates."""
    from monoorbslam3_tpu_torch import sim as tsim
    from monoorbslam3_tpu_torch.evaluation.ate import umeyama_align
    from monoorbslam3_tpu_torch.frontend import tracking as T
    from tests.test_torch_system import _port_system
    from tests.test_torch_tracking import _stream

    syst = _port_system(mesh=cpu_mesh)
    assert syst.problems.mesh is cpu_mesh
    calls = {"sharded": 0, "single": 0}
    inner = syst.problems._solve_sharded
    inner_single = tproblems.schur_ba

    def counted(*a, **k):
        calls["sharded"] += 1
        return inner(*a, **k)

    def single(*a, **k):
        calls["single"] += 1
        return inner_single(*a, **k)

    syst.problems._solve_sharded = counted
    tproblems.schur_ba = single
    try:
        states = [syst.track_features(t, feats, imu)
                  for t, feats, imu, _ in _stream(tsim, syst.camera, 50)]
    finally:
        tproblems.schur_ba = inner_single
    syst.shutdown()
    states = np.asarray(states)
    assert calls["sharded"] >= 3 and calls["single"] == 0, calls
    assert (states == T.LOST).sum() == 0
    assert (states == T.OK).mean() > 0.6
    ids = syst.store.keyframe_ids()
    kp = np.stack([syst.store.kf_t[k] for k in ids])
    gt = tsim.Trajectory().pos(np.array([syst.store.kf_time[k] for k in ids]))
    s, R, tt = umeyama_align(kp, gt)
    rmse = float(np.sqrt((np.linalg.norm((s * kp @ R.T + tt) - gt, axis=1) ** 2).mean()))
    assert rmse < 0.15, f"sharded-mapper KF ATE RMSE {rmse * 100:.0f} cm"


def test_two_process_all_reduce(tmp_path):
    outs = _spawn(tmp_path, "reduce", 2)
    assert [o["sum"] for o in outs] == [28.0, 28.0]


def test_single_process_initialize_is_noop():
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False


def test_mesh_entry_points_raise_without_a_card(monkeypatch):
    """initialize and global_mesh default to the card, as every entry point
    of the port does: without one they raise, and never fall back to the
    CPU; the dataset CLI does the same without --device."""
    from monoorbslam3_tpu_torch.runners import datasets

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.initialize(coordinator="localhost:1", num_processes=2, process_id=0)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        multihost.global_mesh(("dp",))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        datasets.main(["synthetic", "settings/synthetic.yaml", "circle:t_end=0.1",
                       "unused_traj.txt"])


def test_global_mesh_shape_layout(tmp_path):
    """Host-major layout: the fastest-varying axis (mp) holds adjacent
    ranks, as JAX's global_mesh keeps it within a host."""
    outs = _spawn(tmp_path, "layout", 4)
    for o in outs:
        assert o["names"] == ["dp", "mp"]
        assert o["ranks"] == [[0, 1], [2, 3]]


def _images():
    H, W = 120, 160
    rng = np.random.default_rng(3)
    base = rng.uniform(0, 255, (4, H // 4, W // 4)).astype(np.float32)
    return np.stack([np.kron(b, np.ones((4, 4), np.float32)) for b in base])


def test_batch_extract_matches_single_frame(tmp_path):
    images = _images()
    data = tmp_path / "images.npy"
    np.save(data, images)
    outs = _spawn(tmp_path, "extract", 2, data)
    ext = OrbExtractor(images.shape[1], images.shape[2], n_features=128, n_levels=3,
                       device="cpu")
    singles = [ext(images[i]) for i in range(len(images))]
    for o in outs:
        for key in ("xy", "response", "level", "angle", "desc", "valid"):
            want = np.stack([s[key].numpy() for s in singles])
            np.testing.assert_array_equal(o[key], want, err_msg=key)
        assert o["indivisible"] == "ValueError"
    assert int(outs[0]["valid"].sum()) > 8


def test_batch_extract_one_rank(cpu_mesh):
    images = _images()[:2]
    ext = OrbExtractor(images.shape[1], images.shape[2], n_features=128, n_levels=3,
                       device="cpu")
    got = frontend_dp.make_batch_extractor(ext, cpu_mesh)(images)
    for key, v in got.items():
        np.testing.assert_array_equal(v.numpy(), np.stack([ext(im)[key].numpy() for im in images]))
    np.testing.assert_array_equal(frontend_dp.shard_images(images, cpu_mesh).numpy(), images)
    with pytest.raises(ValueError, match="mesh"):
        frontend_dp.make_batch_extractor(ext, types.SimpleNamespace(device_type="cuda"))

