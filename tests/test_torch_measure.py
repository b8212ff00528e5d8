"""PyTorch port: the measuring entry points (`graft_entry.py`,
`measure/`) against their JAX twins on the CPU.

- `graft_entry.flagship`'s tracking step against a test-side twin of
  `__graft_entry__._flagship` built from the JAX package's functions, with
  H, W, N as arguments (240x376, 256 features), on its seeded random
  inputs (drawn alike in both) and on the rendered set of
  `chip_smoke.graft_frames` (the map from the JAX package's extraction of
  the first frame): inliers within 2, R and t within 1e-3, over 100
  inliers on the rendered set.
- `measure.bench` with `device="cpu"` on a small window: the JAX script's
  keys, its costs against the JAX package's `schur_ba` on
  `bench.build_problem` at the same size (1e-4 / 1e-3), and every device
  metric "not measured".
- `measure.bench_kernels`' byte and operation counts against hand
  arithmetic, kernel by kernel.
- Each entry point, called without a card and without `device="cpu"`,
  raises; `multihost.run_ranks` raises with a failed rank's traceback and
  for a rank that dies.

`tests/test_torch_measure_mesh.py` holds `dryrun_multichip` and
`bench_scaling`, `tests/test_torch_measure_e2e.py` the end-to-end run.
"""

import json
import operator
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench as jbench
import chip_smoke as cs
from monoorbslam3_tpu.backend.problems import _identity_edge as j_identity_edge
from monoorbslam3_tpu.backend.problems import _pose_optimize_impl as j_pose_optimize
from monoorbslam3_tpu.backend.residuals import KfState as JKfState
from monoorbslam3_tpu.backend.solver import schur_ba as jschur_ba
from monoorbslam3_tpu.models.camera import Pinhole as JPinhole
from monoorbslam3_tpu.ops import matching as jmatching
from monoorbslam3_tpu.ops.match_pallas import projected_match as jprojected_match
from monoorbslam3_tpu.ops.orb import OrbExtractor as JOrb
from monoorbslam3_tpu_torch import graft_entry
from monoorbslam3_tpu_torch.measure import bench, bench_kernels, bench_scaling, e2e, timing
from monoorbslam3_tpu_torch.ops.image import pyramid_shapes
from monoorbslam3_tpu_torch.parallel import multihost

from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
H, W, N = 240, 376, 256
SMALL_WINDOW = dict(n_kf=8, n_fixed=2, n_pts=256, obs_per_kf=48)


def _jax_flagship(H, W, N):
    """`__graft_entry__._flagship` with H, W, N as arguments: the same
    chain from the JAX package's functions, and its inputs drawn by the
    same calls."""
    import jax

    cam = JPinhole.create(fx=458.654, fy=457.296, cx=367.215, cy=248.375, width=W, height=H)
    ext = JOrb(H, W, n_features=N)
    R_cb, t_cb = jnp.eye(3), jnp.zeros(3)

    def tracking_step(image, pt_xyz, pt_desc, pt_valid, R0, t0):
        feats = ext._extract(image)
        state0 = JKfState(R0, t0, jnp.zeros(3), jnp.zeros(3), jnp.zeros(3))
        R_cw = R_cb @ state0.R_wb.T
        t_cw = t_cb - R_cw @ state0.t_wb
        pc = pt_xyz @ R_cw.T + t_cw
        uv = cam.project(pc)
        ok = (pc[:, 2] > 0.05) & cam.is_in_image(uv) & pt_valid
        radius = jnp.full(pt_xyz.shape[0], 15.0, jnp.float32)
        idx, _ = jprojected_match(pt_desc, feats["desc"], uv_a=uv, xy_b=feats["xy"],
                                  radius=radius, valid_a=ok, valid_b=feats["valid"],
                                  max_dist=jmatching.TH_HIGH, ratio=0.9)
        hit = idx >= 0
        safe = jnp.maximum(idx, 0)
        obs_uv = feats["xy"][safe]
        inv_s2 = 1.0 / 1.2 ** (2.0 * feats["level"][safe].astype(jnp.float32))
        dummy = JKfState.zeros()
        state, inlier = j_pose_optimize(
            state0, pt_xyz, obs_uv, inv_s2, hit, cam, R_cb, t_cb, j_identity_edge(), dummy,
            jnp.float32(0.0), dummy, jnp.zeros(9, jnp.float32), use_inertial=False,
            use_prior=False)
        return state.R_wb, state.t_wb, jnp.sum(inlier)

    rng = np.random.default_rng(0)
    image = rng.uniform(0, 255, (H, W)).astype(np.float32)
    pt_xyz = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N),
                       rng.uniform(2, 9, N)], -1).astype(np.float32)
    pt_desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    args = (image, pt_xyz, pt_desc, np.ones(N, bool), np.eye(3, dtype=np.float32),
            np.zeros(3, np.float32))
    return jax.jit(tracking_step), ext, args


@pytest.fixture(scope="module")
def steps():
    jstep, jext, jargs = _jax_flagship(H, W, N)
    tstep, _ = graft_entry.flagship("cpu", H, W, N)
    return jstep, jext, jargs, tstep


def _rendered(jext):
    img_map, img_track, world, cam = cs.graft_frames(H, W)
    f = jext(jnp.asarray(img_map))
    return (img_track,) + cs.graft_rendered_inputs(np.asarray(f["xy"]), np.asarray(f["desc"]),
                                                   np.asarray(f["valid"]), world, cam)


@pytest.mark.parametrize("inputs", ["seeded", "rendered"])
def test_graft_step_matches_jax(steps, inputs):
    jstep, jext, jargs, tstep = steps
    if inputs == "seeded":
        args = graft_entry.seeded_inputs(H, W, N)
        for a, b in zip(args, jargs):
            np.testing.assert_array_equal(a, b)
    else:
        args = _rendered(jext)
    jR, jt, jn = (np.asarray(x) for x in jstep(*(jnp.asarray(a) for a in args)))
    tR, tt, tn = (x.numpy() for x in tstep(*graft_entry.upload(args, "cpu")))
    assert abs(int(tn) - int(jn)) <= 2, (int(tn), int(jn))
    np.testing.assert_allclose(tR, jR, atol=1e-3)
    np.testing.assert_allclose(tt, jt, atol=1e-3)
    if inputs == "rendered":
        assert int(jn) > 100 and int(tn) > 100, (int(jn), int(tn))


def test_graft_entry_full_size_inputs():
    """`entry`'s arguments are the JAX script's seeded inputs at full size,
    as device tensors (uint32 descriptors as their int32 view)."""
    args = graft_entry.upload(graft_entry.seeded_inputs(), "cpu")
    shapes = [tuple(a.shape) for a in args]
    assert shapes == [(480, 752), (1024, 3), (1024, 8), (1024,), (3, 3), (3,)]
    assert args[2].dtype == torch.int32 and args[3].dtype == torch.bool


def test_bench_costs_match_jax():
    out = bench.bench("cpu", window=SMALL_WINDOW, frontend=(H, W, N))
    problem, cam = jbench.build_problem(**SMALL_WINDOW)
    _, _, info = jschur_ba(problem, cam, jnp.eye(3), jnp.zeros(3), n_iters=bench.N_ITERS)
    np.testing.assert_allclose(out["cost0"], float(info["cost0"]), rtol=1e-4)
    np.testing.assert_allclose(out["cost"], float(info["cost"]), rtol=1e-3)
    jax_keys = {"metric", "value", "unit", "vs_baseline", "device", "window", "cost0", "cost",
                "grouped_polish_iters_per_s", "frontend_fps", "frontend_vs_20hz"}
    assert jax_keys <= set(out)
    assert out["metric"] == "local_ba_iters_per_s" and out["unit"] == "iters/s"
    for key in ("value", "vs_baseline", "grouped_polish_iters_per_s", "frontend_fps",
                "frontend_vs_20hz", "timing", "setup_s"):
        assert out[key] == timing.NOT_MEASURED, key
    assert out["device"]["platform"] == "cpu"
    assert out["baseline_iters_per_s"] == jbench.G2O_BASELINE_ITERS_PER_S
    json.dumps(out)


# ---- bench_kernels' counts, by hand ------------------------------------------

def _counts(b):
    return b["bytes"], [c for c, _ in b["ops"]]


def test_counts_hamming():
    # [1024, 8] x [1024, 8] words read, [1024, 1024] int32 written;
    # 2 x 256 binary multiply-adds a pair
    assert _counts(timing.k3_bound(1024, 1024)) == (2048 * 32 + 1024 * 1024 * 4,
                                                    [2 * 256 * 1024 * 1024])
    assert _counts(timing.k3_bound(8192, 8192)) == (16384 * 32 + 8192 * 8192 * 4,
                                                    [2 * 256 * 8192 ** 2])
    assert timing.k3_bound(1024, 1024)["bound_by"] == "bytes"


def test_counts_match_rows():
    # both sides' words and five float vectors, best/second/idx written;
    # the binary product and 11 float operations a pair
    assert _counts(timing.k2_bound(1024, 512)) == (1536 * (32 + 20) + 12 * 1024,
                                                   [2 * 256 * 1024 * 512, 11 * 1024 * 512])
    b = timing.k2_bound(1024, 1024)
    assert b["bound_by"] == "operations"
    assert b["bound_ms"] == pytest.approx(1e3 * 2 * 256 * 1024 ** 2 / 1979e12)


def test_counts_match_step():
    # descriptors 32 B, uv / xy 8 B, radius 4 B, valid 1 B each side; idx
    # and dist 4 B each; both passes
    got = _counts(bench_kernels.match_step_work(1024, 1024))
    assert got == (2048 * 32 + 2048 * 8 + 1024 * 4 + 2048 + 1024 * 8,
                   [2 * 2 * 256 * 1024 ** 2, 2 * 11 * 1024 ** 2])


def test_counts_gather():
    # two windows on a 100 x 100 atlas: one at (0, 0), one overlapping it
    # by 8 rows (rows 40..87): 48 x 48 + 40 x 48 atlas pixels covered
    atlas = torch.zeros((100, 100))
    ys = torch.tensor([0, 40], dtype=torch.int32)
    xs = torch.tensor([0, 0], dtype=torch.int32)
    windows = 2 * 48 * 48 * 4
    assert timing.k1_bound(atlas, ys, xs)["bytes"] == 4 * (48 * 48 + 40 * 48) + 16 + windows
    assert timing.k1_bound(atlas, ys, xs, atlas_in_l2=True)["bytes"] == 16 + windows


def test_counts_chol():
    # S and b read, x written; D^3/3 multiply-adds and 6 D^2
    D = 480
    assert _counts(timing.k4_bound(2, D)) == (4 * 2 * (D * D + 2 * D),
                                              [2 * (2 * D ** 3 / 3 + 6 * D * D)])
    assert _counts(timing.k4_bound(1, 1440))[1] == [2 * 1440 ** 3 / 3 + 6 * 1440 ** 2]


def test_counts_orb():
    px = sum(h * w for h, w in pyramid_shapes(480, 752, 8, 1.2))
    # the level sizes of the EuRoC pyramid, rounded as cv::resize rounds
    assert px == (480 * 752 + 400 * 627 + 333 * 522 + 278 * 435 + 231 * 363 + 193 * 302
                  + 161 * 252 + 134 * 210)
    assert _counts(bench_kernels.orb_work(480, 752, 1024)) == (
        4 * 480 * 752 + 1024 * 53, [56 * px + 256 * 1024])


def test_counts_preintegration():
    # 200 x (gyro, acc, dt) + both biases read, one Preintegrated written;
    # 4,398 float operations a sample
    assert bench_kernels.PREINT_OPS_PER_SAMPLE == 2916 + 972 + 450 + 60
    assert _counts(bench_kernels.preint_work(200)) == (4 * (1400 + 6 + 292), [200 * 4398])


def test_counts_ba_iteration():
    # 3 keyframes, 2 points; point 0 seen 3 times, point 1 once valid (and
    # once invalid): pairs 3^2 + 1^2
    obs_pt = np.array([0, 0, 0, 1, 1])
    valid = np.array([True, True, True, True, False])
    b = bench_kernels.ba_iter_work(3, obs_pt, valid, 2, 2)
    D = 45
    edge_bytes = 4 * 148 + 8 + 8 + 1 + 24 + 1
    assert b["bytes"] == 29 * 5 + 25 * 2 + 4 * 3 * (42 + 15 + 15 + 21) + 2 * edge_bytes
    assert b["ops"][0][0] == (384 * 4 + 60 * 2 + 324 * (9 + 1) + 16200 * 2
                              + 2 * D ** 3 / 3 + 6 * D * D)


def test_bench_kernels_cpu_lines():
    """`--device cpu`: every line of the JAX script and every kernel line,
    with its counts, no time."""
    rows = bench_kernels.run("cpu", log=lambda row: None)
    names = [r["metric"] for r in rows]
    for name in ("hamming_rt", "hamming_bulk", "match_step_rt", "orb_extract_frame",
                 "preintegrate_200", "schur_ba_iter", "K1_gather_atlas_in_l2",
                 "K1_gather_atlas_from_hbm", "K2_match_rows_rows", "K2_match_rows_transposed",
                 "K4_chol_cluster", "K4_chol_large_d"):
        assert f"kernel_{name}" in names
    for r in rows:
        assert r["value"] == timing.NOT_MEASURED and r["device_ms"] == timing.NOT_MEASURED
        assert r["bound_us"] > 0 and r["bound_by"] in ("bytes", "operations")
        assert r["device"]["platform"] == "cpu"


# ---- no card: every entry point raises ---------------------------------------

@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the entry points run on it")


@pytest.mark.parametrize("call", [
    "graft_entry.entry", "graft_entry.dryrun_multichip", "bench.main", "bench_kernels.main",
    "e2e.main", "bench_scaling.main", "timing.card_identity"])
def test_entry_points_raise_without_a_card(no_card, call):
    fn = {"graft_entry.entry": graft_entry.entry,
          "graft_entry.dryrun_multichip": lambda: graft_entry.dryrun_multichip(1),
          "bench.main": lambda: bench.main([]),
          "bench_kernels.main": lambda: bench_kernels.main([]),
          "e2e.main": lambda: e2e.main(["--worlds", "circle10"]),
          "bench_scaling.main": lambda: bench_scaling.main(["1"]),
          "timing.card_identity": timing.card_identity}[call]
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn()


def test_module_exits_nonzero_without_a_card(no_card):
    """`python -m ...bench` on a host without a card exits with an error and
    prints no result."""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "monoorbslam3_tpu_torch.measure.bench"],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "no CUDA card" in proc.stderr


def test_run_ranks_reports_a_failed_rank():
    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        multihost.run_ranks(operator.truediv, 2, "cpu", args=(1, 0), timeout=300)


def test_run_ranks_reports_a_dead_rank():
    with pytest.raises(RuntimeError, match="exited with code 3"):
        multihost.run_ranks(os._exit, 1, "cpu", args=(3,), timeout=300)


def test_run_ranks_returns_in_rank_order():
    assert multihost.run_ranks(multihost.process_info, 2, "cpu", timeout=300) == [
        dict(process_index=r, process_count=2, local_devices=1, global_devices=2)
        for r in range(2)]
