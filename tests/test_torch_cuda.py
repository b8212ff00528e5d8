"""PyTorch port, hand kernels on the card against their plain versions.

This file imports no jax, so it also runs on a machine with a CUDA card
and no JAX (skip the JAX-importing conftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every test skips: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from monoorbslam3_tpu_torch.ops import cuda_lib
from monoorbslam3_tpu_torch.ops import pallas_kernels as tpk
from monoorbslam3_tpu_torch.ops.match_pallas import _match_rows, _match_rows_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gather_kernel_matches_plain(cuda):
    """K1 at the extractor's shape (EuRoC atlas, K = 1024): bit-exact, and
    corners outside the atlas clamp like the plain version."""
    rng = np.random.default_rng(6)
    atlas = torch.as_tensor(rng.uniform(0, 255, (2274, 1024)).astype(np.float32), device=cuda)
    ys = rng.integers(0, 2274 - 48, 1024).astype(np.int32)
    xs = rng.integers(0, 1024 - 48, 1024).astype(np.int32)
    ys[:2], xs[:2] = [-5, 5000], [2000, -3]
    ys, xs = torch.as_tensor(ys, device=cuda), torch.as_tensor(xs, device=cuda)
    n0 = cuda_lib.launches["gather_patches"]
    out = tpk.gather_patches_dyn(atlas, ys, xs)
    torch.cuda.synchronize()
    assert cuda_lib.launches["gather_patches"] == n0 + 1
    assert torch.equal(out, tpk.gather_patches_plain(atlas, ys, xs))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(300, 52), (48, 48), (301, 1023), (97, 50)])
@pytest.mark.parametrize("K", [1024, 13])
def test_gather_kernel_shapes(cuda, shape, K):
    """K1 on atlases whose row pitch is and is not a multiple of 16 bytes
    (the kernel's loads are scalar, only its stores are 16 bytes wide), down
    to an atlas of one window, with corners clamped at all four borders:
    bit-exact."""
    ha, wa = shape
    rng = np.random.default_rng(ha + wa + K)
    atlas = torch.as_tensor(rng.uniform(0, 255, shape).astype(np.float32), device=cuda)
    ys = rng.integers(0, ha - 47, K).astype(np.int32)
    xs = rng.integers(0, wa - 47, K).astype(np.int32)
    ys[:8] = [-7, ha, 0, ha - 48, -1, ha - 47, 3, 2 * ha]
    xs[:8] = [0, wa - 48, -9, wa + 5, wa - 47, -1, 2 * wa, 4]
    ys, xs = torch.as_tensor(ys, device=cuda), torch.as_tensor(xs, device=cuda)
    n0 = cuda_lib.launches["gather_patches"]
    out = tpk.gather_patches_dyn(atlas, ys, xs)
    torch.cuda.synchronize()
    assert cuda_lib.launches["gather_patches"] == n0 + 1
    assert torch.equal(out, tpk.gather_patches_plain(atlas, ys, xs))


@pytest.mark.gpu
def test_gather_kernel_unaligned_base(cuda):
    """An atlas whose base is not 16-byte aligned (a slice of a longer
    buffer): bit-exact."""
    rng = np.random.default_rng(3)
    buf = torch.as_tensor(rng.uniform(0, 255, 1 + 64 * 64).astype(np.float32), device=cuda)
    atlas = buf[1:].view(64, 64)
    ys = torch.as_tensor(rng.integers(-4, 24, 40).astype(np.int32), device=cuda)
    xs = torch.as_tensor(rng.integers(-4, 24, 40).astype(np.int32), device=cuda)
    assert torch.equal(tpk.gather_patches_dyn(atlas, ys, xs),
                       tpk.gather_patches_plain(atlas, ys, xs))


def _match_args(N, M, device, seed=11):
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    k = min(N, M) // 2
    db[:k] = da[:k]
    db[:k, 3] ^= np.uint32(1 << 31)
    uv = rng.uniform(0, 700, (N, 2))
    xy = rng.uniform(0, 700, (M, 2))
    xy[:k] = uv[:k] + rng.normal(0, 4, (k, 2))
    dup = min(k + 1, M - 1)
    db[dup], xy[dup] = db[0], xy[0]  # duplicate column: second == best, first index wins
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    d = lambda x: torch.as_tensor(x.view(np.int32), device=device)
    rows = [d(da), d(db), f(uv[:, 0]), f(uv[:, 1]), f(rng.uniform(8, 20, N) ** 2),
            f(rng.integers(-1, 7, N)), f(rng.random(N) > 0.1),
            f(xy[:, 0]), f(xy[:, 1]), f(np.full(M, 1e9)), f(rng.integers(-1, 7, M)),
            f(rng.random(M) > 0.1)]
    cols = [rows[1], rows[0], *rows[7:12], *rows[2:7]]
    return rows, cols


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (4096, 1024), (200, 300), (5, 3)])
def test_match_kernel_matches_plain(cuda, shape):
    """K2 against its plain version in both directions: best, second and
    idx bit-identical (the tracking step's shapes 1024 x 1024, 4096 x 1024
    and 1024 x 4096; ragged shapes; fewer columns than one column chunk)."""
    for args in _match_args(*shape, cuda):
        _check_match(args)


def _check_match(args):
    n0 = cuda_lib.launches["match_rows"]
    out = _match_rows(*args)
    torch.cuda.synchronize()
    assert cuda_lib.launches["match_rows"] == n0 + 1
    ref = _match_rows_plain(*args)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    return ref


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (4096, 1024), (1024, 4096), (37, 1000)])
def test_match_kernel_ties_across_chunks(cuda, shape):
    """K2 on rows whose best distance sits at two columns in different
    column chunks (a pair straddles every multiple of 8 up to 512, the
    rest lie at random): the lower column wins and second == best."""
    from chip_smoke import seeded_match_ties

    args = [t.to(cuda) for t in seeded_match_ties(*shape, np.random.default_rng(sum(shape)))]
    best, second, idx = _check_match(args)
    assert bool((best == 1).any()) and bool((second == best).all())


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1000, 7])
def test_match_kernel_gated_edges(cuda, M):
    """K2's edge rows: a row whose only gated-in column is the last one
    (in the last, ragged column chunk at M = 1000; fewer columns than one
    chunk at M = 7), a row with no valid side, a row that only its vocab
    node lets through, and rows beyond a row tile."""
    N = 70
    rows, _ = _match_args(N, M, cuda, seed=5)
    ax, ay, r2a, ga, va = (t.clone() for t in rows[2:7])
    bx, by, r2b, gb, vb = (t.clone() for t in rows[7:12])
    bx[:] = 5000.0  # every column far from every row ...
    bx[-1], by[-1], vb[-1], gb[-1] = 10.0, 10.0, 1.0, -1.0  # ... but the last one
    ax[0], ay[0], r2a[0], va[0], ga[0] = 10.5, 10.0, 4.0, 1.0, -1.0  # row 0 sees only it
    va[1] = 0.0  # row 1: all gated
    ax[2], ay[2], r2a[2], va[2], ga[2] = 10.0, 10.0, 4.0, 1.0, 3.0  # row 2: vocab 3 ...
    gb[-1] = 4.0  # ... and the last column now vocab 4, so row 2 sees nothing
    ax[3], ay[3], r2a[3], va[3], ga[3] = 10.0, 10.5, 4.0, 1.0, 4.0  # row 3: vocab 4 sees it
    args = [rows[0], rows[1], ax, ay, r2a, ga, va, bx, by, r2b, gb, vb]
    best, second, idx = _check_match(args)
    assert idx[:4].tolist() == [M - 1, -1, -1, M - 1]
    assert float(second[0]) == 1e9 and float(best[1]) == 1e9


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (300, 513), (1, 70), (65, 1), (5, 3), (15, 7),
                                   (17, 9), (1024, 1023), (64, 130)])
def test_hamming_kernel_matches_plain(cuda, shape):
    """K3 at the mapper's shape and at ragged ones: not multiples of the
    64 x 64 tile, below one 16 x 8 mma tile, and a row pitch that is not a
    multiple of 16 bytes (M = 1023): bit-identical to the plain XOR +
    popcount."""
    from monoorbslam3_tpu_torch.ops import pallas_kernels as pk

    rng = np.random.default_rng(21)
    a = rng.integers(0, 2**32, (shape[0], 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (shape[1], 8), dtype=np.uint32)
    b[: min(shape) // 2] = a[: min(shape) // 2]  # zero distances
    ta = torch.as_tensor(a.view(np.int32), device=cuda)
    tb = torch.as_tensor(b.view(np.int32), device=cuda)
    n0 = cuda_lib.launches["hamming"]
    out = pk.hamming_matrix_pallas(ta, tb)
    torch.cuda.synchronize()
    assert cuda_lib.launches["hamming"] == n0 + 1
    assert torch.equal(out, pk.hamming_matrix_plain(ta, tb))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [12, 96, 465, 480, 768, 769, 1440])
def test_chol_kernel_matches_f64(cuda, D):
    """K4 on seeded SPD systems (A A^T + D I, as tests/test_pallas.py builds
    them), batched G = 2: relative error below 1e-5 against a float64
    solve, and within 1e-5 of the plain version. D up to the cluster
    route's capacity (768 on an H100: 48 row blocks, the substitutions'
    limit, in 228,368 bytes of shared memory a block, under the 232,448 a
    block may take) launches the cluster kernel
    (counter `chol_solve`); 769 and the full polish's 1440 launch the
    large-D kernel (`chol_solve_l2`), one cooperative launch over the
    card. The capacity the kernel reports is the one the numpy emulation of
    its schedule computes."""
    from chip_smoke import seeded_spd
    from experiments import port_chol_cluster_emulate as emu
    from monoorbslam3_tpu_torch.ops import chol_pallas as cp

    S, b = seeded_spd(D, np.random.default_rng(D), G=2)
    tS, tb = torch.as_tensor(S, device=cuda), torch.as_tensor(b, device=cuda)
    assert cp.cluster_shape(tS.device) == (emu.CLUSTER, emu.max_cluster_d(emu.CLUSTER)) == (8, 768)
    route = "cluster" if D <= 768 else "l2"
    counter = {"cluster": "chol_solve", "l2": "chol_solve_l2"}[route]
    assert cp.route(D, tS.device) == route
    n0 = dict(cuda_lib.launches)
    x = cp.chol_solve(tS, tb)
    torch.cuda.synchronize()
    for k in ("chol_solve", "chol_solve_l2"):
        assert cuda_lib.launches[k] == n0[k] + (k == counter)
    xp = cp.chol_solve_plain(tS, tb).cpu().numpy().astype(np.float64)
    x = x.cpu().numpy().astype(np.float64)
    for g in range(2):
        ref = np.linalg.solve(S[g].astype(np.float64), b[g].astype(np.float64))
        assert np.linalg.norm(x[g] - ref) / np.linalg.norm(ref) < 1e-5
        assert np.linalg.norm(x[g] - xp[g]) / np.linalg.norm(xp[g]) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kernel", ["cluster", "l2"])
@pytest.mark.parametrize("kind", ["indefinite", "negative definite"])
def test_chol_kernel_not_spd(cuda, kernel, kind):
    """A 480 x 480 system that is not positive definite, batched beside an
    SPD one: both K4 kernels give all-NaN for it, as the plain version
    does, and solve its SPD neighbour within 1e-5 of float64."""
    from chip_smoke import seeded_not_spd, seeded_spd
    from monoorbslam3_tpu_torch.ops import chol_pallas as cp

    rng = np.random.default_rng(48)
    S_spd, b_spd = seeded_spd(480, rng)
    S = torch.as_tensor(np.stack([seeded_not_spd(480, rng, kind), S_spd[0]]), device=cuda)
    b = torch.as_tensor(np.stack([np.ones(480, np.float32), b_spd[0]]), device=cuda)
    x = {"cluster": cp.chol_solve_cluster, "l2": cp.chol_solve_l2}[kernel](S, b)
    xp = cp.chol_solve_plain(S, b)
    torch.cuda.synchronize()
    assert torch.isnan(x[0]).all() and torch.isnan(xp[0]).all()
    ref = torch.linalg.solve(S[1].double(), b[1].double())
    assert float((x[1].double() - ref).norm() / ref.norm()) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("G", [1, 2, 3])
@pytest.mark.parametrize("D", [5, 769, 1000, 1440, 1600])
def test_chol_grid_route(cuda, D, G):
    """K4's large-D route (the cooperative grid kernel) called directly, at
    the first D past the cluster route, a ragged D, the full polish's 1440,
    a D below one tile, and 1600 (100 row blocks: more tiles a substitution
    step than a warp prefetches); one system, two that share the grid,
    three (two batches): within 1e-5 of float64, bit-identical across two
    runs, on a grid of more than one block per system."""
    from chip_smoke import seeded_spd
    from monoorbslam3_tpu_torch.ops import chol_pallas as cp

    S, b = seeded_spd(D, np.random.default_rng(100 * D + G), G=G)
    tS, tb = torch.as_tensor(S, device=cuda), torch.as_tensor(b, device=cuda)
    assert cuda_lib.lib().chol_grid_blocks(D) >= 4
    n0 = cuda_lib.launches["chol_solve_l2"]
    x1 = cp.chol_solve_l2(tS, tb)
    x2 = cp.chol_solve_l2(tS, tb)
    torch.cuda.synchronize()
    assert cuda_lib.launches["chol_solve_l2"] == n0 + 2
    assert torch.equal(x1, x2)
    x = x1.cpu().numpy().astype(np.float64)
    for g in range(G):
        ref = np.linalg.solve(S[g].astype(np.float64), b[g].astype(np.float64))
        assert np.linalg.norm(x[g] - ref) / np.linalg.norm(ref) < 1e-5


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["indefinite", "negative definite"])
def test_chol_grid_route_not_spd_1000(cuda, kind):
    """A 1000 x 1000 system that is not positive definite between two SPD
    ones (three systems: the grid's two slots and a second batch): all-NaN
    for it alone, its neighbours within 1e-5 of float64."""
    from chip_smoke import seeded_not_spd, seeded_spd
    from monoorbslam3_tpu_torch.ops import chol_pallas as cp

    rng = np.random.default_rng(1000)
    S_spd, b_spd = seeded_spd(1000, rng, G=2)
    S = torch.as_tensor(np.stack([S_spd[0], seeded_not_spd(1000, rng, kind), S_spd[1]]),
                        device=cuda)
    b = torch.as_tensor(np.stack([b_spd[0], np.ones(1000, np.float32), b_spd[1]]), device=cuda)
    x = cp.chol_solve(S, b)
    torch.cuda.synchronize()
    assert torch.isnan(x[1]).all()
    for g in (0, 2):
        ref = torch.linalg.solve(S[g].double(), b[g].double())
        assert float((x[g].double() - ref).norm() / ref.norm()) < 1e-5


@pytest.mark.gpu
def test_chol_grid_route_on_the_store_polish(cuda):
    """K4's large-D route on the reduced systems of the full polish built
    from the seeded 96-keyframe map store (D = 1440, condition ~9e4, dense
    inertial and visual coupling): within max(1e-5, 2 x the plain
    version's error) of float64, as chip_smoke.py holds it. Before a
    panel's products were summed first, tiny far-panel products were
    rounded away one by one and the solve landed 2e-3 from float64 (the
    plain version: 7e-6)."""
    import chip_smoke as cs
    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.backend.problems import Problems
    from monoorbslam3_tpu_torch.models.imu import ImuBuffer, ImuCalib
    from monoorbslam3_tpu_torch.models.map_state import MapStore
    from monoorbslam3_tpu_torch.ops import chol_pallas as cp

    cam = config.build_camera(config.load_settings(cs.SETTINGS / cs.EUROC_PROFILE), device=cuda)
    pr = Problems(cam, cs.store_calibration(ImuCalib, device=cuda), device=cuda)
    store, _ = cs.seeded_store(MapStore, ImuBuffer)
    with cs._Capture(cp, "chol_solve_cuda", maxlen=3) as cap:
        pr.full_inertial_optimize(store)
    assert cap.n == 12
    for S, b in cap.calls:
        ref = torch.linalg.solve(S.double(), b.double())
        err = float(cs._rel(cp.chol_solve_l2(S, b), ref).max())
        err_plain = float(cs._rel(cp.chol_solve_plain(S, b), ref).max())
        assert err <= max(1e-5, 2.0 * err_plain), (err, err_plain)


# ---------------------------------------------------------------------------
# The inertial stage on the card (plain torch, no hand kernel): the same
# functions on the CPU are its reference
# ---------------------------------------------------------------------------


def _imu_window(device, n_samples=50):
    """A keyframe window of the circle trajectory (200 Hz, EuRoC noise
    densities, a constant bias) and the EuRoC profile's calibration."""
    from chip_smoke import BA_TRUE, BG_TRUE, EUROC_PROFILE, SETTINGS
    from monoorbslam3_tpu_torch import config
    from monoorbslam3_tpu_torch.models.imu import ImuBuffer
    from monoorbslam3_tpu_torch.sim import Trajectory

    g, a, d = Trajectory().imu_samples(0.0, n_samples / 200.0, 200.0, bg=BG_TRUE, ba=BA_TRUE,
                                       noise_gyro=1.7e-4, noise_acc=2e-3,
                                       rng=np.random.default_rng(n_samples))
    buf = ImuBuffer()
    for k in range(len(d)):
        buf.add(g[k], a[k], d[k])
    calib = config.build_imu_calib(config.load_settings(SETTINGS / EUROC_PROFILE), device=device)
    bias = [torch.as_tensor(np.float32(b), device=device) for b in (BG_TRUE, BA_TRUE)]
    return buf, calib, bias


@pytest.mark.gpu
@pytest.mark.parametrize("n_samples", [10, 50, 130])
def test_inertial_stage_card_matches_cpu(cuda, n_samples):
    """preintegrate_tree, whiten and the deltas on the card within 1e-5 of
    the largest entry of each field of the same functions on the CPU (no
    TF32 or other card-only arithmetic on the path)."""
    from monoorbslam3_tpu_torch.backend.problems import whiten
    from monoorbslam3_tpu_torch.frontend.tracking import _predict_deltas

    out = {}
    for dev in (cuda, torch.device("cpu")):
        buf, calib, (bg, ba) = _imu_window(dev, n_samples)
        pre = buf.integrate(bg, ba, calib)
        out[dev.type] = (pre, whiten(pre), _predict_deltas(pre, bg + 1e-3, ba - 1e-2))
    for got, ref in zip(out["cuda"], out["cpu"]):
        for g, r in zip(got, ref):
            g, r = g.double().cpu(), r.double()
            assert float((g - r).abs().max()) <= 1e-5 * max(float(r.abs().max()), 1e-30)


@pytest.mark.gpu
def test_inertial_stage_makes_no_host_sync(cuda):
    """The whole inertial stage (upload of a window, the tree, the deltas,
    the whitening) under PyTorch's sync debug mode set to raise."""
    from monoorbslam3_tpu_torch.backend.problems import whiten
    from monoorbslam3_tpu_torch.frontend.tracking import _predict_deltas

    buf, calib, (bg, ba) = _imu_window(cuda)
    whiten(buf.integrate(bg, ba, calib))  # first launches outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pre = buf.integrate(bg, ba, calib)
        _predict_deltas(pre, bg, ba)
        whiten(pre)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_inertial_pose_lm_card_matches_cpu(cuda):
    """The 15-dim pose LM with the inertial edge and the prior on the card
    and on the CPU, on one seeded problem: final states within 1e-4."""
    from monoorbslam3_tpu_torch.backend.problems import _pose_optimize_impl, whiten
    from monoorbslam3_tpu_torch.backend.residuals import KfState
    from monoorbslam3_tpu_torch.models.camera import Pinhole
    from monoorbslam3_tpu_torch.sim import Trajectory

    traj = Trajectory()
    rng = np.random.default_rng(3)
    R_cb = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float32)
    t_cb = np.zeros(3, np.float32)
    R1, p1 = traj.R_wb(0.25), traj.pos(0.25)
    pc = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200), rng.uniform(2, 9, 200)], -1)
    R_cw = R_cb @ R1.T
    pts = ((pc - (t_cb - R_cw @ p1)) @ R_cw).astype(np.float32)
    uv = np.stack([400 * pc[:, 0] / pc[:, 2] + 376, 400 * pc[:, 1] / pc[:, 2] + 240], -1)
    uv = (uv + rng.normal(0, 0.5, uv.shape)).astype(np.float32)
    f32 = lambda x: np.asarray(x, np.float32)
    last = (f32(traj.R_wb(0.0)), f32(traj.pos(0.0)), f32(traj.vel(0.0)),
            np.full(3, 0.004, np.float32), np.full(3, 0.03, np.float32))
    state0 = (f32(R1), f32(p1 + 0.02), f32(traj.vel(0.25) + 0.1), last[3], last[4])
    finals = []
    for dev in (cuda, torch.device("cpu")):
        buf, calib, _ = _imu_window(dev)
        up = lambda x: torch.as_tensor(x, device=dev)
        edge = whiten(buf.integrate(up(last[3]), up(last[4]), calib))
        cam = Pinhole.create(400.0, 400.0, 376.0, 240.0, width=752, height=480, device=dev)
        st, _ = _pose_optimize_impl(
            KfState(*map(up, state0)), up(pts), up(uv), up(np.ones(200, np.float32)),
            up(np.ones(200, bool)), cam, up(R_cb), up(t_cb), edge, KfState(*map(up, last)),
            1.0, KfState(*map(up, last)), up(np.full(9, 10.0, np.float32)),
            use_inertial=True, use_prior=True)
        finals.append([a.cpu().numpy() for a in st])
    for a, b in zip(*finals):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_two_view_bootstrap_on_the_card(cuda):
    """reconstruct_two_views on the card against the CPU on the same RANSAC
    samples (a general scene at 4-12 m, 0.3 px noise, 20 outliers, the
    samples `draw_samples` draws on the host under the JAX key of seed 0,
    uploaded to the card): the same success and
    family, R within 1e-4 rad, n_good within 1, good equal in 99% of the
    rows. Its host syncs under the sync debug mode: the two of each of the
    five batched SVDs at most (`torch.linalg.svd` reads its status back),
    none from the winner's selection or the constants."""
    import warnings

    from monoorbslam3_tpu_torch.ops import twoview
    from monoorbslam3_tpu_torch.utils import prng

    rng = np.random.default_rng(11)
    K = np.array([[450.0, 0.0, 376.0], [0.0, 450.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
    pts = np.stack([rng.uniform(-3, 3, 400), rng.uniform(-2, 2, 400), rng.uniform(4, 12, 400)], -1)
    c, s = np.cos(0.1), np.sin(0.1)
    R21 = np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])
    t21 = np.array([0.4, 0.05, 0.02])
    proj = lambda p: (p @ K.T)[:, :2] / p[:, 2:3]
    uv1 = proj(pts) + rng.normal(scale=0.3, size=(400, 2))
    uv2 = proj(pts @ R21.T + t21) + rng.normal(scale=0.3, size=(400, 2))
    uv2[:20] += rng.uniform(30, 120, size=(20, 2))
    xy1, xy2 = (np.concatenate([u, np.zeros((64, 2))]).astype(np.float32) for u in (uv1, uv2))
    valid = np.concatenate([np.ones(400, bool), np.zeros(64, bool)])
    args = [torch.as_tensor(a, device=cuda) for a in (xy1, xy2, valid, K)]
    idx = torch.as_tensor(twoview.draw_samples(prng.prng_key(0), valid, 200), device=cuda)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = twoview.reconstruct_two_views(*args, idx)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("called a synchronizing" in str(w.message) for w in caught)
    assert syncs <= 10, syncs
    assert bool(((idx >= 0) & (idx < 400)).all())
    ref = twoview.reconstruct_two_views(*(a.cpu() for a in args), idx.cpu())
    got = {k: v.cpu().numpy() for k, v in out.items()}
    ref = {k: v.numpy() for k, v in ref.items()}
    assert bool(got["success"]) == bool(ref["success"]) is True
    assert (float(got["rh"]) > 0.45) == (float(ref["rh"]) > 0.45)
    dR = got["R"].astype(np.float64).T @ ref["R"].astype(np.float64)
    assert np.abs(dR - np.eye(3)).max() <= 1e-4
    assert abs(int(got["n_good"]) - int(ref["n_good"])) <= 1
    assert (got["good"] == ref["good"]).mean() >= 0.99


@pytest.mark.gpu
def test_vocabulary_transform_on_the_card(cuda):
    """Vocabulary.transform of the 100k-leaf vocabulary on the card against
    the CPU on seeded descriptors with padding: word and group ids equal,
    the BoW vector within 1e-7, and no host sync (the sync debug mode set
    to raise)."""
    from pathlib import Path

    from monoorbslam3_tpu_torch.ops import vocab

    path = Path(__file__).resolve().parents[1] / "settings" / "synthetic_voc_100k.txt.gz"
    v_cpu = vocab.load_dbow2_text(str(path), device="cpu")
    nd, idf = v_cpu.host_tables()
    v_card = vocab.Vocabulary.from_numpy(v_cpu.k, v_cpu.levels, nd, v_cpu.level_offset, idf,
                                         v_cpu.group_level, cuda)
    rng = np.random.default_rng(21)
    desc = rng.integers(0, 2**32, size=(768, 8), dtype=np.uint32)
    desc[:64] = nd[rng.integers(0, len(nd), 64)]
    valid = np.ones(768, bool)
    valid[700:] = False
    d_cpu = torch.from_numpy(desc.view(np.int32).copy())
    v_t = torch.from_numpy(valid)
    d_card, val_card = d_cpu.to(cuda), v_t.to(cuda)
    v_card.transform(d_card, val_card)  # first launches outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = v_card.transform(d_card, val_card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    ref = v_cpu.transform(d_cpu, v_t)
    w, g, b = (x.cpu() for x in out)
    assert torch.equal(w, ref[0]) and torch.equal(g, ref[1])
    assert float((b - ref[2]).abs().max()) <= 1e-7


@pytest.mark.gpu
def test_system_track_fetches_on_the_card(cuda):
    """build_system of the system world's profile on the card, warmed up,
    over the first 12 frames of its stream: every frame tracked after the
    bootstrap makes 3 fetches, its extraction, BoW, both stages and the
    preintegration included, and no host sync beyond them (the sync debug
    mode's warnings counted)."""
    import warnings
    from pathlib import Path

    from monoorbslam3_tpu_torch.config import build_system
    from monoorbslam3_tpu_torch.runners.synth import SyntheticDataset

    settings = Path(__file__).resolve().parents[1] / "settings" / "synthetic_vocab.yaml"
    syst = build_system(str(settings), device=cuda)
    syst.warmup()
    ds = SyntheticDataset("circle:t_end=1,fps=20", syst.camera, syst.calib)
    rows = []
    for t, img, imu in ds.frames():
        if len(rows) == 12:
            break
        n0, kf0 = syst.problems.syncs.n, syst.store.kf_created_total
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                state = syst.track(t, img, imu)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        syncs = sum("called a synchronizing" in str(w.message) for w in caught)
        rows.append((state, syst.problems.syncs.n - n0, syncs,
                     syst.store.kf_created_total > kf0))
    syst.shutdown()
    states = [r[0] for r in rows]
    assert 2 in states
    boot = states.index(2)
    tracked = [r for r in rows[boot + 1:] if r[0] == 2 and not r[3]]
    assert len(tracked) >= 5
    for state, fetches, syncs, _ in tracked:
        assert fetches == 3 and syncs == fetches, rows


@pytest.mark.gpu
def test_sharded_schur_ba_on_one_nccl_rank(cuda, tmp_path):
    """`sharded_schur_ba` on a one-rank NCCL group (a file store) and its
    ("dp",) mesh, on the bench window: the cost of `schur_ba` within 1e-3,
    the poses within 2e-3, one all_reduce an iteration (and two after the
    loop), ten K4 launches and no host sync inside the solve."""
    import warnings

    import torch.distributed as dist

    from monoorbslam3_tpu_torch.backend.solver import schur_ba
    from monoorbslam3_tpu_torch.bench_window import build_problem
    from monoorbslam3_tpu_torch.parallel import multihost, sharded_ba

    assert multihost.initialize(coordinator=f"file://{tmp_path}/store", num_processes=1,
                                process_id=0)
    calls = []
    inner = dist.all_reduce
    try:
        mesh = multihost.global_mesh(("dp",))
        problem, cam = build_problem(seed=0, device=cuda)
        eye, z = torch.eye(3, device=cuda), torch.zeros(3, device=cuda)
        sharded, dropped = sharded_ba.shard_problem_by_point(problem, 1)
        sharded_ba.sharded_schur_ba(sharded, cam, eye, z, mesh, n_iters=10)  # warm-up
        torch.cuda.synchronize()
        dist.all_reduce = lambda *a, **k: (calls.append(1), inner(*a, **k))[1]
        n0 = cuda_lib.launches["chol_solve"]
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                kf, pts, info = sharded_ba.sharded_schur_ba(sharded, cam, eye, z, mesh,
                                                             n_iters=10)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        syncs = sum("called a synchronizing" in str(w.message) for w in caught)
        launches = cuda_lib.launches["chol_solve"] - n0
        kf1, _, info1 = schur_ba(problem, cam, eye, z, n_iters=10)
        assert dropped == 0 and syncs == 0 and launches == 10 and len(calls) == 12
        assert abs(float(info["cost"]) - float(info1["cost"])) <= 1e-3 * float(info1["cost"])
        assert float((kf.t_wb - kf1.t_wb).abs().max()) <= 2e-3
        assert bool(torch.isfinite(pts).all())
    finally:
        dist.all_reduce = inner
        dist.destroy_process_group()


@pytest.mark.gpu
def test_graft_step_makes_no_host_sync(cuda):
    """The flagship step (`graft_entry.entry`) runs with PyTorch's sync
    debug mode raising on any host sync, after one warm-up call; its
    outputs stay on the card."""
    from monoorbslam3_tpu_torch import graft_entry

    step, args = graft_entry.entry(cuda)
    step(*args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        R, t, n = step(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert R.is_cuda and t.is_cuda and n.is_cuda


@pytest.mark.gpu
def test_failed_kernel_build_raises(cuda, tmp_path, monkeypatch):
    """A source that nvcc refuses ends a measurement with nvcc's error: no
    entry point falls back to a plain version on the card."""
    from monoorbslam3_tpu_torch.measure import bench

    (tmp_path / "broken.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(cuda_lib, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_lib, "BUILD", tmp_path / "_build")
    monkeypatch.setattr(cuda_lib, "LIB", tmp_path / "_build" / "lib.so")
    monkeypatch.setattr(cuda_lib, "BUILD_LOG", tmp_path / "_build" / "nvcc.log")
    monkeypatch.setattr(cuda_lib, "_lib", None)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        bench.bench(cuda, window=dict(n_kf=8, n_fixed=2, n_pts=256, obs_per_kf=48),
                    frontend=(240, 376, 256))


@pytest.mark.gpu
def test_failed_frontend_bench_raises(cuda, monkeypatch):
    """A tracking step that fails ends the bench: no -1 stands in for its
    rate."""
    from monoorbslam3_tpu_torch.measure import bench

    def broken(device, *shape):
        def step(*args):
            raise RuntimeError("the tracking step failed")
        return step, None

    monkeypatch.setattr(bench, "flagship", broken)
    with pytest.raises(RuntimeError, match="the tracking step failed"):
        bench.bench(cuda, window=dict(n_kf=8, n_fixed=2, n_pts=256, obs_per_kf=48),
                    frontend=(240, 376, 256))


@pytest.mark.gpu
def test_failed_rank_raises_on_the_card(cuda):
    """A rank's exception comes back with its traceback; more ranks than
    cards raise before any process starts."""
    import operator

    from monoorbslam3_tpu_torch.parallel import multihost

    with pytest.raises(RuntimeError, match="ZeroDivisionError"):
        multihost.run_ranks(operator.truediv, 1, "cuda", args=(1, 0), timeout=300)
    n = torch.cuda.device_count() + 1
    with pytest.raises(RuntimeError, match=f"{n} ranks need {n} cards"):
        multihost.run_ranks(operator.truediv, n, "cuda", args=(1, 1))
