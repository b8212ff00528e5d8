"""PyTorch port, IMU preintegration and the whitened inertial edge, against
the JAX package on the CPU, on seeded inputs.

Tolerances (XLA on the CPU fuses multiply-adds inside jitted code, eager
torch rounds each product): the deltas dR/dV/dP and the five bias
Jacobians within 1e-5 of the largest entry of the JAX field, the
covariance C and the whitener L_inv within 1e-4. The port's scan is held
to JAX's scan and the port's tree to JAX's tree; the two reductions are
not compared across packages. Host numpy (`ImuBuffer`, the trajectory's
IMU samples) is bit-identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoorbslam3_tpu import sim as jsim
from monoorbslam3_tpu.backend import solver as jsolver
from monoorbslam3_tpu.backend.residuals import PreintEdge as JPreintEdge
from monoorbslam3_tpu.frontend.tracking import _predict_deltas as j_predict_deltas
from monoorbslam3_tpu.models import imu as jimu
from monoorbslam3_tpu_torch import sim as tsim
from monoorbslam3_tpu_torch.backend import solver as tsolver
from monoorbslam3_tpu_torch.backend.problems import whiten as t_whiten
from monoorbslam3_tpu_torch.frontend.tracking import _predict_deltas as t_predict_deltas
from monoorbslam3_tpu_torch.models import imu as timu

# EuRoC's rig and densities (settings/euroc.yaml:15-26)
R_BC = np.array([[0.0148655429818, -0.999880929698, 0.00414029679422],
                 [0.999557249008, 0.0149672133247, 0.025715529948],
                 [-0.0257744366974, 0.00375618835797, 0.999660727178]])
T_BC = np.array([-0.0216401454975, -0.064676986768, 0.00981073058949])
DENSITIES = dict(noise_gyro=1.6968e-4, noise_acc=2.0e-3, walk_gyro=1.9393e-5, walk_acc=3.0e-3)
BG = np.array([0.004, -0.003, 0.002], np.float32)
BA = np.array([0.03, -0.02, 0.05], np.float32)

DELTA_FIELDS = ("dR", "dV", "dP", "JRg", "JVg", "JVa", "JPg", "JPa", "dt")
DELTA_RTOL, COV_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def calibs():
    return (jimu.ImuCalib.create(R_BC, T_BC, freq=200.0, **DENSITIES),
            timu.ImuCalib.create(R_BC, T_BC, freq=200.0, device="cpu", **DENSITIES))


def seeded_window(n, seed, n_masked=0):
    """n samples of a rotating, accelerating body at 200 Hz (rates up to
    1 rad/s, specific force near gravity), the last n_masked masked out."""
    rng = np.random.default_rng(seed)
    gyro = (rng.normal(size=(n, 3)) * 0.6).astype(np.float32)
    acc = (rng.normal(size=(n, 3)) * 1.5 + [0.0, 0.0, 9.8]).astype(np.float32)
    dts = np.full(n, 0.005, np.float32) + rng.uniform(0, 1e-4, n).astype(np.float32)
    mask = np.ones(n, np.float32)
    if n_masked:
        mask[n - n_masked:] = 0.0
    return gyro, acc, dts, mask


def _rel(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def assert_pre_close(tpre, jpre, cov_rtol=COV_RTOL):
    for name in DELTA_FIELDS:
        assert _rel(getattr(tpre, name), getattr(jpre, name)) <= DELTA_RTOL, name
    assert _rel(tpre.C, jpre.C) <= cov_rtol
    np.testing.assert_array_equal(tpre.bg.numpy(), np.asarray(jpre.bg))
    np.testing.assert_array_equal(tpre.ba.numpy(), np.asarray(jpre.ba))


def to_torch(rec, cls):
    return cls(*(torch.as_tensor(np.array(a, np.float32)) for a in rec))


def test_imu_calib_create(calibs):
    """The densities discretized at 200 Hz, the inverse extrinsics."""
    jc, tc = calibs
    for name in ("R_bc", "t_bc", "R_cb", "cov_noise", "cov_walk", "bg0", "ba0"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(), np.asarray(getattr(jc, name)),
                                      err_msg=name)
    np.testing.assert_allclose(tc.t_cb.numpy(), np.asarray(jc.t_cb), rtol=0, atol=1e-8)
    assert tc.freq == jc.freq == 200.0
    np.testing.assert_allclose(tc.cov_noise.numpy()[:3], 1.6968e-4 ** 2 * 200, rtol=1e-6)
    np.testing.assert_allclose(tc.cov_walk.numpy()[3:], 3.0e-3 ** 2 / 200, rtol=1e-6)


@pytest.mark.parametrize("n,n_masked", [(1, 0), (7, 2), (50, 5)])
def test_preintegrate_scan_matches_jax(calibs, n, n_masked):
    jc, tc = calibs
    g, a, d, m = seeded_window(n, seed=n, n_masked=n_masked)
    jpre = jimu.preintegrate_jit(g, a, d, m, jnp.asarray(BG), jnp.asarray(BA), jc)
    tpre = timu.preintegrate(g, a, d, m, BG, BA, tc)
    assert_pre_close(tpre, jpre)


@pytest.mark.parametrize("n,n_masked", [(1, 0), (7, 2), (50, 5), (64, 0), (200, 13)])
def test_preintegrate_tree_matches_jax(calibs, n, n_masked):
    jc, tc = calibs
    g, a, d, m = seeded_window(n, seed=100 + n, n_masked=n_masked)
    jpre = jimu.preintegrate_tree_jit(g, a, d, m, jnp.asarray(BG), jnp.asarray(BA), jc)
    tpre = timu.preintegrate_tree(g, a, d, m, BG, BA, tc)
    assert_pre_close(tpre, jpre)
    # masked samples are the identity element: the first n - n_masked alone
    # give the same result
    k = n - n_masked
    tpre_k = timu.preintegrate_tree(g[:k], a[:k], d[:k], m[:k], BG, BA, tc)
    for name in DELTA_FIELDS:
        assert _rel(getattr(tpre_k, name), getattr(tpre, name)) <= DELTA_RTOL, name


def test_imu_buffer_bit_identical(calibs):
    """add/extend/decimated/padded give the same arrays in both packages,
    and `integrate` runs the tree on the calibration's device."""
    jc, tc = calibs
    g, a, d, _ = seeded_window(150, seed=3)
    jb, tb = jimu.ImuBuffer(capacity=64), timu.ImuBuffer(capacity=64)
    for buf in (jb, tb):
        for k in range(100):
            buf.add(g[k], a[k], d[k])
    je, te = jimu.ImuBuffer(), timu.ImuBuffer()
    for k in range(100, 150):
        je.add(g[k], a[k], d[k])
        te.add(g[k], a[k], d[k])
    jb.extend(je)
    tb.extend(te)
    assert jb.n == tb.n == 150 and jb.capacity == tb.capacity == 256
    for cap in (None, 64, 512):
        for x, y in zip(jb.padded(cap), tb.padded(cap)):
            np.testing.assert_array_equal(y, x)
    for cap in (37, 64, 149, 200):
        jd, td = jb.decimated(cap), tb.decimated(cap)
        assert jd.n == td.n <= cap
        for name in ("gyro", "acc", "dts"):
            np.testing.assert_array_equal(getattr(td, name)[: td.n], getattr(jd, name)[: jd.n])
    small = timu.ImuBuffer()
    for k in range(10):
        small.add(g[k], a[k], d[k])
    assert small.padded()[0].shape == (64, 3)  # a 20 fps frame pads to 64
    jpre = jb.integrate(BG, BA, jc)
    tpre = tb.integrate(BG, BA, tc)
    assert tpre.dR.device == tc.cov_noise.device
    assert_pre_close(tpre, jpre)


def test_whiten_matches_jax(calibs):
    """PreintEdge.from_preintegrated on one window and on a batch of three."""
    jc, tc = calibs
    pres = []
    for n in (10, 50, 120):
        g, a, d, m = seeded_window(n, seed=7 * n)
        pres.append(jimu.preintegrate_tree_jit(g, a, d, m, jnp.asarray(BG), jnp.asarray(BA), jc))
    batch = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *pres)
    for jpre in (pres[1], batch):
        je = jax.jit(JPreintEdge.from_preintegrated)(jpre)
        te = t_whiten(to_torch(jpre, timu.Preintegrated))
        assert _rel(te.L_inv, je.L_inv) <= COV_RTOL
        for tf, jf in zip(te[:-1], je[:-1]):
            np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_whiten_not_positive_definite_gives_nan(calibs):
    """A covariance that is not positive definite: the whitener is NaN in
    both packages (the port's Cholesky reads no status back)."""
    jc, _ = calibs
    g, a, d, m = seeded_window(20, seed=5)
    jpre = jimu.preintegrate_tree_jit(g, a, d, m, jnp.asarray(BG), jnp.asarray(BA), jc)
    C = np.array(jpre.C)
    C[4, 4] = -1.0
    jpre = jpre._replace(C=jnp.asarray(C))
    je = jax.jit(JPreintEdge.from_preintegrated)(jpre)
    te = t_whiten(to_torch(jpre, timu.Preintegrated))
    assert np.isnan(np.asarray(je.L_inv)).all()
    assert torch.isnan(te.L_inv).all()


def test_predict_deltas_matches_jax(calibs):
    """Bias-corrected deltas at a bias off the linearization point; the
    port's polar re-orthonormalization against JAX's SVD."""
    jc, _ = calibs
    g, a, d, m = seeded_window(50, seed=11)
    jpre = jimu.preintegrate_tree_jit(g, a, d, m, jnp.asarray(BG), jnp.asarray(BA), jc)
    bg2 = BG + np.array([2e-3, -1e-3, 3e-3], np.float32)
    ba2 = BA + np.array([-0.02, 0.01, 0.03], np.float32)
    jd = j_predict_deltas(jpre, jnp.asarray(bg2), jnp.asarray(ba2))
    td = t_predict_deltas(to_torch(jpre, timu.Preintegrated), torch.as_tensor(bg2),
                          torch.as_tensor(ba2))
    for t, j in zip(td, jd):
        assert _rel(t, j) <= DELTA_RTOL
    R = td[0].double()
    assert float((R.T @ R - torch.eye(3, dtype=torch.float64)).abs().max()) < 1e-6


def test_polar_rotation_matches_svd():
    """lie.polar_rotation against the SVD projection of both packages on
    rotations perturbed by 1e-5 (rounding scale and past it)."""
    from monoorbslam3_tpu.utils import lie as jlie
    from monoorbslam3_tpu_torch.utils import lie as tlie

    rng = np.random.default_rng(2)
    R = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(size=(64, 3)).astype(np.float32))))
    R = (R + 1e-5 * rng.normal(size=R.shape)).astype(np.float32)
    ref = np.asarray(jlie.normalize_rotation(jnp.asarray(R)))
    got = tlie.polar_rotation(torch.as_tensor(R)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tlie.normalize_rotation(torch.as_tensor(R)).numpy(), ref,
                               rtol=0, atol=1e-6)


def test_solve_spd15_jacobi_matches_jax():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(4, 15, 15)).astype(np.float32)
    scale = np.logspace(-3, 3, 15).astype(np.float32)
    H = (A @ A.transpose(0, 2, 1) + 15 * np.eye(15, dtype=np.float32)) * scale[:, None] * scale
    g = rng.normal(size=(4, 15)).astype(np.float32)
    ref = np.asarray(jsolver.solve_spd15_jacobi(jnp.asarray(H), jnp.asarray(g)))
    got = tsolver.solve_spd15_jacobi(torch.as_tensor(H), torch.as_tensor(g)).numpy()
    x64 = np.linalg.solve(H.astype(np.float64), g.astype(np.float64)[..., None])[..., 0]
    assert _rel(got, ref) <= 1e-5
    assert _rel(got, x64) <= 1e-4


@pytest.mark.parametrize("kind", ["clean", "noisy"])
def test_trajectory_imu_bit_identical(kind):
    jt, tt = jsim.Trajectory(), tsim.Trajectory()
    ts = np.linspace(0.0, 3.0, 17)
    for name in ("pos", "vel", "acc", "omega_body", "R_wb"):
        np.testing.assert_array_equal(getattr(tt, name)(ts), getattr(jt, name)(ts), err_msg=name)
    kw = dict(bg=[0.004, -0.003, 0.002], ba=[0.03, -0.02, 0.05])
    if kind == "noisy":
        kw.update(noise_gyro=1.7e-4, noise_acc=2e-3)
    a = jt.imu_samples(0.05, 0.3, 200.0, rng=np.random.default_rng(9), **kw)
    b = tt.imu_samples(0.05, 0.3, 200.0, rng=np.random.default_rng(9), **kw)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype == np.float32
        np.testing.assert_array_equal(y, x)


def test_convert_keeps_scalar_fields():
    """convert.tensor / preint_edge keep a 0-d field 0-d (a PreintEdge's
    dt became shape (1,), which broke the inertial residual's
    broadcasting)."""
    from monoorbslam3_tpu_torch import convert

    assert convert.tensor(np.float32(0.25), device="cpu").shape == ()
    assert convert.tensor(np.zeros((2, 3)), device="cpu").shape == (2, 3)
    g, a, d, m = seeded_window(10, seed=1)
    jc = jimu.ImuCalib.create(R_BC, T_BC, freq=200.0, **DENSITIES)
    je = jax.jit(JPreintEdge.from_preintegrated)(
        jimu.preintegrate_tree_jit(g, a, d, m, jnp.asarray(BG), jnp.asarray(BA), jc))
    te = convert.preint_edge(je, device="cpu")
    assert [tuple(x.shape) for x in te] == [np.shape(x) for x in je]
