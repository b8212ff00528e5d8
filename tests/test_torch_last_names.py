"""PyTorch port: the JAX package's remaining public names, each against the
JAX function on the same seeded inputs on the CPU.

- `ops/pallas_kernels.hamming_matrix_best` (the plain version here, K3 on a
  CUDA tensor; JAX's XLA product here): equal, integer distances;
- `ops/image.gaussian_blur`: within 1e-4 on a 0..255 image (the two
  convolutions sum the taps in another order);
- `ops/fast.fast_score_map` and `ops/orb.gather_patches`: equal
  (subtractions, minima and copies only);
- `backend/residuals.inertial_gs_residual` and `gravity_rotation`: within
  1e-5 of the largest entry, and the Jacobian of the residual in the
  gravity angles and the log scale (the port's autograd) within 1e-4 of
  the largest entry of JAX's `jacfwd`;
- `backend/solver.inv_spd_blocks15`: within 1e-4 of JAX's inverse at
  K = 9 blocks, and the solve within tests/test_solver.py's bound of
  float64;
- `models/imu.GRAVITY_W`: equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoorbslam3_tpu.backend import residuals as jres
from monoorbslam3_tpu.backend import solver as jsolver
from monoorbslam3_tpu.models import imu as jimu
from monoorbslam3_tpu.ops import fast as jfast
from monoorbslam3_tpu.ops import image as jimage
from monoorbslam3_tpu.ops import orb as jorb
from monoorbslam3_tpu.ops import pallas_kernels as jpk
from monoorbslam3_tpu_torch.backend import residuals as tres
from monoorbslam3_tpu_torch.backend import solver as tsolver
from monoorbslam3_tpu_torch.models import imu as timu
from monoorbslam3_tpu_torch.ops import fast as tfast
from monoorbslam3_tpu_torch.ops import image as timage
from monoorbslam3_tpu_torch.ops import orb as torb
from monoorbslam3_tpu_torch.ops import pallas_kernels as tpk
from monoorbslam3_tpu_torch.utils import lie as tlie

from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

BLUR_ATOL = 1e-4
GS_RTOL, GS_JAC_RTOL = 1e-5, 1e-4


def seeded_image(shape, seed):
    return (np.random.default_rng(seed).random(shape) * 255).astype(np.float32)


@pytest.mark.parametrize("N,M", [(1, 1), (37, 100), (300, 1024)])
def test_hamming_matrix_best(N, M):
    rng = np.random.default_rng(N + M)
    a = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (M, 8), dtype=np.uint64).astype(np.uint32)
    ref = np.asarray(jpk.hamming_matrix_best(jnp.asarray(a), jnp.asarray(b)))
    got = tpk.hamming_matrix_best(torch.as_tensor(a.view(np.int32)),
                                  torch.as_tensor(b.view(np.int32)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("ksize,sigma,shape", [(7, 2.0, (60, 80)), (5, 1.0, (33, 47)),
                                               (9, 3.0, (512, 96))])
def test_gaussian_blur(ksize, sigma, shape):
    img = seeded_image(shape, ksize)
    ref = np.asarray(jimage.gaussian_blur(jnp.asarray(img), ksize, sigma))
    got = timage.gaussian_blur(torch.as_tensor(img), ksize, sigma).numpy()
    assert got.shape == ref.shape == shape
    np.testing.assert_allclose(got, ref, rtol=0, atol=BLUR_ATOL)


@pytest.mark.parametrize("threshold", [0.0, 7.0, 20.0])
def test_fast_score_map(threshold):
    img = seeded_image((64, 96), 3)
    ref = np.asarray(jfast.fast_score_map(jnp.asarray(img), threshold))
    got = tfast.fast_score_map(torch.as_tensor(img), threshold).numpy()
    assert (ref > 0).any() and (ref == 0).any()
    np.testing.assert_array_equal(got, ref)


def test_gather_patches():
    rng = np.random.default_rng(4)
    img = seeded_image((120, 200), 4)
    # corners and the interior, at fractional positions (truncated)
    xy = np.concatenate([[[0.0, 0.0], [199.9, 119.9], [0.0, 119.0], [199.0, 0.0]],
                         rng.uniform([0, 0], [200, 120], (60, 2))]).astype(np.float32)
    ref = np.asarray(jorb.gather_patches(jnp.asarray(img), jnp.asarray(xy)))
    got = torb.gather_patches(torch.as_tensor(img), torch.as_tensor(xy)).numpy()
    assert got.shape == (64, torb.PATCH, torb.PATCH)
    np.testing.assert_array_equal(got, ref)


def _rotations(rng, n, scale):
    w = torch.as_tensor(rng.normal(size=(n, 3)) * scale)
    return tlie.exp_so3(w).numpy().astype(np.float32)


@pytest.fixture(scope="module")
def gs_inputs():
    """Six inertial edges between seeded states, a gravity frame and a log
    scale, as float32 numpy arrays."""
    rng = np.random.default_rng(11)
    E = 6
    f = lambda *s, k=1.0: (rng.normal(size=s) * k).astype(np.float32)
    s1 = dict(R_wb=_rotations(rng, E, 1.0), t_wb=f(E, 3, k=2.0), v=f(E, 3), bg=f(E, 3, k=1e-3),
              ba=f(E, 3, k=1e-2))
    s2 = dict(R_wb=_rotations(rng, E, 1.0), t_wb=f(E, 3, k=2.0), v=f(E, 3), bg=f(E, 3, k=1e-3),
              ba=f(E, 3, k=1e-2))
    L = np.tril(f(E, 9, 9, k=0.3)) + 5.0 * np.eye(9, dtype=np.float32)
    edge = dict(dR=_rotations(rng, E, 0.2), dV=f(E, 3), dP=f(E, 3), JRg=f(E, 3, 3, k=0.1),
                JVg=f(E, 3, 3, k=0.1), JVa=f(E, 3, 3, k=0.1), JPg=f(E, 3, 3, k=0.1),
                JPa=f(E, 3, 3, k=0.1), bg0=f(E, 3, k=1e-3), ba0=f(E, 3, k=1e-2),
                dt=np.full(E, 0.25, np.float32), L_inv=L)
    R_wg0 = _rotations(rng, 1, 0.3)[0]
    theta = f(2, k=0.05)
    log_scale = np.float32(0.3)
    return s1, s2, edge, R_wg0, theta, log_scale


def _jax_gs(s1, s2, edge):
    return (jres.KfState(**{k: jnp.asarray(v) for k, v in s1.items()}),
            jres.KfState(**{k: jnp.asarray(v) for k, v in s2.items()}),
            jres.PreintEdge(**{k: jnp.asarray(v) for k, v in edge.items()}))


def _torch_gs(s1, s2, edge):
    t = torch.as_tensor
    return (tres.KfState(**{k: t(v) for k, v in s1.items()}),
            tres.KfState(**{k: t(v) for k, v in s2.items()}),
            tres.PreintEdge(**{k: t(v) for k, v in edge.items()}))


def test_gravity_rotation(gs_inputs):
    *_, R_wg0, theta, _ = gs_inputs
    ref = np.asarray(jres.gravity_rotation(jnp.asarray(theta), jnp.asarray(R_wg0)))
    got = tres.gravity_rotation(torch.as_tensor(theta), torch.as_tensor(R_wg0)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GS_RTOL)
    np.testing.assert_allclose(got @ got.T, np.eye(3), atol=1e-6)


@pytest.mark.parametrize("whiten", [False, True])
def test_inertial_gs_residual(gs_inputs, whiten):
    s1, s2, edge, R_wg0, theta, log_scale = gs_inputs
    j1, j2, je = _jax_gs(s1, s2, edge)
    R_wg = jres.gravity_rotation(jnp.asarray(theta), jnp.asarray(R_wg0))
    ref = np.asarray(jres.inertial_gs_residual(j1, j2, je, R_wg, jnp.asarray(log_scale), whiten))
    t1, t2, te = _torch_gs(s1, s2, edge)
    R_wg_t = tres.gravity_rotation(torch.as_tensor(theta), torch.as_tensor(R_wg0))
    got = tres.inertial_gs_residual(t1, t2, te, R_wg_t, torch.tensor(log_scale), whiten).numpy()
    assert got.shape == (6, 9)
    np.testing.assert_allclose(got, ref, rtol=0, atol=GS_RTOL * np.abs(ref).max())


def test_inertial_gs_jacobian(gs_inputs):
    """d r / d (theta, log_scale): the port's autograd against JAX's jacfwd."""
    s1, s2, edge, R_wg0, theta, log_scale = gs_inputs
    j1, j2, je = _jax_gs(s1, s2, edge)

    def jax_r(x):
        R_wg = jres.gravity_rotation(x[:2], jnp.asarray(R_wg0))
        return jres.inertial_gs_residual(j1, j2, je, R_wg, x[2])

    x0 = np.concatenate([theta, [log_scale]]).astype(np.float32)
    ref = np.asarray(jax.jacfwd(jax_r)(jnp.asarray(x0)))

    parts, R0 = _torch_gs(s1, s2, edge), torch.as_tensor(R_wg0)

    def torch_r(x):
        return tres.inertial_gs_residual(*parts, tres.gravity_rotation(x[:2], R0), x[2])

    got = torch.autograd.functional.jacobian(torch_r, torch.as_tensor(x0)).numpy()
    assert got.shape == ref.shape == (6, 9, 3)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(got, ref, rtol=0, atol=GS_JAC_RTOL * scale)


def test_inv_spd_blocks15():
    """tests/test_solver.py's case (K = 9 blocks, LM-damped and Jacobi-
    normalized) through both packages."""
    rng = np.random.default_rng(7)
    K = 9
    n = 15 * K
    A = rng.normal(size=(2, n, n)).astype(np.float32) / np.sqrt(n)
    H = A @ A.transpose(0, 2, 1) + 0.05 * np.eye(n, dtype=np.float32)
    d = np.sqrt(np.abs(np.diagonal(H, axis1=-2, axis2=-1)))
    Hn = (H / d[:, :, None] / d[:, None, :]).astype(np.float32)
    g = rng.normal(size=(2, n)).astype(np.float32)
    ref = np.asarray(jsolver.inv_spd_blocks15(jnp.asarray(Hn), K))
    got = tsolver.inv_spd_blocks15(torch.as_tensor(Hn), K).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    x_ref = np.linalg.solve(Hn.astype(np.float64), g.astype(np.float64)[..., None]).squeeze(-1)
    x = (got @ g[..., None]).squeeze(-1)
    scale = np.abs(x_ref).max()
    assert np.allclose(x, x_ref, rtol=5e-3, atol=1e-3 * scale)


def test_gravity_w():
    assert timu.GRAVITY_W.dtype == jimu.GRAVITY_W.dtype
    np.testing.assert_array_equal(timu.GRAVITY_W, jimu.GRAVITY_W)
    np.testing.assert_array_equal(tres.G_I, timu.GRAVITY_W)
