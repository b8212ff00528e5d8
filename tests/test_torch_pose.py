"""PyTorch port, visual frame pose LM (`backend/problems._pose_optimize_impl`)
against the JAX package on the CPU, on the same seeded problem.

Tolerances: R within 1e-4 (Frobenius) and t within 1e-4 m, inlier masks
identical (measured over the three seeds: at most 8.2e-7 and 3.1e-6 m). Both run the same deferred-accept parallel-lambda LM in float32;
only the summation order of the products differs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from monoorbslam3_tpu.backend import problems as jp
from monoorbslam3_tpu.backend.residuals import KfState as JKfState
from monoorbslam3_tpu.models.camera import Pinhole as JPinhole
from monoorbslam3_tpu.utils import lie as jlie
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch.backend import problems as tp
from monoorbslam3_tpu_torch.backend import residuals as tres
from monoorbslam3_tpu_torch.backend import solver as tsolver
from monoorbslam3_tpu_torch.utils import lie as tlie

R_CB = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]], np.float32)
T_CB = np.array([0.02, -0.01, 0.03], np.float32)


def _problem(seed, N=240, outlier_frac=0.1, noise_px=0.5):
    rng = np.random.default_rng(seed)
    jcam = JPinhole.create(fx=458.654, fy=457.296, cx=367.215, cy=248.375,
                           dist=[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05],
                           width=752, height=480)
    R_wb = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(0, 0.3, 3), jnp.float32)))
    t_wb = rng.normal(0, 0.5, 3).astype(np.float32)
    # points in front of the camera: camera frame -> world
    pc = np.stack([rng.uniform(-3, 3, N), rng.uniform(-2, 2, N), rng.uniform(2, 9, N)], -1)
    R_cw = R_CB @ R_wb.T
    t_cw = T_CB - R_cw @ t_wb
    pts = ((pc - t_cw) @ R_cw).astype(np.float32)
    uv = np.stack([458.654 * pc[:, 0] / pc[:, 2] + 367.215,
                   457.296 * pc[:, 1] / pc[:, 2] + 248.375], -1)
    uv += rng.normal(0, noise_px, uv.shape)
    out = rng.random(N) < outlier_frac
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    level = rng.integers(0, 8, N)
    inv_s2 = (1.0 / 1.2 ** (2.0 * level)).astype(np.float32)
    valid = rng.random(N) > 0.05
    # predicted pose: the true one moved by a few cm and ~1 degree
    dR = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(0, 0.01, 3), jnp.float32)))
    state0 = (R_wb @ dR, t_wb + rng.normal(0, 0.03, 3).astype(np.float32),
              np.zeros(3, np.float32), np.zeros(3, np.float32), np.zeros(3, np.float32))
    state0 = tuple(np.asarray(a, np.float32) for a in state0)
    return jcam, state0, pts, uv.astype(np.float32), inv_s2, valid, (R_wb, t_wb)


def _run_jax(jcam, state0, pts, uv, inv_s2, valid):
    z = JKfState.zeros()
    st, inl = jp._pose_optimize_impl(
        JKfState(*map(jnp.asarray, state0)), jnp.asarray(pts), jnp.asarray(uv),
        jnp.asarray(inv_s2), jnp.asarray(valid), jcam, jnp.asarray(R_CB), jnp.asarray(T_CB),
        jp._identity_edge(), z, jnp.float32(0.0), z, jnp.zeros(9, jnp.float32),
        use_inertial=False, use_prior=False)
    return np.asarray(st.R_wb), np.asarray(st.t_wb), np.asarray(inl)


def _run_torch(jcam, state0, pts, uv, inv_s2, valid):
    cam = convert.pinhole(jcam)
    z = tres.KfState.zeros()
    st, inl = tp._pose_optimize_impl(
        convert.kf_state(state0), torch.as_tensor(pts), torch.as_tensor(uv),
        torch.as_tensor(inv_s2), torch.as_tensor(valid), cam, torch.as_tensor(R_CB),
        torch.as_tensor(T_CB), tp._identity_edge(), z, 0.0, z, None,
        use_inertial=False, use_prior=False)
    return st.R_wb.numpy(), st.t_wb.numpy(), inl.numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pose_lm_matches_jax(seed):
    jcam, state0, pts, uv, inv_s2, valid, (R_true, t_true) = _problem(seed)
    Rj, tj, inl_j = _run_jax(jcam, state0, pts, uv, inv_s2, valid)
    Rt, tt, inl_t = _run_torch(jcam, state0, pts, uv, inv_s2, valid)
    assert np.linalg.norm(Rt - Rj) <= 1e-4
    assert np.linalg.norm(tt - tj) <= 1e-4
    np.testing.assert_array_equal(inl_t, inl_j)
    # and the fit is a real one: near the truth, outliers rejected
    assert np.linalg.norm(tj - t_true) < 0.02
    assert 0.7 * valid.sum() < inl_j.sum() < valid.sum()


def test_pose_lm_rejects_inertial_branch():
    jcam, state0, pts, uv, inv_s2, valid, _ = _problem(0, N=16)
    cam = convert.pinhole(jcam)
    z = tres.KfState.zeros()
    with pytest.raises(NotImplementedError):
        tp._pose_optimize_impl(
            convert.kf_state(state0), torch.as_tensor(pts), torch.as_tensor(uv),
            torch.as_tensor(inv_s2), torch.as_tensor(valid), cam, torch.as_tensor(R_CB),
            torch.as_tensor(T_CB), tp._identity_edge(), z, 1.0, z, None, use_inertial=True)


def test_small_inverses_and_retraction_match_jax():
    """inv_spd6 (nested Schur, closed form), exp_so3 and retract_kf on the
    same inputs: float32 agreement to 1e-5 relative."""
    from monoorbslam3_tpu.backend import residuals as jres
    from monoorbslam3_tpu.backend import solver as jsolver

    rng = np.random.default_rng(3)
    A = rng.normal(size=(5, 6, 6)).astype(np.float32)
    M = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6, dtype=np.float32)).astype(np.float32)
    ref = np.asarray(jsolver.inv_spd6(jnp.asarray(M)))
    np.testing.assert_allclose(tsolver.inv_spd6(torch.as_tensor(M)).numpy(), ref,
                               rtol=1e-5, atol=1e-6)
    w = rng.normal(0, 0.5, (7, 3)).astype(np.float32)
    w[0] = 0.0
    np.testing.assert_allclose(tlie.exp_so3(torch.as_tensor(w)).numpy(),
                               np.asarray(jlie.exp_so3(jnp.asarray(w))), atol=1e-6)
    R0 = np.asarray(jlie.exp_so3(jnp.asarray(rng.normal(0, 1, 3), jnp.float32)))
    s = (R0, rng.normal(size=3), rng.normal(size=3), rng.normal(size=3), rng.normal(size=3))
    s = tuple(np.asarray(a, np.float32) for a in s)
    dx = rng.normal(0, 0.1, 15).astype(np.float32)
    rj = jres.retract_kf(JKfState(*map(jnp.asarray, s)), jnp.asarray(dx))
    rt = tres.retract_kf(convert.kf_state(s), torch.as_tensor(dx))
    for a, b in zip(rj, rt):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6)
