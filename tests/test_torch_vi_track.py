"""PyTorch port, the visual-inertial tracking step against the JAX package
on the CPU, on a seeded scene: the circle trajectory, a keyframe at
t = 0 (its true state and biases) and a frame at t = 0.25 s, the IMU
samples between them preintegrated and whitened by the JAX package and
carried over, map points seen by the frame with pixel noise and outliers.

0. The IMU prediction of the frame from the keyframe against the inertial
   branch of the JAX package's `Tracking._predict_state`, within 1e-5.
1. The LM tail's closed-form Jacobian (inertial J2 block, prior diagonal)
   against JAX's jacfwd of the same residuals, within 1e-4 of the largest
   entry.
2. `_pose_optimize_impl` with `use_inertial` and `use_prior` on and off:
   the final state within 1e-3 and the final cost within 1e-3 relative
   (LM decisions may flip on rounding, so the iterates are not compared).
3. `_local_track_kernel(use_inertial=True)` on seeded candidates and
   features: the integer outputs identical, the state within 1e-3.

The cameras: a radtan pinhole, the TUM-VI fisheye, and KITTI's
(settings/kitti.yaml: 1392x512, five radtan coefficients, k1 -0.373; its
points spread over its narrower field of view, 1,536 features in the
local stage).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoorbslam3_tpu import sim as jsim
from monoorbslam3_tpu.backend import problems as jproblems
from monoorbslam3_tpu.backend import residuals as jres
from monoorbslam3_tpu.frontend import tracking as jtrack
from monoorbslam3_tpu.models import imu as jimu
from monoorbslam3_tpu.models.camera import Fisheye as JFisheye
from monoorbslam3_tpu.models.camera import Pinhole as JPinhole
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch.backend import problems as tproblems
from monoorbslam3_tpu_torch.backend.residuals import KfState as TKfState
from monoorbslam3_tpu_torch.frontend import tracking as ttrack
from monoorbslam3_tpu_torch.models.camera import Fisheye as TFisheye
from monoorbslam3_tpu_torch.models.camera import Pinhole as TPinhole

# the e2e tests' rig: camera 45 deg between forward and outward, y down
_s2 = 1.0 / np.sqrt(2.0)
_z_c = np.array([_s2, -_s2, 0.0])
_x_c = np.array([-_s2, -_s2, 0.0])
R_BC = np.stack([_x_c, np.cross(_z_c, _x_c), _z_c], axis=1)
T_BC = np.array([0.03, 0.01, -0.02])
R_CB = R_BC.T.astype(np.float32)
T_CB = (-R_BC.T @ T_BC).astype(np.float32)
BG_TRUE = np.array([0.004, -0.003, 0.002])  # chip_smoke.BG_TRUE, the inertial drive's bias
BA_TRUE = np.array([0.03, -0.02, 0.05])
T_KF, T_FR = 0.0, 0.25
N_PTS = 300
CAMS = {
    "pinhole": dict(fx=300.0, fy=300.0, cx=320.0, cy=240.0, width=640, height=480,
                    dist=[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]),
    "fisheye": dict(fx=190.97847715128717, fy=190.9733070521226, cx=254.93170605935475,
                    cy=256.8974428996504, width=512, height=512,
                    dist=[0.0034823894022493434, 0.0007150348452162257,
                          -0.0020532361418706202, 0.00020293673591811182]),
    # settings/kitti.yaml: five radtan coefficients, k1 -0.373
    "kitti": dict(fx=984.2439, fy=980.8141, cx=690.0, cy=233.1966, width=1392, height=512,
                  dist=[-0.3728755, 0.2037299, 0.002219027, 0.001383707, -0.07233722]),
}
# the local stage's features a frame: KITTI's 1,536 (settings/kitti.yaml)
N_FEAT = {"pinhole": 384, "fisheye": 384, "kitti": 1536}


def _cams(kind):
    if kind in ("pinhole", "kitti"):
        return (JPinhole.create(**CAMS[kind]), TPinhole.create(**CAMS[kind], device="cpu"))
    return JFisheye.create(**CAMS[kind]), TFisheye.create(**CAMS[kind], device="cpu")


def _true_state(traj, t):
    return tuple(np.asarray(a, np.float32) for a in
                 (traj.R_wb(t), traj.pos(t), traj.vel(t), BG_TRUE, BA_TRUE))


@pytest.fixture(scope="module")
def scene():
    traj = jsim.Trajectory()
    rng = np.random.default_rng(21)
    g, a, d = traj.imu_samples(T_KF, T_FR, 200.0, bg=BG_TRUE, ba=BA_TRUE,
                               noise_gyro=1.7e-4, noise_acc=2e-3, rng=rng)
    calib = jimu.ImuCalib.create(R_BC, T_BC, 1.7e-4, 2e-3, 1.9e-5, 3e-3, freq=200.0)
    buf = jimu.ImuBuffer()
    for k in range(len(d)):
        buf.add(g[k], a[k], d[k])
    pre = buf.integrate(BG_TRUE.astype(np.float32), BA_TRUE.astype(np.float32), calib)
    edge = jax.jit(jres.PreintEdge.from_preintegrated)(pre)
    last = _true_state(traj, T_KF)
    truth = _true_state(traj, T_FR)
    # points 3-9 m in front of the frame's camera, world frame
    R_wc = truth[0].astype(np.float64) @ R_BC
    c_w = truth[0].astype(np.float64) @ T_BC + truth[1]
    ray = np.concatenate([rng.uniform(-0.9, 0.9, (N_PTS, 2)), np.ones((N_PTS, 1))], 1)
    pc = ray * rng.uniform(3.0, 9.0, (N_PTS, 1))
    pts = (pc @ R_wc.T + c_w).astype(np.float32)
    # for KITTI's narrower field of view (1392x512 at fx 984), its own spread
    rng_k = np.random.default_rng(22)
    ray_k = np.concatenate([rng_k.uniform(-0.6, 0.6, (N_PTS, 1)),
                            rng_k.uniform(-0.2, 0.22, (N_PTS, 1)), np.ones((N_PTS, 1))], 1)
    pts_k = ((ray_k * rng_k.uniform(3.0, 9.0, (N_PTS, 1))) @ R_wc.T + c_w).astype(np.float32)
    # a perturbed start: 0.5 deg, 3 cm, 0.1 m/s, small bias offsets
    w = np.array([0.005, -0.006, 0.004])
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    U, _, Vt = np.linalg.svd(truth[0] @ (np.eye(3) + K + 0.5 * K @ K))
    state0 = ((U @ Vt).astype(np.float32), truth[1] + np.float32([0.02, -0.03, 0.01]),
              truth[2] + np.float32([0.1, -0.05, 0.02]), truth[3] + np.float32(1e-3),
              truth[4] - np.float32(5e-3))
    return dict(traj=traj, pre=pre, edge=edge, last=last, truth=truth, state0=state0, rng=rng,
                pts={"pinhole": pts, "fisheye": pts, "kitti": pts_k})


def test_predict_state_inertial_matches_jax(scene):
    """The port's prediction on the JAX package's deltas against
    `Tracking._predict_state` (its inertial branch, called on stand-ins for
    the tracker and the frame that hold the keyframe's state as keyframe
    0): R, t and v within 1e-5, the keyframe's biases carried over, and the
    prediction within 5 mm and 0.05 deg of the true frame state."""
    pre, kf = scene["pre"], scene["last"]
    bg, ba = jnp.asarray(kf[3]), jnp.asarray(kf[4])
    deltas = jtrack._predict_deltas(pre, bg, ba)
    store = SimpleNamespace(**{f"kf_{k}": [v] for k, v in zip(("R", "t", "v", "bg", "ba"), kf)})
    tracker = SimpleNamespace(imu_ready=True, last_kf_id=0, store=store)
    frame = SimpleNamespace(pre_from_kf=pre, _pred_deltas=deltas)
    ref = jtrack.Tracking._predict_state(tracker, frame)

    t_kf = TKfState(*(torch.as_tensor(a) for a in kf))
    t_deltas = [torch.from_numpy(np.array(a, np.float32)) for a in deltas]
    got = ttrack._predict_state_inertial(t_kf, *t_deltas, float(pre.dt))
    assert isinstance(got, TKfState)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)
    truth = scene["truth"]
    assert np.linalg.norm(got.t_wb.numpy() - truth[1]) < 5e-3
    assert _rot_deg(got.R_wb.numpy(), truth[0]) < 0.05


def _observations(scene, kind):
    """Pixels of the scene's points in the true frame pose through each
    package's camera, 0.5 px noise, 8% gross outliers, 10% invalid."""
    jcam, tcam = _cams(kind)
    rng = np.random.default_rng(5)
    truth = scene["truth"]
    R_cw = R_CB @ truth[0].T
    t_cw = T_CB - R_cw @ truth[1]
    pc = scene["pts"][kind] @ R_cw.T + t_cw
    uv = np.asarray(jcam.project(jnp.asarray(pc))) + rng.normal(0, 0.5, (N_PTS, 2))
    out = rng.uniform(size=N_PTS) < 0.08
    uv[out] += rng.uniform(-40, 40, (out.sum(), 2))
    valid = rng.uniform(size=N_PTS) > 0.1
    inv_s2 = np.full(N_PTS, 1.0, np.float32)
    return jcam, tcam, uv.astype(np.float32), inv_s2, valid


def _prior(scene):
    ref = scene["truth"]
    inv_sigma = np.concatenate([np.full(3, 10.0), np.full(3, 100.0), np.full(3, 10.0)])
    return ref, inv_sigma.astype(np.float32)


def _jax_tail(s, scene, use_inertial, use_prior):
    """The JAX package's tail_fn (problems.py:102-121) at a fresh tangent of s."""
    last = jres.KfState(*map(jnp.asarray, scene["last"]))
    ref, inv_sigma = _prior(scene)
    ref = jres.KfState(*map(jnp.asarray, ref))

    def tail_fn(dx):
        sd = jres.retract_kf(s, dx)
        parts = []
        if use_inertial:
            parts.append(jres.inertial_residual(last, sd, scene["edge"]) * 1.0)
        if use_prior:
            x = jnp.concatenate([sd.v, sd.bg, sd.ba])
            x0 = jnp.concatenate([ref.v, ref.bg, ref.ba])
            parts.append((x - x0) * inv_sigma)
        return jnp.concatenate(parts)

    z = jnp.zeros(15, jnp.float32)
    return np.asarray(tail_fn(z)), np.asarray(jax.jacfwd(tail_fn)(z))


@pytest.mark.parametrize("use_inertial,use_prior", [(True, False), (False, True), (True, True)])
def test_tail_jacobian_matches_jacfwd(scene, use_inertial, use_prior):
    """Five candidate states around the frame's: residuals within 1e-5 and
    the closed-form Jacobian within 1e-4 of jacfwd's largest entry."""
    rng = np.random.default_rng(7)
    truth = scene["truth"]
    cands = []
    for c in range(5):
        dx = rng.normal(0, [0.01] * 3 + [0.05] * 3 + [0.1] * 3 + [1e-3] * 3 + [1e-2] * 3)
        cands.append(tuple(np.asarray(a) for a in
                           jres.retract_kf(jres.KfState(*map(jnp.asarray, truth)),
                                           jnp.asarray(dx, jnp.float32))))
    batch = tuple(np.stack(x) for x in zip(*cands))
    ref, inv_sigma = _prior(scene)
    r_t, J_t = tproblems._tail_linearize(
        convert.kf_state(batch, device="cpu"), convert.preint_edge(scene["edge"], device="cpu"),
        convert.kf_state(scene["last"], device="cpu"), 1.0, convert.kf_state(ref, device="cpu"),
        torch.as_tensor(inv_sigma), use_inertial, use_prior)
    for c, s in enumerate(cands):
        r_j, J_j = _jax_tail(jres.KfState(*map(jnp.asarray, s)), scene, use_inertial, use_prior)
        assert r_t.shape[1:] == r_j.shape and J_t.shape[1:] == J_j.shape
        assert np.abs(r_t[c].numpy() - r_j).max() <= 1e-5 * max(np.abs(r_j).max(), 1.0)
        assert np.abs(J_t[c].numpy() - J_j).max() <= 1e-4 * np.abs(J_j).max()


def _jax_cost(state, jcam, pts, uv, inv_s2, valid, scene, use_inertial, use_prior):
    """Robust visual cost over the valid points plus the tail's squared
    norm, in float64 numpy on the JAX package's residuals."""
    s = jres.KfState(*map(jnp.asarray, state))
    r = np.asarray(jres.reprojection_residual(s, jnp.asarray(pts), jnp.asarray(uv), jcam,
                                              jnp.asarray(R_CB), jnp.asarray(T_CB)), np.float64)
    chi2 = (r * r).sum(-1) * inv_s2
    d = np.sqrt(5.991)
    rho = np.where(chi2 <= 5.991, chi2, 2 * d * np.sqrt(chi2) - 5.991)
    cost = float(rho[valid].sum())
    if use_inertial or use_prior:
        r_t, _ = _jax_tail(s, scene, use_inertial, use_prior)
        cost += float((np.asarray(r_t, np.float64) ** 2).sum())
    return cost


def _rot_deg(Ra, Rb):
    M = np.asarray(Ra, np.float64).T @ np.asarray(Rb, np.float64)
    return float(np.degrees(np.arccos(np.clip((np.trace(M) - 1) / 2, -1, 1))))


@pytest.mark.parametrize("kind,use_inertial,use_prior", [
    ("pinhole", False, False), ("pinhole", True, False), ("pinhole", False, True),
    ("pinhole", True, True), ("fisheye", True, False), ("kitti", False, False),
    ("kitti", True, True)])
def test_pose_optimize_matches_jax(scene, kind, use_inertial, use_prior):
    jcam, tcam, uv, inv_s2, valid = _observations(scene, kind)
    ref, inv_sigma = _prior(scene)
    pts, state0 = scene["pts"][kind], scene["state0"]
    j_state, j_inl = jproblems._pose_optimize_impl(
        jres.KfState(*map(jnp.asarray, state0)), jnp.asarray(pts), jnp.asarray(uv),
        jnp.asarray(inv_s2), jnp.asarray(valid), jcam, jnp.asarray(R_CB), jnp.asarray(T_CB),
        scene["edge"], jres.KfState(*map(jnp.asarray, scene["last"])), jnp.float32(1.0),
        jres.KfState(*map(jnp.asarray, ref)), jnp.asarray(inv_sigma),
        use_inertial=use_inertial, use_prior=use_prior)
    t_state, t_inl = tproblems._pose_optimize_impl(
        convert.kf_state(state0, device="cpu"), torch.as_tensor(pts), torch.as_tensor(uv),
        torch.as_tensor(inv_s2), torch.as_tensor(valid), tcam, torch.as_tensor(R_CB),
        torch.as_tensor(T_CB), convert.preint_edge(scene["edge"], device="cpu"),
        convert.kf_state(scene["last"], device="cpu"), 1.0, convert.kf_state(ref, device="cpu"),
        torch.as_tensor(inv_sigma), use_inertial=use_inertial, use_prior=use_prior)
    j_state = [np.asarray(a) for a in j_state]
    t_state = [a.numpy() for a in t_state]
    assert _rot_deg(t_state[0], j_state[0]) <= 1e-3 * 57.3
    for k in range(1, 5):
        np.testing.assert_allclose(t_state[k], j_state[k], rtol=0, atol=1e-3)
    args = (jcam, pts, uv, inv_s2, valid, scene, use_inertial, use_prior)
    c_j, c_t = _jax_cost(j_state, *args), _jax_cost(t_state, *args)
    assert abs(c_t - c_j) <= 1e-3 * c_j
    assert (t_inl.numpy() != np.asarray(j_inl)).sum() <= 2
    # the LM moved toward the truth: the start was 3.7 cm off
    assert np.linalg.norm(t_state[1] - scene["truth"][1]) < 0.02
    if use_inertial:
        assert np.linalg.norm(t_state[2] - scene["truth"][2]) < 0.05


def _local_scene(scene, kind):
    """Candidates: the scene's points with seeded descriptors; features:
    their noisy pixels (bit-flipped descriptors) in a shuffled order, and
    distractors."""
    jcam, tcam, uv, inv_s2, valid = _observations(scene, kind)
    rng = np.random.default_rng(31)
    P, N = 512, N_FEAT[kind]
    desc = rng.integers(0, 2 ** 32, (N_PTS, 8), dtype=np.uint32)
    cand_xyz = np.zeros((P, 3), np.float32)
    cand_desc = np.zeros((P, 8), np.uint32)
    cand_valid = np.zeros(P, bool)
    cand_xyz[:N_PTS], cand_desc[:N_PTS], cand_valid[:N_PTS] = scene["pts"][kind], desc, True
    truth = scene["truth"]
    c_w = truth[0] @ T_BC + truth[1]
    normal = cand_xyz - c_w
    normal /= np.maximum(np.linalg.norm(normal, axis=1, keepdims=True), 1e-9)
    order = rng.permutation(N)
    fr_xy = rng.uniform([0, 0], [CAMS[kind]["width"], CAMS[kind]["height"]], (N, 2))
    fr_desc = rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32)
    seen = np.nonzero(valid)[0]
    slots = order[: len(seen)]
    fr_xy[slots] = uv[seen]
    flips = np.uint32(1) << rng.integers(0, 32, (len(seen), 8)).astype(np.uint32)
    fr_desc[slots] = desc[seen] ^ np.where(rng.uniform(size=(len(seen), 8)) < 0.3, flips, 0)
    return jcam, tcam, dict(
        cand_xyz=cand_xyz, cand_desc=cand_desc, cand_valid=cand_valid,
        cand_normal=normal.astype(np.float32), cand_use_vcos=cand_valid.copy(),
        cand_extra2=np.zeros(P, np.float32), radius=np.full(P, 15.0, np.float32),
        blockrow=np.full(N, -1, np.int32), coarse_pts=np.zeros((N, 3), np.float32),
        coarse_inv_s2=np.ones(N, np.float32), coarse_valid=np.zeros(N, bool),
        fr_xy=fr_xy.astype(np.float32), fr_desc=fr_desc, fr_valid=np.ones(N, bool),
        fr_sigma2=np.ones(N, np.float32))


_LOCAL_ORDER = ("cand_xyz", "cand_desc", "cand_valid", "cand_normal", "cand_use_vcos",
                "cand_extra2", "radius", "blockrow", "coarse_pts", "coarse_inv_s2",
                "coarse_valid", "fr_xy", "fr_desc", "fr_valid", "fr_sigma2")


@pytest.mark.parametrize("kind", ["pinhole", "fisheye", "kitti"])
def test_local_track_kernel_inertial_matches_jax(scene, kind):
    jcam, tcam, kw = _local_scene(scene, kind)
    state0 = scene["state0"]
    j_out = jtrack._local_track_kernel(
        jres.KfState(*map(jnp.asarray, state0)), *(jnp.asarray(kw[n]) for n in _LOCAL_ORDER),
        jcam, jnp.asarray(R_CB), jnp.asarray(T_CB), jnp.asarray(T_BC, jnp.float32),
        jnp.float32(0.5), jnp.int32(24), scene["edge"],
        jres.KfState(*map(jnp.asarray, scene["last"])), jnp.float32(1.0), use_inertial=True)
    t_out = ttrack._local_track_kernel(
        convert.kf_state(state0, device="cpu"),
        *(convert.tensor(kw[n], device="cpu") for n in _LOCAL_ORDER),
        tcam, torch.as_tensor(R_CB), torch.as_tensor(T_CB),
        torch.as_tensor(T_BC.astype(np.float32)), 0.5, 24,
        convert.preint_edge(scene["edge"], device="cpu"),
        convert.kf_state(scene["last"], device="cpu"), 1.0, use_inertial=True)
    (j_st, *j_int), (t_st, *t_int) = j_out, t_out
    for name, a, b in zip(("lci", "keep_coarse", "hit"), t_int[:3], j_int[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    assert abs(int(t_int[3]) - int(j_int[3])) <= 2
    assert int(t_int[3]) > 150
    assert _rot_deg(t_st[0].numpy(), np.asarray(j_st[0])) <= 1e-3 * 57.3
    for k in range(1, 5):
        np.testing.assert_allclose(t_st[k].numpy(), np.asarray(j_st[k]), rtol=0, atol=1e-3)
