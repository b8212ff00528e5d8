"""PyTorch port, the per-frame tracking slice as a whole, against the JAX
package on the CPU.

1. The port's `sim.ImageWorld` renders the same frames as the JAX one.
2. Both packages' `_coarse_track_kernel` and `_local_track_kernel`
   (visual) run on the SAME inputs, built from the JAX extractor's
   features: integer outputs identical, pose within 1e-4.
3. image -> own extractor -> finish_features -> both stages, in each
   package: the final poses agree within 2e-3 rad and 5e-3 m.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from monoorbslam3_tpu import sim as jsim
from monoorbslam3_tpu.backend.residuals import KfState as JKfState
from monoorbslam3_tpu.backend.problems import _identity_edge as j_identity_edge
from monoorbslam3_tpu.frontend import frame as jframe
from monoorbslam3_tpu.frontend import tracking as jtrack
from monoorbslam3_tpu.models.camera import Pinhole as JPinhole
from monoorbslam3_tpu.ops.orb import OrbExtractor as JOrbExtractor
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch import sim as tsim
from monoorbslam3_tpu_torch.backend.problems import _identity_edge as t_identity_edge
from monoorbslam3_tpu_torch.backend.residuals import KfState as TKfState
from monoorbslam3_tpu_torch.frontend import frame as tframe
from monoorbslam3_tpu_torch.frontend import tracking as ttrack
from monoorbslam3_tpu_torch.models.camera import Pinhole as TPinhole
from monoorbslam3_tpu_torch.ops.orb import OrbExtractor as TOrbExtractor

H, W, N_FEAT, N_LEVELS, P_LOCAL = 240, 320, 384, 4, 768
INTR = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
            dist=[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05], width=W, height=H)
# camera 45 deg between forward and outward, y down (the e2e tests' rig)
_s2 = 1.0 / np.sqrt(2.0)
_z_c = np.array([_s2, -_s2, 0.0])
_x_c = np.array([-_s2, -_s2, 0.0])
R_BC = np.stack([_x_c, np.cross(_z_c, _x_c), _z_c], axis=1)
T_BC = np.array([0.03, 0.01, -0.02])
R_CB = R_BC.T.astype(np.float32)
T_CB = (-R_BC.T @ T_BC).astype(np.float32)
TIMES = (0.0, 0.05, 0.10)


@pytest.fixture(scope="module")
def world():
    jcam = JPinhole.create(**INTR)
    tcam = TPinhole.create(**INTR, device="cpu")
    jw, tw = jsim.ImageWorld(), tsim.ImageWorld()
    imgs_j = [jw.render(t, jcam, R_BC, T_BC, rng=np.random.default_rng(i))
              for i, t in enumerate(TIMES)]
    imgs_t = [tw.render(t, tcam, R_BC, T_BC, rng=np.random.default_rng(i))
              for i, t in enumerate(TIMES)]
    return dict(jcam=jcam, tcam=tcam, tw=tw, traj=tw.traj, imgs_j=imgs_j, imgs_t=imgs_t)


def test_sim_renders_same_images():
    """Undistorted camera: the two sims render bit-identical frames."""
    kw = dict(INTR, dist=None)
    jcam, tcam = JPinhole.create(**kw), TPinhole.create(**kw, device="cpu")
    jw, tw = jsim.ImageWorld(), tsim.ImageWorld()
    for i, t in enumerate(TIMES):
        a = jw.render(t, jcam, R_BC, T_BC, rng=np.random.default_rng(i))
        b = tw.render(t, tcam, R_BC, T_BC, rng=np.random.default_rng(i))
        assert a.shape == b.shape == (H, W)
        np.testing.assert_array_equal(b, a)


def test_sim_renders_with_distortion(world):
    """Radtan camera: the undistortions agree to 1e-4 px (measured 6.1e-5,
    two ulps at ~300 px: XLA fuses multiply-adds inside the fixed-point
    loop, torch does not). Such a ray shift moves a pixel across a texture
    step edge, so the frames agree to 1e-3 grey levels on 95% of the pixels
    (measured 97.5%) and to 0.01 grey levels on average (measured 1.6e-4)."""
    u, v = np.meshgrid(np.arange(W, dtype=np.float32), np.arange(H, dtype=np.float32))
    uv = np.stack([u, v], -1).reshape(-1, 2)
    a = np.asarray(world["jcam"].undistort_points(jnp.asarray(uv)))
    b = world["tcam"].undistort_points(torch.as_tensor(uv)).numpy()
    assert np.abs(a - b).max() <= 1e-4
    for a, b in zip(world["imgs_j"], world["imgs_t"]):
        d = np.abs(a - b)
        assert (d <= 1e-3).mean() >= 0.95 and d.mean() <= 0.01


def _body_pose(traj, t):
    return traj.R_wb(t).astype(np.float32), traj.pos(t).astype(np.float32)


def _state(R, t):
    z = np.zeros(3, np.float32)
    return (np.asarray(R, np.float32), np.asarray(t, np.float32), z, z, z)


def _perturbed(traj, t, seed):
    rng = np.random.default_rng(seed)
    R, p = _body_pose(traj, t)
    w = rng.normal(0, 0.004, 3)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    dR = np.eye(3) + K + 0.5 * K @ K  # second-order, re-orthonormalised
    U, _, Vt = np.linalg.svd(R.astype(np.float64) @ dR)
    return _state(U @ Vt, p + rng.normal(0, 0.01, 3))


def _lift(world, feats, t):
    """True world points of a frame's keypoints (port sim, both sides)."""
    return world["tw"].world_points(t, world["tcam"], R_BC, T_BC, feats["xy_raw"]).astype(np.float32)


def _coarse_inputs(world, f0, f1, t0):
    """Candidates = frame-0 keypoints at their true world points."""
    xyz = _lift(world, f0, t0)
    return dict(cand_xyz=xyz, cand_desc=f0["desc"], cand_valid=f0["valid"],
                cand_ang=f0["angle"], cand_extra2=np.zeros(N_FEAT, np.float32),
                fr_xy=f1["xy"], fr_desc=f1["desc"], fr_valid=f1["valid"],
                fr_angle=f1["angle"], fr_sigma2=f1["sigma2"],
                radius=np.full(N_FEAT, 15.0, np.float32), retry_below=24)


def _local_inputs(world, f0, f2, f1, t0, t2, state1, ci):
    """Window = frame-0 then frame-2 keypoints at their true world points,
    padded to P_LOCAL; coarse associations from `ci` (rows of frame 0)."""
    xyz = np.zeros((P_LOCAL, 3), np.float32)
    desc = np.zeros((P_LOCAL, 8), np.uint32)
    valid = np.zeros(P_LOCAL, bool)
    normal = np.zeros((P_LOCAL, 3), np.float32)
    for off, (f, t) in zip((0, N_FEAT), ((f0, t0), (f2, t2))):
        x = _lift(world, f, t)
        center = world["traj"].pos(t) + world["traj"].R_wb(t) @ T_BC
        v = x - center
        xyz[off: off + N_FEAT] = x
        desc[off: off + N_FEAT] = f["desc"]
        valid[off: off + N_FEAT] = f["valid"]
        normal[off: off + N_FEAT] = v / np.linalg.norm(v, axis=1, keepdims=True)
    sel = ci >= 0
    coarse_pts = np.zeros((N_FEAT, 3), np.float32)
    coarse_pts[sel] = xyz[ci[sel]]
    blockrow = np.where(sel, ci, -1).astype(np.int32)
    return dict(cand_xyz=xyz, cand_desc=desc, cand_valid=valid, cand_normal=normal,
                cand_use_vcos=valid.copy(), cand_extra2=np.zeros(P_LOCAL, np.float32),
                radius=np.full(P_LOCAL, 12.0, np.float32), blockrow=blockrow,
                coarse_pts=coarse_pts,
                coarse_inv_s2=np.where(sel, 1.0 / f1["sigma2"], 1.0).astype(np.float32),
                coarse_valid=sel, fr_xy=f1["xy"], fr_desc=f1["desc"], fr_valid=f1["valid"],
                fr_sigma2=f1["sigma2"], t_bc=T_BC.astype(np.float32), view_cos_gate=0.5,
                retry_min=24)


def _jax_coarse(cam, state0, kw):
    k = {n: (v if n == "retry_below" else jnp.asarray(v)) for n, v in kw.items()}
    st, ci, n_match, n_inl = jtrack._coarse_track_kernel(
        JKfState(*map(jnp.asarray, state0)), k["cand_xyz"], k["cand_desc"], k["cand_valid"],
        k["cand_ang"], k["cand_extra2"], k["fr_xy"], k["fr_desc"], k["fr_valid"],
        k["fr_angle"], k["fr_sigma2"], cam, jnp.asarray(R_CB), jnp.asarray(T_CB),
        k["radius"], jnp.int32(kw["retry_below"]), use_rotation=True)
    return [np.asarray(a) for a in st], np.asarray(ci), int(n_match), int(n_inl)


def _torch_coarse(cam, state0, kw):
    k = {n: (v if n == "retry_below" else convert.tensor(v, device="cpu")) for n, v in kw.items()}
    st, ci, n_match, n_inl = ttrack._coarse_track_kernel(
        convert.kf_state(state0, device="cpu"), k["cand_xyz"], k["cand_desc"], k["cand_valid"],
        k["cand_ang"], k["cand_extra2"], k["fr_xy"], k["fr_desc"], k["fr_valid"],
        k["fr_angle"], k["fr_sigma2"], cam, torch.as_tensor(R_CB), torch.as_tensor(T_CB),
        k["radius"], kw["retry_below"], use_rotation=True)
    return [a.numpy() for a in st], ci.numpy(), int(n_match), int(n_inl)


_LOCAL_ORDER = ("cand_xyz", "cand_desc", "cand_valid", "cand_normal", "cand_use_vcos",
                "cand_extra2", "radius", "blockrow", "coarse_pts", "coarse_inv_s2",
                "coarse_valid", "fr_xy", "fr_desc", "fr_valid", "fr_sigma2")


def _jax_local(cam, state0, kw):
    z = JKfState.zeros()
    out = jtrack._local_track_kernel(
        JKfState(*map(jnp.asarray, state0)), *(jnp.asarray(kw[n]) for n in _LOCAL_ORDER),
        cam, jnp.asarray(R_CB), jnp.asarray(T_CB), jnp.asarray(kw["t_bc"]),
        jnp.float32(kw["view_cos_gate"]), jnp.int32(kw["retry_min"]),
        j_identity_edge(), z, jnp.float32(0.0), use_inertial=False)
    st, lci, keep, hit, n_inl = out
    return [np.asarray(a) for a in st], np.asarray(lci), np.asarray(keep), np.asarray(hit), int(n_inl)


def _torch_local(cam, state0, kw):
    z = TKfState.zeros(device="cpu")
    out = ttrack._local_track_kernel(
        convert.kf_state(state0, device="cpu"), *(convert.tensor(kw[n], device="cpu") for n in _LOCAL_ORDER),
        cam, torch.as_tensor(R_CB), torch.as_tensor(T_CB), torch.as_tensor(kw["t_bc"]),
        kw["view_cos_gate"], kw["retry_min"], t_identity_edge("cpu"), z, 0.0, use_inertial=False)
    st, lci, keep, hit, n_inl = out
    return [a.numpy() for a in st], lci.numpy(), keep.numpy(), hit.numpy(), int(n_inl)


def _jax_feats(world, i):
    ext = JOrbExtractor(H, W, n_features=N_FEAT, n_levels=N_LEVELS)
    return jframe.features_from_extractor(ext(world["imgs_j"][i]), world["jcam"],
                                          ext.scale_factors)


@pytest.fixture(scope="module")
def jax_feats(world):
    return [_jax_feats(world, i) for i in range(len(TIMES))]


def _rot_err(Ra, Rb):
    return float(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1) / 2, -1, 1)))


def test_stages_match_jax_on_same_inputs(world, jax_feats):
    """Same inputs into both packages' stages. Tolerances: cand_of_feature,
    n_match, keep_coarse and hit identical; pose within 1e-4 (R Frobenius,
    t in m). Measured: coarse 7.8e-7 and 3.2e-6 m, local 2.0e-7 and 5.6e-7 m."""
    f0, f1, f2 = jax_feats
    jcam = world["jcam"]
    tcam = convert.pinhole(jcam, device="cpu")
    state0 = _perturbed(world["traj"], TIMES[1], seed=4)
    kw = _coarse_inputs(world, f0, f1, TIMES[0])
    st_j, ci_j, nm_j, ni_j = _jax_coarse(jcam, state0, kw)
    st_t, ci_t, nm_t, ni_t = _torch_coarse(tcam, state0, kw)
    assert nm_j > 60 and ni_j > 40  # the stage really tracks
    np.testing.assert_array_equal(ci_t, ci_j)
    assert (nm_t, ni_t) == (nm_j, ni_j)
    assert np.linalg.norm(st_t[0] - st_j[0]) <= 1e-4
    assert np.linalg.norm(st_t[1] - st_j[1]) <= 1e-4

    # local stage from the JAX coarse result (same inputs again)
    kl = _local_inputs(world, f0, f2, f1, TIMES[0], TIMES[2], st_j, ci_j)
    st1 = tuple(np.asarray(a, np.float32) for a in st_j)
    lst_j, lci_j, keep_j, hit_j, nl_j = _jax_local(jcam, st1, kl)
    lst_t, lci_t, keep_t, hit_t, nl_t = _torch_local(tcam, st1, kl)
    assert nl_j > 60
    np.testing.assert_array_equal(lci_t, lci_j)
    np.testing.assert_array_equal(keep_t, keep_j)
    np.testing.assert_array_equal(hit_t, hit_j)
    assert nl_t == nl_j
    assert np.linalg.norm(lst_t[0] - lst_j[0]) <= 1e-4
    assert np.linalg.norm(lst_t[1] - lst_j[1]) <= 1e-4
    R_true, p_true = _body_pose(world["traj"], TIMES[1])
    assert np.linalg.norm(lst_j[1] - p_true) < 0.02  # tracked, not just equal


def _chain_torch(world):
    """image -> port extractor -> finish_features -> both stages."""
    tcam = world["tcam"]
    ext = TOrbExtractor(H, W, n_features=N_FEAT, n_levels=N_LEVELS, device="cpu")
    feats = []
    for img in world["imgs_t"]:
        f = tframe.finish_features(ext(img), tcam, ext.scale_factors)
        f = {k: v.numpy() for k, v in f.items()}
        f["desc"] = convert.desc_to_numpy(f["desc"])
        feats.append(f)
    return feats, (tcam, _torch_coarse, _torch_local)


def _run_stages(world, feats, cam, coarse, local):
    f0, f1, f2 = feats
    state0 = _perturbed(world["traj"], TIMES[1], seed=4)
    st, ci, _, _ = coarse(cam, state0, _coarse_inputs(world, f0, f1, TIMES[0]))
    st = tuple(np.asarray(a, np.float32) for a in st)
    lst, _, _, _, n_inl = local(cam, st, _local_inputs(world, f0, f2, f1, TIMES[0],
                                                       TIMES[2], st, ci))
    return lst, n_inl


def test_slice_chain_matches_jax(world, jax_feats):
    """Each package's own extractor on its own rendering. Tolerance: final
    pose within 2e-3 rad and 5e-3 m of the JAX chain's. Measured: 0 rad and
    5.5e-7 m (the two extractors gave the same keypoints and bits here)."""
    lst_j, nj = _run_stages(world, jax_feats, world["jcam"], _jax_coarse, _jax_local)
    feats_t, (tcam, coarse, local) = _chain_torch(world)
    lst_t, nt = _run_stages(world, feats_t, tcam, coarse, local)
    assert nj > 60 and nt > 60
    assert _rot_err(lst_t[0], lst_j[0]) <= 2e-3
    assert np.linalg.norm(lst_t[1] - lst_j[1]) <= 5e-3
