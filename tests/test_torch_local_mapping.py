"""PyTorch port: the `LocalMapping` class against the JAX package's
(`monoorbslam3_tpu/frontend/local_mapping.py`) on the CPU, on map stores
seeded by `chip_smoke.seeded_store` with each package's classes (the same
bits in both), at small capacities.

- `process_new_keyframe` and `cull_map_points` (the graduation gate
  included): the same store, bit for bit.
- `create_new_map_points` and `fuse_neighbors` on a store with a seeded
  third of its points removed (their features free in every keyframe that
  saw them): the same counts within 1%, the same new points, as accurate
  against their triangulation in float64 as JAX's (quantiles within 2x).
- `cull_keyframes`: the same keyframes removed.
- `initialize_imu` on the init store of chip_smoke's store path (13
  keyframes in a rotated visual frame at 1/4 scale): the same decision,
  the scale within 1e-3 relative, and the tracker told.
- `process(light=True)`: the per-keyframe stages and the short visual BA,
  the same counts within 1% and the BA's costs within 1e-3.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from monoorbslam3_tpu import config as jconfig
from monoorbslam3_tpu.backend.problems import Problems as JProblems
from monoorbslam3_tpu.frontend import local_mapping as jlm
from monoorbslam3_tpu.models import imu as jimu
from monoorbslam3_tpu.models.map_state import MapStore as JStore
from monoorbslam3_tpu_torch import config as tconfig
from monoorbslam3_tpu_torch.backend.problems import Problems as TProblems
from monoorbslam3_tpu_torch.backend.problems import _np_exp_so3
from monoorbslam3_tpu_torch.frontend import local_mapping as tlm
from monoorbslam3_tpu_torch.models.camera import _host_intrinsics
from monoorbslam3_tpu_torch.models import imu as timu
from monoorbslam3_tpu_torch.models.map_state import MapStore as TStore
from monoorbslam3_tpu_torch.ops import twoview as ttv

import chip_smoke as cs
from tests.test_torch_store import assert_same_store
from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

CAPS = dict(local_k=16, local_p=512, local_o=1536, imu_cap=64, full_k=24, full_p=1024,
            full_opk=64)
STORE = dict(n_kf=12, n_pts=3000, n_feat=256)
COUNT_RTOL, COST_RTOL, SCALE_RTOL = 0.01, 1e-3, 1e-3


def _tracker():
    return SimpleNamespace(imu_ready=False, gauge_changes=0,
                           update_after_gauge_change=lambda: None)


@pytest.fixture(scope="module")
def sensors():
    path = str(cs.SETTINGS / cs.EUROC_PROFILE)
    return dict(jcam=jconfig.build_camera(jconfig.load_settings(path)),
                tcam=tconfig.build_camera(tconfig.load_settings(path), device="cpu"),
                jcalib=cs.store_calibration(jimu.ImuCalib),
                tcalib=cs.store_calibration(timu.ImuCalib, device="cpu"))


@pytest.fixture(scope="module")
def base_stores():
    return (cs.seeded_store(JStore, jimu.ImuBuffer, **STORE)[0],
            cs.seeded_store(TStore, timu.ImuBuffer, **STORE)[0])


def mappers(sensors, js, ts):
    """(JAX, port) mappers over the given stores, each with its façade and a
    tracker stand-in."""
    jp = JProblems(sensors["jcam"], sensors["jcalib"], **CAPS)
    tp = TProblems(sensors["tcam"], sensors["tcalib"], device="cpu", **CAPS)
    cfg = {"scale_factors": cs.SCALE ** np.arange(cs.N_LEVELS)}
    return (jlm.LocalMapping(js, jp, sensors["jcalib"], _tracker(), cfg),
            tlm.LocalMapping(ts, tp, sensors["tcalib"], _tracker(), cfg))


def _thinned(base_stores, frac=1 / 3, seed=1):
    """Copies of the base stores with the same seeded fraction of the points
    removed."""
    js, ts = (copy.deepcopy(s) for s in base_stores)
    live = np.nonzero(ts.pt_valid)[0]
    gone = np.random.default_rng(seed).choice(live, int(frac * len(live)), replace=False)
    for st in (js, ts):
        for p in gone:
            st.remove_point(int(p))
    assert_same_store(js, ts)
    return js, ts


def test_process_new_keyframe_and_cull_map_points(sensors, base_stores):
    """The point statistics of a keyframe's points, then MapPointCulling
    over a seeded set of young points with seeded found/visible counts and
    ages (every branch: found ratio, under-observed, graduation): the same
    store bit for bit."""
    js, ts = (copy.deepcopy(s) for s in base_stores)
    jm, tm = mappers(sensors, js, ts)
    rng = np.random.default_rng(3)
    live = np.nonzero(ts.pt_valid)[0]
    young = rng.choice(live, len(live) // 2, replace=False)
    births = rng.integers(0, 6, len(young))
    found, visible = rng.integers(0, 10, len(ts.pt_found)), rng.integers(1, 12, len(ts.pt_found))
    sigma = rng.uniform(0.0, 3.0, len(ts.pt_sigma_z)).astype(np.float32)
    for m, st in ((jm, js), (tm, ts)):
        st.pt_found[:] = found
        st.pt_visible[:] = visible
        m.recent_points = [(int(p), int(b)) for p, b in zip(young, births)]
        m.kf_counter = 6
        for k in st.keyframe_ids()[-3:]:
            m.process_new_keyframe(k)
        st.pt_sigma_z[:] = sigma
        m.cull_map_points()
    assert jm.recent_points == tm.recent_points
    assert ts.n_points() < len(live)
    assert_same_store(js, ts)


@pytest.fixture(scope="module")
def searched(sensors, base_stores):
    """create_new_map_points then fuse_neighbors for the last keyframe of a
    thinned store, in both packages."""
    js, ts = _thinned(base_stores)
    jm, tm = mappers(sensors, js, ts)
    k = ts.keyframe_ids()[-1]
    out = {}
    for tag, m, st in (("j", jm, js), ("t", tm, ts)):
        n0 = st.n_points()
        m.process_new_keyframe(k)
        n_new = m.create_new_map_points(k)
        new = {int(f): (st.pt_xyz[p].copy(), st.pt_obs_kf[p, :2].copy(),
                        st.pt_obs_feat[p, :2].copy())
               for f, p in enumerate(st.kf_feat_pt[k]) if p >= 0 and st.pt_first_kf[p] == k}
        n_obs0 = int((st.pt_obs_kf >= 0).sum())
        m.fuse_neighbors(k)
        out[tag] = dict(n_new=n_new, n_pts=st.n_points() - n0, new=new,
                        fused_obs=int((st.pt_obs_kf >= 0).sum()) - n_obs0,
                        n_points=st.n_points(), store=st)
    return out


def _dlt64(st, cam, kfs, feats):
    """The kernel's triangulation of one new point (the normalized DLT of
    its two observations) in float64."""
    P, m = [], []
    for k, f in zip(kfs, feats):
        R_cw, t_cw = st.kf_pose_cw(int(k), cs.R_CB, cs.T_CB)
        P.append(torch.as_tensor(np.concatenate([R_cw, t_cw[:, None]], 1), dtype=torch.float64))
        u, v = st.kf_feat_xy[int(k), int(f)].astype(np.float64)
        m.append(torch.tensor([(u - cam["cx"]) / cam["fx"], (v - cam["cy"]) / cam["fy"]],
                              dtype=torch.float64))
    return ttv.triangulate_dlt(P[0], P[1], m[0], m[1]).numpy()


def test_create_new_map_points(searched, sensors):
    """The same number of new points within 1%, the same features, and the
    same accuracy: each point's error from the same triangulation in
    float64, relative to its magnitude, has its median, 90th percentile and
    maximum within twice JAX's (plus 1e-7). The closed-form DLT solves
    normal equations in float32, so a low-parallax point's rounding
    differs between XLA's fused program and eager torch by up to ~5e-4 of
    its depth, either way, while the median agrees to 6e-6."""
    j, t = searched["j"], searched["t"]
    assert j["n_new"] > 20
    assert abs(t["n_new"] - j["n_new"]) <= COUNT_RTOL * j["n_new"]
    common = sorted(set(j["new"]) & set(t["new"]))
    assert len(set(j["new"]) ^ set(t["new"])) <= COUNT_RTOL * len(j["new"])
    cam = _host_intrinsics(sensors["tcam"])
    errs = []
    for f in common:
        (xj, kj, fj), (xt, kt, ft) = j["new"][f], t["new"][f]
        assert list(kj) == list(kt) and list(fj) == list(ft)
        x64 = _dlt64(t["store"], cam, kt, ft)
        errs.append([np.abs(x - x64).max() / np.abs(x64).max() for x in (xj, xt)])
    e_jax, e_port = np.asarray(errs).T
    for q in (50, 90, 100):
        assert np.percentile(e_port, q) <= 2.0 * np.percentile(e_jax, q) + 1e-7, q


def test_fuse_neighbors(searched):
    """Two-way fuse: the observations it adds or merges, and the points
    left, within 1% of JAX's."""
    j, t = searched["j"], searched["t"]
    assert j["fused_obs"] != 0
    assert abs(t["fused_obs"] - j["fused_obs"]) <= max(1, COUNT_RTOL * abs(j["fused_obs"]))
    assert abs(t["n_points"] - j["n_points"]) <= COUNT_RTOL * j["n_points"]


def test_cull_keyframes(sensors, base_stores):
    """KeyFrameCulling after the IMU init on the seeded store: the same
    keyframes removed (and none before the init)."""
    js, ts = (copy.deepcopy(s) for s in base_stores)
    jm, tm = mappers(sensors, js, ts)
    cur = ts.keyframe_ids()[-1]
    for m in (jm, tm):
        m.cull_keyframes(cur)
    assert ts.keyframe_ids() == js.keyframe_ids() == base_stores[1].keyframe_ids()
    for m in (jm, tm):
        m.imu_state = tlm.IMU_INITIALIZED
        m.cull_keyframes(cur)
    assert ts.keyframe_ids() == js.keyframe_ids()
    assert_same_store(js, ts)


def test_initialize_imu(sensors):
    """initializeIMU on the init store (chip_smoke.init_phase's): accepted
    in both, the scale within 1e-3 relative, the tracker marked ready, the
    keyframes' gauge within 1e-3 of their magnitude after the polish."""
    R_vw = _np_exp_so3(np.asarray(cs.INIT_ROT_VEC))
    kw = dict(n_kf=cs.INIT_KFS, n_pts=cs.INIT_POINTS, pos_noise=cs.INIT_POS_NOISE,
              rot_noise_deg=0.0, visual_frame=(R_vw, cs.INIT_SCALE), n_feat=256)
    js = cs.seeded_store(JStore, jimu.ImuBuffer, **kw)[0]
    ts = cs.seeded_store(TStore, timu.ImuBuffer, **kw)[0]
    jm, tm = mappers(sensors, js, ts)
    scales = []
    for m in (jm, tm):
        orig = m.problems.inertial_optimize

        def spy(*a, _orig=orig, **k):
            out = _orig(*a, **k)
            scales.append(None if out is None else out["scale"])
            return out

        m.problems.inertial_optimize = spy
        assert m.initialize_imu() is True
        assert m.imu_state == tlm.IMU_INITIALIZED and m.tracking.imu_ready
    assert abs(scales[1] - scales[0]) <= SCALE_RTOL * abs(scales[0])
    assert tm.imu_init_time == jm.imu_init_time
    for name in ("kf_t", "kf_v"):
        a, b = getattr(ts, name), getattr(js, name)
        assert np.all(np.abs(a - b) <= 1e-3 * np.maximum(1.0, np.abs(b))), name


def test_process_light(sensors, base_stores):
    """process(k, light=True) before the IMU init: attach, cull,
    triangulate, fuse, and one 4-iteration visual window BA; the same
    counts within 1%, the BA's costs within 1e-3."""
    js, ts = _thinned(base_stores, seed=2)
    jm, tm = mappers(sensors, js, ts)
    k = ts.keyframe_ids()[-2]
    for m in (jm, tm):
        m.process(k, light=True)
    assert abs(ts.n_points() - js.n_points()) <= COUNT_RTOL * js.n_points()
    oj, ot = jm.last_info, tm.last_info
    assert ot["ids"] == oj["ids"]
    for key in ("cost0", "cost"):
        assert abs(ot[key] - oj[key]) <= COST_RTOL * abs(oj[key]), key
