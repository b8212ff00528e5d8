"""PyTorch port: the `Problems` façade against the JAX package's
(`monoorbslam3_tpu/backend/problems.py`) on the CPU, on map stores seeded
by `chip_smoke.seeded_store` (bit-identical in both packages) at small
capacities.

- The batched preintegration tree against JAX's vmap of its tree on five
  ragged windows (1e-5 on the deltas and Jacobians, 1e-4 on C), and its
  operation count independent of the number of windows.
- The host problem of `build_window_problem`: bit-identical in every field
  but the preintegrated edges (1e-4 relative), in the flat and grouped
  layouts, with the anchor drop, the point and observation subsamples,
  merged windows, and an empty IMU window beside an anchor out of time
  order (whose costs must stay finite and equal).
- Each named problem: cost0 within 1e-4 and cost within 1e-3 relative,
  the written-back states and points within 1e-4 of their magnitude, the
  removed outlier observations equal up to one; `full_inertial_optimize`
  in every mode and on both sides of local_k and full_k (the same costs
  and outliers, the ATE within 1%, the states within 1e-2); the f64
  inertial init to 1e-6 relative (bit-identical on the same edges); the
  frame pose LMs.
- The card path's CPU rehearsal (`chip_smoke.store_ba("cpu")`) meets the
  bounds chip_smoke.py holds the card to.
"""

import copy
import logging
import types

import jax
import numpy as np
import pytest
import torch

from monoorbslam3_tpu import config as jconfig
from monoorbslam3_tpu.backend import problems as jproblems
from monoorbslam3_tpu.models import imu as jimu
from monoorbslam3_tpu.models.camera import Pinhole as JPinhole
from monoorbslam3_tpu.models.map_state import MapStore as JStore
from monoorbslam3_tpu_torch import config as tconfig
from monoorbslam3_tpu_torch.backend import problems as tproblems
from monoorbslam3_tpu_torch.backend.residuals import KfState as TKfState
from monoorbslam3_tpu_torch.models import imu as timu
from monoorbslam3_tpu_torch.models.camera import Pinhole as TPinhole
from monoorbslam3_tpu_torch.models.map_state import MapStore as TStore
from monoorbslam3_tpu_torch.sim import Trajectory

import chip_smoke as cs
from experiments.port_track_profile import count_ops

CAPS = dict(local_k=8, local_p=256, local_o=768, imu_cap=64, full_k=12, full_p=512, full_opk=48)
STORE = dict(n_pts=600, n_feat=128)
EDGE_RTOL = 1e-4  # of each edge field's largest entry
COST0_RTOL, COST_RTOL, STATE_RTOL = 1e-4, 1e-3, 1e-4
# the polish windows of these small stores still descend after 12
# iterations along weakly observable directions (biases, velocities, far
# points), where the LM's path follows rounding (costs agree to ~1e-4)
POLISH_STATE_RTOL = 1e-2
STORE_FIELDS = ("kf_R", "kf_t", "kf_v", "kf_bg", "kf_ba", "pt_xyz")


@pytest.fixture(scope="module")
def sensors():
    path = str(cs.SETTINGS / cs.EUROC_PROFILE)
    return dict(jcam=jconfig.build_camera(jconfig.load_settings(path)),
                tcam=tconfig.build_camera(tconfig.load_settings(path), device="cpu"),
                jcalib=cs.store_calibration(jimu.ImuCalib),
                tcalib=cs.store_calibration(timu.ImuCalib, device="cpu"))


def problems(sensors, **kw):
    """(JAX, port) façades with the small capacities, overridden by kw."""
    caps = CAPS | kw
    return (jproblems.Problems(sensors["jcam"], sensors["jcalib"], **caps),
            tproblems.Problems(sensors["tcam"], sensors["tcalib"], device="cpu", **caps))


_stores = {}


def stores(n_kf):
    """Copies of the (JAX, port) seeded stores of n_kf keyframes, and the
    true body positions."""
    if n_kf not in _stores:
        _stores[n_kf] = (cs.seeded_store(JStore, jimu.ImuBuffer, n_kf=n_kf, **STORE)[0],
                         *cs.seeded_store(TStore, timu.ImuBuffer, n_kf=n_kf, **STORE))
    js, ts, truth = _stores[n_kf]
    return copy.deepcopy(js), copy.deepcopy(ts), truth


def assert_close_stores(js, ts, rtol=STATE_RTOL):
    """Keyframe states and points within `rtol` of their magnitude (at least
    1). A point seen by two keyframes only sits in a flat valley along its
    short-baseline ray, where float32 rounding moves it further: within
    10 x rtol."""
    assert ts.keyframe_ids() == js.keyframe_ids()
    for f in STORE_FIELDS:
        a, b = getattr(ts, f), getattr(js, f)
        assert np.isfinite(a).all(), f
        err = np.abs(a - b).reshape(len(a), -1).max(1)
        tol = rtol * np.maximum(1.0, np.abs(b).reshape(len(b), -1).max(1))
        if f == "pt_xyz":
            tol = np.where(js.pt_n_obs <= 2, 10.0 * tol, tol)
        bad = np.nonzero(err > tol)[0]
        assert len(bad) == 0, (f, bad[:5], err[bad[:5]], tol[bad[:5]])


def observations(st):
    ok = st.pt_obs_kf >= 0
    return set(zip(np.nonzero(ok)[0].tolist(), st.pt_obs_kf[ok].tolist()))


def assert_same_result(oj, ot, js, ts, state_rtol=STATE_RTOL):
    """Same window and points, cost0 within 1e-4 and cost within 1e-3
    relative, the removed outliers equal up to one, and the written-back
    store within `state_rtol` (`assert_close_stores`)."""
    assert ot["ids"] == oj["ids"] and ot["n_points"] == oj["n_points"]
    assert ot["n_ie"] == oj["n_ie"]
    np.testing.assert_array_equal(ot["pids"], oj["pids"])
    assert abs(ot["cost0"] - oj["cost0"]) <= COST0_RTOL * abs(oj["cost0"])
    assert abs(ot["cost"] - oj["cost"]) <= COST_RTOL * abs(oj["cost"])
    assert abs(ot["n_outliers"] - oj["n_outliers"]) <= 1
    assert len(observations(js) ^ observations(ts)) <= 1
    assert_close_stores(js, ts, state_rtol)


# -- the batched tree --------------------------------------------------------


def ragged_windows(rng, lengths, n=64):
    E = len(lengths)
    g = np.zeros((E, n, 3), np.float32)
    a = np.zeros((E, n, 3), np.float32)
    d = np.zeros((E, n), np.float32)
    m = np.zeros((E, n), np.float32)
    for e, k in enumerate(lengths):
        g[e, :k] = rng.normal(scale=0.5, size=(k, 3))
        a[e, :k] = rng.normal(scale=2.0, size=(k, 3)) + [0.0, 0.0, 9.8]
        d[e, :k] = rng.uniform(0.004, 0.006, k)
        m[e, :k] = 1.0
    bg = rng.normal(scale=1e-3, size=(E, 3)).astype(np.float32)
    ba = rng.normal(scale=1e-2, size=(E, 3)).astype(np.float32)
    return g, a, d, m, bg, ba


def test_batched_tree_matches_jax_vmap(sensors):
    """Against `Problems._preint_batch`, the JAX package's jit of a vmap of
    its tree, on five ragged windows (one empty)."""
    args = ragged_windows(np.random.default_rng(5), (7, 64, 33, 0, 50))
    jp, _ = problems(sensors)
    ref = jp._preint_batch(*args)
    got = timu.preintegrate_tree_batch(*args, sensors["tcalib"])
    for f in got._fields:
        tol = 1e-4 if f == "C" else 1e-5
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   rtol=tol, atol=tol, err_msg=f)
    # the empty window is the identity
    np.testing.assert_array_equal(got.dR[3].numpy(), np.eye(3, dtype=np.float32))
    assert float(got.dt[3]) == 0.0


def test_batched_tree_is_the_single_tree_of_each_window(sensors):
    args = ragged_windows(np.random.default_rng(6), (64, 1, 17))
    got = timu.preintegrate_tree_batch(*args, sensors["tcalib"])
    for e in range(3):
        one = timu.preintegrate_tree(*(x[e] for x in args), sensors["tcalib"])
        for f in got._fields:
            np.testing.assert_allclose(getattr(got, f)[e].numpy(), getattr(one, f).numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=f)


def test_batch_edges_work_does_not_grow_with_the_edges(sensors):
    """One tree for all edges: the same operations (launches on the card)
    for 3 and for 19 edges."""
    _, tp = problems(sensors)
    _, ts, _ = stores(20)
    ids = ts.keyframe_ids()
    counts = []
    for E in (3, 19):
        counts.append(count_ops(lambda: tp._batch_edges(ts, ids[:E + 1])))
        edge = tp._batch_edges(ts, ids[:E + 1])
        assert isinstance(edge.dR, np.ndarray) and edge.dR.shape[0] == -(-E // 16) * 16
    assert counts[0] == counts[1]


# -- the host problem ----------------------------------------------------------


def window_args(kind, ts):
    ids = ts.keyframe_ids()
    if kind == "flat_visual":
        # 10 anchors over capacity 8: the anchor drop and both subsamples
        return dict(opt_ids=ids[-5:], fixed_ids=ids[:10])
    if kind == "grouped_inertial":
        return dict(opt_ids=ids[-6:], fixed_ids=ids[-8:-6], inertial=True, vb_dofs=True,
                    priors=True, grouped=True, fixed_vb_free=True)
    if kind == "flat_inertial_anchor_out_of_order":
        # an anchor far back in time (no true successor) and an empty window
        ts.kf_imu[ids[-4]].clear()
        return dict(opt_ids=ids[-5:], fixed_ids=[ids[2], ids[-6]], inertial=True,
                    vb_dofs=True, priors=True)
    raise ValueError(kind)


KINDS = ("flat_visual", "grouped_inertial", "flat_inertial_anchor_out_of_order", "edge_bufs")


def host_problems(sensors, kind, caps=None):
    jp, tp = problems(sensors, local_p=64, local_o=128) if caps is None else caps
    js, ts, _ = stores(20)
    if kind == "edge_bufs":
        ids = ts.keyframe_ids()
        sel = ids[::3] + [ids[-1]]
        kw = dict(opt_ids=sel[1:], fixed_ids=[sel[0]], inertial=True, vb_dofs=True, priors=True,
                  grouped=True, caps=(12, 128, 12 * 16), fixed_vb_free=True,
                  edge_bufs=jp._merged_windows(js, sel))
        kt = dict(kw, edge_bufs=tp._merged_windows(ts, sel))
    else:
        kw = window_args(kind, js)
        kt = window_args(kind, ts)
    outj = jp.build_window_problem(js, **kw)
    outt = tp.build_window_problem(ts, **kt)
    return outj, outt, (jp, tp, js, ts, kw, kt)


@pytest.mark.parametrize("kind", KINDS)
def test_host_problem_is_bit_identical(sensors, kind, caplog):
    caplog.set_level(logging.INFO)
    (pj, ids_j, pids_j, meta_j), (pt, ids_t, pids_t, meta_t), _ = host_problems(sensors, kind)
    assert ids_t == ids_j
    np.testing.assert_array_equal(pids_t, pids_j)
    for a, b in zip(meta_t, meta_j):
        np.testing.assert_array_equal(a, b)
    for f in pt._fields:
        if f == "ie_edge":
            continue
        for x, y in zip(jax.tree_util.tree_leaves(getattr(pt, f)),
                        jax.tree_util.tree_leaves(getattr(pj, f))):
            x, y = x.numpy(), np.asarray(y)
            assert x.shape == y.shape, f
            assert np.array_equal(x, y), f
    for f in pt.ie_edge._fields:
        a, b = getattr(pt.ie_edge, f).numpy(), np.asarray(getattr(pj.ie_edge, f))
        assert np.abs(a - b).max() <= EDGE_RTOL * max(np.abs(b).max(), 1e-6), f
    log = caplog.text
    if kind == "flat_visual":
        assert "dropping" in log and "point capacity" in log and "stride-subsampling" in log
    if kind == "edge_bufs":
        ne = len(ids_t) - 1
        assert "per-KF obs capacity" in log and bool(pt.ie_valid[:ne].all())
        assert "time-weighted decimation" in log  # merged windows above imu_cap
    if kind == "flat_inertial_anchor_out_of_order":
        ne = len(ids_t) - 1
        assert not bool(pt.ie_valid[:ne].all())  # invalid rows inside the real edges


def test_invalid_edge_rows_keep_the_costs_finite(sensors):
    """The solvers weight inertial edges by `ie_valid * ...`: an invalid row
    inside the real edges (an empty window, a non-successor anchor pair)
    must not carry a NaN into the costs (0 * NaN is NaN) in either package.
    The LM is run to convergence (20 iterations) and held to the costs; the
    window's biases are barely observable (an edge is empty), so its
    written-back states are only held finite."""
    _, _, (jp, tp, js, ts, kw, kt) = host_problems(sensors, "flat_inertial_anchor_out_of_order")
    oj = jp.run_window_ba(js, n_iters=20, **kw)
    ot = tp.run_window_ba(ts, n_iters=20, **kt)
    assert np.isfinite([oj["cost0"], oj["cost"], ot["cost0"], ot["cost"]]).all()
    assert_same_result(oj, ot, js, ts, state_rtol=np.inf)


# -- the named problems ----------------------------------------------------------


NAMED = {
    "initial_optimize": lambda pr, st: pr.initial_optimize(st, st.keyframe_ids()[:2]),
    "local_bundle_adjustment": lambda pr, st: pr.local_bundle_adjustment(st, st.keyframe_ids()[-1]),
    "local_full_bundle_adjustment": lambda pr, st: pr.local_full_bundle_adjustment(st, window=5),
    "local_inertial_bundle_adjustment":
        lambda pr, st: pr.local_inertial_bundle_adjustment(st, window=5),
}


@pytest.mark.parametrize("name", sorted(NAMED))
def test_named_problem_matches_jax(sensors, name):
    jp, tp = problems(sensors)
    js, ts, _ = stores(20)
    assert_same_result(NAMED[name](jp, js), NAMED[name](tp, ts), js, ts)


# hybrid takes every branch by size; grouped above full_k (at or below it,
# grouped and hybrid run the same grouped problem); one case per other mode
FULL_CASES = [("hybrid", 6), ("hybrid", 10), ("hybrid", 20), ("grouped", 20),
              ("recent", 20), ("capped", 10), ("grouped_nomerge", 20), ("off", 10)]


@pytest.mark.parametrize("mode,n_kf", FULL_CASES, ids=[f"{m}-{n}" for m, n in FULL_CASES])
def test_full_inertial_optimize_matches_jax(sensors, mode, n_kf):
    """local_k 8, full_k 12: 6 keyframes take the regular window, 10 the
    grouped K = 12 problem (or the capped subsample), 20 the stride
    subsample with merged windows and the propagated corrections (or the
    recent window, the capped subsample, no merge)."""
    jp, tp = problems(sensors, full_polish_mode=mode)
    js, ts, truth = stores(n_kf)
    oj, ot = jp.full_inertial_optimize(js), tp.full_inertial_optimize(ts)
    if mode == "off":
        assert oj is None and ot is None
        return
    assert_same_result(oj, ot, js, ts, POLISH_STATE_RTOL)
    assert abs(cs.store_ate(ts, truth) / cs.store_ate(js, truth) - 1.0) <= 0.01


# -- the inertial initialization -------------------------------------------------


def init_scenario(buf_cls):
    """tests/test_solver.py::test_inertial_init_recovers_scale_under_visual_noise:
    13 keyframes over 3 s in a rotated visual frame scaled by 1/4, positions
    noised by 2e-4, the IMU biased; a stub store of what the init reads."""
    s_true = 4.0
    bg_true = np.array([0.004, -0.003, 0.002], np.float32)
    ba_true = np.array([0.02, -0.01, 0.03], np.float32)
    traj = Trajectory()
    R_vw = tproblems._np_exp_so3([0.3, -0.2, 0.5]).astype(np.float32)
    rng = np.random.default_rng(3)
    times = np.arange(0.0, 3.01, 0.25)
    K = len(times)
    st = type("Store", (), {})()
    st.kf_imu, st.kf_time, st.kf_v = {}, times, {}
    st.kf_bg = np.zeros((K, 3), np.float32)
    st.kf_ba = np.zeros((K, 3), np.float32)
    R_list, t_list = [], []
    for i, t in enumerate(times):
        R_list.append((R_vw @ traj.R_wb(t)).astype(np.float32))
        t_list.append(((R_vw @ traj.pos(t)) / s_true + rng.normal(scale=2e-4, size=3)).astype(np.float32))
        if i < K - 1:
            g, a, d = traj.imu_samples(t, times[i + 1], 200.0, bg=bg_true, ba=ba_true,
                                       noise_gyro=1.7e-4, noise_acc=2e-3, rng=rng)
            buf = buf_cls(capacity=64)
            for j in range(len(g)):
                buf.add(g[j], a[j], d[j])
            st.kf_imu[i] = buf
    ids = list(range(K))
    st.keyframe_ids = lambda: ids
    st.keyframe_states = lambda ii: (np.stack([R_list[k] for k in ii]),
                                     np.stack([t_list[k] for k in ii]),
                                     np.zeros((len(ii), 3), np.float32), None, None)
    return st


@pytest.fixture(scope="module")
def init_problems():
    calib = dict(R_bc=np.eye(3, dtype=np.float32), t_bc=np.zeros(3, np.float32), noise_gyro=1.7e-4,
                 noise_acc=2e-3, walk_gyro=2e-5, walk_acc=3e-3, freq=200.0)
    cam = dict(fx=450.0, fy=450.0, cx=376.0, cy=240.0, width=752, height=480)
    caps = dict(local_k=16, local_p=64, local_o=128, imu_cap=64)
    return (jproblems.Problems(JPinhole.create(**cam), jimu.ImuCalib.create(**calib), **caps),
            tproblems.Problems(TPinhole.create(**cam, device="cpu"),
                               timu.ImuCalib.create(**calib, device="cpu"), device="cpu", **caps))


@pytest.mark.parametrize("method", ["inertial_optimize", "gravity_optimize"])
def test_inertial_init_matches_jax(init_problems, method):
    jp, tp = init_problems
    js, ts = init_scenario(jimu.ImuBuffer), init_scenario(timu.ImuBuffer)
    oj, ot = getattr(jp, method)(js), getattr(tp, method)(ts)
    assert abs(ot["scale"] / oj["scale"] - 1.0) <= 1e-6
    for f in ("R_wg", "bg", "ba"):
        np.testing.assert_allclose(ot[f], oj[f], rtol=1e-6, atol=1e-7, err_msg=f)
    np.testing.assert_allclose(ot["cost"], oj["cost"], rtol=1e-5)
    for k in range(13):
        np.testing.assert_allclose(ts.kf_v[k], js.kf_v[k], rtol=1e-6, atol=1e-6)
    if method == "inertial_optimize":
        assert abs(ot["scale"] - 4.0) / 4.0 < 0.15


def test_inertial_init_defers_an_unobservable_scale(init_problems):
    """Above the relative-sigma gate both packages defer (return None) and
    leave the store as it was."""
    for pr, buf_cls in zip(init_problems, (jimu.ImuBuffer, timu.ImuBuffer)):
        st = init_scenario(buf_cls)
        assert pr.inertial_optimize(st, defer_above=1e-6) is None
        assert not st.kf_v and not st.kf_bg.any()


def test_inertial_init_host_is_bit_identical_on_the_same_edges(init_problems):
    """The f64 host solve is a numpy copy: on the JAX package's own edges it
    gives the same bits."""
    jp, _ = init_problems
    js = init_scenario(jimu.ImuBuffer)
    ids = js.keyframe_ids()
    R, t, _, _, _ = js.keyframe_states(ids)
    edge = jax.tree_util.tree_map(lambda a: np.asarray(a[:12], np.float64),
                                  jp._batch_edges(js, ids, cap=12))
    kw = dict(with_scale=True, n_iters=60, t_bc=np.zeros(3), skip_lm_above=0.08)
    args = (np.asarray(R, np.float64), np.asarray(t, np.float64))
    oj = jproblems._inertial_init_host(*args, edge, 1e6, 1e12, **kw)
    ot = tproblems._inertial_init_host(*args, tproblems.PreintEdge(*edge), 1e6, 1e12, **kw)
    for k in oj:
        assert np.array_equal(np.asarray(ot[k]), np.asarray(oj[k])), k


# -- the frame LMs -----------------------------------------------------------------


def frame_inputs(ts, k):
    f = np.nonzero(ts.kf_feat_pt[k] >= 0)[0]
    n = 128
    pts = np.zeros((n, 3), np.float32)
    uv = np.zeros((n, 2), np.float32)
    is2 = np.ones(n, np.float32)
    valid = np.zeros(n, bool)
    pts[:len(f)] = ts.pt_xyz[ts.kf_feat_pt[k, f]]
    uv[:len(f)] = ts.kf_feat_xy[k, f]
    is2[:len(f)] = 1.0 / ts.kf_feat_sigma2[k, f]
    valid[:len(f)] = True
    return pts, uv, is2, valid


def test_pose_optimizers_match_jax(sensors):
    jp, tp = problems(sensors)
    js, ts, _ = stores(20)
    ids = ts.keyframe_ids()
    k, k0 = ids[10], ids[9]
    state = [np.asarray(a) for a in ts.keyframe_states([k])]
    state = [a[0] for a in state]
    state[1] = state[1] + np.float32(0.02)
    inputs = frame_inputs(ts, k)
    sj, ij = jp.pose_optimize(jproblems.KfState(*state), *inputs)
    st_, it = tp.pose_optimize(TKfState(*state), *inputs)
    np.testing.assert_array_equal(it, np.asarray(ij))
    for a, b in zip(st_, sj):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    last = [a[0] for a in ts.keyframe_states([k0])]
    bg, ba = np.zeros(3, np.float32), np.zeros(3, np.float32)
    pre_j = js.kf_imu[k0].integrate(bg, ba, sensors["jcalib"])
    pre_t = ts.kf_imu[k0].integrate(bg, ba, sensors["tcalib"])
    prior = np.asarray(cs.STORE_PRIOR_INV_SIGMA, np.float32)
    sj, ij = jp.pose_full_optimize(jproblems.KfState(*state), *inputs,
                                   jproblems.KfState(*last), pre_j, prior_inv_sigma=prior)
    st_, it = tp.pose_full_optimize(TKfState(*state), *inputs, TKfState(*last), pre_t,
                                    prior_inv_sigma=prior)
    np.testing.assert_array_equal(it, np.asarray(ij))
    for a, b in zip(st_, sj):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-3)


# -- the façade itself ---------------------------------------------------------------


def test_problems_rejects_a_mesh_and_warms_nothing_off_the_card(sensors):
    """A mesh of another device type than the façade's is refused (the
    sharded path on a CPU mesh: tests/test_torch_parallel.py)."""
    with pytest.raises(ValueError, match="mesh"):
        tproblems.Problems(sensors["tcam"], sensors["tcalib"],
                           mesh=types.SimpleNamespace(device_type="cuda"), device="cpu")
    _, tp = problems(sensors)
    tp.warm_solvers()
    assert tp.device == torch.device("cpu") and tp.syncs.n == 0


def test_store_ba_rehearsal_meets_the_card_bounds():
    """chip_smoke.store_ba on the CPU, at the card's sizes (default
    capacities, the 96-keyframe store): the port meets every bound the card
    run is held to but the card's own counts (fetches, syncs, K4 launches)."""
    sba = cs.store_ba("cpu", n_runs=0, log=lambda *_: None)
    assert cs.store_checks(sba, on_card=False) == []
