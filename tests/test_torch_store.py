"""PyTorch port: the map store, its checkpoint and its native bookkeeping
against the JAX package's (`monoorbslam3_tpu/models/map_state.py`,
`models/checkpoint.py`, `native/`).

Both stores are host numpy with the same arithmetic, so after the same
seeded script of calls (adds, removes, replaces, point and keyframe
evictions at small capacities, IMU merges, point statistics, the gauge
rewrite) they must hold the same bits in every array, the same free
lists, order and counters. Checkpoints load across the packages both
ways; the covisibility counts and the redundancy scan agree in the C++ and
the numpy branch."""

import numpy as np
import pytest

from monoorbslam3_tpu import native as jnative
from monoorbslam3_tpu.models import checkpoint as jckpt
from monoorbslam3_tpu.models.imu import ImuBuffer as JBuf
from monoorbslam3_tpu.models.map_state import MapStore as JStore
from monoorbslam3_tpu_torch import native as tnative
from monoorbslam3_tpu_torch.backend.problems import _np_exp_so3
from monoorbslam3_tpu_torch.models import checkpoint as tckpt
from monoorbslam3_tpu_torch.models.imu import ImuBuffer as TBuf
from monoorbslam3_tpu_torch.models.map_state import MapStore as TStore

import chip_smoke as cs

ARRAYS = ("kf_valid", "kf_time", "kf_R", "kf_t", "kf_v", "kf_bg", "kf_ba", "kf_parent",
          "kf_feat_xy", "kf_feat_level", "kf_feat_angle", "kf_feat_desc", "kf_feat_valid",
          "kf_feat_sigma2", "kf_feat_pt", "kf_feat_group", "kf_prior_inv_sigma",
          "pt_valid", "pt_xyz", "pt_desc", "pt_normal", "pt_min_dist", "pt_max_dist",
          "pt_sigma_z", "pt_first_kf", "pt_visible", "pt_found", "pt_obs_kf", "pt_obs_feat",
          "pt_n_obs")
SCALARS = ("_kf_order", "_free_pt", "_free_kf", "_next_kf_slot", "kf_created_total", "version",
           "max_kf", "max_pt", "n_feat", "max_obs")
R_CB = cs.R_CB
T_CB = cs.T_CB
SCALE_FACTORS = 1.2 ** np.arange(8)


def assert_same_store(a, b):
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and x.shape == y.shape, name
        assert np.array_equal(x, y), name
    for name in SCALARS:
        assert getattr(a, name) == getattr(b, name), name
    assert sorted(a.kf_imu) == sorted(b.kf_imu)
    for k in a.kf_imu:
        ba, bb = a.kf_imu[k], b.kf_imu[k]
        assert ba.n == bb.n
        for f in ("gyro", "acc", "dts"):
            assert np.array_equal(getattr(ba, f)[:ba.n], getattr(bb, f)[:bb.n]), (k, f)


def _features(rng, n_feat):
    return {"xy": rng.uniform(0, 640, (n_feat, 2)).astype(np.float32),
            "level": rng.integers(0, 8, n_feat).astype(np.int32),
            "angle": rng.uniform(0, 360, n_feat).astype(np.float32),
            "desc": rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint32),
            "valid": rng.uniform(size=n_feat) < 0.9,
            "sigma2": (1.2 ** (2 * rng.integers(0, 3, n_feat))).astype(np.float32),
            "group": rng.integers(-1, 50, n_feat).astype(np.int32)}


def run_script(store_cls, buf_cls, seed, n_steps=160):
    """A seeded script of store calls at small capacities: keyframe slot
    recycling and hard-capacity eviction, point eviction (the whole point
    set at this capacity), observation removal cascading into point
    removal, replaces, IMU windows merged on culling, point statistics and
    one gauge rewrite. The decisions depend only on the seed and the
    store's own state."""
    rng = np.random.default_rng(seed)
    n_feat = 24
    st = store_cls(max_kf=10, max_pt=60, n_feat=n_feat, max_obs=6)
    t = 0.0
    for _ in range(n_steps):
        op = rng.integers(0, 10)
        ids = st.keyframe_ids()
        valid_pts = np.nonzero(st.pt_valid)[0]
        if op <= 2 or len(ids) < 2:
            t += float(rng.uniform(0.05, 0.3))
            R = _np_exp_so3(rng.normal(size=3) * 0.3).astype(np.float32)
            k = st.add_keyframe(t, R, rng.normal(size=3).astype(np.float32),
                                rng.normal(size=3).astype(np.float32),
                                rng.normal(scale=1e-3, size=3).astype(np.float32),
                                rng.normal(scale=1e-2, size=3).astype(np.float32),
                                _features(rng, n_feat),
                                prior_inv_sigma=rng.uniform(1, 100, 9).astype(np.float32))
            buf = buf_cls(capacity=8)
            for _ in range(int(rng.integers(0, 20))):
                buf.add(rng.normal(size=3), rng.normal(size=3), float(rng.uniform(0.004, 0.006)))
            st.kf_imu[k] = buf
        elif op <= 5:
            k0 = int(rng.choice(ids))
            p = st.add_point(rng.normal(scale=5.0, size=3).astype(np.float32),
                             rng.integers(0, 2 ** 32, 8, dtype=np.uint32), k0)
            for k in rng.choice(ids, size=min(len(ids), int(rng.integers(1, 8))), replace=False):
                f = int(rng.integers(0, n_feat))
                if st.kf_feat_pt[k, f] < 0:
                    st.add_observation(p, int(k), f)
        elif op == 6 and len(valid_pts):
            p = int(rng.choice(valid_pts))
            if st.pt_n_obs[p]:
                st.remove_observation(p, int(st.pt_obs_kf[p, int(rng.integers(0, st.pt_n_obs[p]))]))
        elif op == 7 and len(valid_pts) >= 2:
            a, b = rng.choice(valid_pts, 2, replace=False)
            st.replace_point(int(a), int(b))
        elif op == 8 and len(ids) > 3:
            st.remove_keyframe(int(rng.choice(ids[1:-1])))
        elif op == 9 and len(valid_pts):
            st.update_point_stats(rng.choice(valid_pts, min(len(valid_pts), 6), replace=False),
                                  R_CB, T_CB, SCALE_FACTORS)
    st.apply_scale_rotation(_np_exp_so3([0.1, -0.4, 0.2]), 2.5, t_bc=cs.T_BC.astype(np.float32))
    return st


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_seeded_script_leaves_bit_identical_stores(seed):
    a, b = run_script(JStore, JBuf, seed), run_script(TStore, TBuf, seed)
    assert b.kf_created_total > b.max_kf  # keyframe slots were recycled or evicted
    assert len(b._free_pt) > 0
    assert_same_store(a, b)


def test_covisibility_and_point_stats_agree():
    a, b = run_script(JStore, JBuf, 4), run_script(TStore, TBuf, 4)
    pids = np.nonzero(b.pt_valid)[0]
    a.update_point_stats(pids, R_CB, T_CB, SCALE_FACTORS)
    b.update_point_stats(pids, R_CB, T_CB, SCALE_FACTORS)
    assert_same_store(a, b)
    for k in b.keyframe_ids():
        assert a.covisibility_weights(k) == b.covisibility_weights(k)
        for kw in ({}, {"min_weight": 1}, {"min_weight": 2, "top": 3}):
            assert a.covisible_keyframes(k, **kw) == b.covisible_keyframes(k, **kw)
    assert [np.array_equal(x, y) for x, y in
            zip(a.keyframe_states(b.keyframe_ids()), b.keyframe_states(b.keyframe_ids()))] == [True] * 5


def test_seeded_store_builder_is_the_same_in_both_packages():
    """chip_smoke.seeded_store, the store of the card's store BA path, built
    with either package's classes (a small one here)."""
    kw = dict(n_kf=10, n_pts=300, n_feat=96)
    a, _ = cs.seeded_store(JStore, JBuf, **kw)
    b, truth = cs.seeded_store(TStore, TBuf, **kw)
    assert_same_store(a, b)
    assert b.n_keyframes() == 10 and b.n_points() > 50
    assert 0.0 < cs.store_ate(b, truth) < 0.05


def test_apply_scale_rotation_keeps_the_lever_arm_metric():
    a, b = run_script(JStore, JBuf, 5), run_script(TStore, TBuf, 5)
    t0, R0 = b.kf_t.copy(), b.kf_R.copy()
    R_gw = _np_exp_so3([0.3, 0.1, -0.2])
    t_bc = np.array([0.05, -0.02, 0.01], np.float32)
    for st in (a, b):
        st.apply_scale_rotation(R_gw, 3.0, t_bc=t_bc)
    assert_same_store(a, b)
    # camera centres scale, the body-camera lever arm does not
    c0 = t0 + np.einsum("kij,j->ki", R0, t_bc)
    c1 = b.kf_t + np.einsum("kij,j->ki", b.kf_R, t_bc)
    np.testing.assert_allclose(c1, 3.0 * c0 @ R_gw.T.astype(np.float32), rtol=1e-5, atol=1e-4)


def test_reset_empties_the_store():
    b = run_script(TStore, TBuf, 6)
    b.reset()
    assert_same_store(b, TStore(max_kf=10, max_pt=60, n_feat=24, max_obs=6))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_loads_across_packages(tmp_path, direction):
    a, b = run_script(JStore, JBuf, 7), run_script(TStore, TBuf, 7)
    path = str(tmp_path / "map.npz")
    extra = {"imu_state": 1, "scale": 2.5}
    if direction == "jax_to_port":
        jckpt.save_map(a, path, extra=extra)
        restored, got = tckpt.load_map(path)
        assert isinstance(restored, TStore)
    else:
        tckpt.save_map(b, path, extra=extra)
        restored, got = jckpt.load_map(path)
        assert isinstance(restored, JStore)
    assert got == extra
    assert_same_store(restored, b)


def _branches(monkeypatch, native_on):
    """Point both packages at their compiled map_ops, or at none (the numpy
    fallbacks)."""
    for mod in (jnative, tnative):
        if native_on:
            monkeypatch.delitem(mod._exts, "map_ops", raising=False)
            monkeypatch.delenv("MONOSLAM_NO_NATIVE", raising=False)
            assert mod.get_ext("map_ops") is not None, "g++ did not build map_ops"
        else:
            monkeypatch.setitem(mod._exts, "map_ops", None)


@pytest.mark.parametrize("native_on", [True, False], ids=["cpp", "numpy"])
def test_covis_counts_and_redundancy_agree(monkeypatch, native_on):
    st = run_script(TStore, TBuf, 8)

    def both(k):
        args = (st.kf_feat_pt[k], st.pt_obs_kf, st.pt_n_obs, st.max_kf, k)
        rargs = (st.kf_feat_pt[k], st.kf_feat_level[k], st.pt_obs_kf, st.pt_obs_feat,
                 st.pt_n_obs, st.kf_feat_level, k)
        got = (tnative.covis_counts(*args), tuple(tnative.redundancy_count(*rargs)))
        assert got[0].dtype == np.int32
        assert np.array_equal(got[0], jnative.covis_counts(*args))
        assert got[1] == tuple(jnative.redundancy_count(*rargs))
        return got

    _branches(monkeypatch, native_on)
    outs = {k: both(k) for k in st.keyframe_ids()}
    assert any(r[1][1] for r in outs.values())  # some feature is redundant
    # the other branch gives the same counts
    _branches(monkeypatch, not native_on)
    for k, (counts, red) in outs.items():
        other = both(k)
        assert np.array_equal(counts, other[0]) and red == other[1]
