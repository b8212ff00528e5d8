"""PyTorch port, the mapper's keyframe searches against the JAX package on
the CPU: K3's plain version (`hamming_matrix`), the search masks,
`triangulate_dlt`, and the two device searches `_triangulate_pair_kernel`
and `_fuse_project_kernel`, on the same inputs and as a whole from each
package's own extractor.

Frames are small renderings of the `ImageWorld` circle (320x240, 384
features on 4 levels); keyframes 0.5 s apart (0.87 m of baseline) are
triangulated and the new points fused into a keyframe between them.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from monoorbslam3_tpu.frontend import frame as jframe
from monoorbslam3_tpu.frontend import local_mapping as jlm
from monoorbslam3_tpu.models.camera import Pinhole as JPinhole
from monoorbslam3_tpu.ops import matching as jm
from monoorbslam3_tpu.ops import twoview as jtv
from monoorbslam3_tpu.ops.orb import OrbExtractor as JOrbExtractor
from monoorbslam3_tpu.ops.pallas_kernels import hamming_matrix_pallas as j_hamming_pallas
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch import sim as tsim
from monoorbslam3_tpu_torch.frontend import frame as tframe
from monoorbslam3_tpu_torch.frontend import local_mapping as tlm
from monoorbslam3_tpu_torch.models.camera import Pinhole as TPinhole
from monoorbslam3_tpu_torch.ops import matching as tm
from monoorbslam3_tpu_torch.ops import pallas_kernels as tpk
from monoorbslam3_tpu_torch.ops import twoview as ttv
from monoorbslam3_tpu_torch.ops.orb import OrbExtractor as TOrbExtractor

H, W, N_FEAT, N_LEVELS = 240, 320, 384, 4
INTR = dict(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
            dist=[-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05], width=W, height=H)
_s2 = 1.0 / np.sqrt(2.0)
_z_c = np.array([_s2, -_s2, 0.0])
_x_c = np.array([-_s2, -_s2, 0.0])
R_BC = np.stack([_x_c, np.cross(_z_c, _x_c), _z_c], axis=1)
T_BC = np.array([0.03, 0.01, -0.02])
KF_TIMES = (0.0, 0.5, 0.25)  # triangulate KF0 x KF1, fuse into KF2


# ---------------------------------------------------------------------------
# K3's plain version and the masks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(300, 513), (5, 7), (1, 257)])
def test_hamming_matrix_matches_jax(shape):
    """K3's plain version (what `hamming_matrix` runs on a CPU tensor) is
    bit-identical to the JAX package's XLA `hamming_matrix` and to its
    Pallas kernel in interpret mode, for N, M that are not multiples of the
    256 tile; duplicated rows give distance 0 and bit 31 counts once."""
    rng = np.random.default_rng(sum(shape))
    a = rng.integers(0, 2**32, (shape[0], 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (shape[1], 8), dtype=np.uint32)
    k = min(shape) // 2
    b[:k] = a[:k]
    a[-1] = np.uint32(0xFFFFFFFF)
    got = tm.hamming_matrix(convert.desc_to_torch(a, "cpu"), convert.desc_to_torch(b, "cpu")).numpy()
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    pal = np.asarray(j_hamming_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)
    assert got.dtype == np.int32


def test_hamming_dispatch_checks_inputs():
    """The K3 dispatcher takes [n, 8] int32 on one device and nothing else."""
    a = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        tpk.hamming_matrix_pallas(a, torch.zeros((4, 7), dtype=torch.int32))
    with pytest.raises(ValueError):
        tpk.hamming_matrix_pallas(a, torch.zeros((4, 8), dtype=torch.int64))


def test_masks_match_jax():
    """window_mask, projection_mask (with and without the level band) and
    node_mask: identical boolean masks."""
    rng = np.random.default_rng(12)
    N, M = 70, 90
    xa = rng.uniform(0, 100, (N, 2)).astype(np.float32)
    xb = rng.uniform(0, 100, (M, 2)).astype(np.float32)
    va, vb = rng.random(N) > 0.2, rng.random(M) > 0.2
    r = rng.uniform(5, 30, N).astype(np.float32)
    lb = rng.integers(0, 8, M).astype(np.int32)
    lmin = rng.integers(0, 4, N).astype(np.int32)
    lmax = (lmin + rng.integers(0, 4, N)).astype(np.int32)
    wa, wb = rng.integers(-1, 5, N).astype(np.int32), rng.integers(-1, 5, M).astype(np.int32)
    J, T = (lambda *xs: [jnp.asarray(x) for x in xs]), (lambda *xs: [torch.as_tensor(x) for x in xs])
    np.testing.assert_array_equal(
        tm.window_mask(*T(xa, xb, va, vb), 12.0).numpy(),
        np.asarray(jm.window_mask(*J(xa, xb, va, vb), 12.0)))
    np.testing.assert_array_equal(
        tm.projection_mask(*T(xa, va, xb, vb, r)).numpy(),
        np.asarray(jm.projection_mask(*J(xa, va, xb, vb, r))))
    np.testing.assert_array_equal(
        tm.projection_mask(*T(xa, va, xb, vb, r, lb, lmin, lmax)).numpy(),
        np.asarray(jm.projection_mask(*J(xa, va, xb, vb, r, lb, lmin, lmax))))
    np.testing.assert_array_equal(tm.node_mask(*T(wa, wb, va, vb)).numpy(),
                                  np.asarray(jm.node_mask(*J(wa, wb, va, vb))))


def test_triangulate_dlt_matches_jax():
    """Closed-form DLT on two seeded cameras and 500 noisy correspondences,
    and on one degenerate (zero-baseline) pair that hits the 1e-20 det
    guard: points within 1e-4 relative to their norm (measured 4e-7)."""
    rng = np.random.default_rng(8)
    X = rng.uniform([-3, -2, 4], [3, 2, 12], (500, 3))
    P = []
    for t in ([0, 0, 0], [0.5, 0.05, 0.1]):
        w = rng.normal(0, 0.05, 3)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        U, _, Vt = np.linalg.svd(np.eye(3) + K)
        P.append(np.concatenate([U @ Vt, np.asarray(t, float)[:, None]], 1).astype(np.float32))
    xy = [((X @ p[:, :3].T + p[:, 3])[:, :2] / (X @ p[:, :3].T + p[:, 3])[:, 2:]
           + rng.normal(0, 1e-3, (500, 2))).astype(np.float32) for p in P]
    xy[1][0] = xy[0][0]
    P2 = P[1].copy()
    ref = np.asarray(jtv.triangulate_dlt(jnp.asarray(P[0]), jnp.asarray(P2),
                                         jnp.asarray(xy[0]), jnp.asarray(xy[1])))
    got = ttv.triangulate_dlt(torch.as_tensor(P[0]), torch.as_tensor(P2),
                              torch.as_tensor(xy[0]), torch.as_tensor(xy[1])).numpy()
    scale = np.maximum(np.linalg.norm(ref, axis=1), 1.0)
    assert np.max(np.linalg.norm(got - ref, axis=1) / scale) < 1e-4
    degen = [np.asarray(f(P[0], P[0], xy[0][:3], xy[0][:3])) for f in (
        lambda *a: jtv.triangulate_dlt(*map(jnp.asarray, a)),
        lambda *a: ttv.triangulate_dlt(*map(torch.as_tensor, a)).numpy())]
    np.testing.assert_allclose(degen[1], degen[0], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the two device searches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def kfs():
    jcam, tcam = JPinhole.create(**INTR), TPinhole.create(**INTR, device="cpu")
    world = tsim.ImageWorld()
    imgs = [world.render(t, tcam, R_BC, T_BC, rng=np.random.default_rng(30 + i))
            for i, t in enumerate(KF_TIMES)]
    poses = [tuple(a.astype(np.float32) for a in world.pose_cw(t, R_BC, T_BC)) for t in KF_TIMES]
    ext = JOrbExtractor(H, W, n_features=N_FEAT, n_levels=N_LEVELS)
    feats = [jframe.features_from_extractor(ext(img), jcam, ext.scale_factors) for img in imgs]
    return dict(jcam=jcam, tcam=tcam, world=world, imgs=imgs, poses=poses, jfeats=feats)


def _jax_search(cam, feats, poses):
    a, b, c = feats
    idx, X, acc = jlm._triangulate_pair_kernel(
        a["xy"], a["desc"], a["valid"], a["sigma2"], b["xy"], b["desc"], b["valid"],
        b["sigma2"], cam, *map(jnp.asarray, (*poses[0], *poses[1])))
    idx, X, acc = np.asarray(idx), np.asarray(X), np.asarray(acc)
    pts, desc, valid = _fuse_inputs(a, X, acc)
    fidx = jlm._fuse_project_kernel(pts, desc, valid, c["xy"], c["desc"], c["valid"],
                                    c["sigma2"], cam, *map(jnp.asarray, poses[2]), 4.0)
    return idx, X, acc, np.asarray(fidx)


def _torch_search(cam, feats, poses):
    a, b, c = [{k: convert.tensor(v, "cpu") for k, v in f.items()} for f in feats]
    T = lambda *xs: [torch.as_tensor(x) for x in xs]
    idx, X, acc = tlm._triangulate_pair_kernel(
        a["xy"], a["desc"], a["valid"], a["sigma2"], b["xy"], b["desc"], b["valid"],
        b["sigma2"], cam, *T(*poses[0], *poses[1]))
    idx, X, acc = idx.numpy(), X.numpy(), acc.numpy()
    pts, desc, valid = _fuse_inputs(feats[0], X, acc)
    fidx = tlm._fuse_project_kernel(torch.as_tensor(pts), convert.desc_to_torch(desc, "cpu"),
                                    torch.as_tensor(valid), c["xy"], c["desc"], c["valid"],
                                    c["sigma2"], cam, *T(*poses[2]), 4.0)
    return idx, X, acc, fidx.numpy()


def _fuse_inputs(f1, X, acc):
    """The accepted points with KF0's descriptors, padded to N_FEAT (the
    store's per-KF capacity, as LocalMapping._dispatch_fuse packs them)."""
    sel = np.nonzero(acc)[0][:N_FEAT]
    pts = np.zeros((N_FEAT, 3), np.float32)
    desc = np.zeros((N_FEAT, 8), np.uint32)
    valid = np.zeros(N_FEAT, bool)
    pts[: len(sel)], desc[: len(sel)], valid[: len(sel)] = X[sel], np.asarray(f1["desc"])[sel], True
    return pts, desc, valid


def _tri_error(kfs, feats, X, acc):
    f = np.nonzero(acc)[0]
    truth = kfs["world"].world_points(KF_TIMES[0], kfs["tcam"], R_BC, T_BC,
                                      np.asarray(feats[0]["xy_raw"])[f])
    return np.linalg.norm(X[f] - truth, axis=1)


def test_mapper_kernels_match_jax_on_same_inputs(kfs):
    """Both packages' triangulation and fuse on the JAX extractor's
    features. Bounds: the accepted sets overlap in 98% (a point whose
    gates sit within rounding of 5.991 or 0.9998 may flip; measured 100%);
    the shared points' matches are identical and the points agree within
    1e-3 of their distance from the origin (measured 3.9e-5, and 2.6e-4 at
    half this baseline: the normal equations of a short baseline at ~10 m
    depth are ill-conditioned, and XLA rounds its fused multiply-adds once
    where torch rounds twice); the fuse picks the same feature for 99% of
    the points (measured 100%). The triangulated points lie within 0.5 m of
    the renderer's (median; measured 0.26 m: at a 200 px focal length a
    half-pixel keypoint error moves a point ~0.2 m in depth at 8 m over this
    baseline)."""
    cam_t = convert.pinhole(kfs["jcam"], device="cpu")
    ji, jX, ja, jf = _jax_search(kfs["jcam"], kfs["jfeats"], kfs["poses"])
    ti, tX, ta, tf = _torch_search(cam_t, kfs["jfeats"], kfs["poses"])
    assert ja.sum() > 40  # the pair really triangulates
    both = ja & ta
    assert both.sum() >= 0.98 * max(ja.sum(), ta.sum())
    np.testing.assert_array_equal(ti[both], ji[both])
    dist = np.linalg.norm(jX[both], axis=1)
    assert np.max(np.linalg.norm(tX[both] - jX[both], axis=1) / dist) < 1e-3
    assert (jf >= 0).sum() > 20
    assert (tf == jf).mean() >= 0.99
    assert np.median(_tri_error(kfs, kfs["jfeats"], jX, ja)) < 0.5


def test_mapper_search_chain_matches_jax(kfs):
    """image -> each package's own extractor -> triangulation -> fuse.
    Bounds: accepted and fused counts within 5% of the JAX chain's, median
    3D error against the renderer's true points within 10% (measured:
    identical counts and errors; the extractors agree bit for bit)."""
    ext = TOrbExtractor(H, W, n_features=N_FEAT, n_levels=N_LEVELS, device="cpu")
    tcam = kfs["tcam"]
    tfeats = []
    for img in kfs["imgs"]:
        f = tframe.finish_features(ext(img), tcam, ext.scale_factors)
        f = {k: v.numpy() for k, v in f.items()}
        f["desc"] = convert.desc_to_numpy(f["desc"])
        tfeats.append(f)
    _, jX, ja, jf = _jax_search(kfs["jcam"], kfs["jfeats"], kfs["poses"])
    _, tX, ta, tf = _torch_search(tcam, tfeats, kfs["poses"])
    assert abs(int(ta.sum()) - int(ja.sum())) <= 0.05 * ja.sum()
    assert abs(int((tf >= 0).sum()) - int((jf >= 0).sum())) <= 0.05 * (jf >= 0).sum()
    ej = np.median(_tri_error(kfs, kfs["jfeats"], jX, ja))
    et = np.median(_tri_error(kfs, tfeats, tX, ta))
    assert abs(et - ej) <= 0.1 * ej
