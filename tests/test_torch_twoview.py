"""PyTorch port: the two-view bootstrap (`ops/twoview.py`) against the JAX
package on the same seeded inputs, on the CPU.

The RANSAC samples are an input of the port's `reconstruct_two_views`:
the parity tests hand it the indices `jax.random.choice` draws from the
key the JAX call gets (drawn with replacement, ~5% of the 8-point samples
repeat an index here, ~13% at 200 matches). A repeated index leaves the
fundamental DLT's 8x9 system a two-dimensional null space, whose `Vt[-1]`
is the library's choice, so the per-hypothesis scores are compared on the
rows of eight distinct indices only, and the output by its winner (R, t,
good, n_good, rh), not by its slot: the sign of U permutes the Faugeras
and essential banks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from monoorbslam3_tpu.ops import twoview as jtv
from monoorbslam3_tpu.utils import lie as jlie
from monoorbslam3_tpu_torch.ops import twoview as ttv
from monoorbslam3_tpu_torch.utils import prng

from tests.test_torch_tracking import one_torch_thread  # noqa: F401  (autouse)

K = np.array([[450.0, 0.0, 376.0], [0.0, 450.0, 240.0], [0.0, 0.0, 1.0]], np.float32)
N_ITERS = 200


def _project(pts):
    uv = pts @ K.T
    return uv[:, :2] / uv[:, 2:3]


def _scene(planar, seed):
    """The two scenes of tests/test_twoview.py from a seeded generator:
    general motion over 4-12 m depth (20 outliers), or a plane at 6 m (10
    outliers); 0.3 px noise; 64 padding rows."""
    rng = np.random.default_rng(seed)
    if planar:
        pts = np.stack([rng.uniform(-4, 4, 400), rng.uniform(-2.5, 2.5, 400),
                        np.full(400, 6.0)], -1)
        rv, t21, n_out = [0.03, 0.08, -0.02], np.array([0.35, -0.1, 0.05], np.float32), 10
    else:
        pts = np.stack([rng.uniform(-3, 3, 400), rng.uniform(-2, 2, 400),
                        rng.uniform(4, 12, 400)], -1)
        rv, t21, n_out = [0.02, -0.1, 0.03], np.array([0.4, 0.05, 0.02], np.float32), 20
    R21 = np.asarray(jlie.exp_so3(jnp.asarray(rv, jnp.float32)))
    uv1 = _project(pts) + rng.normal(scale=0.3, size=(400, 2))
    uv2 = _project(pts @ R21.T + t21) + rng.normal(scale=0.3, size=(400, 2))
    sel = rng.choice(400, n_out, replace=False)
    uv2[sel] += rng.uniform(30, 120, size=(n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    pad = np.zeros((64, 2))
    xy1 = np.concatenate([uv1, pad]).astype(np.float32)
    xy2 = np.concatenate([uv2, pad]).astype(np.float32)
    valid = np.concatenate([np.ones(400, bool), np.zeros(64, bool)])
    return xy1, xy2, valid, R21, t21, pts


def _jax_samples(key, valid):
    """The indices the JAX call draws from `key` (twoview.py:336-338)."""
    w = valid.astype(np.float32)
    probs = jnp.asarray(w / max(w.sum(), 1.0))
    return np.asarray(jax.random.choice(key, len(valid), shape=(N_ITERS, 8), p=probs))


def _t(x):
    return torch.as_tensor(np.array(x))


def _rot_angle(Ra, Rb):
    """Angle (rad) between two rotations, float64, accurate near zero."""
    dR = Ra.astype(np.float64).T @ Rb.astype(np.float64)
    w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2.0
    return float(np.arctan2(np.linalg.norm(w), (np.trace(dR) - 1.0) / 2.0))


@pytest.fixture(scope="module", params=[False, True], ids=["general", "planar"])
def scene(request):
    xy1, xy2, valid, R21, t21, pts = _scene(request.param, seed=11 + request.param)
    key = jax.random.PRNGKey(int(request.param))
    idx = _jax_samples(key, valid)
    distinct = np.array([len(set(r)) == 8 for r in idx])
    return dict(planar=request.param, xy1=xy1, xy2=xy2, valid=valid, R21=R21, t21=t21,
                pts=pts, key=key, idx=idx, distinct=distinct)


def test_masked_normalize(scene):
    """Hartley normalization: xy_n, mean, s and T within 1e-6 relative."""
    xy, v = scene["xy1"], scene["valid"]
    for a, b in zip(jtv._masked_normalize(jnp.asarray(xy), jnp.asarray(v)),
                    ttv._masked_normalize(_t(xy), _t(v))):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6, atol=1e-6)


def _normalized_samples(scene):
    xy1, xy2, v, idx = scene["xy1"], scene["xy2"], scene["valid"], scene["idx"]
    _, m1, s1, _ = jtv._masked_normalize(jnp.asarray(xy1), jnp.asarray(v))
    _, m2, s2, _ = jtv._masked_normalize(jnp.asarray(xy2), jnp.asarray(v))
    p1 = (xy1[idx] - np.asarray(m1)) * np.asarray(s1)
    p2 = (xy2[idx] - np.asarray(m2)) * np.asarray(s2)
    return p1.astype(np.float32), p2.astype(np.float32)


def _same_up_to_sign(a, b, atol):
    """Rows of [S, 9] null vectors equal up to their sign."""
    a = a.reshape(len(a), -1)
    b = b.reshape(len(b), -1)
    sgn = np.sign(np.sum(a * b, axis=1, keepdims=True))
    np.testing.assert_allclose(b * sgn, a, atol=atol)


def test_dlt_homography_and_fundamental(scene):
    """Both DLTs on the rows of eight distinct indices: the null vectors
    (unit, up to sign) within 1e-3, the rank-2 F within 1e-3 up to sign."""
    p1, p2 = _normalized_samples(scene)
    d = scene["distinct"]
    Hj = np.asarray(jtv._dlt_homography(jnp.asarray(p1), jnp.asarray(p2)))[d]
    Ht = ttv._dlt_homography(_t(p1), _t(p2)).numpy()[d]
    _same_up_to_sign(Hj, Ht, 1e-3)
    Fj = np.asarray(jtv._dlt_fundamental(jnp.asarray(p1), jnp.asarray(p2)))[d]
    Ft = ttv._dlt_fundamental(_t(p1), _t(p2)).numpy()[d]
    _same_up_to_sign(Fj, Ft, 1e-3)


def test_scores_per_hypothesis(scene):
    """The H and F scores of every hypothesis of eight distinct indices,
    each scored by both packages on the JAX package's own matrices: within
    1e-4 relative of the score scale plus what the flipped matches add; the
    inlier masks equal in 99.5% of the entries.

    A match on its chi2 threshold may flip between the packages, and its
    flag carries its whole term into the score (one term of the planar
    scene's 187 hypotheses moved a score by 4.98, 1.2e-3 of the scale). So
    each hypothesis may also differ by its flipped matches' contribution:
    the larger of the two packages' scores over those matches alone."""
    p1, p2 = _normalized_samples(scene)
    d = scene["distinct"]
    xy1, xy2, v = (jnp.asarray(scene[k]) for k in ("xy1", "xy2", "valid"))
    _, _, _, T1 = jtv._masked_normalize(xy1, v)
    _, _, _, T2 = jtv._masked_normalize(xy2, v)
    H = np.asarray(jnp.linalg.inv(T2)[None] @ jtv._dlt_homography(jnp.asarray(p1), jnp.asarray(p2))
                   @ T1[None])[d]
    F = np.asarray(T2.T[None] @ jtv._dlt_fundamental(jnp.asarray(p1), jnp.asarray(p2))
                   @ T1[None])[d]
    for jfn, tfn, M in ((jtv._score_homography, ttv._score_homography, H),
                        (jtv._score_fundamental, ttv._score_fundamental, F)):
        sj, okj = jax.vmap(lambda m: jfn(m, xy1, xy2, v))(jnp.asarray(M))
        st, okt = tfn(_t(M), _t(scene["xy1"]), _t(scene["xy2"]), _t(scene["valid"]))
        sj, okj, okt = np.asarray(sj), np.asarray(okj), okt.numpy()
        flipped = np.zeros(len(sj))
        for h in np.flatnonzero((okt != okj).any(axis=1)):
            f = okt[h] != okj[h]
            fj, _ = jfn(jnp.asarray(M[h]), xy1, xy2, jnp.asarray(f))
            ft, _ = tfn(_t(M[h]), _t(scene["xy1"]), _t(scene["xy2"]), _t(f))
            flipped[h] = max(abs(float(fj)), abs(float(ft)))
        err = np.abs(st.numpy() - sj)
        assert np.all(err <= 1e-4 * np.abs(sj).max() + flipped), (err.max(), flipped.max())
        assert (okt == okj).mean() >= 0.995


def _hypothesis_sets_match(Rj, tj, Rt, tt):
    """Every JAX (R, t) has a port hypothesis with R within 1e-4 rad and t
    within 1e-4 (the bank's order is the SVD's choice)."""
    for R, t in zip(Rj, tj):
        err = [max(_rot_angle(R, R2), float(np.abs(t - t2).max())) for R2, t2 in zip(Rt, tt)]
        assert min(err) < 1e-4, err


def test_decompositions(scene):
    """decompose_essential on the scene's E = [t]x R and
    decompose_homography on the homography its motion induces on the z = 6
    plane: the same set of motion hypotheses in both packages."""
    R21, t21 = scene["R21"], scene["t21"]
    E = (np.asarray(jlie.hat(jnp.asarray(t21))) @ R21).astype(np.float32)
    Rj, tj = (np.asarray(a) for a in jtv.decompose_essential(jnp.asarray(E)))
    Rt, tt = (a.numpy() for a in ttv.decompose_essential(_t(E)))
    _hypothesis_sets_match(Rj, tj, Rt, tt)
    n = np.array([0.0, 0.0, 1.0])
    Hc = R21 + np.outer(t21, n) / 6.0
    H = (K @ Hc @ np.linalg.inv(K)).astype(np.float32)
    Rj, tj = (np.asarray(a) for a in jtv.decompose_homography(jnp.asarray(H), jnp.asarray(K)))
    Rt, tt = (a.numpy() for a in ttv.decompose_homography(_t(H), _t(K)))
    _hypothesis_sets_match(Rj, tj, Rt, tt)


def test_check_rt(scene):
    """CheckRT under the true motion and its mirror: n_good within 1, good
    equal in 99.5% of the rows, the parallax statistic within 1e-6. The
    points come from normal equations (the closed-form DLT squares the
    system), whose float32 rounding differs between XLA's fused program
    and eager torch by up to ~3e-4 relative on the plane: each package's
    good points are held to the same solve in float64, the port's within
    twice JAX's error (plus 1e-6 of the depth)."""
    R21, t21 = scene["R21"], scene["t21"] / np.linalg.norm(scene["t21"])
    xy1, xy2, v = scene["xy1"], scene["xy2"], scene["valid"]
    for t in (t21, -t21):
        t = t.astype(np.float32)
        nj, Xj, gj, pj = jtv.check_rt(jnp.asarray(R21), jnp.asarray(t), jnp.asarray(xy1),
                                      jnp.asarray(xy2), jnp.asarray(v), jnp.asarray(K))
        nt, Xt, gt, pt = ttv.check_rt(_t(R21), _t(t), _t(xy1), _t(xy2), _t(v), _t(K))
        gj = np.asarray(gj)
        assert abs(int(nt) - int(nj)) <= 1
        assert (gt.numpy() == gj).mean() >= 0.995
        assert abs(float(pt) - float(pj)) <= 1e-6
        if gj.any():
            K64 = torch.as_tensor(K, dtype=torch.float64)
            P1 = torch.cat([K64, torch.zeros((3, 1), dtype=torch.float64)], 1)
            P2 = K64 @ torch.cat([torch.as_tensor(R21, dtype=torch.float64),
                                  torch.as_tensor(t, dtype=torch.float64)[:, None]], 1)
            X64 = ttv.triangulate_dlt(P1, P2, torch.as_tensor(xy1, dtype=torch.float64),
                                      torch.as_tensor(xy2, dtype=torch.float64)).numpy()[gj]
            e_jax = np.abs(np.asarray(Xj)[gj] - X64).max()
            e_port = np.abs(Xt.numpy()[gj] - X64).max()
            assert e_port <= 2.0 * e_jax + 1e-6 * np.abs(X64).max(), (e_port, e_jax)


def test_triangulate_dlt_broadcasts():
    """One camera pair against a bank of hypotheses broadcasts as a loop
    over the bank does."""
    rng = np.random.default_rng(3)
    xy1 = _t(rng.uniform(0, 700, (50, 2)).astype(np.float32))
    xy2 = _t(rng.uniform(0, 700, (50, 2)).astype(np.float32))
    P1 = _t(np.concatenate([K, np.zeros((3, 1), np.float32)], 1))
    P2 = _t(rng.normal(size=(4, 3, 4)).astype(np.float32))
    bank = ttv.triangulate_dlt(P1, P2[:, None], xy1, xy2)
    for h in range(4):
        torch.testing.assert_close(bank[h], ttv.triangulate_dlt(P1, P2[h], xy1, xy2))


def test_reconstruct_with_the_jax_draws(scene):
    """reconstruct_two_views on the indices JAX drew: the same success and
    family (general motion with F, the plane with H), R within 1e-4 rad,
    t's direction cos above 1 - 1e-6, good equal in 99% of the rows, n_good
    within 1, rh within 1e-4."""
    args = [scene[k] for k in ("xy1", "xy2", "valid")]
    oj = {k: np.asarray(v) for k, v in jtv.reconstruct_two_views(
        *(jnp.asarray(a) for a in args), jnp.asarray(K), scene["key"]).items()}
    ot = {k: v.numpy() for k, v in ttv.reconstruct_two_views(
        *(_t(a) for a in args), _t(K), _t(scene["idx"])).items()}
    assert bool(ot["success"]) == bool(oj["success"]) is True
    assert (float(ot["rh"]) > 0.45) == (float(oj["rh"]) > 0.45) == scene["planar"]
    assert abs(float(ot["rh"]) - float(oj["rh"])) <= 1e-4
    assert _rot_angle(oj["R"], ot["R"]) <= 1e-4
    cos = float(oj["t"] @ ot["t"]) / (np.linalg.norm(oj["t"]) * np.linalg.norm(ot["t"]))
    assert cos > 1.0 - 1e-6
    assert (ot["good"] == oj["good"]).mean() >= 0.99
    assert abs(int(ot["n_good"]) - int(oj["n_good"])) <= 1


def _truth_gates(out, scene):
    """tests/test_twoview.py's gates against the true motion: success, the
    family, R within 1 deg (general) / 1.5 deg (plane) and t's direction
    cos above 0.995 / 0.99."""
    out = {k: np.asarray(v) for k, v in out.items()}
    if not bool(out["success"]) or (float(out["rh"]) > 0.45) != scene["planar"]:
        return False
    R21, t21 = scene["R21"], scene["t21"]
    ang = np.degrees(_rot_angle(out["R"], R21))
    cos = abs(out["t"] @ t21 / (np.linalg.norm(out["t"]) * np.linalg.norm(t21)))
    return (ang < 1.5 and cos > 0.99) if scene["planar"] else (ang < 1.0 and cos > 0.995)


def test_reconstruct_with_own_draws_holds_the_truth_gates(scene):
    """The port's own draws (`draw_samples` under the key chain of
    `utils.prng`) are the JAX package's: for keys 0-19 the indices equal
    the ones `jax.random.choice` draws from the same key, and the port
    meets tests/test_twoview.py's truth gates on exactly as many of them as
    the JAX package (on the general scene the reference itself fails the
    gates for 9 of the 20 keys: a winning F whose decomposition
    triangulates few points, or a motion off by more than the gate); every
    planar run meets them."""
    args = [scene[k] for k in ("xy1", "xy2", "valid")]
    n_port = n_jax = 0
    for k in range(20):
        idx = ttv.draw_samples(prng.prng_key(k), scene["valid"], N_ITERS)
        np.testing.assert_array_equal(idx, _jax_samples(jax.random.PRNGKey(k), scene["valid"]))
        assert idx.shape == (N_ITERS, 8) and bool(scene["valid"][idx].all())
        n_port += _truth_gates(ttv.reconstruct_two_views(*(_t(a) for a in args), _t(K), _t(idx)),
                               scene)
        n_jax += _truth_gates(jtv.reconstruct_two_views(*(jnp.asarray(a) for a in args),
                                                        jnp.asarray(K), jax.random.PRNGKey(k)),
                              scene)
    assert n_port == n_jax, (n_port, n_jax)
    if scene["planar"]:
        assert n_port == n_jax == 20


def test_draw_samples_follows_the_valid_rows_and_the_device():
    """Draws land on valid rows only, as host int64 indices that
    `upload_inputs` puts on the pair's device with the pair; with no valid
    row every index is 0, as JAX's `choice` gives it."""
    from monoorbslam3_tpu_torch.backend.problems import upload_inputs

    key = prng.prng_key(5)
    v = np.zeros(64, bool)
    v[10:20] = True
    idx = ttv.draw_samples(key, v, 50)
    assert isinstance(idx, np.ndarray) and idx.dtype == np.int64 and idx.shape == (50, 8)
    assert ((idx >= 10) & (idx < 20)).all()
    np.testing.assert_array_equal(idx, np.asarray(jax.random.choice(
        jax.random.PRNGKey(5), 64, shape=(50, 8), p=jnp.asarray(v / 10.0, jnp.float32))))
    valid_t, idx_t = upload_inputs((v, idx), torch.device("cpu"))
    assert idx_t.device == valid_t.device and bool((idx_t == torch.as_tensor(idx)).all())
    idx0 = ttv.draw_samples(key, np.zeros(64, bool), 50)
    assert idx0.shape == (50, 8) and not idx0.any()
