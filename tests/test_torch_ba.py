"""PyTorch port, the window BA (`backend/solver.schur_ba` and its pieces),
against the JAX package on the CPU.

Inputs are made once with numpy and handed to both packages: the bench
window of `bench.build_problem` at a small size (K = 8 with 2 fixed,
P = 256, 64 obs/KF), with random inertial edges, biases and priors laid
over it so the inertial terms are not trivial. Each test states its
tolerance. The LM accept decisions compare costs that differ in the last
bits between XLA (which fuses multiply-adds on the CPU) and torch, so the
solvers are compared on cost0 and the converged cost, not iterate by
iterate.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
import chip_smoke
from experiments import port_chol_cluster_emulate as chol_emulate
from experiments import port_chol_grid_emulate as grid_emulate
from monoorbslam3_tpu.backend import residuals as jres
from monoorbslam3_tpu.backend import solver as jsolver
from monoorbslam3_tpu.ops.chol_pallas import chol_solve_pallas
from monoorbslam3_tpu.utils import lie as jlie
from monoorbslam3_tpu_torch import bench_window, convert
from monoorbslam3_tpu_torch.backend import residuals as tres
from monoorbslam3_tpu_torch.backend import solver as tsolver
from monoorbslam3_tpu_torch.ops import chol_pallas
from monoorbslam3_tpu_torch.ops.chol_pallas import chol_solve
from monoorbslam3_tpu_torch.utils import lie as tlie

SMALL = dict(n_kf=8, n_fixed=2, n_pts=256, obs_per_kf=64)
I3, Z3 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, ref, rel, what=""):
    """|got - ref| <= rel * max(1, max|ref|), elementwise."""
    got, ref = _np(got).astype(np.float64), _np(ref).astype(np.float64)
    assert got.shape == ref.shape, what
    scale = max(1.0, float(np.max(np.abs(ref)))) if ref.size else 1.0
    err = float(np.max(np.abs(got - ref))) if ref.size else 0.0
    assert err <= rel * scale, f"{what}: max err {err:.3e} > {rel:.0e} * {scale:.3e}"


def _rodrigues(w):
    th = np.linalg.norm(w, axis=-1)[..., None, None]
    k = w / np.maximum(np.linalg.norm(w, axis=-1, keepdims=True), 1e-12)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _vi_problem(seed=3):
    """The small bench window with random inertial edges, biases, velocities
    and priors (numpy), as the JAX record."""
    jp, cam = bench.build_problem(seed=0, **SMALL)
    rng = np.random.default_rng(seed)
    K, E = SMALL["n_kf"], SMALL["n_kf"] - 1
    f = lambda *s, sc=1.0: (rng.normal(0, sc, s)).astype(np.float32)
    kf = jp.kf._replace(v=jnp.asarray(f(K, 3, sc=0.5)), bg=jnp.asarray(f(K, 3, sc=0.01)),
                        ba=jnp.asarray(f(K, 3, sc=0.05)))
    L = np.tril(f(E, 9, 9, sc=0.1)) + np.eye(9, dtype=np.float32) * rng.uniform(1, 5, (E, 1, 1)).astype(np.float32)
    edge = jres.PreintEdge(
        dR=jnp.asarray(_rodrigues(f(E, 3, sc=0.05))), dV=jnp.asarray(f(E, 3, sc=0.1)),
        dP=jnp.asarray(f(E, 3, sc=0.05)), JRg=jnp.asarray(f(E, 3, 3, sc=0.1)),
        JVg=jnp.asarray(f(E, 3, 3, sc=0.1)), JVa=jnp.asarray(f(E, 3, 3, sc=0.1)),
        JPg=jnp.asarray(f(E, 3, 3, sc=0.05)), JPa=jnp.asarray(f(E, 3, 3, sc=0.05)),
        bg0=jnp.asarray(f(E, 3, sc=0.01)), ba0=jnp.asarray(f(E, 3, sc=0.05)),
        dt=jnp.asarray(rng.uniform(0.2, 0.3, E).astype(np.float32)), L_inv=jnp.asarray(L))
    prior = np.zeros((K, 15), np.float32)
    prior[:3, 6:15] = rng.uniform(1, 10, (3, 9))
    ref = kf._replace(v=kf.v + jnp.asarray(f(K, 3, sc=0.1)))
    jp = jp._replace(kf=kf, ie_edge=edge, prior_inv_sigma=jnp.asarray(prior), prior_ref=ref)
    return jp, cam


@pytest.fixture(scope="module")
def vi():
    jp, jcam = _vi_problem()
    return dict(jp=jp, jcam=jcam, tp=convert.ba_problem(jp, device="cpu"), tcam=convert.pinhole(jcam, device="cpu"),
                jR=jnp.asarray(I3), jt=jnp.asarray(Z3),
                tR=torch.eye(3), tt=torch.zeros(3))


# ---------------------------------------------------------------------------
# SO(3) and the residual library
# ---------------------------------------------------------------------------


def test_lie_functions():
    """exp, log, vee, Jr, Jr^-1, the inverse-Jr coefficient and
    normalize_rotation on angles from 1e-8 rad to 3 rad: within 2e-5 (log
    near 3 rad is the least conditioned of them).

    The coefficient D of Jr^-1 = I + hat(w)/2 + D hat(w)^2 is held where its
    callers use it, as its contribution D theta^2 (hat(w)^2 is of order
    theta^2). Raw D is not pinned down: both packages take the closed form
    1/theta^2 - (1 + cos)/(2 theta sin) down to theta = 1e-6, where float32
    cancels catastrophically (at 1.42e-6 rad JAX gives -65536, torch 32768,
    float64 0.0834, depending on the machine's sin and cos); there D theta^2
    is still below 1.3e-7."""
    rng = np.random.default_rng(5)
    ax = rng.normal(size=(64, 3))
    ax /= np.linalg.norm(ax, axis=1, keepdims=True)
    w = (ax * np.geomspace(1e-8, 3.0, 64)[:, None]).astype(np.float32)
    jw, tw = jnp.asarray(w), torch.as_tensor(w)
    R = np.array(jlie.exp_so3(jw))
    _close(tlie.exp_so3(tw), R, 2e-6, "exp_so3")
    _close(tlie.log_so3(torch.as_tensor(R)), jlie.log_so3(jnp.asarray(R)), 2e-5, "log_so3")
    _close(tlie.vee(torch.as_tensor(R)), jlie.vee(jnp.asarray(R)), 1e-7, "vee")
    _close(tlie.right_jacobian_so3(tw), jlie.right_jacobian_so3(jw), 2e-6, "Jr")
    _close(tlie.inv_right_jacobian_so3(tw), jlie.inv_right_jacobian_so3(jw), 2e-5, "Jr^-1")
    theta2 = np.sum(w.astype(np.float64) ** 2, axis=-1)
    _close(_np(tlie.inv_jr_coeff(tw)) * theta2, np.asarray(jlie.inv_jr_coeff(jw)) * theta2,
           2e-5, "inv_jr_coeff * theta^2")
    noisy = (R + rng.normal(0, 0.01, R.shape)).astype(np.float32)
    _close(tlie.normalize_rotation(torch.as_tensor(noisy)),
           jlie.normalize_rotation(jnp.asarray(noisy)), 2e-5, "normalize_rotation")


def test_inertial_walk_prior_residuals(vi):
    """Bias-corrected deltas and the inertial residual (whitened and not),
    the bias walk and the prior on random edges and states: within 1e-5
    relative to the largest entry."""
    jp, tp = vi["jp"], vi["tp"]
    js1, js2 = jsolver._gather_kf(jp.kf, jp.ie_i), jsolver._gather_kf(jp.kf, jp.ie_j)
    ts1, ts2 = tsolver._gather_kf(tp.kf, tp.ie_i), tsolver._gather_kf(tp.kf, tp.ie_j)
    for a, b in zip(tp.ie_edge.corrected(ts1.bg, ts1.ba), jp.ie_edge.corrected(js1.bg, js1.ba)):
        _close(a, b, 1e-6, "corrected")
    for whiten in (False, True):
        _close(tres.inertial_residual(ts1, ts2, tp.ie_edge, whiten),
               jres.inertial_residual(js1, js2, jp.ie_edge, whiten), 1e-5, f"inertial {whiten}")
    _close(tres.bias_walk_residual(ts1, ts2, tp.walk_inv_sigma),
           jres.bias_walk_residual(js1, js2, jp.walk_inv_sigma), 1e-6, "walk")
    x = np.random.default_rng(2).normal(size=(8, 9)).astype(np.float32)
    _close(tres.prior_residual(torch.as_tensor(x), torch.as_tensor(x[::-1].copy()),
                               tp.prior_inv_sigma[:, 6:]),
           jres.prior_residual(jnp.asarray(x), jnp.asarray(x[::-1].copy()),
                               jp.prior_inv_sigma[:, 6:]), 1e-6, "prior")


# ---------------------------------------------------------------------------
# linearizations, costs, assembly
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("piece", ["vis", "inertial", "walk", "prior"])
def test_linearize(vi, piece):
    """Every output of each `_*_linearize` on the same state: residuals,
    Jacobians, weights and costs within 1e-5 relative to the largest entry
    of each (measured: below 1e-7 for the inertial, walk and prior terms).
    The visual terms get 5e-5: the projections are ~400 px, where one f32
    ulp is 3e-5 px, and the Huber weight sqrt(5.991 / chi2) moves by up to
    1.6e-5 (measured) on such a residual difference."""
    jp, tp = vi["jp"], vi["tp"]
    if piece == "vis":
        j = jsolver._vis_linearize(jp, vi["jcam"], vi["jR"], vi["jt"], jsolver.CHI2_MONO)
        t = tsolver._vis_linearize(tp, vi["tcam"], vi["tR"], vi["tt"], tsolver.CHI2_MONO)
        names, rel = ("r0", "Jc", "Jl", "w", "chi2", "cost"), 5e-5
    else:
        fn = {"inertial": "_inertial_linearize", "walk": "_walk_linearize",
              "prior": "_prior_linearize"}[piece]
        j, t = getattr(jsolver, fn)(jp), getattr(tsolver, fn)(tp)
        names = ("r0", "J1", "J2", "w", "cost") if piece != "prior" else ("r", "inv_sigma", "cost")
        rel = 1e-5
    for n, a, b in zip(names, t, j):
        _close(a, b, rel, f"{piece}.{n}")


@pytest.mark.parametrize("override", [False, True])
def test_total_cost(vi, override):
    """`_total_cost` under the state's own depth gate and under a fixed
    observation mask: within 1e-5 relative."""
    jp, tp = vi["jp"], vi["tp"]
    mask = np.asarray(jp.obs_valid) & (np.arange(jp.obs_valid.shape[0]) % 3 > 0)
    jm, tm = (jnp.asarray(mask), torch.as_tensor(mask)) if override else (None, None)
    a = tsolver._total_cost(tp, vi["tcam"], vi["tR"], vi["tt"], tsolver.CHI2_MONO, tm)
    b = jsolver._total_cost(jp, vi["jcam"], vi["jR"], vi["jt"], jsolver.CHI2_MONO, jm)
    assert abs(float(a) - float(b)) <= 1e-5 * abs(float(b))


def _jax_first_reduced_system(jp, jcam, grouped):
    """(Sd_n, rhs) of the JAX package's first reduced solve: a fresh jit of
    the undecorated schur_ba with Cholesky and cho_solve wrapped in host
    callbacks."""
    cap = {"S": [], "b": []}
    chol, cho_solve = jnp.linalg.cholesky, jax.scipy.linalg.cho_solve

    def spy_chol(a):
        jax.debug.callback(lambda v: cap["S"].append(np.asarray(v)), a)
        return chol(a)

    def spy_solve(lo, b):
        jax.debug.callback(lambda v: cap["b"].append(np.asarray(v)), b)
        return cho_solve(lo, b)

    fn = jax.jit(jsolver.schur_ba.__wrapped__,
                 static_argnames=("n_iters", "huber_delta2", "deferred", "grouped_obs"))
    jnp.linalg.cholesky, jax.scipy.linalg.cho_solve = spy_chol, spy_solve
    try:
        out = fn(jp, jcam, jnp.asarray(I3), jnp.asarray(Z3), n_iters=1, grouped_obs=grouped)
        jax.block_until_ready(out)
        jax.effects_barrier()
    finally:
        jnp.linalg.cholesky, jax.scipy.linalg.cho_solve = chol, cho_solve
    return cap["S"][0], cap["b"][0]


@pytest.mark.parametrize("grouped", [0, SMALL["obs_per_kf"]])
def test_reduced_system(vi, grouped):
    """The Jacobi-scaled, damped reduced camera system of the first LM
    iteration (what K4 solves), flat and grouped assembly: matrix and
    right-hand side within 1e-4 relative to their largest entry. Not 1e-5:
    the landmark elimination Hcc - W Hll^-1 W^T cancels most of each pose
    block, which lifts the 1e-5 differences of the visual linearization
    (test_linearize) to 2.4e-5 in the scaled matrix (measured)."""
    jS, jb = _jax_first_reduced_system(vi["jp"], vi["jcam"], grouped)
    cap = []
    plain = chol_pallas.chol_solve_plain

    def spy(S, b):
        cap.append((S, b))
        return plain(S, b)

    chol_pallas.chol_solve_plain = spy
    try:
        tsolver.schur_ba(vi["tp"], vi["tcam"], vi["tR"], vi["tt"], n_iters=1,
                         grouped_obs=grouped)
    finally:
        chol_pallas.chol_solve_plain = plain
    tS, tb = cap[0]
    assert tS.shape == (1, 120, 120)
    _close(tS[0], jS, 1e-4, "Sd_n")
    _close(tb[0], jb, 1e-4, "rhs")


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("deferred", [True, False], ids=["deferred", "parallel"])
@pytest.mark.parametrize("grouped", [0, SMALL["obs_per_kf"]], ids=["flat", "grouped"])
def test_schur_ba(vi, deferred, grouped):
    """10 LM iterations on the visual-inertial small window, each layout and
    LM mode: cost0 within 1e-5 and the converged cost within 1e-3
    relative; the final poses within 1e-3 m and points within 1e-2 m (the
    iterates may part on an accept decision at equal cost)."""
    kw = dict(n_iters=10, deferred=deferred, grouped_obs=grouped)
    jkf, jpts, jinfo = jsolver.schur_ba(vi["jp"], vi["jcam"], vi["jR"], vi["jt"], **kw)
    tkf, tpts, tinfo = tsolver.schur_ba(vi["tp"], vi["tcam"], vi["tR"], vi["tt"], **kw)
    c0j, cj = float(jinfo["cost0"]), float(jinfo["cost"])
    assert cj < 0.5 * c0j  # the window really converges
    assert abs(float(tinfo["cost0"]) - c0j) <= 1e-5 * c0j
    assert abs(float(tinfo["cost"]) - cj) <= 1e-3 * cj
    assert tinfo["cost_hist"].shape == (10,)
    assert tinfo["obs_chi2"].shape == jinfo["obs_chi2"].shape
    assert np.max(np.abs(_np(tkf.t_wb) - np.asarray(jkf.t_wb))) < 1e-3
    assert np.max(np.abs(_np(tpts) - np.asarray(jpts))) < 1e-2


@pytest.mark.parametrize("D", [12, 96, 480])
def test_chol_solve_plain(D):
    """K4's plain version (the CPU path of `chol_solve`) against the TPU
    kernel run in interpret mode and against a float64 solve, on
    tests/test_pallas.py's SPD construction: both within 1e-5 relative."""
    rng = np.random.default_rng(40 + D)
    A = rng.normal(size=(D, D)).astype(np.float32)
    S = A @ A.T + D * np.eye(D, dtype=np.float32)
    b = rng.normal(size=D).astype(np.float32)
    x = chol_solve(torch.as_tensor(S), torch.as_tensor(b)).numpy().astype(np.float64)
    ref = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
    pal = np.asarray(chol_solve_pallas(jnp.asarray(S), jnp.asarray(b), interpret=True), np.float64)
    rel = lambda u, v: np.linalg.norm(u - v) / np.linalg.norm(v)
    assert rel(x, ref) < 1e-5
    assert rel(x, pal) < 1e-5


def test_chol_solve_batched_and_not_spd():
    """A leading batch axis solves each system; a matrix that is not
    positive definite gives NaN (as JAX's Cholesky) instead of raising."""
    rng = np.random.default_rng(9)
    A = rng.normal(size=(3, 20, 20)).astype(np.float32)
    S = A @ np.swapaxes(A, 1, 2) + 20 * np.eye(20, dtype=np.float32)
    S[2] = -S[2]
    b = rng.normal(size=(3, 20)).astype(np.float32)
    x = chol_solve(torch.as_tensor(S), torch.as_tensor(b)).numpy()
    for g in range(2):
        np.testing.assert_allclose(x[g], np.linalg.solve(S[g].astype(np.float64), b[g]),
                                   rtol=1e-5, atol=1e-6)
    assert np.isnan(x[2]).all()
    with pytest.raises(ValueError):
        chol_solve(torch.as_tensor(S), torch.as_tensor(b[:, :5]))


def test_chol_solve_not_spd_480():
    """The semantics K4's kernels are held to: in one batch, an SPD system
    is solved (within 1e-5 of float64), and the 480 x 480 indefinite
    system (one eigenvalue -1e-3) and a negative definite one come out
    all-NaN, as JAX's Cholesky solve (`solve_reduced`'s path) gives them."""
    rng = np.random.default_rng(480)
    S_spd, b_spd = chip_smoke.seeded_spd(480, rng)
    S = np.stack([S_spd[0], chip_smoke.seeded_not_spd(480, rng, "indefinite"),
                  chip_smoke.seeded_not_spd(480, rng, "negative definite")])
    b = np.stack([b_spd[0], np.ones(480, np.float32), np.ones(480, np.float32)])
    x = chol_solve(torch.as_tensor(S), torch.as_tensor(b)).numpy().astype(np.float64)
    ref = np.linalg.solve(S[0].astype(np.float64), b[0].astype(np.float64))
    assert np.linalg.norm(x[0] - ref) / np.linalg.norm(ref) < 1e-5
    assert np.isnan(x[1]).all() and np.isnan(x[2]).all()
    jx = np.asarray(jax.scipy.linalg.cho_solve((jnp.linalg.cholesky(jnp.asarray(S)), True),
                                               jnp.asarray(b)[..., None]))[..., 0]
    assert np.isfinite(jx[0]).all() and np.isnan(jx[1]).all() and np.isnan(jx[2]).all()


def test_chol_cluster_schedule():
    """The numpy emulation of K4's cluster schedule (rank ownership, one
    barrier per panel, look-ahead, the folded forward pass, the rank-0
    solves) at the ragged D = 465 (30 row blocks over 8 ranks): no tile is
    read and written by two ranks between two barriers, every rank holds
    the same pivot flag, and the solution lies within 1e-5 of float64; a
    non-SPD system raises the flag and comes out all-NaN. A guard on the
    experiment's model only: the kernel itself is held to float64 by
    tests/test_torch_cuda.py and chip_smoke.py on the card."""
    D = 465
    rng = np.random.default_rng(1000 + D)
    S, b = (a[0] for a in chip_smoke.seeded_spd(D, rng))
    x, cl, ok = chol_emulate.cluster_solve(S, b, chol_emulate.CLUSTER)
    ref = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
    assert ok and np.linalg.norm(x - ref) / np.linalg.norm(ref) < 1e-5
    T = -(-D // 16)
    assert cl.barriers == T + 5  # load, one per panel, end of factor, 3 around the solves
    x, _, ok = chol_emulate.cluster_solve(
        chip_smoke.seeded_not_spd(D, rng, "indefinite"), b, chol_emulate.CLUSTER)
    assert not ok and np.isnan(x).all()


@pytest.mark.parametrize("D", [769, 1000, 1440])
def test_chol_grid_schedule(D):
    """The numpy emulation of K4's large-D schedule (tiles in a work buffer
    shared by every block, one grid barrier per panel, every block's own
    factor of the next diagonal tile, the look-ahead, the folded forward
    pass, the leader's substitutions) at the first D past the cluster
    route, a ragged D and the full polish's 1440: no location is written by
    one task and touched by another between two barriers, every block
    holds the same Li and the same pivot flag, T + 4 barriers, and the
    solution lies within 1e-5 of float64; a non-SPD system raises the flag
    and comes out all-NaN. A guard on the experiment's model only: the
    kernel itself is held to float64 by tests/test_torch_cuda.py and
    chip_smoke.py on the card."""
    rng = np.random.default_rng(2000 + D)
    S, b = (a[0] for a in chip_smoke.seeded_spd(D, rng))
    x, g, ok = grid_emulate.grid_solve(S, b)
    ref = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
    assert ok and np.linalg.norm(x - ref) / np.linalg.norm(ref) < 1e-5
    T = -(-D // 16)
    assert g.barriers == T + 4
    assert g.tasks == sum((T - k - 2) * (T - k - 1) // 2 for k in range(T - 1)) + T * (T - 1) // 2
    if D == 1000:
        x, _, ok = grid_emulate.grid_solve(chip_smoke.seeded_not_spd(D, rng, "indefinite"), b)
        assert not ok and np.isnan(x).all()


def test_chol_grid_ledger_finds_a_race():
    """The emulation's ledger does fail when two tasks touch one location
    between two barriers (so its silence above means something)."""
    g = grid_emulate.Ledger()
    g.write("a", "tile", 1.0)
    with pytest.raises(AssertionError):
        g.read("b", "tile")
    g.sync()
    assert g.read("b", "tile") == 1.0
    with pytest.raises(AssertionError):
        g.write("a", "tile", 2.0)


# ---------------------------------------------------------------------------
# the bench window
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", ["small", "bench"])
def test_build_problem_matches_bench(size):
    """`bench_window.build_problem(seed=0)` and `bench.build_problem(seed=0)`
    make the same window: indices, masks and constants equal; states and
    points within 1e-6 (float32 rounding of the two exp maps); the valid
    observations' pixels within 1e-3 px."""
    kw = SMALL if size == "small" else {}
    jp, _ = bench.build_problem(seed=0, **kw)
    tp, cam = bench_window.build_problem(seed=0, **kw, device="cpu")
    cp = convert.ba_problem(jp, device="cpu")
    for name in ("obs_kf", "obs_pt", "obs_valid", "ie_i", "ie_j", "pt_active", "kf_dof",
                 "walk_inv_sigma", "obs_inv_sigma2", "prior_inv_sigma", "ie_valid",
                 "walk_valid"):
        assert torch.equal(getattr(tp, name), getattr(cp, name)), name
    for a, b in zip(tp.ie_edge, cp.ie_edge):
        assert torch.equal(a, b)
    for a, b in zip(list(tp.kf) + list(tp.prior_ref), list(cp.kf) + list(cp.prior_ref)):
        _close(a, b, 1e-6, "kf")
    _close(tp.points, cp.points, 1e-6, "points")
    v = _np(tp.obs_valid)
    assert np.max(np.abs(_np(tp.obs_uv)[v] - _np(cp.obs_uv)[v])) < 1e-3
    assert float(cam.fx) == np.float32(458.654)


def test_bench_window_full_size():
    """The whole bench window (24+8 KF, 2048 points, 6144 observations),
    flat layout, deferred LM, 10 iterations, each package on its own build
    of the window: cost0 within 1e-5 and the converged cost within 1e-3
    relative of the JAX package's (both measured on the CPU: cost0
    200982.56 and cost 1118.566 for JAX)."""
    jp, jcam = bench.build_problem(seed=0)
    tp, tcam = bench_window.build_problem(seed=0, device="cpu")
    _, _, jinfo = jsolver.schur_ba(jp, jcam, jnp.asarray(I3), jnp.asarray(Z3), n_iters=10)
    _, _, tinfo = tsolver.schur_ba(tp, tcam, torch.eye(3), torch.zeros(3), n_iters=10)
    c0, c = float(jinfo["cost0"]), float(jinfo["cost"])
    assert abs(float(tinfo["cost0"]) - c0) <= 1e-5 * c0
    assert abs(float(tinfo["cost"]) - c) <= 1e-3 * c


POLISH_SMALL = dict(n_kf=12, n_fixed=1, n_pts=256, obs_per_kf=48)


@pytest.mark.parametrize("deferred", [True, False], ids=["deferred", "parallel"])
def test_polish_window_small(deferred):
    """A polish-shaped window (every keyframe free but the anchor, grouped
    layout, 12 iterations, as chip_smoke.polish_ba runs at 96 keyframes),
    each package on its own build of the window: cost0 within 1e-4 and the
    converged cost within 1e-3 relative of the JAX package's, the
    tolerances `test_schur_ba` states."""
    jp, jcam = bench.build_problem(seed=0, **POLISH_SMALL)
    tp, tcam = bench_window.build_problem(seed=0, device="cpu", **POLISH_SMALL)
    kw = dict(n_iters=chip_smoke.POLISH_ITERS, deferred=deferred,
              grouped_obs=POLISH_SMALL["obs_per_kf"])
    _, _, jinfo = jsolver.schur_ba(jp, jcam, jnp.asarray(I3), jnp.asarray(Z3), **kw)
    _, tpts, tinfo = tsolver.schur_ba(tp, tcam, torch.eye(3), torch.zeros(3), **kw)
    c0, c = float(jinfo["cost0"]), float(jinfo["cost"])
    assert c < 0.05 * c0  # the window really converges
    assert abs(float(tinfo["cost0"]) - c0) <= 1e-4 * c0
    assert abs(float(tinfo["cost"]) - c) <= 1e-3 * c
    assert tinfo["cost_hist"].shape == (chip_smoke.POLISH_ITERS,)
    assert bool(torch.isfinite(tpts).all())


def test_polish_constants():
    """chip_smoke's polish window is the full polish's capacities of the
    JAX package's mapper config (full_k, full_p, full_opk), D = 15 K."""
    import inspect

    from monoorbslam3_tpu.backend import problems as jproblems

    owners = [c for c in vars(jproblems).values() if inspect.isclass(c)
              and "full_k" in inspect.signature(c.__init__).parameters]
    assert len(owners) == 1
    params = inspect.signature(owners[0].__init__).parameters
    w = chip_smoke.POLISH_WINDOW
    for name, val in (("full_k", w["n_kf"]), ("full_p", w["n_pts"]), ("full_opk", w["obs_per_kf"])):
        assert params[name].default == val, name
    assert all(kw["grouped_obs"] == w["obs_per_kf"] for kw in chip_smoke.POLISH_VARIANTS.values())
    assert 15 * w["n_kf"] == 1440
