"""Per-kernel times against the H100's bound (counterpart of the
repository's `bench_kernels.py`).

Prints one JSON line per row of the JAX script, at its shapes:

- `hamming_rt` (1,024 x 1,024) and `hamming_bulk` (8,192 x 8,192): K3,
  `[N, 8]` words against `[M, 8]` words to `[N, M]` int32 distances;
- `match_step_rt`: `projected_match` over 1,024 x 1,024 descriptors with
  the spatial gate, ratio and mutual check (K2, both passes);
- `orb_extract_frame`: the extractor on a 752x480 frame, 8 levels, 1,024
  features (K1 inside);
- `preintegrate_200`: one keyframe window of 200 IMU samples
  (`ImuBuffer.integrate`, the tree reduction);
- `schur_ba_iter`: one iteration of `schur_ba` on the bench window (K4's
  cluster route inside);

then one line per hand kernel at the main path's shapes: K1 on the
extraction's atlas with 1,024 corners, the atlas in L2 (as the extractor
finds it, just written) and from HBM (copies cycled past the L2); K2's two
launches of the gated match; K3 at 1,024 x 1,024 (the mapper searches'
shape; `hamming_rt` is that line); K4's cluster route on the bench
window's reduced system (D = 480) and its large-D route on a seeded SPD
system of the full polish's size (D = 1440).

Each line gives the device time (`timing.time_kernel`: calls enqueued
behind a sleep kernel between two CUDA events, 20 calls a window, or one
call a window for the launch-heavy rows; "not measured" where a row's
launches cannot be held) and the host-inclusive call time, the bound (the
larger of the bytes the function must move over 3.35 TB/s and its
operations over the peak of their type: int8 tensor 1,979 TOP/s for the
binary Hamming products, float32 67 TFLOP/s for the rest) with what bounds
it, the share of the bound, the yardstick (one PyTorch call for the same
function: the +-1 bf16 product on unpacked bit planes for K3, an index
into the atlas's window view for K1, `linalg.solve_ex` for K4; K2 and
the pipeline rows have none), and the check of each hand kernel on that
call against its plain version: bit-exact for K1-K3, within 1e-5 of float64
for K4. A failed check raises. The byte and operation counts are the work
these functions do on the card (`*_work` below), not the JAX script's.

    python -m monoorbslam3_tpu_torch.measure.bench_kernels             # the card
    python -m monoorbslam3_tpu_torch.measure.bench_kernels --device cpu  # counts only

With `--device cpu` every time reads "not measured" and nothing is
checked (the kernels have no CPU mode); the counts are printed. Without a
card and without `--device cpu` it raises.
"""

from __future__ import annotations

import argparse
import itertools
import json

import numpy as np
import torch

from ..backend.solver import schur_ba
from ..bench_window import build_problem
from ..models.imu import ImuBuffer, ImuCalib
from ..ops import chol_pallas, match_pallas, matching, pallas_kernels
from ..ops.image import pyramid_shapes
from ..ops.orb import OrbExtractor
from ..utils.device import CARD, resolve
from .timing import (F32_OPS_PER_S, INT8_OPS_PER_S, K2_GATE_OPS, NOT_MEASURED, TIMED_CALLS,
                     Capture, bound, device_identity, k1_bound, k2_bound, k3_bound, k4_bound,
                     time_kernel)

K4_RTOL = 1e-5
SRC = "monoorbslam3_tpu_torch/csrc/"
KERNELS = {
    "K1": (SRC + "gather_patches.cu", "monoorbslam3_tpu/ops/pallas_kernels.py:80"),
    "K2": (SRC + "match_rows.cu", "monoorbslam3_tpu/ops/match_pallas.py:43"),
    "K3": (SRC + "hamming.cu", "monoorbslam3_tpu/ops/pallas_kernels.py:28"),
    "K4": (SRC + "chol_solve.cu", "monoorbslam3_tpu/ops/chol_pallas.py:40"),
}
# the extractor's float32 work a pyramid pixel: the FAST ring's 16
# differences, 32 threshold compares (brighter and darker) and the 3x3
# non-maximum suppression's 8 compares; a keypoint's 256 BRIEF compares.
# The resampling, the patch blur and the angle are not counted: a lower
# bound.
FAST_OPS_PER_PX = 56
BRIEF_OPS = 256
# the preintegration's float32 work a sample, the recurrence of the
# reference (Imu.cpp:101-148): A C A^T on the 9x9 noise block (2 x 2 x 9^3),
# B Q B^T with a diagonal Q (2 x 9 x 9 x 6), ten 3x3 products of the
# Jacobian and delta updates (10 x 45) and 60 for the rest
PREINT_OPS_PER_SAMPLE = 2 * 2 * 9 ** 3 + 2 * 9 * 9 * 6 + 10 * 45 + 60
# the BA iteration's float32 work: an observation's residual and 2 x 9
# Jacobian (60), its Hessian blocks and gradients (pose 6x6 144, coupling
# 6x3 72, point 3x3 36, gradients 36) and its back-substitution (36); a
# point's 3x3 inverse (60); each pair of observations of one point in the
# Schur complement, W_i H_pp^-1 W_j^T (2 x (54 + 108)); an inertial edge's
# 9 x 30 Jacobian product (2 x 9 x 30 x 30); the reduced solve at
# D = 15 K (k4_bound's count)
BA_OPS_PER_OBS = 60 + 144 + 72 + 36 + 36 + 36
BA_OPS_PER_POINT = 60
BA_OPS_PER_PAIR = 2 * (54 + 108)
BA_OPS_PER_EDGE = 2 * 9 * 30 * 30
PREINT_EDGE_FLOATS = 9 + 3 + 3 + 5 * 9 + 3 + 3 + 1 + 81  # dR dV dP J* bg0 ba0 dt L_inv


def match_step_work(N, M):
    """`projected_match`'s inputs read once (both descriptor sets, uv_a,
    xy_b, the radius, both valid masks) and its outputs written once (idx,
    dist); both passes' binary products at the int8 peak and their gates
    and top-2 at the float32 peak."""
    n_bytes = (N + M) * 32 + (N + M) * 8 + 4 * N + (N + M) + 8 * N
    return bound(n_bytes, [(2 * 2 * 256 * N * M, INT8_OPS_PER_S),
                           (2 * K2_GATE_OPS * N * M, F32_OPS_PER_S)])


def orb_work(H, W, N, n_levels=8, scale=1.2):
    """The extractor reads the image and writes N features (xy 8, response,
    level, angle 4 each, descriptor 32, valid 1 bytes); its float32 work
    is FAST_OPS_PER_PX a pyramid pixel and BRIEF_OPS a feature."""
    px = sum(h * w for h, w in pyramid_shapes(H, W, n_levels, scale))
    return bound(4 * H * W + N * (8 + 4 + 4 + 4 + 32 + 1),
                 [(FAST_OPS_PER_PX * px + BRIEF_OPS * N, F32_OPS_PER_S)])


def preint_work(n):
    """n samples read (gyro, acc, dt: 7 floats), both biases read, and one
    Preintegrated written (dR 9, dV 3, dP 3, C 225, five Jacobians 45, dt
    1, bg 3, ba 3 floats); PREINT_OPS_PER_SAMPLE a sample."""
    return bound(4 * (7 * n + 6 + 292), [(PREINT_OPS_PER_SAMPLE * n, F32_OPS_PER_S)])


def ba_iter_work(n_kf, obs_pt, obs_valid, n_pts, n_edges):
    """One `schur_ba` iteration on a window: the observations read (kf and
    point indices 8 bytes each, uv 8, weight 4, valid 1), the points read
    and written (12 each, active 1), the keyframe states read and written
    (21 floats each) with their dof, prior weight and prior reference, the
    inertial edges and walk terms read. Operations (float32) from this
    window's own data: the pairs of valid observations of each point
    (sum of the squared counts) decide the Schur complement's work."""
    obs_pt = np.asarray(obs_pt)
    obs_valid = np.asarray(obs_valid, bool)
    counts = np.bincount(obs_pt[obs_valid], minlength=n_pts)
    n_obs = len(obs_pt)
    D = 15 * n_kf
    n_bytes = (29 * n_obs + 25 * n_pts + 4 * n_kf * (2 * 21 + 15 + 15 + 21)
               + n_edges * (4 * PREINT_EDGE_FLOATS + 8 + 8 + 1 + 4 * 6 + 1))
    ops = (BA_OPS_PER_OBS * int(obs_valid.sum()) + BA_OPS_PER_POINT * n_pts
           + BA_OPS_PER_PAIR * int((counts.astype(np.int64) ** 2).sum())
           + BA_OPS_PER_EDGE * n_edges + 2 * D ** 3 / 3 + 6 * D * D)
    return bound(n_bytes, [(ops, F32_OPS_PER_S)])


def _desc(rng, n, dev):
    return torch.as_tensor(rng.integers(0, 2**32, (n, 8), dtype=np.uint32).view(np.int32),
                           device=dev)


def _row(name, shape, work, note, kernel=None, identity=None, **timed):
    """One JSON line: the JAX script's keys (metric, value in us, unit, the
    bound in us, its share, shape, note) and the port's."""
    dev_ms = timed.get("device_ms", NOT_MEASURED)
    measured = isinstance(dev_ms, float)
    row = {"metric": f"kernel_{name}", "value": 1e3 * dev_ms if measured else NOT_MEASURED,
           "unit": "us", "bound_us": work["bound_us"], "bound_by": work["bound_by"],
           "share_of_bound": work["bound_ms"] / dev_ms if measured else NOT_MEASURED,
           "bytes": work["bytes"], "ops": work["ops"], "shape": shape, "note": note}
    if kernel is not None:
        row.update(kernel=kernel, source=KERNELS[kernel][0], replaces=KERNELS[kernel][1])
    row.update({k: timed.get(k, NOT_MEASURED)
                for k in ("device_ms", "call_ms", "plain_ms", "library_ms")})
    row.update({k: v for k, v in timed.items() if k not in row})
    row["device"] = identity
    return row


def _timed(fn, plain=None, library=None, n=TIMED_CALLS, reps=5, label=""):
    """device_ms, call_ms (and plain_ms, library_ms) of one call on the card."""
    out = {}
    out["device_ms"], out["call_ms"] = time_kernel(fn, label, n=n, reps=reps, held_only=True)
    if out["device_ms"] is None:
        out["device_ms"] = NOT_MEASURED
    for key, f in (("plain_ms", plain), ("library_ms", library)):
        if f is not None:
            out[key], _ = time_kernel(f, label, n=n, reps=reps)
    return out


def _same(got, ref, what):
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise RuntimeError(f"{what}: the kernel disagrees with its plain version")


def _k4_check(x, S, b, what):
    x64 = torch.linalg.solve(S.double(), b.double())
    err = float(((x.double() - x64).norm(dim=-1) / x64.norm(dim=-1)).max())
    if not err <= K4_RTOL:
        raise RuntimeError(f"{what}: K4 {err:.3e} from float64 (bound {K4_RTOL})")
    return dict(max_rel_vs_f64=err, tol=K4_RTOL)


def seeded_spd(D, rng, G=1):
    """G SPD systems A A^T + D I (tests/test_pallas.py's construction) and
    right-hand sides, float32 numpy."""
    A = rng.normal(size=(G, D, D)).astype(np.float32)
    S = A @ A.transpose(0, 2, 1) + D * np.eye(D, dtype=np.float32)
    return S, rng.normal(size=(G, D)).astype(np.float32)


def run(device=CARD, log=print) -> list:
    """Every row on `device`, each passed to `log` as it is made (JSON
    objects); returns them. On the CPU only the shapes and counts."""
    dev = resolve(device)
    on_card = dev.type == "cuda"
    ident = device_identity(dev)
    rows = []

    def emit(*a, **k):
        rows.append(_row(*a, identity=ident, **k))
        log(rows[-1])

    rng = np.random.default_rng(0)
    # ---- K3: the Hamming matrix, the mapper searches' and a bulk shape ---
    for N, M, tag in ((1024, 1024, "rt"), (8192, 8192, "bulk")):
        da, db = _desc(rng, N, dev), _desc(rng, M, dev)
        timed = {}
        if on_card:
            ref = pallas_kernels.hamming_matrix_plain(da, db)
            _same([pallas_kernels.hamming_matrix_cuda(da, db)], [ref], f"K3 {N}x{M}")
            pa, pb = (pallas_kernels.pm1_planes(d, torch.bfloat16) for d in (da, db))
            if not torch.equal((256 - (pa @ pb.T).float()) / 2, ref.float()):
                raise RuntimeError("K3's yardstick: the +-1 product is not 256 - 2 x the distance")
            del ref
            fast = N <= 1024
            timed = _timed(lambda: pallas_kernels.hamming_matrix_cuda(da, db),
                           plain=lambda: pallas_kernels.hamming_matrix_plain(da, db),
                           n=TIMED_CALLS if fast else 4, reps=5 if fast else 3, label=f"K3 {tag}")
            timed["library_ms"], _ = time_kernel(lambda: pa @ pb.T, "K3 yardstick")
            timed["library"] = "torch.matmul of the +-1 bf16 bit planes (unpacked beforehand)"
            timed["check"] = "bit-exact"
        emit(f"hamming_{tag}", f"{N}x{M}x256b", k3_bound(N, M),
             "K3: XOR + popcount on the binary tensor cores" + (
                 "; the mapper searches' shape" if tag == "rt" else ""), kernel="K3", **timed)

    # ---- K2: the gated match, both passes --------------------------------
    N = M = 1024
    da, db = _desc(rng, N, dev), _desc(rng, M, dev)
    uv = torch.as_tensor(rng.uniform(0, 700, (N, 2)).astype(np.float32), device=dev)
    xy = torch.as_tensor(rng.uniform(0, 700, (M, 2)).astype(np.float32), device=dev)
    rad = torch.full((N,), 15.0, device=dev)
    ones_a = torch.ones(N, dtype=torch.bool, device=dev)
    ones_b = torch.ones(M, dtype=torch.bool, device=dev)

    def match():
        return match_pallas.projected_match(da, db, uv_a=uv, xy_b=xy, radius=rad,
                                            valid_a=ones_a, valid_b=ones_b,
                                            max_dist=matching.TH_HIGH, ratio=0.9)

    timed, k2_calls = {}, []
    if on_card:
        with Capture(match_pallas, "_match_rows_cuda", maxlen=2) as cap:
            got = match()
        cpu = [t.cpu() for t in (da, db, uv, xy, rad, ones_a, ones_b)]
        ref = match_pallas.projected_match(cpu[0], cpu[1], uv_a=cpu[2], xy_b=cpu[3],
                                           radius=cpu[4], valid_a=cpu[5], valid_b=cpu[6],
                                           max_dist=matching.TH_HIGH, ratio=0.9)
        _same([g.cpu() for g in got], ref, "match_step_rt")
        k2_calls = list(cap.calls)
        timed = _timed(match, label="match_step_rt")
        timed["check"] = "bit-exact against the CPU's plain path"
    emit("match_step_rt", f"{N}x{M} gated", match_step_work(N, M),
         "K2 twice (rows, then the mutual pass) with the gate, ratio and mutual check",
         kernel="K2", **timed)

    # ---- the extractor on one frame (K1 inside) --------------------------
    H, W, NF = 480, 752, 1024
    ext = OrbExtractor(H, W, n_features=NF, device=dev)
    img = torch.as_tensor(rng.uniform(0, 255, (H, W)).astype(np.float32), device=dev)
    timed = {}
    if on_card:
        with Capture(pallas_kernels, "gather_patches_cuda", maxlen=1) as k1:
            ext(img)
        _same([pallas_kernels.gather_patches_cuda(*k1.calls[-1])],
              [pallas_kernels.gather_patches_plain(*k1.calls[-1])], "K1 in the extractor")
        timed = _timed(lambda: ext(img), n=1, label="orb_extract_frame")
        timed["check"] = "K1's launch bit-exact"
    emit("orb_extract_frame", f"{W}x{H}, 8 levels, {NF} features", orb_work(H, W, NF),
         "pyramid, FAST, grid selection, K1's atlas gather, angle, rBRIEF", kernel="K1", **timed)

    # ---- IMU preintegration: a 1 s keyframe window -------------------------
    calib = ImuCalib.create(R_bc=np.eye(3), t_bc=np.zeros(3), noise_gyro=1.7e-4, noise_acc=2e-3,
                            walk_gyro=2e-5, walk_acc=3e-3, freq=200.0, device=dev)
    buf = ImuBuffer()
    for _ in range(200):
        buf.add(rng.normal(0, 0.01, 3), [0, 0, 9.8] + rng.normal(0, 0.01, 3), 0.005)
    bg = torch.zeros(3, device=dev)
    timed = _timed(lambda: buf.integrate(bg, bg, calib), n=1, label="preintegrate_200") \
        if on_card else {}
    emit("preintegrate_200", "200 samples, 15x15 cov", preint_work(200),
         "the log-depth tree reduction (ImuBuffer.integrate); no hand kernel", **timed)

    # ---- one BA iteration on the bench window (K4 inside) ---------------
    problem, cam = build_problem(seed=0, device=dev)
    R_cb, t_cb = torch.eye(3, device=dev), torch.zeros(3, device=dev)
    ba1 = lambda: schur_ba(problem, cam, R_cb, t_cb, n_iters=1)  # noqa: E731
    timed, k4_sys = {}, None
    if on_card:
        with Capture(chol_pallas, "chol_solve_cuda", maxlen=1) as k4:
            ba1()
        k4_sys = k4.calls[-1]
        timed = _timed(ba1, n=1, label="schur_ba_iter")
        timed["check"] = _k4_check(chol_pallas.chol_solve_cuda(*k4_sys), *k4_sys,
                                   "K4 in the BA iteration")
    n_kf, n_pts = problem.kf_dof.shape[0], problem.points.shape[0]
    emit("schur_ba_iter", f"{n_kf} KF, {n_pts} pts, {problem.obs_kf.shape[0]} obs",
         ba_iter_work(n_kf, problem.obs_pt.cpu().numpy(), problem.obs_valid.cpu().numpy(), n_pts,
                      problem.ie_i.shape[0]),
         "relinearize + landmark Schur + reduced Cholesky (K4) + retract", kernel="K4", **timed)

    # ---- each hand kernel at the main path's shapes ---------------------
    atlas, ys, xs, _ = ext._detect(img)  # K1's inputs in the extractor
    k1_lines = (("K1_gather_atlas_in_l2", k1_bound(atlas, ys, xs, atlas_in_l2=True)),
                ("K1_gather_atlas_from_hbm", k1_bound(atlas, ys, xs)))
    S1440, b1440 = (torch.as_tensor(x, device=dev)
                    for x in seeded_spd(1440, np.random.default_rng(44)))
    k4_lines = (("K4_chol_cluster", k4_sys, "cluster", 480), ("K4_chol_large_d", (S1440, b1440),
                                                            "l2", 1440))
    if not on_card:
        for name, work in k1_lines:
            emit(name, f"atlas {tuple(atlas.shape)}, {ys.shape[0]} corners", work,
                 "K1: 48x48 windows from the pyramid atlas", kernel="K1")
        for label in ("rows", "transposed"):
            emit(f"K2_match_rows_{label}", "1024x1024", k2_bound(1024, 1024),
                 "K2: gated Hamming best, second and argmin a row", kernel="K2")
        for name, _, want, D in k4_lines:
            emit(name, f"D {D}, G 1", k4_bound(1, D), f"K4's {want} route", kernel="K4")
        return rows

    ref = pallas_kernels.gather_patches_plain(atlas, ys, xs)
    windows = atlas.unfold(0, 48, 1).unfold(1, 48, 1)
    y0 = ys.long().clamp(0, atlas.shape[0] - 48)
    x0 = xs.long().clamp(0, atlas.shape[1] - 48)
    if not torch.equal(windows[y0, x0], ref):
        raise RuntimeError("K1's yardstick computes another function")
    l2_bytes = getattr(torch.cuda.get_device_properties(dev), "L2_cache_size", 50 * 2 ** 20)
    atlases = itertools.cycle([atlas.clone() for _ in range(2 * l2_bytes // atlas.nbytes + 2)])
    fns = {"K1_gather_atlas_in_l2": lambda: pallas_kernels.gather_patches_cuda(atlas, ys, xs),
           "K1_gather_atlas_from_hbm": lambda: pallas_kernels.gather_patches_cuda(next(atlases),
                                                                                  ys, xs)}
    for name, work in k1_lines:
        timed = _timed(fns[name], plain=lambda: pallas_kernels.gather_patches_plain(atlas, ys, xs),
                       library=lambda: windows[y0, x0], label=name)
        timed.update(check="bit-exact", library="index into the atlas's unfold view of windows")
        emit(name, f"atlas {tuple(atlas.shape)}, {ys.shape[0]} corners", work,
             "K1: 48x48 windows from the pyramid atlas", kernel="K1", **timed)
    del atlases, fns

    for label, a in zip(("rows", "transposed"), k2_calls):
        _same(match_pallas._match_rows_cuda(*a), match_pallas._match_rows_plain(*a),
              f"K2 {label}")
        Na, Mb = a[0].shape[0], a[1].shape[0]
        timed = _timed(lambda: match_pallas._match_rows_cuda(*a),
                       plain=lambda: match_pallas._match_rows_plain(*a), label=f"K2 {label}")
        timed.update(check="bit-exact", library=None)
        emit(f"K2_match_rows_{label}", f"{Na}x{Mb}", k2_bound(Na, Mb),
             "K2: gated Hamming best, second and argmin a row; no single library call",
             kernel="K2", **timed)

    for name, (S, b), want, D in k4_lines:
        if S.shape[-1] != D or chol_pallas.route(D, dev) != want:
            raise RuntimeError(f"K4 D = {S.shape[-1]}: route {chol_pallas.route(D, dev)}, "
                               f"expected {want} at D = {D}")
        G = S.reshape(-1, D, D).shape[0]
        timed = _timed(lambda: chol_pallas.chol_solve_cuda(S, b),
                       plain=lambda: chol_pallas.chol_solve_plain(S, b),
                       library=lambda: torch.linalg.solve_ex(S, b), label=name)
        timed.update(check=_k4_check(chol_pallas.chol_solve_cuda(S, b), S, b, name),
                     library="torch.linalg.solve_ex", route=want)
        emit(name, f"D {D}, G {G}", k4_bound(G, D),
             f"K4's {want} route: blocked Cholesky, both substitutions, one f64-residual "
             "refinement", kernel="K4", **timed)
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=CARD.type, help="cuda (the card, default) or cpu")
    args = ap.parse_args(argv)
    return run(args.device, log=lambda row: print(json.dumps(row), flush=True))


if __name__ == "__main__":
    main()
