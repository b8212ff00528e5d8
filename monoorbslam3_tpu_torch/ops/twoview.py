"""Batched two-view reconstruction: H/F RANSAC, decomposition, cheirality
(counterpart of `monoorbslam3_tpu/ops/twoview.py`).

The analog of the reference TwoViewReconstruction
(modules/Frontend/TwoViewReconstruction.cpp), as the JAX package designs
it: both model families' hypotheses are DLT-solved and scored in one
batched pass; ReconstructH's 8 Faugeras hypotheses and ReconstructF's 4
E-decomposition hypotheses form one 12-slot motion bank that CheckRT
triangulates and scores against every match at once; the family is chosen
by RH = SH / (SH + SF) > 0.45.

The RANSAC samples are an input. The JAX package draws them inside its
jitted bootstrap with `jax.random.choice` from a key the tracker splits
per attempt; `draw_samples` draws the same indices on the host
(`utils.prng`, bit for bit), and `reconstruct_two_views` takes the
[n_iters, 8] index tensor. Everything runs on the inputs'
device as plain torch; the batched SVDs (`torch.linalg.svd` has no
variant without its host-side convergence check) are the only host syncs
of an attempt on the card. Inverses, determinants, the winner's selection
and the constants avoid theirs (`inv_ex`, closed-form 3x3 determinants,
`index_select` by a device index, constants copied from pinned memory).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import prng

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_TH = 5.991  # the reference scores both models against 5.991
MIN_TRIANGULATED = 50
# the reference's minParallax (1.0 deg); see the JAX module for why the
# port keeps the reference's value
MIN_PARALLAX_DEG = 1.0


def _det3_rows(M: torch.Tensor) -> torch.Tensor:
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            + M[..., 0, 1] * (M[..., 1, 2] * M[..., 2, 0] - M[..., 1, 0] * M[..., 2, 2])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d index tensor, without reading the index on the host
    (indexing with a tensor scalar converts it to a Python int)."""
    return x.index_select(0, i.reshape(1))[0]


def _vector(values, like: torch.Tensor) -> torch.Tensor:
    """A small constant vector on `like`'s device, copied from pinned memory
    without a host wait (a copy from pageable memory, or a Python scalar
    written into a device tensor, waits for the device's queue)."""
    out = torch.tensor(values, dtype=like.dtype)
    if like.is_cuda:
        out = out.pin_memory().to(like.device, non_blocking=True)
    return out


def _inv(M: torch.Tensor) -> torch.Tensor:
    """Matrix inverse without the host-side error check of `linalg.inv`
    (a singular input gives non-finite entries, as in JAX)."""
    return torch.linalg.inv_ex(M)[0]


def _masked_normalize(xy, valid):
    """Hartley normalization over the valid points: zero mean, unit mean
    absolute deviation. Returns (xy_n, mean, s, T) with
    xy_n = T @ [xy, 1]."""
    w = valid.to(torch.float32)
    n = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(xy * w[:, None], dim=0) / n
    d = torch.abs(xy - mean) * w[:, None]
    mean_dev = torch.sum(d, dim=0) / n
    s = 1.0 / torch.clamp(mean_dev, min=1e-6)
    xy_n = (xy - mean) * s
    zero, one = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return xy_n, mean, s, T


def _null_vector(A):
    """The right singular vector of the smallest singular value of each
    [..., m, 9] system (`Vt[-1]` of the full SVD)."""
    _, _, Vt = torch.linalg.svd(A, full_matrices=True)
    return Vt[..., -1, :]


def _dlt_homography(p1, p2):
    """[S, 8, 2] x [S, 8, 2] -> [S, 3, 3] homographies via a batched SVD
    (reference ComputeH21, TwoViewReconstruction.cpp:163-193)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    zero = torch.zeros_like(x1)
    one = torch.ones_like(x1)
    rows_a = torch.stack([zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], dim=-1)
    rows_b = torch.stack([x1, y1, one, zero, zero, zero, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)  # [S, 16, 9]
    h = _null_vector(A)
    return h.reshape(*h.shape[:-1], 3, 3)


def _dlt_fundamental(p1, p2):
    """[S, 8, 2] x [S, 8, 2] -> [S, 3, 3] rank-2 fundamental matrices
    (reference ComputeF21, TwoViewReconstruction.cpp:195-225)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)
    F = _null_vector(A).reshape(*A.shape[:-2], 3, 3)
    # enforce rank 2
    U, S, Vt2 = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., :, None] * Vt2)


def _score_homography(H21, xy1, xy2, valid, sigma2=1.0):
    """Symmetric-transfer score (reference CheckHomography, .cpp:227-303)
    of H21 [..., 3, 3] over the matches [N]: (score [...], ok [..., N])."""
    H12 = _inv(H21)

    def transfer(H, a, b):
        h = H[..., None, :, :]
        x = h[..., 0, 0] * a[:, 0] + h[..., 0, 1] * a[:, 1] + h[..., 0, 2]
        y = h[..., 1, 0] * a[:, 0] + h[..., 1, 1] * a[:, 1] + h[..., 1, 2]
        z = h[..., 2, 0] * a[:, 0] + h[..., 2, 1] * a[:, 1] + h[..., 2, 2]
        zi = 1.0 / torch.where(torch.abs(z) < 1e-12, torch.full_like(z, 1e-12), z)
        du = x * zi - b[:, 0]
        dv = y * zi - b[:, 1]
        return (du * du + dv * dv) / sigma2

    chi2_21 = transfer(H21, xy1, xy2)
    chi2_12 = transfer(H12, xy2, xy1)
    ok = (chi2_21 < CHI2_H) & (chi2_12 < CHI2_H) & valid
    score = torch.sum(torch.where(ok, (SCORE_TH - chi2_21) + (SCORE_TH - chi2_12),
                                  torch.zeros_like(chi2_21)), dim=-1)
    return score, ok


def _score_fundamental(F21, xy1, xy2, valid, sigma2=1.0):
    """Epipolar-distance score (reference CheckFundamental, .cpp:305-345)
    of F21 [..., 3, 3] over the matches [N]: (score [...], ok [..., N])."""
    one1 = torch.ones_like(xy1[:, :1])
    p1 = torch.cat([xy1, one1], dim=-1)  # [N, 3]
    p2 = torch.cat([xy2, one1], dim=-1)
    l2 = p1 @ F21.transpose(-1, -2)  # [..., N, 3] epipolar lines in image 2
    l1 = p2 @ F21
    num2 = torch.sum(l2 * p2, dim=-1)
    num1 = torch.sum(l1 * p1, dim=-1)
    d2 = num2 * num2 / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12) / sigma2
    d1 = num1 * num1 / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12) / sigma2
    ok = (d2 < CHI2_F) & (d1 < CHI2_F) & valid
    score = torch.sum(torch.where(ok, (SCORE_TH - d2) + (SCORE_TH - d1), torch.zeros_like(d2)),
                      dim=-1)
    return score, ok


def triangulate_dlt(P1, P2, xy1, xy2):
    """Batched linear triangulation (reference Triangulate, .cpp:689-705).

    P1, P2: [3, 4] (or broadcastable leading dims); xy1, xy2: [..., 2].
    Returns [..., 3] points: the inhomogeneous DLT (w = 1 gauge) solved
    from its 3x3 normal equations in closed form (Cramer), with the
    determinant guarded at 1e-20."""
    rows = [
        xy1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        xy1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        xy2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        xy2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(torch.broadcast_tensors(*rows), dim=-2)  # [..., 4, 4]
    A1 = A[..., :3]
    a4 = A[..., 3]
    M = torch.einsum("...ri,...rj->...ij", A1, A1)
    b = -torch.einsum("...ri,...r->...i", A1, a4)
    det = _det3_rows(M)
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)

    def cram(col):
        Mi = M.clone()
        Mi[..., :, col] = b
        return _det3_rows(Mi) / det

    return torch.stack([cram(0), cram(1), cram(2)], dim=-1)


def decompose_essential(E):
    """E -> 4 motion hypotheses (R [4, 3, 3], t [4, 3] unit) — reference
    DecomposeE (.cpp:707-725)."""
    U, _, Vt = torch.linalg.svd(E)
    # proper rotations
    U = U * torch.sign(_det3_rows(U))
    Vt = Vt * torch.sign(_det3_rows(Vt))
    W = _vector([0.0, -1.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0], E).reshape(3, 3)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_homography(H, K):
    """Faugeras SVD decomposition of a calibrated homography into 8 motion
    hypotheses (reference ReconstructH, .cpp:347-476).

    Returns (R [8, 3, 3], t [8, 3] unit-normalized)."""
    A = _inv(K) @ H @ K
    U, S, Vt = torch.linalg.svd(A)
    s = _det3_rows(U) * _det3_rows(Vt)
    d1, d2, d3 = S[0], S[1], S[2]

    # guard: d1 > d2 > d3 strictly for the generic formulas
    eps = 1e-8
    d1 = torch.maximum(d1, d2 + eps)
    d3 = torch.minimum(d3, d2 - eps)

    aux1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), min=0.0))
    aux3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), min=0.0))
    x1s = _vector([1.0, 1.0, -1.0, -1.0], H) * aux1
    x3s = _vector([1.0, -1.0, 1.0, -1.0], H) * aux3
    signs = _vector([1.0, -1.0, -1.0, 1.0], H)
    root = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))
    zero = torch.zeros(4, dtype=H.dtype, device=H.device)
    one = torch.ones_like(zero)

    # case d' = d2 (positive): rotation about y by theta
    stheta = signs * (root / ((d1 + d3) * d2))
    ctheta = ((d2 * d2 + d1 * d3) / ((d1 + d3) * d2)).expand(4)
    Rp = torch.stack([torch.stack([ctheta, zero, -stheta], -1),
                      torch.stack([zero, one, zero], -1),
                      torch.stack([stheta, zero, ctheta], -1)], -2)
    tp = torch.stack([x1s, zero, -x3s], -1) * (d1 - d3)

    # case d' = -d2: rotation by phi with a flip
    sphi = signs * (root / ((d1 - d3) * d2))
    cphi = ((d1 * d3 - d2 * d2) / ((d1 - d3) * d2)).expand(4)
    Rn = torch.stack([torch.stack([cphi, zero, sphi], -1),
                      torch.stack([zero, -one, zero], -1),
                      torch.stack([sphi, zero, -cphi], -1)], -2)
    tn = torch.stack([x1s, zero, x3s], -1) * (d1 + d3)

    Rs = s * (U @ torch.cat([Rp, Rn]) @ Vt)
    ts = torch.cat([tp, tn]) @ U.T
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-12)
    return Rs, ts


def check_rt(R, t, xy1, xy2, valid, K, sigma2=1.0, th_chi2=4.0):
    """Batched CheckRT (reference .cpp:598-688): triangulate every match
    under each motion hypothesis (R [..., 3, 3], t [..., 3]) and gate on
    cheirality, parallax and reprojection. Returns (n_good [...],
    points [..., N, 3] in frame 1, good [..., N], parallax_cos [...])."""
    zcol = torch.zeros((3, 1), dtype=K.dtype, device=K.device)
    P1 = torch.cat([K, zcol], dim=1)
    P2 = K @ torch.cat([R, t[..., :, None]], dim=-1)  # [..., 3, 4]

    X = triangulate_dlt(P1, P2[..., None, :, :], xy1, xy2)  # [..., N, 3] frame 1
    finite = torch.all(torch.isfinite(X), dim=-1)

    O2 = -(R.transpose(-1, -2) @ t[..., :, None])[..., 0]  # camera-2 centre in frame 1
    n1 = X
    n2 = X - O2[..., None, :]
    d1 = torch.linalg.norm(n1, dim=-1)
    d2 = torch.linalg.norm(n2, dim=-1)
    cos_par = torch.sum(n1 * n2, dim=-1) / torch.clamp(d1 * d2, min=1e-12)

    z1 = X[..., 2]
    Xc2 = X @ R.transpose(-1, -2) + t[..., None, :]
    z2 = Xc2[..., 2]

    def reproj(Xc, z, xy):
        zs = torch.clamp(z, min=1e-9)
        uv = torch.stack([K[0, 0] * Xc[..., 0] / zs + K[0, 2],
                          K[1, 1] * Xc[..., 1] / zs + K[1, 2]], dim=-1)
        return torch.sum((uv - xy) ** 2, dim=-1) / sigma2

    e1 = reproj(X, z1, xy1)
    e2 = reproj(Xc2, z2, xy2)

    has_parallax = cos_par < 0.99998
    good = (valid & finite & (z1 > 0) & (z2 > 0) & has_parallax
            & (e1 < th_chi2) & (e2 < th_chi2))
    n_good = torch.sum(good, dim=-1)

    # parallax statistic: the ~50th-best parallax among the good points
    # (the reference takes min(50th, last) of the sorted parallaxes,
    # .cpp:676-682)
    cos_masked = torch.where(good, cos_par, torch.ones_like(cos_par))
    sorted_cos = torch.sort(cos_masked, dim=-1).values  # ascending: best first
    idx = torch.clamp(n_good - 1, min=0, max=49)
    parallax_cos = torch.gather(sorted_cos, -1, idx[..., None])[..., 0]
    return n_good, X, good, parallax_cos


def draw_samples(key, valid, n_iters=200):
    """RANSAC's [n_iters, 8] sample indices (numpy int64) under the JAX
    PRNG key `key` (uint32 [2], `utils.prng`) over the host mask `valid`
    [N]: the JAX package's `jax.random.choice(key, N, (n_iters, 8),
    p=valid / n_valid)`, bit for bit. With no valid match every index is
    0, as JAX's."""
    return prng.choice_with_p(key, np.asarray(valid, bool), (n_iters, 8))


def reconstruct_two_views(xy1, xy2, valid, K, sample_idx, sigma2=1.0, n_iters=200):
    """Full two-view bootstrap (reference Reconstruct, .cpp:14-83) from the
    RANSAC samples `sample_idx` [n_iters, 8] (`draw_samples`, the JAX
    package's draws).

    xy1, xy2: [N, 2] ideal pixels of the matches; valid: [N] bool; K: the
    ideal intrinsics [3, 3]. Returns a dict of tensors on the inputs'
    device: success (bool), R [3, 3], t [3] (frame 1 -> frame 2, unit),
    points [N, 3] in frame 1, good [N], rh (score ratio), n_good,
    parallax_deg and the acceptance diagnostics (n_good_all, n_similar,
    n_inliers, min_good), as the JAX package's."""
    if sample_idx.shape != (n_iters, 8):
        raise ValueError(f"sample_idx of shape {tuple(sample_idx.shape)}, "
                         f"expected ({n_iters}, 8)")
    idx = sample_idx.long()
    s1 = xy1[idx]  # [S, 8, 2]
    s2 = xy2[idx]

    _, mean1, sc1, T1 = _masked_normalize(xy1, valid)
    _, mean2, sc2, T2 = _masked_normalize(xy2, valid)
    s1n = (s1 - mean1) * sc1  # Hartley-normalized samples
    s2n = (s2 - mean2) * sc2

    Hn = _dlt_homography(s1n, s2n)  # [S, 3, 3]
    Fn = _dlt_fundamental(s1n, s2n)
    H_all = _inv(T2)[None] @ Hn @ T1[None]
    F_all = T2.T[None] @ Fn @ T1[None]

    score_h, _ = _score_homography(H_all, xy1, xy2, valid, sigma2)
    score_f, _ = _score_fundamental(F_all, xy1, xy2, valid, sigma2)

    bh = torch.argmax(score_h)
    bf = torch.argmax(score_f)
    H_best = _take(H_all, bh)
    F_best = _take(F_all, bf)
    SH = _take(score_h, bh)
    SF = _take(score_f, bf)
    _, inliers_h = _score_homography(H_best, xy1, xy2, valid, sigma2)
    _, inliers_f = _score_fundamental(F_best, xy1, xy2, valid, sigma2)

    rh = SH / torch.clamp(SH + SF, min=1e-12)
    # model selection at RH > 0.45, as the JAX package (see its comment)
    use_h = rh > 0.45

    # joint 12-slot motion-hypothesis bank
    Rh, th = decompose_homography(H_best, K)  # [8, ...]
    E = K.T @ F_best @ K
    Rf, tf = decompose_essential(E)  # [4, ...]
    Rs = torch.cat([Rh, Rf])
    ts = torch.cat([th, tf])
    family_h = torch.arange(12, device=xy1.device) < 8
    active = torch.where(use_h, family_h, ~family_h)
    model_inliers = torch.where(use_h, inliers_h, inliers_f)

    n_good, X, good, par_cos = check_rt(Rs, ts, xy1, xy2, model_inliers, K, sigma2,
                                        th_chi2=4.0 * sigma2)
    n_good = torch.where(active, n_good, torch.full_like(n_good, -1))

    best = torch.argmax(n_good)
    best_n = _take(n_good, best)
    n_inl = torch.sum(model_inliers)

    # acceptance (reference ReconstructF, .cpp:536-559): a clear winner with
    # enough triangulated points and parallax
    n_similar = torch.sum(n_good > 0.75 * best_n)
    min_good = torch.clamp(0.7 * n_inl, min=float(MIN_TRIANGULATED))
    par_deg = torch.rad2deg(torch.arccos(torch.clamp(_take(par_cos, best), -1.0, 1.0)))
    success = (best_n >= min_good) & (n_similar == 1) & (par_deg > MIN_PARALLAX_DEG)

    return {
        "success": success,
        "R": _take(Rs, best),
        "t": _take(ts, best),
        "points": _take(X, best),
        "good": _take(good, best),
        "rh": rh,
        "n_good": best_n,
        "parallax_deg": par_deg,
        "n_good_all": n_good,
        "n_similar": n_similar,
        "n_inliers": n_inl,
        "min_good": min_good,
    }
