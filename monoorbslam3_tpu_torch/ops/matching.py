"""Batched Hamming matching (counterpart of `monoorbslam3_tpu/ops/matching.py`).

Descriptors are [K, 8] 32-bit words held in int32 (torch's uint32 lacks
most ops). The distance is XOR + popcount in integer ops, exact: on a CUDA
tensor the hand kernel K3 (`pallas_kernels.hamming_matrix_cuda`), on a CPU
tensor its plain SWAR version. The JAX package rides the TPU's matrix unit
with a +-1 bf16 product instead, which is exact too, so both give the same
integers.

Thresholds follow ORBMatcher.cpp:13-15: TH_LOW=50, TH_HIGH=100,
HISTO_LENGTH=30.
"""

from __future__ import annotations

import math

import torch

from .fast import top_k_stable
from .pallas_kernels import hamming_matrix_pallas

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30
BIG = 1 << 20


def hamming_matrix(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """[N, 8] i32 x [M, 8] i32 -> [N, M] int32 Hamming distances (K3 on a
    CUDA tensor, its plain version on a CPU tensor)."""
    return hamming_matrix_pallas(desc_a, desc_b)


def rotation_consistency_mask(angles_a, angles_b, match_idx, matched,
                              min_keep_frac: float = 0.0):
    """Keep only matches whose orientation difference lands in one of the 3
    dominant histogram bins (ORBMatcher.cpp:594-622); see the JAX docstring
    for `min_keep_frac`. Ties between bins resolve to the lower bin, as
    `lax.top_k` does."""
    two_pi = 2.0 * math.pi
    rot = angles_a - angles_b[match_idx]
    # jnp.mod: fmod, then shift a remainder whose sign differs from 2*pi
    rot = torch.fmod(rot, two_pi)
    rot = torch.where((rot != 0) & (rot < 0), rot + two_pi, rot)
    bins = torch.clamp((rot * (HISTO_LENGTH / two_pi)).to(torch.int32), 0, HISTO_LENGTH - 1)
    counts = torch.zeros(HISTO_LENGTH, dtype=torch.int32, device=rot.device)
    counts = counts.index_add(0, bins.long(), matched.to(torch.int32))
    (c1, c2, c3), (i1, i2, i3) = top_k_stable(counts, 3)
    keep2 = c2.to(torch.float32) > 0.1 * c1.to(torch.float32)
    keep3 = c3.to(torch.float32) > 0.1 * c1.to(torch.float32)
    ok = (bins == i1) | (keep2 & (bins == i2)) | (keep3 & (bins == i3))
    if min_keep_frac > 0.0:
        n_match = torch.clamp(matched.sum(), min=1)
        kept = (matched & ok).sum()
        ok = ok | (kept < min_keep_frac * n_match)
    return matched & ok


def masked_nn_match(dists, pair_mask, max_dist=TH_LOW, ratio=0.9,
                    mutual: bool = True, use_ratio: bool = True):
    """Row-wise best match under a candidate mask.

    Returns (match_idx [N] int32 (-1 = none), match_dist [N] int32)."""
    d = torch.where(pair_mask, dists, torch.full_like(dists, BIG))
    vals, idx = torch.sort(d, dim=1, stable=True)  # ascending, first index first
    best, second, best_idx = vals[:, 0], vals[:, 1], idx[:, 0]
    ok = best <= max_dist
    if use_ratio:
        # strict <: a perfect duplicate (best == second) must fail the test
        ok &= best.to(torch.float32) < ratio * second.to(torch.float32)
    if mutual:
        col_best = torch.argmin(d, dim=0)  # first occurrence
        ok &= col_best[best_idx] == torch.arange(d.shape[0], device=d.device)
    idx_out = torch.where(ok, best_idx, torch.full_like(best_idx, -1))
    dist = torch.where(ok, best, torch.full_like(best, BIG))
    return idx_out.to(torch.int32), dist


def window_mask(xy_a, xy_b, valid_a, valid_b, radius):
    """[N,2] x [M,2] -> [N,M] bool: |dx|<r and |dy|<r (init search window,
    ORBMatcher.cpp:47-57)."""
    dx = torch.abs(xy_a[:, None, 0] - xy_b[None, :, 0])
    dy = torch.abs(xy_a[:, None, 1] - xy_b[None, :, 1])
    return (dx < radius) & (dy < radius) & valid_a[:, None] & valid_b[None, :]


def projection_mask(proj_uv, proj_valid, xy_b, valid_b, radius,
                    level_b=None, level_min=None, level_max=None):
    """Circular search-region mask for projection-guided matching
    (ORBMatcher.cpp:203-415): predicted projections [N, 2] with validity
    [N] against target keypoints [M, 2] with validity [M], per-source
    radius [N]; optional target-level band [level_min, level_max]."""
    dx = proj_uv[:, None, 0] - xy_b[None, :, 0]
    dy = proj_uv[:, None, 1] - xy_b[None, :, 1]
    m = (dx * dx + dy * dy) < (radius[:, None] ** 2)
    m &= proj_valid[:, None] & valid_b[None, :]
    if level_b is not None:
        m &= (level_b[None, :] >= level_min[:, None]) & (level_b[None, :] <= level_max[:, None])
    return m


def node_mask(words_a, words_b, valid_a, valid_b):
    """Vocabulary-node equality mask, the dense analog of iterating shared
    FeatureVector nodes in SearchByBow (ORBMatcher.cpp:131-185)."""
    return ((words_a[:, None] == words_b[None, :]) & valid_a[:, None]
            & valid_b[None, :] & (words_a[:, None] >= 0))


def node_gate(groups_a, groups_b):
    """Vocabulary-node gate: same-node pairs pass; a side with group < 0
    passes everything."""
    ga = groups_a[:, None]
    gb = groups_b[None, :]
    return (ga == gb) | (ga < 0) | (gb < 0)


def match_descriptors(desc_a, desc_b, pair_mask, angles_a=None, angles_b=None,
                      max_dist=TH_LOW, ratio=0.9, mutual=True, use_ratio=True,
                      use_rotation=False):
    """Full matching step: Hamming + masked NN + optional rotation histogram."""
    dists = hamming_matrix(desc_a, desc_b)
    idx, dist = masked_nn_match(dists, pair_mask, max_dist, ratio, mutual, use_ratio)
    matched = idx >= 0
    if use_rotation:
        matched = rotation_consistency_mask(angles_a, angles_b,
                                            torch.clamp(idx, min=0).long(), matched)
        idx = torch.where(matched, idx, torch.full_like(idx, -1))
    return idx, torch.where(matched, dist, torch.full_like(dist, BIG))
