"""PyTorch port, matching (`monoorbslam3_tpu_torch/ops/match_pallas.py`,
`ops/matching.py`) against the JAX package on the CPU.

The port's `projected_match` on a CPU tensor runs K2's plain version. Its
idx and dist must be bit-identical to JAX's fused-XLA backend and to the
Pallas kernel in interpret mode: both are integer results of exact
distances and a first-occurrence argmin.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from monoorbslam3_tpu.ops import matching as jm
from monoorbslam3_tpu.ops.match_pallas import projected_match as j_projected_match
from monoorbslam3_tpu_torch import convert
from monoorbslam3_tpu_torch.ops import matching as tm
from monoorbslam3_tpu_torch.ops.match_pallas import projected_match as t_projected_match


def _mk(seed, N, M, n_groups=7, dup=True):
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    k = min(N, M) // 2
    db[:k] = da[:k]
    for i in range(k):  # correlated pairs so real matches exist
        db[i, rng.integers(0, 8)] ^= np.uint32(1) << np.uint32(rng.integers(0, 32))
    if dup:
        # exact duplicate columns (ties in best, second == best) and a
        # column at the same distance as another: first occurrence must win
        db[k + 1] = db[3]
        db[k + 2] = db[5]
        db[k + 2, 0] ^= np.uint32(1 << 31)  # flips bit 31 of word 0
    uv_a = rng.uniform(0, 700, (N, 2)).astype(np.float32)
    xy_b = rng.uniform(0, 700, (M, 2)).astype(np.float32)
    xy_b[:k] = uv_a[:k] + rng.normal(0, 4, (k, 2)).astype(np.float32)
    xy_b[k + 1] = xy_b[3]
    xy_b[k + 2] = xy_b[5]
    radius = rng.uniform(8, 20, N).astype(np.float32)
    va = rng.random(N) > 0.1
    vb = rng.random(M) > 0.1
    ga = rng.integers(-1, n_groups, N).astype(np.int32)
    gb = rng.integers(-1, n_groups, M).astype(np.int32)
    if dup:  # keep the duplicated rows and columns inside the gate
        va[[3, 5]] = True
        vb[[3, 5, k + 1, k + 2]] = True
        ga[[3, 5]] = -1
    return da, db, uv_a, xy_b, radius, va, vb, ga, gb


CASES = [
    # (N, M, spatial gate, groups, mutual, max_dist, ratio)
    (200, 300, True, True, True, jm.TH_HIGH, 0.9),
    (300, 200, True, False, False, jm.TH_LOW, 0.75),
    (200, 200, False, True, True, jm.TH_LOW, 0.75),
    (300, 300, False, False, False, jm.TH_HIGH, 0.8),
]


@pytest.mark.parametrize("backend", ["xla", "interpret"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_projected_match_bit_identical_to_jax(backend, case):
    N, M, spatial, groups, mutual, max_dist, ratio = CASES[case]
    da, db, uv_a, xy_b, radius, va, vb, ga, gb = _mk(case, N, M)
    kw_j = dict(valid_a=va, valid_b=vb, max_dist=max_dist, ratio=ratio, mutual=mutual)
    kw_t = dict(valid_a=torch.as_tensor(va), valid_b=torch.as_tensor(vb),
                max_dist=max_dist, ratio=ratio, mutual=mutual)
    if spatial:
        kw_j.update(uv_a=jnp.asarray(uv_a), xy_b=jnp.asarray(xy_b), radius=radius)
        kw_t.update(uv_a=torch.as_tensor(uv_a), xy_b=torch.as_tensor(xy_b),
                    radius=torch.as_tensor(radius))
    if groups:
        kw_j.update(groups_a=ga, groups_b=gb)
        kw_t.update(groups_a=torch.as_tensor(ga), groups_b=torch.as_tensor(gb))
    idx_j, dist_j = j_projected_match(da, db, backend=backend, **kw_j)
    idx_t, dist_t = t_projected_match(convert.desc_to_torch(da), convert.desc_to_torch(db),
                                      **kw_t)
    idx_j, dist_j = np.asarray(idx_j), np.asarray(dist_j)
    assert (idx_j >= 0).sum() > 10  # the case really matches something
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)  # tolerance: bit-identical
    np.testing.assert_array_equal(dist_t.numpy(), dist_j)


def test_match_rows_plain_ties_and_second():
    """Row-side stats on constructed duplicates: first occurrence wins and
    a duplicate of the best makes second == best, as `_match_rows_xla`."""
    from monoorbslam3_tpu.ops.match_pallas import _match_rows_xla
    from monoorbslam3_tpu_torch.ops.match_pallas import _match_rows_plain

    da, db, uv_a, xy_b, radius, va, vb, ga, gb = _mk(7, 200, 300)
    f = lambda x: np.asarray(x, np.float32)
    args = [f(uv_a[:, 0]), f(uv_a[:, 1]), f(radius**2), f(ga), f(va),
            f(xy_b[:, 0]), f(xy_b[:, 1]), np.full(300, 1e9, np.float32), f(gb), f(vb)]
    bj, sj, ij = (np.asarray(x) for x in _match_rows_xla(
        jnp.asarray(da), jnp.asarray(db), *map(jnp.asarray, args)))
    bt, st, it = _match_rows_plain(convert.desc_to_torch(da), convert.desc_to_torch(db),
                                   *map(torch.as_tensor, args))
    np.testing.assert_array_equal(bt.numpy(), bj)
    np.testing.assert_array_equal(st.numpy(), sj)
    np.testing.assert_array_equal(it.numpy(), ij)
    assert ((bj == sj) & (bj < 1e9)).any()  # the duplicates reached the output


def test_hamming_matrix_exact():
    rng = np.random.default_rng(3)
    a = rng.integers(0, 2**32, (37, 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (53, 8), dtype=np.uint32)
    a[0] = 0xFFFFFFFF
    b[0] = 0
    b[1] = 0x80000000
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    out = tm.hamming_matrix(convert.desc_to_torch(a), convert.desc_to_torch(b)).numpy()
    np.testing.assert_array_equal(out, ref)
    assert out[0, 0] == 256 and out[0, 1] == 248


@pytest.mark.parametrize("min_keep_frac", [0.0, 0.5])
def test_rotation_consistency_mask_ties_exact(min_keep_frac):
    """Tied histogram counts: lax.top_k keeps the lower bin first; the port's
    stable sort must pick the same bins."""
    N, M = 120, 90
    rng = np.random.default_rng(5)
    bin_w = 2 * np.pi / 30
    # four bins with 20 matches each (ties), then a few stragglers
    centers = np.array([3, 11, 17, 25, 7])
    counts = np.array([20, 20, 20, 20, 6])
    rot = np.concatenate([np.full(c, (b + 0.5) * bin_w) for b, c in zip(centers, counts)])
    rot = np.concatenate([rot, rng.uniform(0, 2 * np.pi, N - len(rot))])
    angles_b = rng.uniform(-np.pi, np.pi, M).astype(np.float32)
    match_idx = rng.integers(0, M, N).astype(np.int32)
    angles_a = (angles_b[match_idx] + rot - 2 * np.pi * (rng.random(N) > 0.5)).astype(np.float32)
    matched = rng.random(N) > 0.05
    ref = np.asarray(jm.rotation_consistency_mask(
        jnp.asarray(angles_a), jnp.asarray(angles_b), jnp.asarray(match_idx),
        jnp.asarray(matched), min_keep_frac=min_keep_frac))
    out = tm.rotation_consistency_mask(
        torch.as_tensor(angles_a), torch.as_tensor(angles_b),
        torch.as_tensor(match_idx).long(), torch.as_tensor(matched),
        min_keep_frac=min_keep_frac).numpy()
    np.testing.assert_array_equal(out, ref)


def test_match_descriptors_exact():
    da, db, uv_a, xy_b, radius, va, vb, ga, gb = _mk(9, 200, 300)
    mask = np.array(jm.projection_mask(jnp.asarray(uv_a), jnp.asarray(va), jnp.asarray(xy_b),
                                         jnp.asarray(vb), jnp.asarray(radius)))
    rng = np.random.default_rng(1)
    ang_a = rng.uniform(-np.pi, np.pi, 200).astype(np.float32)
    ang_b = rng.uniform(-np.pi, np.pi, 300).astype(np.float32)
    ij, dj = jm.match_descriptors(jnp.asarray(da), jnp.asarray(db), jnp.asarray(mask),
                                  jnp.asarray(ang_a), jnp.asarray(ang_b), use_rotation=True)
    it, dt = tm.match_descriptors(convert.desc_to_torch(da), convert.desc_to_torch(db),
                                  torch.as_tensor(mask), torch.as_tensor(ang_a),
                                  torch.as_tensor(ang_b), use_rotation=True)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))
