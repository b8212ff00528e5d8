"""PyTorch port, hand kernels on the card against their plain versions.

This file imports no jax, so it also runs on a machine with a CUDA card
and no JAX (skip the JAX-importing conftest there):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Without a CUDA device every test skips: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from monoorbslam3_tpu_torch.ops import cuda_lib
from monoorbslam3_tpu_torch.ops import pallas_kernels as tpk
from monoorbslam3_tpu_torch.ops.match_pallas import _match_rows, _match_rows_plain


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
def test_gather_kernel_matches_plain(cuda):
    """K1 at the extractor's shape (EuRoC atlas, K = 1024): bit-exact, and
    corners outside the atlas clamp like the plain version."""
    rng = np.random.default_rng(6)
    atlas = torch.as_tensor(rng.uniform(0, 255, (2274, 1024)).astype(np.float32), device=cuda)
    ys = rng.integers(0, 2274 - 48, 1024).astype(np.int32)
    xs = rng.integers(0, 1024 - 48, 1024).astype(np.int32)
    ys[:2], xs[:2] = [-5, 5000], [2000, -3]
    ys, xs = torch.as_tensor(ys, device=cuda), torch.as_tensor(xs, device=cuda)
    n0 = cuda_lib.launches["gather_patches"]
    out = tpk.gather_patches_dyn(atlas, ys, xs)
    torch.cuda.synchronize()
    assert cuda_lib.launches["gather_patches"] == n0 + 1
    assert torch.equal(out, tpk.gather_patches_plain(atlas, ys, xs))


def _match_args(N, M, device, seed=11):
    rng = np.random.default_rng(seed)
    da = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    db = rng.integers(0, 2**32, (M, 8), dtype=np.uint32)
    k = min(N, M) // 2
    db[:k] = da[:k]
    db[:k, 3] ^= np.uint32(1 << 31)
    uv = rng.uniform(0, 700, (N, 2))
    xy = rng.uniform(0, 700, (M, 2))
    xy[:k] = uv[:k] + rng.normal(0, 4, (k, 2))
    dup = min(k + 1, M - 1)
    db[dup], xy[dup] = db[0], xy[0]  # duplicate column: second == best, first index wins
    f = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    d = lambda x: torch.as_tensor(x.view(np.int32), device=device)
    rows = [d(da), d(db), f(uv[:, 0]), f(uv[:, 1]), f(rng.uniform(8, 20, N) ** 2),
            f(rng.integers(-1, 7, N)), f(rng.random(N) > 0.1),
            f(xy[:, 0]), f(xy[:, 1]), f(np.full(M, 1e9)), f(rng.integers(-1, 7, M)),
            f(rng.random(M) > 0.1)]
    cols = [rows[1], rows[0], *rows[7:12], *rows[2:7]]
    return rows, cols


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (4096, 1024), (200, 300), (5, 3)])
def test_match_kernel_matches_plain(cuda, shape):
    """K2 against its plain version in both directions: best, second and
    idx bit-identical (main-path shapes, ragged shapes, fewer columns than
    a block's column slices)."""
    for args in _match_args(*shape, cuda):
        n0 = cuda_lib.launches["match_rows"]
        out = _match_rows(*args)
        torch.cuda.synchronize()
        assert cuda_lib.launches["match_rows"] == n0 + 1
        for a, b in zip(out, _match_rows_plain(*args)):
            assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1024, 1024), (300, 513), (1, 70), (65, 1)])
def test_hamming_kernel_matches_plain(cuda, shape):
    """K3 at the mapper's shape and at ragged ones (not multiples of the
    64 x 64 tile): bit-identical to the plain XOR + popcount."""
    from monoorbslam3_tpu_torch.ops import pallas_kernels as pk

    rng = np.random.default_rng(21)
    a = rng.integers(0, 2**32, (shape[0], 8), dtype=np.uint32)
    b = rng.integers(0, 2**32, (shape[1], 8), dtype=np.uint32)
    b[: min(shape) // 2] = a[: min(shape) // 2]  # zero distances
    ta = torch.as_tensor(a.view(np.int32), device=cuda)
    tb = torch.as_tensor(b.view(np.int32), device=cuda)
    n0 = cuda_lib.launches["hamming"]
    out = pk.hamming_matrix_pallas(ta, tb)
    torch.cuda.synchronize()
    assert cuda_lib.launches["hamming"] == n0 + 1
    assert torch.equal(out, pk.hamming_matrix_plain(ta, tb))


@pytest.mark.gpu
@pytest.mark.parametrize("D", [12, 96, 480])
def test_chol_kernel_matches_f64(cuda, D):
    """K4 on seeded SPD systems (A A^T + D I, as tests/test_pallas.py builds
    them), batched G = 2: relative error below 1e-5 against a float64
    solve, and within 1e-5 of the plain version."""
    from monoorbslam3_tpu_torch.ops import chol_pallas as cp

    rng = np.random.default_rng(D)
    S = np.empty((2, D, D), np.float32)
    for g in range(2):
        A = rng.normal(size=(D, D)).astype(np.float32)
        S[g] = A @ A.T + D * np.eye(D, dtype=np.float32)
    b = rng.normal(size=(2, D)).astype(np.float32)
    tS, tb = torch.as_tensor(S, device=cuda), torch.as_tensor(b, device=cuda)
    n0 = cuda_lib.launches["chol_solve"]
    x = cp.chol_solve(tS, tb)
    torch.cuda.synchronize()
    assert cuda_lib.launches["chol_solve"] == n0 + 1
    xp = cp.chol_solve_plain(tS, tb).cpu().numpy().astype(np.float64)
    x = x.cpu().numpy().astype(np.float64)
    for g in range(2):
        ref = np.linalg.solve(S[g].astype(np.float64), b[g].astype(np.float64))
        assert np.linalg.norm(x[g] - ref) / np.linalg.norm(ref) < 1e-5
        assert np.linalg.norm(x[g] - xp[g]) / np.linalg.norm(xp[g]) < 1e-5
