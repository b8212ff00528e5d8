"""K4: the dense SPD Cholesky solve (counterpart of `chol_solve_pallas` in
`monoorbslam3_tpu/ops/chol_pallas.py`).

Solves S x = b for a batch of G symmetric positive definite [D, D] float32
systems: factor S = L L^T, then forward and back substitution, then one
refinement step (the residual b - S x accumulated in float64, solved with
the same factor and added). It is the reduced-camera solve of
`backend/solver.schur_ba` (D = 15 K, 480 on the bench window; G = 1 for the
deferred LM, 2 for the parallel-lambda LM).

The refinement step is the port's addition to the TPU kernel. An f32
Cholesky solve of the BA's Jacobi-scaled reduced systems (condition ~1.6e3)
lands up to 8e-4 (relative) from the float64 solution, whichever library
computes it; with the step it lands below 1e-6 (measured on the CPU on the
bench window's systems). The polish window's systems (D = 1440, condition
~4.8e4) land 2e-4 to 6e-4 from float64 after the step, kernel and plain
version alike (measured on an H100 by `chip_smoke.py`).

`chol_solve` dispatches on the device: a CUDA tensor launches a hand kernel
of `csrc/chol_solve.cu`, a CPU tensor takes `chol_solve_plain`,
`torch.linalg.cholesky_ex` + `torch.cholesky_solve` (the JAX package's own
off-TPU path is `jnp.linalg.cholesky` + `cho_solve`) with the same
refinement step. On the card the kernel is chosen by D (`route`):

- D <= the cluster route's capacity (768 on an H100 with clusters of 8
  blocks, `cluster_shape`): one thread-block cluster per system, the
  factor held in the blocks' shared memory (`chol_solve_cluster`, counter
  `chol_solve`);
- larger D (the full polish's 1440): one cooperative launch that spreads
  each system over the card's SMs, the factor in 16 x 16 tiles of a working
  copy that stays in the L2 cache (`chol_solve_l2`, counter
  `chol_solve_l2`); up to two systems share the grid at a time.

Both are hand kernels; a launch either route refuses raises. A matrix that
is not positive definite (a pivot that is not > 0, NaN included) gives an
all-NaN solution for that system, in the plain version (`cholesky_ex`'s
info), in both kernels and in JAX's Cholesky alike; nothing raises
(raising would need a host read of the factorization status).
"""

from __future__ import annotations

import torch

from . import cuda_lib


def _check_inputs(S: torch.Tensor, b: torch.Tensor):
    if S.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"chol_solve: float32 inputs required, got {S.dtype}, {b.dtype}")
    if S.dim() < 2 or S.shape[-1] != S.shape[-2]:
        raise ValueError(f"chol_solve: S must be [..., D, D], got {tuple(S.shape)}")
    if b.shape != S.shape[:-1]:
        raise ValueError(f"chol_solve: b {tuple(b.shape)} does not match S {tuple(S.shape)}")
    if b.device != S.device:
        raise ValueError("chol_solve: S and b lie on different devices")


def chol_solve_plain(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., D, D], [..., D] -> [..., D] by the library Cholesky, plus one
    refinement step with a float64 residual."""
    L, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(b[..., None], L)
    r = (b.double()[..., None] - S.double() @ x.double()).float()
    x = (x + torch.cholesky_solve(r, L)).squeeze(-1)
    return torch.where((info == 0)[..., None], x, torch.full_like(x, float("nan")))


_cluster_shape = {}


def cluster_shape(device: torch.device) -> tuple[int, int]:
    """(blocks per cluster, the largest D the cluster route takes) on
    `device`: its shared memory per block decides, (8, 768) on an H100."""
    key = device.index if device.index is not None else torch.cuda.current_device()
    if key not in _cluster_shape:
        lib = cuda_lib.lib()
        with torch.cuda.device(key):
            _cluster_shape[key] = (lib.chol_cluster_size(), lib.chol_cluster_max_d())
    return _cluster_shape[key]


def route(D: int, device: torch.device) -> str:
    """The kernel `chol_solve_cuda` launches for systems of size D:
    "cluster" or "l2" (the name of its launch counter is `chol_solve` or
    `chol_solve_l2`)."""
    return "cluster" if D <= cluster_shape(device)[1] else "l2"


def _launch(S, b, name, counter, *extra):
    """Flatten the batch, launch the C entry point `name` (S, b, G, D,
    *extra, x, stream) on the current stream and count it."""
    D = S.shape[-1]
    batch = S.shape[:-2]
    Sc = S.reshape(-1, D, D).contiguous()
    G = Sc.shape[0]
    x = torch.empty((G, D), dtype=torch.float32, device=S.device)
    if G == 0 or D == 0:
        return x.reshape(*batch, D)
    bc = b.reshape(G, D).contiguous()
    extra = [e(Sc).data_ptr() for e in extra]
    err = getattr(cuda_lib.lib(), name)(
        Sc.data_ptr(), bc.data_ptr(), G, D, *extra, x.data_ptr(),
        torch.cuda.current_stream(S.device).cuda_stream)
    cuda_lib.check(err, name)
    cuda_lib.launches[counter] += 1
    return x.reshape(*batch, D)


def chol_solve_cluster(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The cluster route's kernel; raises for D above its capacity."""
    return _launch(S, b, "chol_solve_cluster_f32", "chol_solve")


def _grid_work(Sc: torch.Tensor) -> torch.Tensor:
    """The large-D route's work buffer for the flattened batch Sc (any
    content: the kernel writes every word before it reads it)."""
    n = cuda_lib.lib().chol_grid_work_floats(Sc.shape[0], Sc.shape[-1])
    if n < 0:
        raise ValueError(f"chol_solve: work buffer for {tuple(Sc.shape)} exceeds 2^31 floats")
    return torch.empty(n, dtype=torch.float32, device=Sc.device)


def chol_solve_l2(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The large-D route's kernel (any D); it factors in a working copy, so
    S itself is left untouched."""
    return _launch(S, b, "chol_solve_grid_f32", "chol_solve_l2", _grid_work)


def chol_solve_cuda(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the hand kernel of `route(D)`."""
    if route(S.shape[-1], S.device) == "cluster":
        return chol_solve_cluster(S, b)
    return chol_solve_l2(S, b)


def chol_solve(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b for SPD S [..., D, D], b [..., D] (see module
    docstring for the dispatch)."""
    _check_inputs(S, b)
    if S.is_cuda:
        return chol_solve_cuda(S, b)
    if S.device.type != "cpu":
        raise ValueError(f"chol_solve: unsupported device {S.device}")
    return chol_solve_plain(S, b)
