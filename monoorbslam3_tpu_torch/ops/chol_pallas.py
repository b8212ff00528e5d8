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
bench window's systems).

`chol_solve` dispatches on the device: a CUDA tensor launches the hand
kernel (`csrc/chol_solve.cu`, one block per system); a CPU tensor takes
`chol_solve_plain`, `torch.linalg.cholesky_ex` + `torch.cholesky_solve`
(the JAX package's own off-TPU path is `jnp.linalg.cholesky` +
`cho_solve`) with the same refinement step. A matrix that is not positive
definite gives NaN in the plain version, as JAX's Cholesky does, and never
raises (raising would need a host read of the factorization status).
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


def chol_solve_cuda(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the hand kernel on the current stream: one block per system.
    The kernel factors in a working copy, so S itself is left untouched."""
    D = S.shape[-1]
    batch = S.shape[:-2]
    Sc = S.reshape(-1, D, D).contiguous()
    G = Sc.shape[0]
    work = torch.empty_like(Sc)
    x = torch.empty((G, D), dtype=torch.float32, device=S.device)
    if G == 0 or D == 0:
        return x.reshape(*batch, D)
    bc = b.reshape(G, D).contiguous()
    err = cuda_lib.lib().chol_solve_f32(
        Sc.data_ptr(), bc.data_ptr(), G, D, work.data_ptr(), x.data_ptr(),
        torch.cuda.current_stream(S.device).cuda_stream)
    cuda_lib.check(err, "chol_solve_f32")
    cuda_lib.launches["chol_solve"] += 1
    return x.reshape(*batch, D)


def chol_solve(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve S x = b for SPD S [..., D, D], b [..., D] (see module
    docstring for the dispatch)."""
    _check_inputs(S, b)
    if S.is_cuda:
        return chol_solve_cuda(S, b)
    if S.device.type != "cpu":
        raise ValueError(f"chol_solve: unsupported device {S.device}")
    return chol_solve_plain(S, b)
