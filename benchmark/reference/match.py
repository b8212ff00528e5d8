"""The plain versions of the port's four hand kernels (K1-K4) and of the
gate K2 applies, frozen as the port had them when the benchmark was
written (`ops/pallas_kernels.py`, `ops/match_pallas.py`,
`ops/matching.node_gate`, `ops/chol_pallas.chol_solve_plain`). Imports
nothing of the port.
"""

from __future__ import annotations

import torch

PATCH = 48
INF = 1e9


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bit count of int32 words (SWAR). `>>` is arithmetic on int32; each
    mask clears the sign bits it drags in, so bit 31 counts once."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def pm1_planes(desc: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """[n, 8] int32 words -> [n, 256] bit planes of `dtype`, +1 for a 0 bit
    and -1 for a 1 bit, as the JAX package unpacks them for its +-1 product
    (`monoorbslam3_tpu/ops/matching.py:hamming_matrix`): 256 - 2 x the
    distance is their product."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int32)
    bits = (desc[:, :, None] >> shifts) & 1
    return (1 - 2 * bits).reshape(desc.shape[0], 256).to(dtype)


def hamming_matrix_plain(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """The JAX package's XLA formulation (`ops/matching.py:hamming_matrix`):
    for +-1 bit planes A, B the distance is (256 - A.B) / 2. The products
    are +-1 and every partial sum an integer of at most 256, so the float32
    product is exact in any summation order; one [N, 256] x [256, M] product
    instead of an [N, M, 8] broadcast of popcounts."""
    dot = pm1_planes(desc_a) @ pm1_planes(desc_b).T
    return ((256.0 - dot) * 0.5).to(torch.int32)


def gather_patches_plain(img: torch.Tensor, ys: torch.Tensor,
                         xs: torch.Tensor) -> torch.Tensor:
    """Index-gather version. Corners are treated as `lax.dynamic_slice`
    treats its start indices: a negative one counts from the far border
    (c + size), then all are clamped into the atlas."""
    ha, wa = img.shape
    y0 = torch.where(ys < 0, ys + ha, ys).long().clamp(0, ha - PATCH)
    x0 = torch.where(xs < 0, xs + wa, xs).long().clamp(0, wa - PATCH)
    r = torch.arange(PATCH, device=img.device)
    return img[(y0[:, None] + r)[:, :, None], (x0[:, None] + r)[:, None, :]]


def node_gate(groups_a, groups_b):
    """Vocabulary-node gate: same-node pairs pass; a side with group < 0
    passes everything."""
    ga = groups_a[:, None]
    gb = groups_b[None, :]
    return (ga == gb) | (ga < 0) | (gb < 0)


def _match_rows_plain(desc_a, desc_b, ax, ay, r2a, ga, va, bx, by, r2b, gb, vb):
    """Row-side stats (best [N] f32, second [N] f32, idx [N] i32), with the
    first occurrence winning ties. Plain throughout: the Hamming block is
    K3's plain version on every device."""
    d = hamming_matrix_plain(desc_a, desc_b).to(torch.float32)
    dx = ax[:, None] - bx[None, :]
    dy = ay[:, None] - by[None, :]
    q = dx * dx + dy * dy
    gate = (va[:, None] > 0) & (vb[None, :] > 0)
    gate &= (q < r2a[:, None]) & (q < r2b[None, :])
    gate &= node_gate(ga, gb)
    d = torch.where(gate, d, torch.full_like(d, INF))
    best, idx = torch.min(d, dim=1)  # first occurrence of the minimum
    lane = torch.arange(d.shape[1], device=d.device)
    d2 = torch.where(lane[None, :] == idx[:, None], torch.full_like(d, INF), d)
    second = torch.amin(d2, dim=1)
    idx = torch.where(best < INF, idx, torch.full_like(idx, -1)).to(torch.int32)
    return best, second, idx


def chol_solve_plain(S: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[..., D, D], [..., D] -> [..., D] by the library Cholesky, plus one
    refinement step with a float64 residual."""
    L, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(b[..., None], L)
    r = (b.double()[..., None] - S.double() @ x.double()).float()
    x = (x + torch.cholesky_solve(r, L)).squeeze(-1)
    return torch.where((info == 0)[..., None], x, torch.full_like(x, float("nan")))


