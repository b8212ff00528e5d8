"""K2: the fused gated top-2 match (counterpart of
`monoorbslam3_tpu/ops/match_pallas.py`).

For each row a: the Hamming distance to every column b, the pairwise gate
(both sides valid, squared pixel distance below each side's r^2, vocab node
equal or -1), then best, second best and the first-occurrence argmin.
`projected_match` runs it on rows and again transposed for the mutual
check, and returns (idx, dist) exactly like `match_descriptors`.

`_match_rows` dispatches on the tensors' device: a CUDA tensor launches the
hand kernel (`csrc/match_rows.cu`); a CPU tensor takes `_match_rows_plain`,
the JAX `_match_rows_xla` written in torch with an integer popcount. Both
are exact: idx and dist are bit-identical to the JAX package.
"""

from __future__ import annotations

import torch

from . import cuda_lib
from .matching import node_gate
from .pallas_kernels import hamming_matrix_plain

INF = 1e9


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


def _match_rows_cuda(desc_a, desc_b, ax, ay, r2a, ga, va, bx, by, r2b, gb, vb):
    """Launch the hand kernel on the current stream."""
    N, M = desc_a.shape[0], desc_b.shape[0]
    dev = desc_a.device
    best = torch.empty(N, dtype=torch.float32, device=dev)
    second = torch.empty(N, dtype=torch.float32, device=dev)
    idx = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return best, second, idx
    if M == 0:
        raise ValueError("_match_rows: no columns")
    err = cuda_lib.lib().match_rows_f32(
        desc_a.data_ptr(), ax.data_ptr(), ay.data_ptr(), r2a.data_ptr(),
        ga.data_ptr(), va.data_ptr(), N,
        desc_b.data_ptr(), bx.data_ptr(), by.data_ptr(), r2b.data_ptr(),
        gb.data_ptr(), vb.data_ptr(), M,
        best.data_ptr(), second.data_ptr(), idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(err, "match_rows_f32")
    cuda_lib.launches["match_rows"] += 1
    return best, second, idx


def _check_side(desc, vecs, name):
    n = desc.shape[0]
    if desc.dtype != torch.int32 or desc.dim() != 2 or desc.shape[1] != 8:
        raise ValueError(f"{name}: descriptors must be [n, 8] int32, got "
                         f"{desc.dtype} {tuple(desc.shape)}")
    if not desc.is_contiguous():
        raise ValueError(f"{name}: descriptors must be contiguous")
    for v in vecs:
        if v.dtype != torch.float32 or v.shape != (n,) or not v.is_contiguous():
            raise ValueError(f"{name}: per-side vectors must be contiguous [{n}] float32")
        if v.device != desc.device:
            raise ValueError(f"{name}: per-side vectors on {v.device}, "
                             f"descriptors on {desc.device}")


def _match_rows(desc_a, desc_b, ax, ay, r2a, ga, va, bx, by, r2b, gb, vb):
    """Dispatch on the device of the inputs (see module docstring)."""
    _check_side(desc_a, (ax, ay, r2a, ga, va), "rows")
    _check_side(desc_b, (bx, by, r2b, gb, vb), "columns")
    if desc_a.device != desc_b.device:
        raise ValueError("rows and columns lie on different devices")
    if desc_a.is_cuda:
        return _match_rows_cuda(desc_a, desc_b, ax, ay, r2a, ga, va,
                                bx, by, r2b, gb, vb)
    if desc_a.device.type != "cpu":
        raise ValueError(f"_match_rows: unsupported device {desc_a.device}")
    return _match_rows_plain(desc_a, desc_b, ax, ay, r2a, ga, va,
                             bx, by, r2b, gb, vb)


def _f32(x, n, fill, dev):
    if x is None:
        return torch.full((n,), fill, dtype=torch.float32, device=dev)
    return torch.as_tensor(x, device=dev).to(torch.float32).contiguous()


def projected_match(desc_a, desc_b, *, uv_a=None, xy_b=None, radius=None,
                    groups_a=None, groups_b=None, valid_a, valid_b,
                    max_dist, ratio=0.9, mutual=True, use_ratio=True):
    """Fused analog of projection_mask/node_gate + match_descriptors.

    radius: per-row search radius (None = no spatial gate); groups: vocab
    node ids with -1 pass-through. Returns (idx [N] i32, dist [N] i32)
    exactly like match_descriptors."""
    dev = desc_a.device
    N, M = desc_a.shape[0], desc_b.shape[0]
    ax = _f32(None if uv_a is None else uv_a[:, 0], N, 0.0, dev)
    ay = _f32(None if uv_a is None else uv_a[:, 1], N, 0.0, dev)
    bx = _f32(None if xy_b is None else xy_b[:, 0], M, 0.0, dev)
    by = _f32(None if xy_b is None else xy_b[:, 1], M, 0.0, dev)
    r2 = _f32(radius, N, 0.0, dev) ** 2 if radius is not None else _f32(None, N, INF, dev)
    ga = _f32(groups_a, N, -1.0, dev)
    gb = _f32(groups_b, M, -1.0, dev)
    va = _f32(valid_a, N, 0.0, dev)
    vb = _f32(valid_b, M, 0.0, dev)
    infc = torch.full((M,), INF, dtype=torch.float32, device=dev)

    best, second, idx = _match_rows(desc_a, desc_b, ax, ay, r2, ga, va,
                                    bx, by, infc, gb, vb)
    ok = (idx >= 0) & (best <= max_dist)
    if use_ratio:
        ok &= best < ratio * second
    if mutual:
        # transposed pass (column-wise first-occurrence argmin) under the
        # SAME pairwise gate: the radius rides on the now-column side
        _, _, idx_b = _match_rows(desc_b, desc_a, bx, by, infc, gb, vb,
                                  ax, ay, r2, ga, va)
        safe = torch.clamp(idx, min=0).long()
        ok &= idx_b[safe] == torch.arange(N, dtype=torch.int32, device=dev)
    out_idx = torch.where(ok, idx, torch.full_like(idx, -1))
    big = torch.full_like(best, float(1 << 20))
    return out_idx, torch.where(ok, best, big).to(torch.int32)
