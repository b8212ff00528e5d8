# A frozen copy of `ops/fast.py` as the port had it when the benchmark
# was written: the plain version the benchmark holds the timed path to.
# It imports nothing of the port; edit it only to follow a change of the
# semantics the configuration states.
"""FAST-16/9 corner score, 3x3 NMS and grid-bucketed selection
(counterpart of `monoorbslam3_tpu/ops/fast.py`).

The score is the OpenCV-style V value computed from 16 shifted copies of
the level (the Bresenham circle), a log-time sliding minimum over the
circular axis and a max over arc starts: only subtractions, minima and
maxima, so it is bit-identical to the JAX version. Selection takes the
top `per_cell` scores of every 16x16 cell and then the top `quota` of
those. `lax.top_k` puts the lower index first among equal values; the port
reproduces that order with a stable descending sort.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# 16-point Bresenham circle of radius 3 in circular order, (dy, dx)
CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9


def _arc_min_max(d: torch.Tensor) -> torch.Tensor:
    """Sliding min of window 9 over circular axis 0, then max over starts."""
    circ = torch.cat([d, d[: ARC_LEN - 1]], dim=0)  # [24, H, W]
    w1 = circ
    w2 = torch.minimum(w1[:-1], w1[1:])  # window 2
    w4 = torch.minimum(w2[:-2], w2[2:])  # window 4
    w8 = torch.minimum(w4[:-4], w4[4:])  # window 8
    w9 = torch.minimum(w8[:-1], w1[8: 8 + w8.shape[0] - 1])  # window 9
    return torch.amax(w9[:16], dim=0)


def fast_score_raw(img: torch.Tensor) -> torch.Tensor:
    """[H, W] float -> [H, W] un-thresholded corner score (the V value)."""
    diffs = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) - img for dy, dx in CIRCLE],
        dim=0,
    )  # [16, H, W]; roll wrap-around is masked by the border margin later
    return torch.maximum(_arc_min_max(diffs), _arc_min_max(-diffs))


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """[H, W] float -> [H, W] corner score, zeroed where <= threshold."""
    score = fast_score_raw(img)
    return torch.where(score > threshold, score, torch.zeros_like(score))


def subpixel_peak_offsets(score: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                          valid: torch.Tensor):
    """Separable quadratic peak interpolation at integer keypoints: a
    parabola through (prev, center, next) of the RAW score per axis peaks
    at 0.5 (prev - next) / (prev + next - 2 center), in (-0.5, 0.5) for a
    strict local maximum (the curvature guard trips only on flat plateaus).
    Returns (offx [N], offy [N]) float32, zero for invalid slots."""
    ys, xs = ys.long(), xs.long()
    C = score[ys, xs]
    L = score[ys, xs - 1]
    R = score[ys, xs + 1]
    U = score[ys - 1, xs]
    D = score[ys + 1, xs]

    def axis_offset(prev, nxt):
        den = prev + nxt - 2.0 * C
        curved = den < -1e-6
        off = 0.5 * (prev - nxt) / torch.where(curved, den, torch.full_like(den, -1.0))
        return torch.where(curved, torch.clamp(off, -0.5, 0.5), torch.zeros_like(off))

    m = valid.to(torch.float32)
    return axis_offset(L, R) * m, axis_offset(U, D) * m


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (-inf padding, like reduce_window SAME)."""
    local_max = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= local_max, score, torch.zeros_like(score))


def top_k_stable(x: torch.Tensor, k: int):
    """`lax.top_k` order: descending, lower index first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def select_keypoints(score: torch.Tensor, quota: int, cell: int = 16,
                     per_cell: int = 4, margin: int = 24):
    """Grid-bucketed top-k selection on an NMS'd score map.

    Returns (xy [quota, 2] float32 (x, y) at this level, response [quota],
    valid [quota] bool).
    """
    h, w = score.shape
    dev = score.device
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    ok = (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)
    s = torch.where(ok, score, torch.zeros_like(score))

    hp = -(-h // cell) * cell
    wp = -(-w // cell) * cell
    s = F.pad(s, (0, wp - w, 0, hp - h))
    ncy, ncx = hp // cell, wp // cell
    cells = s.reshape(ncy, cell, ncx, cell).permute(0, 2, 1, 3).reshape(ncy * ncx, cell * cell)

    vals, idx = top_k_stable(cells, per_cell)  # [ncells, per_cell]
    cid = torch.arange(ncy * ncx, dtype=torch.int64, device=dev)
    cy, cx = cid // ncx, cid % ncx
    py = cy[:, None] * cell + idx // cell
    px = cx[:, None] * cell + idx % cell

    top_vals, top_i = top_k_stable(vals.reshape(-1), quota)
    valid = top_vals > 0.0
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    y = torch.where(valid, py.reshape(-1)[top_i], zero)
    x = torch.where(valid, px.reshape(-1)[top_i], zero)
    xy = torch.stack([x, y], dim=-1).to(torch.float32)
    return xy, top_vals, valid
