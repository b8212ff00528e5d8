# A frozen copy of `ops/orb.py` as the port had it when the benchmark
# was written: the plain version the benchmark holds the timed path to.
# It imports nothing of the port; edit it only to follow a change of the
# semantics the configuration states.
"""ORB orientation, rBRIEF descriptors and the whole-image extractor
(counterpart of `monoorbslam3_tpu/ops/orb.py`).

Same structure as the JAX package: every level is scored and selected on
its own, then all levels' keypoints gather their 48x48 patches from one
packed pyramid atlas in a single call (K1, `pallas_kernels.gather_patches_dyn`),
and one IC-angle, one blur and one BRIEF pass run over the whole keypoint
capacity.

Numerics against the JAX package:
- the BRIEF pattern, the IC-angle weights and the blur matrix are the same
  seeded numpy constants;
- the blur is `G @ P @ G^T` in full float32;
- the sampler reads each blurred patch through a bf16 rounding, as the JAX
  one-hot contraction does on purpose (its patch operand is bf16, the
  one-hot selects exactly one value per sample): `.to(bfloat16).float()`;
- cos/sin of the angle may differ by an ulp between the libraries, which
  can move a rotated sample point across a rounding boundary: a few bits
  per thousand differ (the tests state the bound).

Descriptors are [K, 8] int32 words (the bit patterns of the JAX uint32).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import fast as fast_ops
from . import image as image_ops
from .match import gather_patches_plain
from ._util import CARD, constant, resolve

PATCH = 48  # gathered patch size (square)
HALF = PATCH // 2
ORI_RADIUS = 15  # IC-angle circular patch radius (reference HALF_PATCH_SIZE)
PATTERN_SEED = 20240817
N_PAIRS = 256
PATTERN_SIGMA = 13.0 / 2.0
PATTERN_CLIP = 13


@lru_cache(maxsize=None)
def brief_pattern():
    """Deterministic 256-pair BRIEF sampling pattern, coords in [-13, 13]
    (the JAX package's seeded construction, unchanged)."""
    rng = np.random.default_rng(PATTERN_SEED)
    pts = rng.normal(0.0, PATTERN_SIGMA, size=(N_PAIRS * 2, 2))
    pts = np.clip(np.round(pts), -PATTERN_CLIP, PATTERN_CLIP).astype(np.int32)
    pa, pb = pts[:N_PAIRS], pts[N_PAIRS:]
    # re-roll degenerate pairs deterministically
    for i in range(N_PAIRS):
        while (pa[i] == pb[i]).all():
            pb[i] = np.clip(np.round(rng.normal(0, PATTERN_SIGMA, 2)), -PATTERN_CLIP, PATTERN_CLIP)
    return pa.astype(np.float32), pb.astype(np.float32)


@lru_cache(maxsize=None)
def _ic_angle_weights():
    """Circular-mask moment weights for the IC angle (31x31, radius 15)."""
    r = ORI_RADIUS
    y, x = np.mgrid[-r: r + 1, -r: r + 1]
    mask = (x * x + y * y) <= r * r
    wx = (x * mask).astype(np.float32)
    wy = (y * mask).astype(np.float32)
    return wx, wy


@lru_cache(maxsize=None)
def _blur_matrix(ksize: int = 7, sigma: float = 2.0):
    """Banded [PATCH, PATCH] Gaussian so blur(P) = G @ P @ G^T."""
    k = image_ops._gaussian_kernel(ksize, sigma)
    r = ksize // 2
    G = np.zeros((PATCH, PATCH), np.float32)
    for i in range(PATCH):
        for j, kv in zip(range(i - r, i + r + 1), k):
            if 0 <= j < PATCH:
                G[i, j] = kv
    return G


def gather_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """[K, PATCH, PATCH] patches of one image [H, W] centered at integer
    keypoints xy [K, 2] (x, y) at this image's scale, from the image padded
    by HALF zeros. Keypoints lie >= HALF from the border (the FAST margin);
    the extractor itself gathers from the packed atlas (K1)."""
    padded = F.pad(img, (HALF, HALF, HALF, HALF))
    x = xy[:, 0].to(torch.int64)
    y = xy[:, 1].to(torch.int64)
    r = torch.arange(PATCH, device=img.device)
    return padded[(y[:, None] + r)[:, :, None], (x[:, None] + r)[:, None, :]]


def ic_angles(patches_raw: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle per patch (reference IC_Angle,
    ORBExtractor.cpp:18-48). [K, PATCH, PATCH] -> [K] radians."""
    dev = patches_raw.device
    wx = constant("orb.ic_wx", dev, lambda: _ic_angle_weights()[0])
    wy = constant("orb.ic_wy", dev, lambda: _ic_angle_weights()[1])
    c, r = HALF, ORI_RADIUS
    sub = patches_raw[:, c - r: c + r + 1, c - r: c + r + 1].reshape(-1, (2 * r + 1) ** 2)
    m10 = sub @ wx.reshape(-1)
    m01 = sub @ wy.reshape(-1)
    return torch.atan2(m01, m10)


def blur_patches(patches: torch.Tensor) -> torch.Tensor:
    """7x7 sigma-2 Gaussian blur of a [K, PATCH, PATCH] stack as G @ P @ G^T
    (the BRIEF sample extent plus the kernel radius stays inside the patch,
    so sampled values equal the whole-image blur)."""
    G = constant("orb.blur", patches.device, _blur_matrix)
    return G @ patches @ G.T


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[K, 256] bool -> [K, 8] int32 words, bit j of word w = bits[:, 32w + j]
    (packed through int64, then wrapped to the int32 bit pattern)."""
    K = bits.shape[0]
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) << torch.arange(
        32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(K, 8, 32).to(torch.int64) * weights).sum(dim=-1)
    words = torch.where(words >= 2**31, words - 2**32, words)
    return words.to(torch.int32)


def brief_descriptors(patches_blur: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF descriptors. patches: [K, PATCH, PATCH] (blurred),
    angles: [K] -> [K, 8] int32 (256 bits packed little-endian per word)."""
    K = patches_blur.shape[0]
    dev = patches_blur.device
    pts = constant("orb.brief", dev, lambda: np.concatenate(brief_pattern(), 0))  # [512, 2]
    cos = torch.cos(angles)[:, None]
    sin = torch.sin(angles)[:, None]
    # steered BRIEF: sample at R(theta) @ p, rounded to nearest pixel
    x = torch.round(pts[None, :, 0] * cos - pts[None, :, 1] * sin).to(torch.int64) + HALF
    y = torch.round(pts[None, :, 0] * sin + pts[None, :, 1] * cos).to(torch.int64) + HALF
    flat = patches_blur.to(torch.bfloat16).to(torch.float32).reshape(K, PATCH * PATCH)
    v = torch.gather(flat, 1, y * PATCH + x)  # [K, 512] sampled intensities
    return pack_bits(v[:, :N_PAIRS] < v[:, N_PAIRS:])


def level_quotas(n_features: int, n_levels: int, scale: float):
    """Per-level keypoint quotas proportional to (1/scale)^level."""
    inv = 1.0 / scale
    weights = np.array([inv**l for l in range(n_levels)])
    raw = n_features * weights / weights.sum()
    quotas = np.floor(raw).astype(int)
    quotas[0] += n_features - quotas.sum()
    return [int(q) for q in quotas]


class OrbExtractor:
    """Whole-image ORB extractor for a fixed resolution on one device.

    `__call__` runs pyramid -> FAST -> grid-NMS select -> atlas gather ->
    IC angle -> rBRIEF and returns fixed-capacity tensors on the device:
    xy [N, 2] (level-0 raw pixels), response [N], level [N] i32, angle [N],
    desc [N, 8] i32, valid [N] bool. With `subpixel` (off by default, as in
    the JAX package) the keypoints are refined by a parabola through the
    raw FAST score (`fast.subpixel_peak_offsets`) on a packed score atlas.
    """

    def __init__(self, height: int, width: int, n_features: int = 1024,
                 n_levels: int = 8, scale: float = 1.2, ini_th_fast: float = 20.0,
                 min_th_fast: float = 7.0, cell: int = 16, per_cell: int = 4,
                 subpixel: bool = False, device=CARD):
        self.height, self.width = height, width
        self.n_features = n_features
        self.n_levels = n_levels
        self.scale = scale
        self.ini_th, self.min_th = ini_th_fast, min_th_fast
        self.cell, self.per_cell = cell, per_cell
        self.subpixel = subpixel
        self.device = resolve(device)
        self.quotas = level_quotas(n_features, n_levels, scale)
        self.scale_factors = np.array([scale**l for l in range(n_levels)], np.float32)
        self.sigma2 = self.scale_factors**2
        self._sf = torch.as_tensor(self.scale_factors, device=self.device)
        # pyramid-atlas layout of the JAX package: levels stacked vertically,
        # each padded to a 128-aligned width plus 256 columns; 64 slack rows
        shapes = image_ops.pyramid_shapes(height, width, n_levels, scale)
        self._shapes = shapes
        self._row_off = np.cumsum([0] + [h for h, _ in shapes[:-1]]).astype(np.int32)
        self.atlas_w = -(-width // 128) * 128 + 2 * 128
        self.atlas_h = int(sum(h for h, _ in shapes)) + 64
        self._weights = image_ops.pyramid_weights(shapes, self.device)

    def _detect(self, img: torch.Tensor):
        """Pyramid, per-level FAST + grid selection, and the packed atlas.
        Returns (atlas [Ha, Wa], patch corners ys [N], xs [N] int32, and the
        keypoint fields xy, response, level, valid)."""
        levels = image_ops.build_pyramid(img, self.n_levels, self.scale, self._weights)
        dev = img.device
        atlas = torch.zeros((self.atlas_h, self.atlas_w), dtype=torch.float32, device=dev)
        ys_at, xs, out_xy, out_resp, out_level, out_valid = [], [], [], [], [], []
        raw_rows, kx_at, ky_at = [], [], []  # the score atlas of `subpixel`
        for lvl, li in enumerate(levels):
            h, w = li.shape
            off = int(self._row_off[lvl])
            atlas[off: off + h, :w] = li
            quota = self.quotas[lvl]
            if quota == 0:
                continue
            raw = fast_ops.fast_score_raw(li)
            score = fast_ops.nms3(torch.where(raw > self.min_th, raw, torch.zeros_like(raw)))
            xy, resp, valid = fast_ops.select_keypoints(
                score, quota, cell=self.cell, per_cell=self.per_cell, margin=HALF)
            xi = xy[:, 0].to(torch.int32)
            yi = xy[:, 1].to(torch.int32)
            # invalid slots carry xy=(0,0); clamp their patch corner into the
            # atlas (their descriptors are masked out downstream)
            xs.append(torch.clamp(xi - HALF, min=0))
            ys_at.append(torch.clamp(yi - HALF, min=0) + off)
            if self.subpixel:  # keypoint-centred atlas coordinates
                kx_at.append(xi)
                ky_at.append(yi + off)
                raw_rows.append(F.pad(raw, (0, self.atlas_w - w)))
            out_xy.append(xy * float(self.scale_factors[lvl]))  # level-0 pixels
            out_resp.append(resp)
            out_level.append(torch.full((quota,), lvl, dtype=torch.int32, device=dev))
            out_valid.append(valid)

        level_all, valid_all = torch.cat(out_level), torch.cat(out_valid)
        xy_all = torch.cat(out_xy)
        if self.subpixel:
            # one cross-level parabola pass on the packed raw-score atlas
            offx, offy = fast_ops.subpixel_peak_offsets(
                torch.cat(raw_rows), torch.cat(ky_at), torch.cat(kx_at), valid_all)
            sf = self._sf[level_all.long()]
            xy_all = xy_all + torch.stack([offx, offy], -1) * sf[:, None]
        return atlas, torch.cat(ys_at), torch.cat(xs), {
            "xy": xy_all,
            "response": torch.cat(out_resp),
            "level": level_all,
            "valid": valid_all,
        }

    def _extract(self, img: torch.Tensor) -> dict:
        atlas, ys, xs, out = self._detect(img.to(torch.float32))
        # all levels' patches in one gather from the atlas (K1)
        patches_raw = gather_patches_plain(atlas, ys, xs)
        out["angle"] = ic_angles(patches_raw)
        out["desc"] = brief_descriptors(blur_patches(patches_raw), out["angle"])
        return out

    def __call__(self, img) -> dict:
        return self._extract(torch.as_tensor(img, device=self.device))


def finish_features(out: dict, camera, scale_factors) -> dict:
    """`frontend/frame.finish_features` (frozen): undistorted keypoints and
    the per-level measurement variance."""
    xy_raw = out["xy"].to(torch.float32)
    level = out["level"].to(torch.int32)
    sf = torch.as_tensor(np.asarray(scale_factors, np.float32).reshape(-1), device=xy_raw.device)
    und = camera.undistort_points(xy_raw)
    unc = camera.uncertainty(xy_raw)
    return {"xy": und, "xy_raw": xy_raw, "level": level,
            "angle": out["angle"].to(torch.float32), "desc": out["desc"],
            "valid": out["valid"], "sigma2": (sf[level.long()] * unc) ** 2}
