"""Image pyramid (counterpart of `monoorbslam3_tpu/ops/image.py`).

The JAX package resizes each level from the previous one with
`jax.image.resize(..., "linear")`, which on a downscale is a separable
triangle filter widened by the inverse scale (antialiased). The port builds
the same filter as two explicit weight matrices per level, `Wy [h_out, h_in]`
and `Wx [w_out, w_in]`, computed in float32 exactly as JAX computes them
(`jax/_src/image/scale.py::compute_weight_mat`), and applies them as
`Wy @ img @ Wx^T`. `F.interpolate(antialias=True)` uses another filter
normalisation and differs by up to ~2.4e-3 on a 0..255 image. The weights
follow the jitted JAX computation, in which XLA fuses two multiply-adds into
FMAs; the eager formula differs from it by up to 5e-6 per weight, which
moves the resized image by ~1e-3.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch


@lru_cache(maxsize=None)
def _gaussian_kernel(ksize: int, sigma: float):
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


def pyramid_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static per-level (h, w) list, truncating like cv::resize round()."""
    shapes = []
    for lvl in range(n_levels):
        s = 1.0 / (scale**lvl)
        shapes.append((max(16, int(round(height * s))), max(16, int(round(width * s)))))
    return shapes


@lru_cache(maxsize=None)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] float32 antialiased-triangle resize weights, computed
    in float32 in the order of JAX's `compute_weight_mat`."""
    f32 = np.float32
    f64 = np.float64
    scale = n_out / n_in
    inv_scale = f32(1.0 / scale)
    kernel_scale = np.maximum(inv_scale, f32(1.0))
    # XLA contracts a*b+c into one FMA (a single rounding); an f32*f32
    # product is exact in float64, so round(f64 expression) is that FMA
    a = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (a.astype(f64) * f64(inv_scale) - 0.5).astype(f32)
    dist = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None])
    w = np.maximum(0.0, 1.0 - dist.astype(f64) * f64(f32(1.0) / kernel_scale)).astype(f32)
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    w = np.where(inside[None, :], w, f32(0.0))
    return np.ascontiguousarray(w.T.astype(f32))


def build_pyramid(img: torch.Tensor, n_levels: int = 8, scale: float = 1.2,
                  weights=None):
    """[H, W] float32 -> list of per-level images, each resized from the
    previous level. `weights`: optional per-level (Wy, Wx) tensors already on
    the image's device (the extractor builds them once)."""
    h, w = img.shape
    shapes = pyramid_shapes(h, w, n_levels, scale)
    if weights is None:
        weights = pyramid_weights(shapes, img.device)
    levels = [img]
    for lvl in range(1, n_levels):
        wy, wx = weights[lvl - 1]
        levels.append(wy @ levels[-1] @ wx.T)
    return levels


def pyramid_weights(shapes, device):
    """Per-level (Wy, Wx) resize matrices for `build_pyramid`."""
    out = []
    for (h0, w0), (h1, w1) in zip(shapes[:-1], shapes[1:]):
        out.append((torch.as_tensor(resize_weights(h0, h1), device=device),
                    torch.as_tensor(resize_weights(w0, w1), device=device)))
    return out
