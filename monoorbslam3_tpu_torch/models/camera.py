"""Pinhole + radial-tangential camera (counterpart of the `Pinhole` of
`monoorbslam3_tpu/models/camera.py`).

Same semantics as the reference: `project` maps camera-frame points with
the ideal (undistorted) model, keypoints are undistorted once per frame by
a 10-step fixed-point inversion of the radtan model, and `create` derives
the valid undistorted-pixel bounds from the undistorted image corners.
Intrinsics are 0-d float32 tensors on the camera's device, so every
operation stays on that device.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from ..utils.device import CARD, resolve

_Z_MIN = 1e-6  # guard for points at/behind the camera plane


def _distort_normalized(xy: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
    k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def _undistort_radtan(uv, fx, fy, cx, cy, dist):
    x0 = (uv[..., 0] - cx) / fx
    y0 = (uv[..., 1] - cy) / fy
    xyd = torch.stack([x0, y0], dim=-1)
    xy = xyd
    for _ in range(10):
        xy = xyd - (_distort_normalized(xy, dist) - xy)
    u = xy[..., 0] * fx + cx
    v = xy[..., 1] * fy + cy
    return torch.stack([u, v], dim=-1)


@dataclass(frozen=True)
class Pinhole:
    """Pinhole + radtan(k1, k2, p1, p2, k3); 0-d f32 tensors on one device."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # [5] = k1, k2, p1, p2, k3
    width: int
    height: int
    # valid undistorted-pixel bounds (reference: Pinhole.cpp:17-26)
    min_x: torch.Tensor | None = None
    min_y: torch.Tensor | None = None
    max_x: torch.Tensor | None = None
    max_y: torch.Tensor | None = None

    @staticmethod
    def create(fx, fy, cx, cy, dist=None, width=0, height=0,
               device=CARD) -> "Pinhole":
        f32 = dict(dtype=torch.float32, device=resolve(device))
        d = torch.zeros(5, **f32)
        if dist is not None:
            dist = torch.as_tensor(dist, **f32).reshape(-1)
            d[: dist.shape[0]] = dist
        cam = Pinhole(torch.tensor(float(fx), **f32), torch.tensor(float(fy), **f32),
                      torch.tensor(float(cx), **f32), torch.tensor(float(cy), **f32),
                      d, int(width), int(height))
        # undistort the image corners to get the valid pixel bounds
        corners = torch.tensor(
            [[0.0, 0.0], [width - 1.0, 0.0], [0.0, height - 1.0],
             [width - 1.0, height - 1.0]], **f32)
        und = cam.undistort_points(corners)
        return replace(
            cam,
            min_x=torch.maximum(und[0, 0], und[2, 0]),
            max_x=torch.minimum(und[1, 0], und[3, 0]),
            min_y=torch.maximum(und[0, 1], und[1, 1]),
            max_y=torch.minimum(und[2, 1], und[3, 1]),
        )

    @property
    def device(self) -> torch.device:
        return self.fx.device

    # --- ideal model (post-undistortion pixel domain) ---

    def project(self, pc: torch.Tensor) -> torch.Tensor:
        """Camera-frame points [..., 3] -> ideal pixels [..., 2]."""
        z = torch.clamp(pc[..., 2], min=_Z_MIN)
        u = self.fx * pc[..., 0] / z + self.cx
        v = self.fy * pc[..., 1] / z + self.cy
        return torch.stack([u, v], dim=-1)

    def back_project(self, uv: torch.Tensor) -> torch.Tensor:
        """Ideal pixels [..., 2] -> unit-depth rays [..., 3]."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return torch.stack([x, y, torch.ones_like(x)], dim=-1)

    def proj_jacobian(self, pc: torch.Tensor) -> torch.Tensor:
        """d(project)/d(pc): [..., 2, 3] (reference: Pinhole.cpp:49-53)."""
        z = torch.clamp(pc[..., 2], min=_Z_MIN)
        inv_z = 1.0 / z
        inv_z2 = inv_z * inv_z
        zero = torch.zeros_like(inv_z)
        row0 = torch.stack([self.fx * inv_z, zero, -self.fx * pc[..., 0] * inv_z2], dim=-1)
        row1 = torch.stack([zero, self.fy * inv_z, -self.fy * pc[..., 1] * inv_z2], dim=-1)
        return torch.stack([row0, row1], dim=-2)

    # --- distortion model (raw pixel domain) ---

    def undistort_points(self, uv: torch.Tensor) -> torch.Tensor:
        """Raw pixels [..., 2] -> ideal pixels [..., 2] (fixed-point inversion)."""
        return _undistort_radtan(uv, self.fx, self.fy, self.cx, self.cy, self.dist)

    def uncertainty(self, uv: torch.Tensor) -> torch.Tensor:
        """Per-keypoint measurement-scale multiplier (== 1, Pinhole.cpp:55-57)."""
        return torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device)

    def is_in_image(self, uv: torch.Tensor) -> torch.Tensor:
        return ((uv[..., 0] >= self.min_x) & (uv[..., 0] < self.max_x)
                & (uv[..., 1] >= self.min_y) & (uv[..., 1] < self.max_y))
