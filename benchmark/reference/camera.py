# A frozen copy of `models/camera.py` as the port had it when the benchmark
# was written: the plain version the benchmark holds the timed path to.
# It imports nothing of the port; edit it only to follow a change of the
# semantics the configuration states.
"""Camera models: pinhole + radial-tangential, and Kannala-Brandt fisheye
(counterpart of `monoorbslam3_tpu/models/camera.py`).

Same semantics as the reference: pinhole `project` maps camera-frame
points with the ideal (undistorted) model, keypoints are undistorted once
per frame by a 10-step fixed-point inversion of the radtan model, and
`create` derives the valid undistorted-pixel bounds from the undistorted
image corners. Fisheye `project` applies the full KB4 distortion;
keypoints stay distorted and carry a per-pixel uncertainty instead.
Intrinsics are 0-d float32 tensors on the camera's device, so every
operation stays on that device. `project_np` is the numpy mirror of
`project` + `is_in_image` for host-side candidate selection.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ._util import CARD, resolve

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


def _kb4_poly(theta, dist):
    """KB4 theta polynomial d(theta) and its derivative d'(theta)."""
    k1, k2, k3, k4 = (dist[i] for i in range(4))
    t2 = theta * theta
    d = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    dp = 1.0 + t2 * (3 * k1 + t2 * (5 * k2 + t2 * (7 * k3 + t2 * 9 * k4)))
    return d, dp


def _kb4_unproject_theta(uv, fx, fy, cx, cy, dist):
    """Distorted pixels [..., 2] -> unit-depth rays [..., 3]: 10 Newton
    steps on the theta polynomial (Fisheye.cpp:141-172)."""
    mx = (uv[..., 0] - cx) / fx
    my = (uv[..., 1] - cy) / fy
    d = torch.sqrt(mx * mx + my * my)
    theta = d
    for _ in range(10):
        f, fp = _kb4_poly(theta, dist)
        theta = theta - (f - d) / torch.clamp(fp, min=1e-8)
    small = d < 1e-8
    one = torch.ones_like(d)
    scale = torch.where(small, one, torch.tan(theta) / torch.where(small, one, d))
    return torch.stack([mx * scale, my * scale, one], dim=-1)


@dataclass(frozen=True)
class Pinhole:
    """Pinhole + radtan(k1, k2, p1, p2, k3); 0-d f32 tensors on one device."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # [>= 5]: k1, k2, p1, p2, k3 (further terms unread)
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
        # the whole vector is kept, padded to five; the model reads the
        # first five (k1, k2, p1, p2, k3), as the JAX package does
        d = torch.zeros(5, **f32)
        if dist is not None:
            d = torch.as_tensor(np.asarray(dist, np.float32).reshape(-1), **f32)
            if d.shape[0] < 5:
                d = torch.cat([d, torch.zeros(5 - d.shape[0], **f32)])
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

    def distort_normalized(self, xy: torch.Tensor) -> torch.Tensor:
        """Apply radtan to normalized coords [..., 2]."""
        return _distort_normalized(xy, self.dist)

    def undistort_points(self, uv: torch.Tensor) -> torch.Tensor:
        """Raw pixels [..., 2] -> ideal pixels [..., 2] (fixed-point inversion)."""
        return _undistort_radtan(uv, self.fx, self.fy, self.cx, self.cy, self.dist)

    def uncertainty(self, uv: torch.Tensor) -> torch.Tensor:
        """Per-keypoint measurement-scale multiplier (== 1, Pinhole.cpp:55-57)."""
        return torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device)

    def is_in_image(self, uv: torch.Tensor) -> torch.Tensor:
        return ((uv[..., 0] >= self.min_x) & (uv[..., 0] < self.max_x)
                & (uv[..., 1] >= self.min_y) & (uv[..., 1] < self.max_y))


@dataclass(frozen=True)
class Fisheye:
    """Kannala-Brandt equidistant (KB4) model (reference: Fisheye.cpp)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # [4] = k1..k4 theta-polynomial coefficients
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, dist, width=0, height=0, device=CARD) -> "Fisheye":
        f32 = dict(dtype=torch.float32, device=resolve(device))
        return Fisheye(torch.tensor(float(fx), **f32), torch.tensor(float(fy), **f32),
                       torch.tensor(float(cx), **f32), torch.tensor(float(cy), **f32),
                       torch.as_tensor(np.asarray(dist, np.float32), **f32),
                       int(width), int(height))

    @property
    def device(self) -> torch.device:
        return self.fx.device

    def project(self, pc: torch.Tensor) -> torch.Tensor:
        """Camera-frame points [..., 3] -> distorted pixels (Fisheye.cpp:35-66)."""
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        r = torch.sqrt(x * x + y * y)
        theta = torch.atan2(r, z)
        d, _ = _kb4_poly(theta, self.dist)
        small = r < 1e-8
        one = torch.ones_like(r)
        scale = torch.where(small, one, d / torch.where(small, one, r))
        u = self.fx * x * scale + self.cx
        v = self.fy * y * scale + self.cy
        return torch.stack([u, v], dim=-1)

    def proj_jacobian(self, pc: torch.Tensor) -> torch.Tensor:
        """d(project)/d(pc): [..., 2, 3], the KB4 Jacobian in closed form
        (Fisheye.cpp:80-108; the JAX package takes it with jacfwd).

        With r = |(x, y)|, rho2 = r^2 + z^2, theta = atan2(r, z), s = d/r:
        ds/dx = x A, ds/dy = y A with A = (d' z / (rho2 r) - d / r^2) / r,
        and ds/dz = -d' / rho2. Below r = 1e-8 `project` uses s = 1, whose
        Jacobian is diag(fx, fy) and a zero z column."""
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        r2 = x * x + y * y
        r = torch.sqrt(r2)
        small = r < 1e-8
        one = torch.ones_like(r)
        rs = torch.where(small, one, r)
        theta = torch.atan2(r, z)
        d, dp = _kb4_poly(theta, self.dist)
        rho2 = torch.where(small, one, r2 + z * z)
        zero = torch.zeros_like(r)
        s = torch.where(small, one, d / rs)
        A = torch.where(small, zero, (dp * z / (rho2 * rs) - d / (rs * rs)) / rs)
        sz = torch.where(small, zero, -dp / rho2)
        row0 = torch.stack([self.fx * (s + x * x * A), self.fx * x * y * A,
                            self.fx * x * sz], dim=-1)
        row1 = torch.stack([self.fy * x * y * A, self.fy * (s + y * y * A),
                            self.fy * y * sz], dim=-1)
        return torch.stack([row0, row1], dim=-2)

    def unproject_theta(self, uv: torch.Tensor) -> torch.Tensor:
        """Distorted pixels -> unit-depth rays via Newton on the theta poly."""
        return _kb4_unproject_theta(uv, self.fx, self.fy, self.cx, self.cy, self.dist)

    def back_project(self, uv: torch.Tensor) -> torch.Tensor:
        return self.unproject_theta(uv)

    def undistort_points(self, uv: torch.Tensor) -> torch.Tensor:
        """Identity: fisheye keypoints stay distorted (Fisheye.cpp:114-117)."""
        return uv

    def uncertainty(self, uv: torch.Tensor) -> torch.Tensor:
        """Per-pixel measurement scale: the ideal-pinhole radius over the
        distorted radius (Fisheye.cpp:21-33, 110-112)."""
        ray = self.unproject_theta(uv)
        r_ideal = torch.sqrt(ray[..., 0] ** 2 + ray[..., 1] ** 2)
        mx = (uv[..., 0] - self.cx) / self.fx
        my = (uv[..., 1] - self.cy) / self.fy
        r_dist = torch.sqrt(mx * mx + my * my)
        small = r_dist < 1e-6
        one = torch.ones_like(r_dist)
        return torch.where(small, one, r_ideal / torch.where(small, one, r_dist))

    def is_in_image(self, uv: torch.Tensor) -> torch.Tensor:
        return ((uv[..., 0] >= 0.0) & (uv[..., 0] < self.width)
                & (uv[..., 1] >= 0.0) & (uv[..., 1] < self.height))


# ---------------------------------------------------------------------------
# Host-side (numpy) projection for control-plane decisions: the tracker's
# local-map harvest selects candidates over the whole point store with it,
# without a device round trip. Intrinsics are read once per camera object
# (one device read) and kept on it.
# ---------------------------------------------------------------------------


def _host_intrinsics(camera) -> dict:
    d = camera.__dict__.get("_host_intrinsics")
    if d is None:
        d = {"fx": float(camera.fx), "fy": float(camera.fy),
             "cx": float(camera.cx), "cy": float(camera.cy),
             "dist": camera.dist.cpu().numpy().astype(np.float64),
             "fisheye": isinstance(camera, Fisheye)}
        if d["fisheye"]:
            d.update(x0=0.0, y0=0.0, x1=float(camera.width), y1=float(camera.height))
        else:
            d.update(x0=float(camera.min_x), y0=float(camera.min_y),
                     x1=float(camera.max_x), y1=float(camera.max_y))
        # the cameras are frozen dataclasses: the cache goes straight into
        # the instance's __dict__
        camera.__dict__["_host_intrinsics"] = d
    return d


def project_np(camera, pc: np.ndarray):
    """Numpy mirror of camera.project + is_in_image: camera-frame points
    [..., 3] -> (uv [..., 2] float32, in_view [...]) with the z > 0.05
    cheirality gate of `_project_points`."""
    c = _host_intrinsics(camera)
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    if c["fisheye"]:
        r = np.sqrt(x * x + y * y)
        theta = np.arctan2(r, z)
        k1, k2, k3, k4 = c["dist"][:4]
        t2 = theta * theta
        dpoly = theta * (1.0 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
        scale = np.where(r < 1e-8, 1.0, dpoly / np.where(r < 1e-8, 1.0, r))
        u = c["fx"] * x * scale + c["cx"]
        v = c["fy"] * y * scale + c["cy"]
    else:
        zs = np.maximum(z, 1e-6)
        u = c["fx"] * x / zs + c["cx"]
        v = c["fy"] * y / zs + c["cy"]
    uv = np.stack([u, v], axis=-1).astype(np.float32)
    ok = ((z > 0.05) & (u >= c["x0"]) & (u < c["x1"])
          & (v >= c["y0"]) & (v < c["y1"]))
    return uv, ok
