"""Deterministic synthetic world (counterpart of `Trajectory` and
`ImageWorld` in `monoorbslam3_tpu/sim.py`), numpy only.

`ImageWorld` ray-casts a procedurally textured cylinder wall with pillars
into grayscale images. The ray/scene intersection lives in `intersect`, so
a caller can also lift a keypoint to the true world point it sees
(`world_points`) with the very code that rendered it.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Trajectory:
    """Analytic circle-with-bounce trajectory; yaw follows the tangent.

    p(t) = [r cos(w t), r sin(w t), h sin(w2 t)], R_wb(t) = Rz(w t + pi/2).
    """

    radius: float = 5.0
    omega: float = 0.35
    height_amp: float = 0.4
    omega_z: float = 0.9

    def pos(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([self.radius * np.cos(self.omega * t),
                         self.radius * np.sin(self.omega * t),
                         self.height_amp * np.sin(self.omega_z * t)], axis=-1)

    def yaw(self, t):
        return self.omega * np.asarray(t, np.float64) + np.pi / 2.0

    def R_wb(self, t):
        y = self.yaw(t)
        c, s = np.cos(y), np.sin(y)
        zero, one = np.zeros_like(c), np.ones_like(c)
        return np.stack([np.stack([c, -s, zero], axis=-1),
                         np.stack([s, c, zero], axis=-1),
                         np.stack([zero, zero, one], axis=-1)], axis=-2)


@dataclass
class ImageWorld:
    """Renderable synthetic world: a textured cylinder wall around the
    trajectory circle plus textured pillars, ray-cast per frame."""

    traj: Trajectory = field(default_factory=Trajectory)
    wall_radius: float = 11.0
    n_pillars: int = 12
    pillar_ring: float = 8.0
    pillar_radius: float = 0.8
    tex_h: int = 1024
    tex_w: int = 4096
    seed: int = 11

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # multi-scale blocky texture: corners at every pyramid level
        tex = np.zeros((self.tex_h, self.tex_w))
        for cell in (8, 16, 32, 64):
            small = rng.uniform(0, 1, (self.tex_h // cell, self.tex_w // cell))
            tex += np.kron(small, np.ones((cell, cell)))
        tex -= tex.min()
        tex *= 255.0 / tex.max()
        self.texture = tex.astype(np.float32)
        self.z_span = 8.0  # vertical extent the texture band covers
        ang = rng.uniform(0, 2 * np.pi, self.n_pillars)
        self.pillar_xy = np.stack(
            [self.pillar_ring * np.cos(ang), self.pillar_ring * np.sin(ang)], -1)
        self.pillar_uoff = rng.uniform(0, 1, self.n_pillars)

    def pose_cw(self, t, R_bc, t_bc):
        R_wb = self.traj.R_wb(t)
        p_wb = self.traj.pos(t)
        R_wc = R_wb @ R_bc
        t_wc = R_wb @ t_bc + p_wb
        return R_wc.T, -R_wc.T @ t_wc

    def camera_rays(self, camera, uv_raw: np.ndarray) -> np.ndarray:
        """Raw pixels [..., 2] -> camera-frame unit-depth rays [..., 3]
        (float64), through the port camera's undistortion."""
        uv = torch.as_tensor(np.array(uv_raw, np.float32).reshape(-1, 2),
                             device=camera.device)
        rays = camera.back_project(camera.undistort_points(uv)).cpu().numpy()
        return rays.astype(np.float64).reshape(*np.shape(uv_raw)[:-1], 3)

    def _ray_grid(self, camera):
        """Per-pixel camera-frame ray directions, cached per camera. The
        rendered image carries the camera's true distortion."""
        key = (int(camera.width), int(camera.height), float(camera.fx),
               float(camera.fy), float(camera.cx), float(camera.cy),
               camera.dist.cpu().numpy().tobytes())
        if getattr(self, "_ray_key", None) != key:
            H, W = int(camera.height), int(camera.width)
            u, v = np.meshgrid(np.arange(W, dtype=np.float32),
                               np.arange(H, dtype=np.float32))
            self._rays = self.camera_rays(camera, np.stack([u, v], -1))
            self._ray_key = key
        return self._rays

    def intersect(self, o_w: np.ndarray, d_w: np.ndarray):
        """Nearest scene hit of rays o_w + s d_w (d_w [..., 3]): returns the
        ray parameter s and the texture coordinates (tu, tv), each [...]."""
        # wall: |o_xy + s d_xy|^2 = wall_radius^2, exit (larger) root — the
        # camera is inside the cylinder
        a = d_w[..., 0] ** 2 + d_w[..., 1] ** 2
        b = 2.0 * (o_w[0] * d_w[..., 0] + o_w[1] * d_w[..., 1])
        c = o_w[0] ** 2 + o_w[1] ** 2 - self.wall_radius**2
        disc = np.maximum(b * b - 4 * a * c, 0.0)
        s = (-b + np.sqrt(disc)) / np.maximum(2 * a, 1e-12)
        hit = o_w + s[..., None] * d_w
        theta = np.arctan2(hit[..., 1], hit[..., 0])  # [-pi, pi]
        tu = (theta + np.pi) / (2 * np.pi) * (self.tex_w - 1)
        tv = np.mod(hit[..., 2] / self.z_span + 0.5, 1.0) * (self.tex_h - 1)

        # pillars: entry (smaller) root; nearest hit wins (occlusion)
        for p_xy, uoff in zip(self.pillar_xy, self.pillar_uoff):
            oc = o_w[:2] - p_xy
            bp = 2.0 * (oc[0] * d_w[..., 0] + oc[1] * d_w[..., 1])
            cp = oc[0] ** 2 + oc[1] ** 2 - self.pillar_radius**2
            dp = bp * bp - 4 * a * cp
            hit_ok = dp > 0
            sp = np.where(
                hit_ok,
                (-bp - np.sqrt(np.maximum(dp, 0.0))) / np.maximum(2 * a, 1e-12),
                1.0,
            )
            closer = hit_ok & (sp > 0.1) & (sp < s)
            sp = np.where(closer, sp, 1.0)  # keep masked-lane math finite
            hp = o_w + sp[..., None] * d_w
            th_p = np.arctan2(hp[..., 1] - p_xy[1], hp[..., 0] - p_xy[0])
            tu_p = np.mod((th_p + np.pi) / (2 * np.pi) + uoff, 1.0) * (self.tex_w - 1)
            tv_p = np.mod(hp[..., 2] / (0.25 * self.z_span) + 0.5, 1.0) * (self.tex_h - 1)
            s = np.where(closer, sp, s)
            tu = np.where(closer, tu_p, tu)
            tv = np.where(closer, tv_p, tv)
        return s, tu, tv

    def world_points(self, t, camera, R_bc, t_bc, uv_raw: np.ndarray) -> np.ndarray:
        """True world points [..., 3] seen at raw pixels uv_raw at time t."""
        R_cw, t_cw = self.pose_cw(t, R_bc, t_bc)
        R_wc = R_cw.T
        o_w = -R_wc @ t_cw
        d_w = self.camera_rays(camera, uv_raw) @ R_wc.T
        s, _, _ = self.intersect(o_w, d_w)
        return o_w + s[..., None] * d_w

    def render(self, t, camera, R_bc, t_bc, noise=1.0, rng=None):
        """Ray-cast the scene at time t -> [H, W] float32 image 0..255."""
        rng = rng or np.random.default_rng(int(t * 1e3) % (2**31))
        d_c = self._ray_grid(camera)
        R_cw, t_cw = self.pose_cw(t, R_bc, t_bc)
        R_wc = R_cw.T
        o_w = -R_wc @ t_cw  # camera center
        d_w = d_c @ R_wc.T  # [H, W, 3] world ray dirs
        _, tu, tv = self.intersect(o_w, d_w)
        # bilinear sample
        u0 = np.floor(tu).astype(np.int64) % self.tex_w
        v0 = np.floor(tv).astype(np.int64) % self.tex_h
        u1 = (u0 + 1) % self.tex_w
        v1 = (v0 + 1) % self.tex_h
        au = (tu - np.floor(tu)).astype(np.float32)
        av = (tv - np.floor(tv)).astype(np.float32)
        T = self.texture
        img = ((1 - au) * (1 - av) * T[v0, u0] + au * (1 - av) * T[v0, u1]
               + (1 - au) * av * T[v1, u0] + au * av * T[v1, u1])
        if noise > 0:
            img = img + rng.normal(scale=noise, size=img.shape)
        return np.clip(img, 0, 255).astype(np.float32)
