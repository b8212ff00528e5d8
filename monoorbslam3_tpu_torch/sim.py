"""Deterministic synthetic world (counterpart of `monoorbslam3_tpu/sim.py`,
whole), numpy only.

`Trajectory` is analytic: pose, velocity, acceleration and body rate in
closed form, and IMU samples drawn from them (bit-identical to the JAX
package's on the same seed).

`ImageWorld` ray-casts a procedurally textured cylinder wall with pillars
into grayscale images. The ray/scene intersection lives in `intersect`, so
a caller can also lift a keypoint to the true world point it sees
(`world_points`) with the very code that rendered it.

`ForwardTrajectory` and `CorridorImageWorld` are the forward-motion
(KITTI-like) street, `CorridorWorld` its feature-injection twin.

`World` is the feature-injection world: a landmark field projected through
the port camera with pixel and descriptor noise, which drives the tracker
without the extractor (its observations are bit-identical to the JAX
package's on the same seeds).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .models.imu import GRAVITY_VALUE

G_W = np.array([0.0, 0.0, -GRAVITY_VALUE])


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

    def vel(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([-self.radius * self.omega * np.sin(self.omega * t),
                         self.radius * self.omega * np.cos(self.omega * t),
                         self.height_amp * self.omega_z * np.cos(self.omega_z * t)], axis=-1)

    def acc(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([-self.radius * self.omega**2 * np.cos(self.omega * t),
                         -self.radius * self.omega**2 * np.sin(self.omega * t),
                         -self.height_amp * self.omega_z**2 * np.sin(self.omega_z * t)],
                        axis=-1)

    def yaw(self, t):
        return self.omega * np.asarray(t, np.float64) + np.pi / 2.0

    def R_wb(self, t):
        y = self.yaw(t)
        c, s = np.cos(y), np.sin(y)
        zero, one = np.zeros_like(c), np.ones_like(c)
        return np.stack([np.stack([c, -s, zero], axis=-1),
                         np.stack([s, c, zero], axis=-1),
                         np.stack([zero, zero, one], axis=-1)], axis=-2)

    def omega_body(self, t):
        """Body angular rate (yaw-only rotation: a constant z rate)."""
        t = np.asarray(t, np.float64)
        out = np.zeros(t.shape + (3,))
        out[..., 2] = self.omega
        return out

    def imu_samples(self, t0, t1, freq, bg=None, ba=None, noise_gyro=0.0,
                    noise_acc=0.0, rng=None):
        """IMU samples in [t0, t1) at `freq`: gyro/acc with optional bias and
        white noise (densities, discretized at `freq`). Returns (gyro [N, 3],
        acc [N, 3], dts [N]) float32, left-rectangular sampling (the
        measurement at the interval start, Frame.cpp:73-88)."""
        rng = rng or np.random.default_rng(0)
        bg = np.zeros(3) if bg is None else np.asarray(bg)
        ba = np.zeros(3) if ba is None else np.asarray(ba)
        dt = 1.0 / freq
        ts = np.arange(t0, t1 - 1e-9, dt)
        gyro = self.omega_body(ts) + bg
        a_w = self.acc(ts) - G_W  # specific force in the world frame
        R = self.R_wb(ts)
        acc = np.einsum("nij,nj->ni", np.swapaxes(R, -1, -2), a_w) + ba
        if noise_gyro > 0:
            gyro = gyro + rng.normal(scale=noise_gyro * np.sqrt(freq), size=gyro.shape)
        if noise_acc > 0:
            acc = acc + rng.normal(scale=noise_acc * np.sqrt(freq), size=acc.shape)
        dts = np.full(len(ts), dt)
        return gyro.astype(np.float32), acc.astype(np.float32), dts.astype(np.float32)


@dataclass
class HoverTrajectory(Trajectory):
    """Quasi-stationary oscillation (EuRoC-MH-style hover): a bounded view
    direction (a small yaw wiggle) and strong accelerations for IMU
    observability, analytic as the circle."""

    amp: float = 0.8
    w1: float = 1.3
    w2: float = 0.9
    w3: float = 1.7
    yaw_amp: float = 0.25
    yaw_w: float = 0.7

    def pos(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([self.radius + self.amp * np.sin(self.w1 * t),
                         0.7 * self.amp * np.sin(self.w2 * t),
                         0.4 * self.amp * np.sin(self.w3 * t)], axis=-1)

    def vel(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([self.amp * self.w1 * np.cos(self.w1 * t),
                         0.7 * self.amp * self.w2 * np.cos(self.w2 * t),
                         0.4 * self.amp * self.w3 * np.cos(self.w3 * t)], axis=-1)

    def acc(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([-self.amp * self.w1**2 * np.sin(self.w1 * t),
                         -0.7 * self.amp * self.w2**2 * np.sin(self.w2 * t),
                         -0.4 * self.amp * self.w3**2 * np.sin(self.w3 * t)], axis=-1)

    def yaw(self, t):
        return self.yaw_amp * np.sin(self.yaw_w * np.asarray(t, np.float64))

    def omega_body(self, t):
        t = np.asarray(t, np.float64)
        out = np.zeros(t.shape + (3,))
        out[..., 2] = self.yaw_amp * self.yaw_w * np.cos(self.yaw_w * t)
        return out


@dataclass
class ForwardTrajectory(Trajectory):
    """Forward-dominant vehicle motion (the KITTI-raw regime): constant
    speed along +x with a lateral meander, small vertical bumps and a
    longitudinal surge; yaw follows the tangent, so the camera looks near
    the focus of expansion. The surge (~5 s period) keeps the
    monocular-inertial scale observable inside the init window (see the
    JAX package's docstring)."""

    speed: float = 8.0
    curve_amp: float = 4.0
    curve_w: float = 0.12
    bump_amp: float = 0.04
    bump_w: float = 2.1
    surge_amp: float = 0.35
    surge_w: float = 1.3

    def pos(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([
            self.speed * t + self.surge_amp * np.sin(self.surge_w * t),
            self.curve_amp * np.sin(self.curve_w * t),
            self.bump_amp * np.sin(self.bump_w * t),
        ], axis=-1)

    def vel(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([
            self.speed + self.surge_amp * self.surge_w * np.cos(self.surge_w * t),
            self.curve_amp * self.curve_w * np.cos(self.curve_w * t),
            self.bump_amp * self.bump_w * np.cos(self.bump_w * t),
        ], axis=-1)

    def acc(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([
            -self.surge_amp * self.surge_w**2 * np.sin(self.surge_w * t),
            -self.curve_amp * self.curve_w**2 * np.sin(self.curve_w * t),
            -self.bump_amp * self.bump_w**2 * np.sin(self.bump_w * t),
        ], axis=-1)

    def _vx(self, t):
        return self.speed + self.surge_amp * self.surge_w * np.cos(self.surge_w * t)

    def yaw(self, t):
        t = np.asarray(t, np.float64)
        vy = self.curve_amp * self.curve_w * np.cos(self.curve_w * t)
        return np.arctan2(vy, self._vx(t))

    def omega_body(self, t):
        t = np.asarray(t, np.float64)
        vx = self._vx(t)
        dvx = -self.surge_amp * self.surge_w**2 * np.sin(self.surge_w * t)
        vy = self.curve_amp * self.curve_w * np.cos(self.curve_w * t)
        dvy = -self.curve_amp * self.curve_w**2 * np.sin(self.curve_w * t)
        out = np.zeros(t.shape + (3,))
        out[..., 2] = (dvy * vx - vy * dvx) / (vx * vx + vy * vy)
        return out


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
    # low-texture stretch: the wall azimuth sector [a0, a1] (radians) whose
    # texture contrast collapses (a white wall, an overexposed window)
    blank_sector: tuple | None = None

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
        if self.blank_sector is not None:
            a0, a1 = self.blank_sector
            c0 = int((a0 + np.pi) / (2 * np.pi) * self.tex_w)
            c1 = int((a1 + np.pi) / (2 * np.pi) * self.tex_w)
            c0, c1 = max(0, min(c0, c1)), min(self.tex_w, max(c0, c1))
            band = self.texture[:, c0:c1]
            self.texture[:, c0:c1] = band.mean() + 0.02 * (band - band.mean())
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


@dataclass
class CorridorImageWorld(ImageWorld):
    """Renderable street for forward motion (KITTI-like): two textured
    facades, a ground plane and a far end wall, ray-cast with ImageWorld's
    texture, sky above the facades. Pair with ForwardTrajectory: most
    pixels sit near the focus of expansion. The JAX package's docstring
    gives the measurements behind the width and the texture scale."""

    half_width: float = 30.0
    ground_z: float = -1.6
    facade_top: float = 14.0
    sky_lum: float = 96.0
    length: float = 700.0  # the far end wall
    tile_u: float = 96.0  # metres per texture tile along u
    tile_v: float = 24.0  # and along v

    def render(self, t, camera, R_bc, t_bc, noise=1.0, rng=None):
        rng = rng or np.random.default_rng(int(t * 1e3) % (2**31))
        d_c = self._ray_grid(camera)
        R_cw, t_cw = self.pose_cw(t, R_bc, t_bc)
        R_wc = R_cw.T
        o_w = -R_wc @ t_cw
        d_w = d_c @ R_wc.T  # [H, W, 3]

        H, W = d_w.shape[:2]
        s_best = np.full((H, W), np.inf)
        tu = np.zeros((H, W))
        tv = np.zeros((H, W))
        # (axis, value, uoff, clip): u along x, v along the other axis (the
        # end wall: u along y, v along z); `clip` stops the facades at
        # facade_top
        planes = [
            (1, +self.half_width, 0.00, True),   # left facade:  (x, z)
            (1, -self.half_width, 0.37, True),   # right facade
            (2, self.ground_z, 0.61, False),     # ground:       (x, y)
            (0, self.length, 0.19, True),        # end wall:     (y, z)
        ]
        sky = np.ones((H, W), bool)
        for axis, value, uoff, clip in planes:
            dn = d_w[..., axis]
            with np.errstate(divide="ignore", invalid="ignore"):
                s = np.where(np.abs(dn) > 1e-9, (value - o_w[axis]) / dn, np.inf)
            hit = (s > 0.1) & (s < s_best)
            s = np.where(hit, s, 1.0)  # keep masked-lane math finite
            p = o_w[None, None] + s[..., None] * d_w
            if clip:
                hit &= p[..., 2] <= self.facade_top
            uax = 1 if axis == 0 else 0
            u = np.mod(p[..., uax] / self.tile_u + uoff, 1.0) * (self.tex_w - 1)
            vax = 1 if axis == 2 else 2
            v = np.mod(p[..., vax] / self.tile_v + 0.5, 1.0) * (self.tex_h - 1)
            s_best = np.where(hit, s, s_best)
            sky &= ~hit
            tu = np.where(hit, u, tu)
            tv = np.where(hit, v, tv)

        u0 = np.floor(tu).astype(np.int64) % self.tex_w
        v0 = np.floor(tv).astype(np.int64) % self.tex_h
        u1 = (u0 + 1) % self.tex_w
        v1 = (v0 + 1) % self.tex_h
        au = (tu - np.floor(tu)).astype(np.float32)
        av = (tv - np.floor(tv)).astype(np.float32)
        T = self.texture
        img = ((1 - au) * (1 - av) * T[v0, u0] + au * (1 - av) * T[v0, u1]
               + (1 - au) * av * T[v1, u0] + au * av * T[v1, u1])
        img = np.where(sky, self.sky_lum, img)
        if noise > 0:
            img = img + rng.normal(scale=noise, size=img.shape)
        return np.clip(img, 0, 255).astype(np.float32)


@dataclass
class World:
    """Landmark field + feature observation generator: the feature-injection
    world that drives the tracker without the extractor."""

    traj: Trajectory = field(default_factory=Trajectory)
    n_points: int = 2000
    seed: int = 7

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        # landmarks on a cylinder band outside the trajectory circle, so the
        # outward/tangent-facing camera always sees a wall of texture
        r = rng.uniform(self.traj.radius + 3.0, self.traj.radius + 9.0, self.n_points)
        th = rng.uniform(0, 2 * np.pi, self.n_points)
        z = rng.uniform(-3.0, 4.0, self.n_points)
        self.points = np.stack([r * np.cos(th), r * np.sin(th), z], axis=-1)
        # a 256-bit descriptor per landmark, packed into 8 uint32 words
        self.desc = rng.integers(0, 2**32, size=(self.n_points, 8), dtype=np.uint32)
        self._rng = rng

    def camera_pose(self, t, R_bc, t_bc):
        """World->camera (R_cw, t_cw) from the body pose and the body->camera
        extrinsics."""
        R_wb = self.traj.R_wb(t)
        p_wb = self.traj.pos(t)
        R_wc = R_wb @ R_bc
        t_wc = R_wb @ t_bc + p_wb
        R_cw = R_wc.T
        t_cw = -R_cw @ t_wc
        return R_cw, t_cw

    def observe(self, t, camera, R_bc, t_bc, noise_px=0.3, flip_bits=4,
                max_kps=1024, min_depth=0.3, rng=None):
        """Project the landmarks into the camera at time t (through the
        port camera's float32 `project` and `is_in_image`, on its device).

        Returns a dict of padded arrays: uv [max_kps, 2], desc [max_kps, 8]
        uint32, point_id [max_kps] (-1 padding), valid [max_kps] bool, and
        the true R_cw, t_cw. The descriptors are the landmark's with
        `flip_bits` random bits flipped (ORB descriptor noise across
        views)."""
        rng = rng or self._rng
        R_cw, t_cw = self.camera_pose(t, R_bc, t_bc)
        pc = self.points @ R_cw.T + t_cw
        pc_t = torch.as_tensor(pc.astype(np.float32), device=camera.device)
        uv_t = camera.project(pc_t)
        uv = uv_t.cpu().numpy()
        in_img = camera.is_in_image(uv_t).cpu().numpy()
        vis = (pc[:, 2] > min_depth) & in_img
        ids = np.nonzero(vis)[0]
        if len(ids) > max_kps:
            # a deterministic subset by landmark id: consecutive frames see
            # (mostly) the same landmarks, as a feature extractor does
            ids = ids[:max_kps]
        k = len(ids)

        out_uv = np.zeros((max_kps, 2), np.float32)
        out_desc = np.zeros((max_kps, 8), np.uint32)
        out_pid = np.full(max_kps, -1, np.int64)
        out_valid = np.zeros(max_kps, bool)

        out_uv[:k] = uv[ids] + rng.normal(scale=noise_px, size=(k, 2))
        d = self.desc[ids].copy()
        if flip_bits > 0:
            for _ in range(flip_bits):
                word = rng.integers(0, 8, size=k)
                bit = rng.integers(0, 32, size=k).astype(np.uint32)
                d[np.arange(k), word] ^= (np.uint32(1) << bit)
        out_desc[:k] = d
        out_pid[:k] = ids
        out_valid[:k] = True
        return {
            "uv": out_uv, "desc": out_desc, "point_id": out_pid, "valid": out_valid,
            "R_cw": R_cw.astype(np.float32), "t_cw": t_cw.astype(np.float32),
        }


@dataclass
class CorridorWorld(World):
    """Feature-injection corridor for forward motion: landmarks on two side
    walls, the ground and a far skyline along the trajectory's x-extent."""

    traj: Trajectory = field(default_factory=ForwardTrajectory)
    length: float = 600.0
    half_width: float = 12.0
    ground_z: float = -1.6
    # low-texture stretch: an x-range with a sparse landmark field
    sparse_x: tuple | None = None
    sparse_keep: float = 0.12

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        n_far = self.n_points // 5  # end-wall skyline (the KITTI horizon)
        n_wall = (self.n_points - n_far) * 2 // 5
        n_ground = self.n_points - n_far - 2 * n_wall
        x_l = rng.uniform(-10.0, self.length, n_wall)
        x_r = rng.uniform(-10.0, self.length, n_wall)
        x_g = rng.uniform(-10.0, self.length, n_ground)
        left = np.stack([x_l, np.full(n_wall, self.half_width),
                         rng.uniform(self.ground_z, 4.0, n_wall)], -1)
        right = np.stack([x_r, np.full(n_wall, -self.half_width),
                          rng.uniform(self.ground_z, 4.0, n_wall)], -1)
        ground = np.stack([x_g, rng.uniform(-self.half_width, self.half_width, n_ground),
                           np.full(n_ground, self.ground_z)], -1)
        far = np.stack([np.full(n_far, self.length + 80.0),
                        rng.uniform(-60.0, 60.0, n_far),
                        rng.uniform(self.ground_z, 25.0, n_far)], -1)
        self.points = np.concatenate([left, right, ground, far], axis=0)
        if self.sparse_x is not None:
            x0, x1 = self.sparse_x
            inside = (self.points[:, 0] >= x0) & (self.points[:, 0] <= x1)
            drop = inside & (rng.uniform(size=len(inside)) > self.sparse_keep)
            self.points = self.points[~drop]
        self.n_points = len(self.points)
        self.desc = rng.integers(0, 2**32, size=(self.n_points, 8), dtype=np.uint32)
        self._rng = rng
