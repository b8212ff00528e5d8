"""Ray-cast renderer of the synthetic worlds in plain torch (a copy of the
port's `sim.ImageWorld.render` and `sim.CorridorImageWorld.render`), on
any device. The texture and the pillars are drawn from a torch Generator
on the render device, so one seed gives the same world on every run.

The camera's rays come from its own radtan undistortion (the 10-step
fixed-point inversion, in float32, as the port's camera takes it); the
scene is intersected in float64 and sampled bilinearly in float32.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

TEX_H, TEX_W = 1024, 4096
TEX_CELLS = (8, 16, 32, 64)


def _distort(xy, dist):
    k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def camera_rays(fx, fy, cx, cy, dist, width, height, device) -> torch.Tensor:
    """[H, W, 3] float64 unit-depth rays of every raw pixel."""
    f32 = dict(dtype=torch.float32, device=device)
    d = torch.zeros(5, **f32)
    dd = torch.as_tensor(list(dist)[:5], **f32)
    d[: dd.shape[0]] = dd
    fx, fy, cx, cy = (torch.tensor(float(v), **f32) for v in (fx, fy, cx, cy))
    v, u = torch.meshgrid(torch.arange(height, **f32), torch.arange(width, **f32), indexing="ij")
    xyd = torch.stack([(u - cx) / fx, (v - cy) / fy], dim=-1)
    xy = xyd
    for _ in range(10):
        xy = xyd - (_distort(xy, d) - xy)
    # ideal pixels, then back to unit-depth rays, as the port's
    # undistort_points + back_project compose
    u_i = xy[..., 0] * fx + cx
    v_i = xy[..., 1] * fy + cy
    rays = torch.stack([(u_i - cx) / fx, (v_i - cy) / fy, torch.ones_like(u_i)], dim=-1)
    return rays.to(torch.float64)


def make_texture(gen: torch.Generator, device) -> torch.Tensor:
    """The multi-scale blocky texture [TEX_H, TEX_W] float32 in 0..255:
    corners at every pyramid level."""
    tex = torch.zeros((TEX_H, TEX_W), dtype=torch.float64, device=device)
    for cell in TEX_CELLS:
        small = torch.rand((TEX_H // cell, TEX_W // cell), generator=gen, device=device,
                           dtype=torch.float64)
        tex += small.repeat_interleave(cell, 0).repeat_interleave(cell, 1)
    tex -= tex.min()
    tex *= 255.0 / tex.max()
    return tex.to(torch.float32)


def _sample(texture, tu, tv):
    H, W = texture.shape
    fu, fv = torch.floor(tu), torch.floor(tv)
    u0 = fu.long() % W
    v0 = fv.long() % H
    u1 = (u0 + 1) % W
    v1 = (v0 + 1) % H
    au = (tu - fu).to(torch.float32)
    av = (tv - fv).to(torch.float32)
    T = texture
    return ((1 - au) * (1 - av) * T[v0, u0] + au * (1 - av) * T[v0, u1]
            + (1 - au) * av * T[v1, u0] + au * av * T[v1, u1])


@dataclass
class CircleWorld:
    """A textured cylinder wall around the trajectory's circle, with
    textured pillars (`sim.ImageWorld`)."""

    texture: torch.Tensor
    pillar_xy: torch.Tensor  # [n, 2] float64
    pillar_uoff: torch.Tensor  # [n] float64
    wall_radius: float = 11.0
    pillar_radius: float = 0.8
    z_span: float = 8.0

    @staticmethod
    def create(gen, device, n_pillars=12, pillar_ring=8.0, **kw):
        tex = make_texture(gen, device)
        f64 = dict(dtype=torch.float64, device=device)
        ang = torch.rand(n_pillars, generator=gen, **f64) * (2 * math.pi)
        xy = torch.stack([pillar_ring * torch.cos(ang), pillar_ring * torch.sin(ang)], -1)
        return CircleWorld(tex, xy, torch.rand(n_pillars, generator=gen, **f64), **kw)

    def texcoords(self, o_w, d_w):
        """Nearest hit of rays o_w + s d_w [..., 3] -> texture coordinates."""
        tw, th = self.texture.shape[1], self.texture.shape[0]
        a = d_w[..., 0] ** 2 + d_w[..., 1] ** 2
        b = 2.0 * (o_w[0] * d_w[..., 0] + o_w[1] * d_w[..., 1])
        c = o_w[0] ** 2 + o_w[1] ** 2 - self.wall_radius**2
        disc = torch.clamp(b * b - 4 * a * c, min=0.0)
        two_a = torch.clamp(2 * a, min=1e-12)
        s = (-b + torch.sqrt(disc)) / two_a
        hit = o_w + s[..., None] * d_w
        theta = torch.atan2(hit[..., 1], hit[..., 0])
        tu = (theta + math.pi) / (2 * math.pi) * (tw - 1)
        tv = torch.remainder(hit[..., 2] / self.z_span + 0.5, 1.0) * (th - 1)
        for p_xy, uoff in zip(self.pillar_xy, self.pillar_uoff):
            oc = o_w[:2] - p_xy
            bp = 2.0 * (oc[0] * d_w[..., 0] + oc[1] * d_w[..., 1])
            cp = oc[0] ** 2 + oc[1] ** 2 - self.pillar_radius**2
            dp = bp * bp - 4 * a * cp
            ok = dp > 0
            sp = torch.where(ok, (-bp - torch.sqrt(torch.clamp(dp, min=0.0))) / two_a,
                             torch.ones_like(dp))
            closer = ok & (sp > 0.1) & (sp < s)
            sp = torch.where(closer, sp, torch.ones_like(sp))
            hp = o_w + sp[..., None] * d_w
            th_p = torch.atan2(hp[..., 1] - p_xy[1], hp[..., 0] - p_xy[0])
            tu_p = torch.remainder((th_p + math.pi) / (2 * math.pi) + uoff, 1.0) * (tw - 1)
            tv_p = torch.remainder(hp[..., 2] / (0.25 * self.z_span) + 0.5, 1.0) * (th - 1)
            s = torch.where(closer, sp, s)
            tu = torch.where(closer, tu_p, tu)
            tv = torch.where(closer, tv_p, tv)
        return tu, tv, torch.zeros_like(a, dtype=torch.bool)

    def render(self, R_wc, t_wc, rays_c, noise, gen):
        return _shade(self, R_wc, t_wc, rays_c, noise, gen, sky_lum=0.0)


@dataclass
class StreetWorld:
    """A street for forward motion: two textured facades, the ground and a
    far end wall, sky above the facades (`sim.CorridorImageWorld`)."""

    texture: torch.Tensor
    half_width: float = 8.0
    ground_z: float = -1.6
    facade_top: float = 14.0
    sky_lum: float = 96.0
    length: float = 700.0
    tile_u: float = 96.0
    tile_v: float = 24.0

    @staticmethod
    def create(gen, device, **kw):
        return StreetWorld(make_texture(gen, device), **kw)

    def texcoords(self, o_w, d_w):
        tw, th = self.texture.shape[1], self.texture.shape[0]
        shape = d_w.shape[:-1]
        s_best = torch.full(shape, math.inf, dtype=d_w.dtype, device=d_w.device)
        tu = torch.zeros_like(s_best)
        tv = torch.zeros_like(s_best)
        sky = torch.ones(shape, dtype=torch.bool, device=d_w.device)
        planes = ((1, self.half_width, 0.00, True), (1, -self.half_width, 0.37, True),
                  (2, self.ground_z, 0.61, False), (0, self.length, 0.19, True))
        for axis, value, uoff, clip in planes:
            dn = d_w[..., axis]
            big = torch.abs(dn) > 1e-9
            s = torch.where(big, (value - o_w[axis]) / torch.where(big, dn, torch.ones_like(dn)),
                            torch.full_like(dn, math.inf))
            hit = (s > 0.1) & (s < s_best)
            s = torch.where(hit, s, torch.ones_like(s))
            p = o_w + s[..., None] * d_w
            if clip:
                hit = hit & (p[..., 2] <= self.facade_top)
            uax = 1 if axis == 0 else 0
            vax = 1 if axis == 2 else 2
            u = torch.remainder(p[..., uax] / self.tile_u + uoff, 1.0) * (tw - 1)
            v = torch.remainder(p[..., vax] / self.tile_v + 0.5, 1.0) * (th - 1)
            s_best = torch.where(hit, s, s_best)
            sky = sky & ~hit
            tu = torch.where(hit, u, tu)
            tv = torch.where(hit, v, tv)
        return tu, tv, sky

    def render(self, R_wc, t_wc, rays_c, noise, gen):
        return _shade(self, R_wc, t_wc, rays_c, noise, gen, sky_lum=self.sky_lum)


def _shade(world, R_wc, t_wc, rays_c, noise, gen, sky_lum):
    """[H, W] float32 image in 0..255 seen from the camera at (R_wc, t_wc)
    (float64 [3, 3] and [3] on the render device), with Gaussian pixel
    noise of sigma `noise` drawn from `gen`."""
    d_w = rays_c @ R_wc.T
    tu, tv, sky = world.texcoords(t_wc, d_w)
    img = _sample(world.texture, tu, tv)
    img = torch.where(sky, torch.full_like(img, sky_lum), img)
    if noise > 0:
        img = img + noise * torch.randn(img.shape, generator=gen, device=img.device,
                                        dtype=torch.float32)
    return torch.clamp(img, 0, 255)


WORLDS = {"circle": CircleWorld, "street": StreetWorld}
