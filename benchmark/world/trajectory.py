"""Analytic trajectories and their IMU samples (a copy of the port's
`sim.Trajectory`, `sim.ForwardTrajectory` and `Trajectory.imu_samples`),
numpy only."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

GRAVITY = 9.80
G_W = np.array([0.0, 0.0, -GRAVITY])


@dataclass
class Trajectory:
    """Circle with a vertical bounce; yaw follows the tangent.
    p(t) = [r cos(w t), r sin(w t), h sin(w2 t)], R_wb(t) = Rz(w t + pi/2)."""

    radius: float = 5.0
    omega: float = 0.35
    height_amp: float = 0.4
    omega_z: float = 0.9

    def pos(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([self.radius * np.cos(self.omega * t),
                         self.radius * np.sin(self.omega * t),
                         self.height_amp * np.sin(self.omega_z * t)], axis=-1)

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
        t = np.asarray(t, np.float64)
        out = np.zeros(t.shape + (3,))
        out[..., 2] = self.omega
        return out

    def imu_samples(self, t0, t1, freq, bg, ba, noise_gyro, noise_acc, rng):
        """Samples in [t0, t1) at `freq`, measured at each interval's start:
        (gyro [N, 3], acc [N, 3], dts [N]) float32, with the biases and white
        noise of the given densities discretized at `freq`."""
        dt = 1.0 / freq
        ts = np.arange(t0, t1 - 1e-9, dt)
        gyro = self.omega_body(ts) + np.asarray(bg)
        a_w = self.acc(ts) - G_W
        R = self.R_wb(ts)
        acc = np.einsum("nij,nj->ni", np.swapaxes(R, -1, -2), a_w) + np.asarray(ba)
        if noise_gyro > 0:
            gyro = gyro + rng.normal(scale=noise_gyro * np.sqrt(freq), size=gyro.shape)
        if noise_acc > 0:
            acc = acc + rng.normal(scale=noise_acc * np.sqrt(freq), size=acc.shape)
        return (gyro.astype(np.float32), acc.astype(np.float32),
                np.full(len(ts), dt, np.float32))


@dataclass
class ForwardTrajectory(Trajectory):
    """Forward vehicle motion: constant speed along +x with a lateral
    meander, small bumps and a longitudinal surge (which keeps the
    monocular-inertial scale observable); yaw follows the tangent."""

    speed: float = 8.0
    curve_amp: float = 4.0
    curve_w: float = 0.12
    bump_amp: float = 0.04
    bump_w: float = 2.1
    surge_amp: float = 0.35
    surge_w: float = 1.3

    def pos(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([self.speed * t + self.surge_amp * np.sin(self.surge_w * t),
                         self.curve_amp * np.sin(self.curve_w * t),
                         self.bump_amp * np.sin(self.bump_w * t)], axis=-1)

    def acc(self, t):
        t = np.asarray(t, np.float64)
        return np.stack([-self.surge_amp * self.surge_w**2 * np.sin(self.surge_w * t),
                         -self.curve_amp * self.curve_w**2 * np.sin(self.curve_w * t),
                         -self.bump_amp * self.bump_w**2 * np.sin(self.bump_w * t)], axis=-1)

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


TRAJECTORIES = {"circle": Trajectory, "forward": ForwardTrajectory}
