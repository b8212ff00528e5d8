"""Synthetic dataset streams (counterpart of `monoorbslam3_tpu/runners/synth.py`).

The scale-stress battery renders deterministic worlds that match a real
dataset's shape (duration, frame count, motion regime) and streams them
through the same runner path as a disk dataset:

- `circle`    the tangent-camera circle world (an EuRoC-room-like sweep)
- `noisy`     the circle through the sensor model (exposure drift, blur,
  photometric noise: `apply_sensor_model`)
- `fastspin`  the circle at an aggressive yaw rate
- `lowtex`    the circle with a low-contrast wall sector
- `corridor`  ForwardTrajectory down a textured street (KITTI-raw-like)

Spec strings select and parameterize: "circle:t_end=60,fps=20". The same
spec and seed give the same images, IMU rows and ground-truth text as the
JAX package, to the byte. Host numpy throughout: this is a validation
surface, not the perf path, and it builds no tensors.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..sim import CorridorImageWorld, ForwardTrajectory, ImageWorld, Trajectory
from ..utils import lie


def parse_spec(spec: str) -> tuple[str, dict]:
    """'name:k=v,k=v' -> (name, {k: float(v)})."""
    if ":" in spec:
        name, rest = spec.split(":", 1)
        kv = {}
        for part in rest.split(","):
            if part:
                k, v = part.split("=")
                kv[k] = float(v)
        return name, kv
    return spec, {}


def make_world(name: str, kv: dict):
    """Returns (world, trajectory, default_t_end)."""
    if name in ("circle", "noisy"):
        traj = Trajectory()
        return ImageWorld(traj=traj), traj, kv.get("t_end", 60.0)
    if name == "fastspin":
        # 0.9 rad/s = 52 deg/s sustained (2.6x the base world)
        traj = Trajectory(omega=kv.get("omega", 0.9))
        return ImageWorld(traj=traj), traj, kv.get("t_end", 30.0)
    if name == "lowtex":
        traj = Trajectory()
        width = kv.get("sector", 1.1)
        return (ImageWorld(traj=traj, blank_sector=(0.6, 0.6 + width)),
                traj, kv.get("t_end", 60.0))
    if name == "corridor":
        speed = kv.get("speed", 8.0)
        t_end = kv.get("t_end", 60.0)
        traj = ForwardTrajectory(speed=speed)
        # the street outlasts the drive: the end wall stays ~200 m beyond
        # the trajectory's end (see the JAX package for the loss it caused)
        length = kv.get("length", max(700.0, speed * t_end + 200.0))
        return (CorridorImageWorld(traj=traj, half_width=kv.get("half_width", 8.0),
                                   length=length),
                traj, t_end)
    raise ValueError(f"unknown synthetic world {name!r} "
                     "(circle|fastspin|lowtex|corridor|noisy)")


def _conv1d_edge(img: np.ndarray, kernel: np.ndarray, axis: int) -> np.ndarray:
    """Small separable convolution with edge padding."""
    pad = len(kernel) // 2
    padding = [(pad, pad) if i == axis else (0, 0) for i in range(img.ndim)]
    ap = np.pad(img, padding, mode="edge")
    out = np.zeros_like(img)
    for i, w in enumerate(kernel):
        sl = [slice(None)] * img.ndim
        sl[axis] = slice(i, i + img.shape[axis])
        out += w * ap[tuple(sl)]
    return out


def apply_sensor_model(img: np.ndarray, t: float, rng, noise: float = 6.0,
                       exp_amp: float = 0.35, exp_period: float = 17.0, blur: float = 0.9):
    """Camera-artifact model of the `noisy` world: a slow exposure (gain)
    drift of +-exp_amp, a Gaussian blur of sigma `blur` px (the motion-blur
    stand-in) and Gaussian photometric noise of sigma `noise` gray levels."""
    g = 1.0 + exp_amp * np.sin(2.0 * np.pi * t / exp_period)
    img = img * g
    if blur > 0:
        half = max(1, int(np.ceil(2.0 * blur)))
        x = np.arange(-half, half + 1, dtype=np.float32)
        k = np.exp(-0.5 * (x / blur) ** 2)
        k /= k.sum()
        img = _conv1d_edge(_conv1d_edge(img, k, 0), k, 1)
    if noise > 0:
        img = img + rng.normal(scale=noise, size=img.shape)
    return np.clip(img, 0, 255).astype(np.float32)


class SyntheticDataset:
    """`__len__` + `frames()` yielding (t, image, imu_rows), like a disk
    dataset's loader. The frames are rendered through a CPU copy of
    `camera` (the port's camera, on any device), so the same spec and seed
    give the same bits on every device; `calib` gives the body->camera
    extrinsics."""

    def __init__(self, spec: str, camera, calib, fps: float = 20.0,
                 imu_freq: float = 200.0, seed: int = 9,
                 bg=(0.003, -0.002, 0.001), ba=(0.02, -0.015, 0.01),
                 noise_gyro: float = 1.7e-4, noise_acc: float = 2e-3,
                 image_noise: float = 1.0):
        name, kv = parse_spec(spec)
        self.world, self.traj, t_end = make_world(name, kv)
        self.name = name
        # the sensor-artifact model (world `noisy`), spec-overridable
        self.sensor = None
        if name == "noisy":
            self.sensor = dict(noise=kv.get("noise", 6.0), exp_amp=kv.get("exp_amp", 0.35),
                               exp_period=kv.get("exp_period", 17.0),
                               blur=kv.get("blur", 0.9))
        self.t_end = float(kv.get("t_end", t_end))
        self.fps = float(kv.get("fps", fps))
        self.camera = camera
        self.calib = calib
        self._render_camera = _on_cpu(camera)
        self.R_bc = _host(calib.R_bc).astype(np.float64)
        self.t_bc = _host(calib.t_bc).astype(np.float64)
        self.imu_freq = imu_freq
        self.seed = seed
        self.bg = np.asarray(bg)
        self.ba = np.asarray(ba)
        self.noise_gyro = noise_gyro
        self.noise_acc = noise_acc
        self.image_noise = image_noise
        self.times = np.arange(0.0, self.t_end, 1.0 / self.fps)

    def __len__(self):
        return len(self.times)

    def frames(self):
        rng = np.random.default_rng(self.seed)
        last_t = None
        for t in self.times:
            img = self.world.render(t, self._render_camera, self.R_bc, self.t_bc,
                                    noise=self.image_noise, rng=rng)
            if self.sensor is not None:
                img = apply_sensor_model(img, t, rng, **self.sensor)
            imu = None
            if last_t is not None:
                g, a, d = self.traj.imu_samples(
                    last_t, t, self.imu_freq, bg=self.bg, ba=self.ba,
                    noise_gyro=self.noise_gyro, noise_acc=self.noise_acc, rng=rng)
                ts = last_t + np.cumsum(d)
                imu = np.concatenate([ts[:, None], g, a], axis=1)
            yield t, img, imu
            last_t = t

    def save_ground_truth(self, path: str):
        """TUM-format ground-truth camera trajectory (t x y z qx qy qz qw) at
        the frame timestamps: the `gt` file evaluate_sequences reads."""
        with open(path, "w") as f:
            for t in self.times:
                R_wb = self.traj.R_wb(t)
                p_wb = self.traj.pos(t)
                R_wc = R_wb @ self.R_bc
                t_wc = R_wb @ self.t_bc + p_wb
                q = lie.rot_to_quat(torch.as_tensor(np.asarray(R_wc, np.float32))).numpy()
                f.write(f"{t:.6f} {t_wc[0]:.7f} {t_wc[1]:.7f} {t_wc[2]:.7f} "
                        f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _on_cpu(camera):
    """The camera record with its tensors on the CPU."""
    return dataclasses.replace(camera, **{
        f.name: getattr(camera, f.name).cpu() for f in dataclasses.fields(camera)
        if isinstance(getattr(camera, f.name), torch.Tensor)})
