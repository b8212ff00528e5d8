"""A recorded sequence, made from the seed: the frames (host float32
images, as a loader hands them to `System.track`), the IMU rows between
frames (t, gyro, acc in the profile's IMU frame), and the camera's ground
truth at the frame times.

The configuration's `world` fixes the scene kind, the trajectory and its
parameters, the biases and the rig: `camera_in_body` is the camera's
orientation in the trajectory's body frame B. The profile's own Rbc, tbc
(its IMU frame P to its camera) stay as the settings state them; the IMU
frame is mounted on B by R_BP = camera_in_body @ Rbc^T, so the rendered
camera sits at R_BP @ tbc and each IMU row is written in P (v_P = R_BP^T
v_B). The seed draws the texture and the pillars, the image noise and the
IMU noise; the motion belongs to the configuration.
"""

from __future__ import annotations

import numpy as np
import torch

from .render import WORLDS, camera_rays
from .trajectory import TRAJECTORIES


def seeds(seed: int, n: int) -> list[int]:
    """n independent 63-bit seeds derived from one."""
    return [int(x) for x in np.random.SeedSequence(seed % 2**63).generate_state(n, np.uint64)
            % (2**63)]


def build_stream(cfg: dict, seed: int, n_frames: int, device) -> dict:
    cam = cfg["settings"]["Camera"]
    imu = cfg["settings"]["IMU"]
    world = cfg["world"]
    fps = float(cam["fps"])
    s_world, s_noise, s_imu = seeds(seed, 3)
    g_world = torch.Generator(device=device).manual_seed(s_world)
    g_noise = torch.Generator(device=device).manual_seed(s_noise)
    rng_imu = np.random.default_rng(s_imu)

    traj = TRAJECTORIES[world["trajectory"]](**world.get("trajectory_params", {}))
    scene = WORLDS[world["scene"]].create(g_world, device, **world.get("scene_params", {}))
    K = cam["CameraMatrix"]
    rays = camera_rays(K[0], K[4], K[2], K[5], cam.get("Distortion", [0, 0, 0, 0]),
                       int(cam["Width"]), int(cam["Height"]), device)
    Rbc = np.asarray(imu["Rbc"], np.float64).reshape(3, 3)
    tbc = np.asarray(imu["tbc"], np.float64).reshape(3)
    R_rig = np.asarray(world["camera_in_body"], np.float64).reshape(3, 3)
    R_BP = R_rig @ Rbc.T
    t_rig = R_BP @ tbc

    times = np.arange(n_frames) / fps
    frames, gt = [], []
    f64 = dict(dtype=torch.float64, device=device)
    for i, t in enumerate(times):
        R_wb, p_wb = traj.R_wb(t), traj.pos(t)
        R_wc = R_wb @ R_rig
        t_wc = R_wb @ t_rig + p_wb
        img = scene.render(torch.as_tensor(R_wc, **f64), torch.as_tensor(t_wc, **f64), rays,
                           float(world.get("image_noise", 1.0)), g_noise)
        rows = None
        if i:
            g, a, d = traj.imu_samples(times[i - 1], t, float(imu["Frequency"]),
                                       world["bias_gyro"], world["bias_acc"],
                                       float(imu["NoiseGyro"]), float(imu["NoiseAcc"]), rng_imu)
            ts = times[i - 1] + np.cumsum(d)
            rows = np.concatenate([ts[:, None], g @ R_BP, a @ R_BP], axis=1)
        frames.append((float(t), img.cpu().numpy(), rows))
        gt.append((float(t), t_wc))
    return {"frames": frames, "gt_t": np.array([g[0] for g in gt]),
            "gt_p": np.stack([g[1] for g in gt])}
