"""The benchmark's torch renderer and IMU rows against the port's `sim`
(host numpy) at a small size, on the same texture and pillars."""

import numpy as np
import pytest
import torch

from benchmark.world import render, trajectory
from monoorbslam3_tpu_torch import sim
from monoorbslam3_tpu_torch.models.camera import Pinhole

DIST = [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
W, H = 160, 96
R_SIDE = np.array([[-0.70710678, 0, 0.70710678], [-0.70710678, 0, -0.70710678], [0, -1, 0.0]])
R_FWD = np.array([[0, 0, 1.0], [-1, 0, 0], [0, -1, 0]])
T_BC = np.array([0.03, 0.01, -0.02])


@pytest.mark.parametrize("kind", ["circle", "street"])
def test_render_matches_sim(kind):
    cam = Pinhole.create(120.0, 119.0, 80.0, 48.0, dist=DIST, width=W, height=H, device="cpu")
    if kind == "circle":
        world = sim.ImageWorld(traj=sim.Trajectory())
        ours = render.CircleWorld(torch.as_tensor(world.texture), torch.as_tensor(world.pillar_xy),
                                  torch.as_tensor(world.pillar_uoff))
        R_bc = R_SIDE
    else:
        world = sim.CorridorImageWorld(traj=sim.ForwardTrajectory(), half_width=8.0, length=700.0)
        ours = render.StreetWorld(torch.as_tensor(world.texture), half_width=8.0, length=700.0)
        R_bc = R_FWD
    rays = render.camera_rays(120.0, 119.0, 80.0, 48.0, DIST, W, H, "cpu")
    np.testing.assert_allclose(rays.numpy(), world._ray_grid(cam), rtol=0, atol=1e-12)
    for t in (0.0, 1.3, 7.7):
        want = world.render(t, cam, R_bc, T_BC, noise=0.0)
        R_cw, t_cw = world.pose_cw(t, R_bc, T_BC)
        got = ours.render(torch.as_tensor(R_cw.T), torch.as_tensor(-R_cw.T @ t_cw), rays, 0.0,
                          None).numpy()
        assert np.abs(got - want).max() < 1e-3


@pytest.mark.parametrize("kind", ["circle", "forward"])
def test_imu_rows_match_sim(kind):
    ours = trajectory.TRAJECTORIES[kind]()
    theirs = sim.Trajectory() if kind == "circle" else sim.ForwardTrajectory()
    bg, ba = (0.003, -0.002, 0.001), (0.02, -0.015, 0.01)
    for t0 in (0.0, 0.35, 4.0):
        a = ours.imu_samples(t0, t0 + 0.1, 200.0, bg, ba, 1.7e-4, 2e-3, np.random.default_rng(3))
        b = theirs.imu_samples(t0, t0 + 0.1, 200.0, bg=bg, ba=ba, noise_gyro=1.7e-4,
                               noise_acc=2e-3, rng=np.random.default_rng(3))
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(ours.pos(t0), theirs.pos(t0))
        np.testing.assert_array_equal(ours.R_wb(t0), theirs.R_wb(t0))


def test_the_seed_draws_the_world_and_the_motion_stays():
    from benchmark.harness import Bench
    from benchmark.world.stream import build_stream

    cfg = Bench.load().config("euroc_mav")
    cfg = dict(cfg, settings=dict(cfg["settings"], Camera=dict(
        cfg["settings"]["Camera"], Width=64, Height=48,
        CameraMatrix=[40.0, 0, 32.0, 0, 40.0, 24.0, 0, 0, 1.0])))
    a = build_stream(cfg, 2**31 + 5, 3, "cpu")
    b = build_stream(cfg, 2**31 + 5, 3, "cpu")
    c = build_stream(cfg, 7, 3, "cpu")
    for (ta, ia, ma), (tb, ib, mb), (tc, ic, mc) in zip(a["frames"], b["frames"], c["frames"]):
        assert ta == tb == tc
        np.testing.assert_array_equal(ia, ib)
        assert not np.array_equal(ia, ic)
        if ma is not None:
            np.testing.assert_array_equal(ma, mb)
            np.testing.assert_array_equal(ma[:, 0], mc[:, 0])
    np.testing.assert_array_equal(a["gt_p"], c["gt_p"])
