"""The benchmark's traffic generator for the stream mixes: the analytic
trajectories, their IMU rows, and a ray-cast renderer of the textured
worlds in plain torch, so that set-up renders on the card from the seed.

A copy of the port's `sim.py` (`Trajectory`, `ForwardTrajectory`,
`ImageWorld`, `CorridorImageWorld`, `Trajectory.imu_samples`) with its own
radtan undistortion; it imports nothing of the port.
"""
