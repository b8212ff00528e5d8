"""IMU constants (counterpart of `monoorbslam3_tpu/models/imu.py`; the
preintegration itself belongs to the next slice of the port)."""

GRAVITY_VALUE = 9.80  # reference: Imu.h:15
