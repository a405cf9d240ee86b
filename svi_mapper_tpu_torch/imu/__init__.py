"""IMU calibration, filtering and pose-prior integration (the port's copy of
the JAX package's ``imu``)."""
