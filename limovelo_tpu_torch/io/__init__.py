"""Sensor data: the synthetic LiDAR+IMU simulator."""
