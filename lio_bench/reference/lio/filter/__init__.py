"""IMU process model and the iterated measurement update."""
