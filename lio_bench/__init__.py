"""The benchmark of limovelo_tpu_torch on one NVIDIA card (`run.py`)."""
