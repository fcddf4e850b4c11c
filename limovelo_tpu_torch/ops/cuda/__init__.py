"""Hand-written CUDA kernels (sources in limovelo_tpu_torch/csrc/) and their
build, bindings and plain PyTorch versions."""
