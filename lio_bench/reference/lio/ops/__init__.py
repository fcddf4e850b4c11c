"""Point-cloud operators: voxel downsample, plane fit, CUDA kernels."""
