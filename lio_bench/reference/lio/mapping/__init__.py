"""The voxel hash-grid map."""
