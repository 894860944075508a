"""Sparse-voxel models of the port."""
