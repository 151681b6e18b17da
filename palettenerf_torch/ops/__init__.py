"""Compute ops: hash grid, SH, ray/AABB, marching, compositing, occupancy, and the CUDA
kernels' wrappers (scatter-add, window gather)."""
