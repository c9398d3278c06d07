"""Wrappers of the port's CUDA kernels, each with its plain version."""
