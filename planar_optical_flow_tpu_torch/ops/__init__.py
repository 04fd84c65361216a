"""Tensor ops of the port: geometry, cutouts, NMS and the kernels."""
