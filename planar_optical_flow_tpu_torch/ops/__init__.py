"""Tensor ops of the port: geometry, cutouts, the polar grid, NMS and the
kernels."""

from planar_optical_flow_tpu_torch.ops.cutout import scans_to_cutout  # noqa: F401
from planar_optical_flow_tpu_torch.ops.polar_grid import (  # noqa: F401
    scans_to_polar_grid,
)
