"""Scan geometry: polar/Cartesian conversions and per-beam canonical frames.

Counterpart of ``planar_optical_flow_tpu/ops/geometry.py`` (SICK S300
layout: 450 beams, 0.5 deg increment; canonical frame per beam with y
pointing outward along the beam, x pointing right). Broadcasting throughout:
the same function serves single scans ``(P,)`` and batches ``(..., P)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def get_laser_phi(angle_inc: float = math.radians(0.5),
                  num_pts: int = 450) -> np.ndarray:
    """Beam angles of the DROW laser as a host numpy array (static scan
    geometry, computed once per step builder)."""
    fov = (num_pts - 1) * angle_inc
    return np.linspace(-0.5 * fov, 0.5 * fov, num_pts)


def rphi_to_xy(r, phi):
    """Polar (r, phi) -> Cartesian (x, y). Axes: x along phi=0."""
    return r * torch.cos(phi), r * torch.sin(phi)


def canonical_to_global(scan_r, scan_phi, dx, dy):
    """Per-beam canonical offsets (dx, dy) -> global polar (r, phi)."""
    tmp_y = scan_r + dy
    # dx first: canonical x maps to the lateral direction of the beam
    tmp_phi = torch.atan2(dx, tmp_y)
    return tmp_y / torch.cos(tmp_phi), tmp_phi + scan_phi


def canonical_to_global_flow(flow_canonical, scan_phi):
    """Rotate ``(..., P, 2)`` canonical-frame flow vectors back to the
    global frame: R(-phi) per point."""
    c = torch.cos(scan_phi)
    s = torch.sin(scan_phi)
    fx, fy = flow_canonical[..., 0], flow_canonical[..., 1]
    return torch.stack((c * fx + s * fy, -s * fx + c * fy), dim=-1)
