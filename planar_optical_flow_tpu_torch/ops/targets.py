"""Training and evaluation targets: per-point class/offset targets and
ego-motion flow targets, as functions on tensors.

Counterpart of ``planar_optical_flow_tpu/ops/targets.py``. Variable-length
detection lists come padded to a fixed ``D`` with a validity mask. Every
function broadcasts over leading batch dimensions, so one call computes a
whole dataset's targets (``data/drow_detection.py``) where JAX vmaps the
per-frame function.

The 2x2 products are written out as sums over their index in order
(index 0, then 1), the order of the JAX einsums they replace.
"""

from __future__ import annotations

import torch

from planar_optical_flow_tpu_torch.ops.geometry import (
    global_to_canonical,
    global_to_canonical_flow,
    phi_rotation_matrix,
    rphi_to_xy,
)

_BIG = 1e9


def closest_detection(scan, scan_phi, dets_rphi, dets_radius,
                      dets_valid=None):
    """For each scan point, the 1-based index of the closest detection whose
    radius contains it; 0 if none does.

    ``scan``, ``scan_phi``: ``(..., P)``; ``dets_rphi`` ``(..., D, 2)``;
    ``dets_radius`` and ``dets_valid`` ``(..., D)``. Returns ``(..., P)``
    int32. Ties take the first minimum, as ``jnp.argmin`` does.
    """
    px, py = rphi_to_xy(scan, scan_phi)
    dx, dy = rphi_to_xy(dets_rphi[..., 0], dets_rphi[..., 1])
    dists = torch.hypot(px[..., :, None] - dx[..., None, :],
                        py[..., :, None] - dy[..., None, :])
    dists = dists - dets_radius[..., None, :]
    if dets_valid is not None:
        dists = torch.where(dets_valid[..., None, :], dists,
                            torch.full_like(dists, _BIG))
    # a zero column at index 0 wins for any point outside every radius
    dists = torch.cat([torch.zeros_like(dists[..., :1]), dists], dim=-1)
    return torch.argmin(dists, dim=-1).to(torch.int32)


def regression_targets(scan, scan_phi, dets_rphi, dets_radius, dets_label,
                       dets_valid=None):
    """Per-point class label and canonical-frame offset to the matched
    detection: (target_cls ``(..., P)`` int32, target_reg ``(..., P, 2)``
    float32). ``dets_label`` ``(..., D)`` int."""
    idx = closest_detection(scan, scan_phi, dets_rphi, dets_radius,
                            dets_valid)
    hit = idx > 0
    safe = torch.clamp(idx.long() - 1, min=0)
    lead = safe.shape[:-1]
    label = torch.gather(dets_label.expand(*lead, dets_label.shape[-1]), -1,
                         safe)
    target_cls = torch.where(hit, label, torch.zeros_like(label)).to(
        torch.int32)
    det_r = torch.gather(dets_rphi[..., 0].expand(*lead, -1), -1, safe)
    det_phi = torch.gather(dets_rphi[..., 1].expand(*lead, -1), -1, safe)
    dx, dy = global_to_canonical(scan, scan_phi, det_r, det_phi)
    target_reg = torch.stack((dx, dy), dim=-1) * hit[..., None]
    return target_cls, target_reg.to(torch.float32)


def _matvec(m, v):
    """``out_i = sum_j m_ij v_j`` for 2x2 ``m (..., 2, 2)`` and ``v (...,
    2)``."""
    return torch.stack([m[..., i, 0] * v[..., 0] + m[..., i, 1] * v[..., 1]
                        for i in range(2)], dim=-1)


def _tmatvec(m, v):
    """``out_i = sum_k m_ki v_k`` (the transpose's product)."""
    return torch.stack([m[..., 0, i] * v[..., 0] + m[..., 1, i] * v[..., 1]
                        for i in range(2)], dim=-1)


def flow_from_pose_pair(scan, scan_phi, odom0, odom1, to_canonical=False):
    """Rigid ego-motion flow ``(..., P, 2)`` of static points between two
    absolute poses ``odom* (..., 3)`` (x, y, phi), in the frame of pose 0."""
    rot0 = phi_rotation_matrix(odom0[..., 2])
    rot1 = phi_rotation_matrix(odom1[..., 2] - odom0[..., 2])
    trans_frame0 = _matvec(rot0, odom1[..., :2] - odom0[..., :2])
    x, y = rphi_to_xy(scan, scan_phi)
    xy0 = torch.stack((x, y), dim=-1)
    xy1 = _matvec(rot1[..., None, :, :], xy0) - trans_frame0[..., None, :]
    flow = xy1 - xy0
    if to_canonical:
        flow = global_to_canonical_flow(flow, scan_phi)
    return flow


def displacement_from_odometry(scan1_xy, odom0, odom1):
    """Apparent displacement of stationary points caused by scanner motion:
    ``scan1_xy (..., P, 2)`` in the current frame, ``odom0``/``odom1``
    ``(..., 3)`` the previous and current poses.
    ``scan1_xy @ (I - R0^T R1)^T - R0^T (t1 - t0)``."""
    rot0 = phi_rotation_matrix(odom0[..., 2])
    rot1 = phi_rotation_matrix(odom1[..., 2])
    r0t_r1 = torch.stack([torch.stack(
        [rot0[..., 0, i] * rot1[..., 0, j] + rot0[..., 1, i] * rot1[..., 1, j]
         for j in range(2)], dim=-1) for i in range(2)], dim=-2)
    rot = torch.eye(2, dtype=scan1_xy.dtype, device=scan1_xy.device) - r0t_r1
    tran0 = _tmatvec(rot0, odom1[..., :2] - odom0[..., :2])
    return _matvec(rot[..., None, :, :], scan1_xy) - tran0[..., None, :]


def velocity_from_odometry(scan1_xy, odom0, odom1):
    """Apparent velocity (times dt) of stationary points from scanner
    motion: ``-R1^T (t1 - t0) - dphi * J @ scan1_xy``, ``J = [[0, -1], [1,
    0]]``."""
    dpose = odom1 - odom0
    rot1 = phi_rotation_matrix(odom1[..., 2])
    dxy1 = _tmatvec(rot1, dpose[..., :2])
    x, y = scan1_xy[..., 0], scan1_xy[..., 1]
    rot_term = torch.stack((-y, x), dim=-1) * dpose[..., 2][..., None, None]
    return -dxy1[..., None, :] - rot_term


def dynamic_mask(scan_xy, dets_xy, dets_radius, dets_valid=None):
    """1.0 for points farther than every detection's radius (static), 0.0
    for points near any annotated person."""
    diff = scan_xy[..., :, None, :] - dets_xy[..., None, :, :]
    d = torch.sqrt(diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1])
    inside = d <= dets_radius[..., None, :]
    if dets_valid is not None:
        inside = inside & dets_valid[..., None, :]
    return (~inside.any(dim=-1)).to(scan_xy.dtype)


def valid_range_mask(scan, thresh: float = 20.0):
    """1.0 where the return is closer than ``thresh`` meters."""
    return (~(scan >= thresh)).to(scan.dtype)
