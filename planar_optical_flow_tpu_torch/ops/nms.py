"""Vote-space non-maximum suppression for per-point center predictions.

Counterpart of ``planar_optical_flow_tpu/ops/nms.py``, batched over the
leading stream axis B written out (the JAX step ``vmap``s one scan).
Fixed-shape outputs with a boolean ``keep`` mask.

Ordering among equal confidences: both functions order votes with a stable
descending sort, so ties keep the lower beam index first. That is what
``jax.lax.top_k`` and the stable ``jnp.argsort`` of the JAX functions do;
``torch.topk`` promises no order among ties, so it is not used.
"""

from __future__ import annotations

import torch

from planar_optical_flow_tpu_torch.ops.geometry import (
    canonical_to_global,
    rphi_to_xy,
)


def _vote_xy(scan, scan_phi, pred_reg):
    pred_r, pred_phi = canonical_to_global(
        scan, scan_phi, pred_reg[..., 0], pred_reg[..., 1])
    return rphi_to_xy(pred_r, pred_phi)


def _sorted_votes(xs_all, ys_all, pred_cls, k):
    order = torch.sort(pred_cls[..., 0], dim=-1, descending=True,
                       stable=True).indices[:, :k]
    xs = torch.gather(xs_all, 1, order)
    ys = torch.gather(ys_all, 1, order)
    cls_sorted = torch.gather(pred_cls, 1, order[..., None].expand(
        -1, -1, pred_cls.shape[-1]))
    close = torch.hypot(xs[:, :, None] - xs[:, None, :],
                        ys[:, :, None] - ys[:, None, :])
    return order, xs, ys, cls_sorted, close


def nms_predicted_center_topk(scan, scan_phi, pred_cls, pred_reg,
                              min_dist: float = 0.5, top_k: int = 64):
    """Greedy center NMS among the ``top_k`` most confident votes.

    ``scan (B, P)``, ``scan_phi (P,)``, ``pred_cls (B, P, 1)`` sigmoided,
    ``pred_reg (B, P, 2)``. Returns (det_xys (B, K, 2), det_cls (B, K, 1),
    keep (B, K) bool, instance_mask (B, P) int32): the instance of every
    point is the 1-based rank among kept detections of the nearest kept
    detection within ``min_dist`` (0 = unassigned).
    """
    xs_all, ys_all = _vote_xy(scan, scan_phi, pred_reg)
    _, xs, ys, cls_sorted, dist = _sorted_votes(xs_all, ys_all, pred_cls,
                                                top_k)
    close = dist < min_dist
    keep = torch.ones(xs.shape, dtype=torch.bool, device=xs.device)
    for i in range(top_k):
        active = keep[:, i].clone()
        keep &= ~(close[:, i, :] & active[:, None])
        keep[:, i] = active

    d_all = torch.hypot(xs_all[:, :, None] - xs[:, None, :],
                        ys_all[:, :, None] - ys[:, None, :])  # (B, P, K)
    d_all = torch.where(keep[:, None, :], d_all,
                        torch.full_like(d_all, float("inf")))
    d_min = d_all.min(dim=-1).values
    ranks = torch.cumsum(keep.int(), dim=-1)
    at_min = d_all == d_min[..., None]
    # ties resolve to the lowest rank, as argmin's first index would
    inst_min = torch.where(at_min, ranks[:, None, :],
                           torch.full_like(ranks[:, None, :], top_k + 1)
                           ).min(dim=-1).values
    instance_mask = torch.where(d_min < min_dist, inst_min,
                                torch.zeros_like(inst_min)).int()
    return torch.stack((xs, ys), dim=-1), cls_sorted, keep, instance_mask


def nms_predicted_center(scan, scan_phi, pred_cls, pred_reg,
                         min_dist: float = 0.5):
    """Greedy center NMS over every vote (the JAX ``method="fori"``).

    Same arguments as :func:`nms_predicted_center_topk`. Returns det_xys
    ``(B, P, 2)`` and det_cls ``(B, P, 1)`` sorted by descending
    confidence, keep ``(B, P)`` in sorted order and instance_mask
    ``(B, P)`` int32 in original point order (0 = unassigned).
    """
    num_pts = scan.shape[-1]
    xs_all, ys_all = _vote_xy(scan, scan_phi, pred_reg)
    order, xs, ys, cls_sorted, dist = _sorted_votes(xs_all, ys_all,
                                                    pred_cls, num_pts)
    close = dist < min_dist
    keep = torch.ones(xs.shape, dtype=torch.bool, device=xs.device)
    inst = torch.zeros(xs.shape, dtype=torch.int32, device=xs.device)
    next_id = torch.ones(xs.shape[:1], dtype=torch.int32, device=xs.device)
    for i in range(num_pts):
        active = keep[:, i].clone()
        dup = close[:, i, :] & active[:, None]
        # suppress everything close to i; i itself stays as it was
        keep &= ~dup
        keep[:, i] = active
        inst = torch.where(dup, next_id[:, None], inst)
        next_id = next_id + active.int()
    instance_mask = torch.zeros_like(inst).scatter_(1, order, inst)
    return torch.stack((xs, ys), dim=-1), cls_sorted, keep, instance_mask
