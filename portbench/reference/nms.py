"""The reference vote NMS (DROW's ``nms_predicted_center``, greedy among
the ``top_k`` most confident votes), batched over rows.

Each beam votes for a centre: its canonical offset ``(dx, dy)`` (``dx``
across the beam, ``dy`` outward) becomes ``phi = atan2(dx, r + dy)``,
range ``(r + dy) / cos(phi)`` at angle ``phi + phi_i``. Votes are taken in
descending confidence (ties: the lower beam first); a vote is kept unless a
kept, more confident vote lies closer than ``min_dist``.
"""

from __future__ import annotations

import torch


def vote_nms(scan, phi, conf, reg, min_dist=0.5, top_k=64):
    """``scan (N, P)``, ``phi (P,)``, ``conf (N, P)`` probabilities,
    ``reg (N, P, 2)`` -> (centres ``(N, K, 2)``, confidences ``(N, K)``,
    keep ``(N, K)`` bool), in descending confidence."""
    tmp_y = scan + reg[..., 1]
    tmp_phi = torch.atan2(reg[..., 0], tmp_y)
    r = tmp_y / torch.cos(tmp_phi)
    ang = tmp_phi + phi
    xs_all, ys_all = r * torch.cos(ang), r * torch.sin(ang)
    order = torch.sort(conf, dim=-1, descending=True, stable=True).indices
    order = order[:, :top_k]
    xs = torch.gather(xs_all, 1, order)
    ys = torch.gather(ys_all, 1, order)
    conf_k = torch.gather(conf, 1, order)
    close = torch.hypot(xs[:, :, None] - xs[:, None, :],
                        ys[:, :, None] - ys[:, None, :]) < min_dist
    keep = torch.ones_like(close[:, 0])
    for i in range(1, order.shape[1]):
        beaten = (keep[:, :i] & close[:, :i, i]).any(dim=1)
        keep[:, i] = ~beaten
    return torch.stack((xs, ys), dim=-1), conf_k, keep
