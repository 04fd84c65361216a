"""Losses and flow metrics.

Counterpart of ``planar_optical_flow_tpu/ops/losses.py``: the masked mean
endpoint-error flow loss, the EPE/AAE metrics, the multi-class and binary
focal losses, the box-regression L1 losses and the DROW detection loss.
Every loss computes in f32 whatever the network's dtype (a bf16 model's
predictions are promoted first), as the JAX functions do.

Inside a data-parallel step (``parallel.comm.data_parallel``) every mean
is the global batch's, as JAX's is on a sharded batch: the numerator and
the count are all-reduced over the data group, the numerator with an
identity gradient, so each rank's backward carries its own rows' share
and the trainer sums the gradients once.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _masked_mean(num: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """``num / max(count, 1)``, both over the global batch inside a
    data-parallel step."""
    from planar_optical_flow_tpu_torch.parallel import comm

    group = comm.data_group()
    if group is not None:
        num, count = comm.reduce_sum(
            torch.stack([num, count.detach().to(num.dtype)]), group)
    return num / torch.clamp(count, min=1.0)


def _mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean()``, over the global batch inside a data-parallel step."""
    from planar_optical_flow_tpu_torch.parallel import comm

    if comm.data_group() is None:
        return t.mean()
    return _masked_mean(t.sum(), t.new_tensor(float(t.numel())))


def _norm(v: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis."""
    return torch.sqrt((v * v).sum(dim=-1))


def epe_loss(pred, target, mask=None):
    """Mean endpoint error over ``(..., P, 2)`` flow fields; with a mask,
    the mean over the points where it is 1."""
    err = _norm(pred.float() - target.float())
    if mask is None:
        return _mean(err)
    m = mask.to(err.dtype)
    return _masked_mean((err * m).sum(), m.sum())


def epe_aae(pred, target, wrap_angles: bool = False):
    """Per-sample EPE [m] and AAE [deg] over ``(B, P, 2)`` flow fields. The
    angle difference is not wrapped unless ``wrap_angles`` (the reference's
    choice: an error across the branch cut reads ~360 deg)."""
    epe = _norm(pred - target).mean(dim=-1)
    diff = (torch.atan2(pred[..., 0], pred[..., 1])
            - torch.atan2(target[..., 0], target[..., 1]))
    if wrap_angles:
        diff = torch.remainder(diff + math.pi, 2.0 * math.pi) - math.pi
    return epe, diff.abs().mean(dim=-1) * (180.0 / math.pi)


def _reduce(loss, reduction: str):
    if reduction == "mean":
        return _mean(loss)
    if reduction == "sum":
        return loss.sum()
    return loss


def focal_loss(logits, labels, gamma: float = 0.0, alpha=None,
               reduction: str = "mean"):
    """Multi-class focal loss on raw logits ``(N, C)`` with integer labels
    ``(N,)``; ``gamma=0`` is the cross-entropy."""
    logp = F.log_softmax(logits, dim=-1)
    logpt = torch.gather(logp, -1, labels.long()[..., None])[..., 0]
    pt = torch.exp(logpt)
    if alpha is not None:
        at = torch.as_tensor(alpha, dtype=logpt.dtype,
                             device=logpt.device)[labels.long()]
        logpt = logpt * at
    return _reduce(-((1.0 - pt) ** gamma) * logpt, reduction)


def binary_focal_loss(probs, targets, gamma: float = 2.0, alpha: float = -1.0,
                      reduction: str = "mean", eps: float = 1e-12):
    """Binary focal loss on probabilities; ``gamma=0, alpha<0`` is the
    binary cross-entropy."""
    probs = torch.clamp(probs, eps, 1.0 - eps)
    loss_pos = -targets * (1.0 - probs) ** gamma * torch.log(probs)
    loss_neg = -(1.0 - targets) * probs ** gamma * torch.log(1.0 - probs)
    if 0.0 <= alpha <= 1.0:
        loss_pos = loss_pos * alpha
        loss_neg = loss_neg * (1.0 - alpha)
    return _reduce(loss_pos + loss_neg, reduction)


def box_regression_loss(pred, target, alpha: float = 0.5):
    """L1 box losses: 5-dim ``[cz, l, w, h, ori]`` targets give |z| +
    sum|dims| + alpha |ori|, 3-dim ``[l, w, ori]`` sum|dims| + alpha
    |ori|."""
    d = pred.shape[-1]
    pred, target = pred.float(), target.float()
    loss_ori = _mean((pred[..., -1] - target[..., -1]).abs())
    if d == 5:
        loss_z = _mean((pred[..., 0] - target[..., 0]).abs())
        loss_dim = _mean((pred[..., 1:-1] - target[..., 1:-1]).abs().sum(-1))
        return loss_z + loss_dim + alpha * loss_ori
    if d == 3:
        loss_dim = _mean((pred[..., :-1] - target[..., :-1]).abs().sum(-1))
        return loss_dim + alpha * loss_ori
    raise ValueError(f"unsupported target dim {d}")


def detection_loss(pred_cls, pred_reg, target_cls, target_reg,
                   focal_gamma: float = 0.0, pedestrian_only: bool = False):
    """Joint cls + reg loss of the DROW family: the cls loss over every
    point (binary focal on the sigmoid for one logit, else multi-class
    focal), the reg loss the mean Euclidean distance over the foreground
    points. Returns (cls_loss, reg_loss, fg_ratio), f32."""
    n = target_cls.numel()
    cls_flat = pred_cls.reshape(n, -1).float()
    pred_reg = pred_reg.float()
    tgt_flat = target_cls.reshape(n)
    if pedestrian_only or cls_flat.shape[-1] == 1:
        probs = torch.sigmoid(cls_flat[:, 0])
        cls_loss = binary_focal_loss(probs, tgt_flat.to(probs.dtype),
                                     gamma=focal_gamma)
    else:
        cls_loss = focal_loss(cls_flat, tgt_flat, gamma=focal_gamma)
    fg = (tgt_flat != 0).to(pred_reg.dtype)
    reg_err = _norm(pred_reg.reshape(n, -1) - target_reg.reshape(n, -1))
    reg_loss = _masked_mean((reg_err * fg).sum(), fg.sum())
    return cls_loss, reg_loss, _mean(fg)
