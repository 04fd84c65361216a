"""The analytic floor of the box regressor.

Counterpart of ``planar_optical_flow_tpu/eval/baseline.py``:
:func:`mean_box_baseline` predicts the dataset's mean box dimensions (and
mean z in 3D) at each detection centre with a fixed pi/2 orientation, and
reports its IoU, dims, ori (and z) errors: the numbers a learned regressor
must beat. The means and errors are float64 on the host, as in JAX; the
rotated IoU runs in f32 on ``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from planar_optical_flow_tpu_torch import resolve_device
from planar_optical_flow_tpu_torch.ops import rotated_iou


def mean_box_baseline(dataset, is_3d: bool | None = None,
                      device="cuda") -> dict:
    """The mean-box baseline over a ``JrdbBoxRegressionDataset``-like
    object exposing ``targets`` (a list of ``(7|5,)`` boxes) and
    ``dets_center``; ``is_3d`` defaults to the targets' width."""
    dev = resolve_device(device)
    targets = np.asarray(dataset.targets, dtype=np.float64)
    centers = np.asarray(dataset.dets_center, dtype=np.float64)
    if is_3d is None:
        is_3d = targets.shape[1] == 7
    n = len(targets)
    if is_3d:
        preds = np.column_stack([
            centers[:, 0], centers[:, 1], np.full(n, targets[:, 2].mean()),
            np.tile(targets[:, 3:6].mean(axis=0), (n, 1)),
            np.full(n, 0.5 * np.pi)])
        iou_fn, dims, ori = rotated_iou.rotated_iou_3d_paired, slice(3, 6), 6
    else:
        preds = np.column_stack([
            centers[:, 0], centers[:, 1],
            np.tile(targets[:, 2:4].mean(axis=0), (n, 1)),
            np.full(n, 0.5 * np.pi)])
        iou_fn, dims, ori = rotated_iou.rotated_iou_paired, slice(2, 4), 4
    iou = iou_fn(*(torch.as_tensor(b, dtype=torch.float32, device=dev)
                   for b in (preds, targets))).cpu().numpy()
    out = {
        "iou": float(iou.mean()),
        "loss_dim": float(np.abs(preds[:, dims] - targets[:, dims])
                          .sum(axis=1).mean()),
        "loss_ori": float(np.abs(preds[:, ori] - targets[:, ori]).mean()),
    }
    if is_3d:
        # the mean-z predictor's error, comparable to the model's loss_z
        out["loss_z"] = float(np.abs(preds[:, 2] - targets[:, 2]).mean())
    return out
