"""Detection precision/recall metrics (DROW evaluation protocol), numpy.

Counterpart of ``planar_optical_flow_tpu/eval/detection_ap.py``: greedy
confidence-ordered matching of detections to ground-truth person centers
within an association radius (0.5 m in the DROW papers), a precision-recall
curve over all frames jointly, AP (trapezoidal area under PR), peak-F1 and
EER.
"""

from __future__ import annotations

import numpy as np


def match_detections(det_xy, det_conf, gt_xy, radius: float = 0.5):
    """Greedy matching for ONE frame.

    Returns (tp_flags (N,), num_gt) with detections sorted by conf DESC
    before matching; each GT matches at most one detection.
    """
    det_xy = np.asarray(det_xy, dtype=np.float64).reshape(-1, 2)
    det_conf = np.asarray(det_conf, dtype=np.float64).reshape(-1)
    gt_xy = np.asarray(gt_xy, dtype=np.float64).reshape(-1, 2)
    order = np.argsort(-det_conf)
    det_xy = det_xy[order]
    tp = np.zeros(len(det_xy), dtype=bool)
    used = np.zeros(len(gt_xy), dtype=bool)
    for i, d in enumerate(det_xy):
        if len(gt_xy) == 0:
            break
        dist = np.linalg.norm(gt_xy - d, axis=1)
        dist[used] = np.inf
        j = np.argmin(dist)
        if dist[j] <= radius:
            tp[i] = True
            used[j] = True
    # report flags in confidence order along with the sorted confidences
    return tp, det_conf[order], len(gt_xy)


def precision_recall_from_pool(flags, confs, num_gt: int):
    """PR curve from an already-matched detection pool.

    ``flags``: (N,) bool TP flags; ``confs``: (N,) confidences (any order);
    ``num_gt``: total ground-truth count across frames.
    """
    flags = np.asarray(flags, bool).reshape(-1)
    confs = np.asarray(confs, np.float64).reshape(-1)
    if len(flags) == 0 or num_gt == 0:
        return np.ones(1), np.zeros(1), np.zeros(1)
    order = np.argsort(-confs)
    flags = flags[order]
    confs = confs[order]
    tp_cum = np.cumsum(flags)
    fp_cum = np.cumsum(~flags)
    precision = tp_cum / np.maximum(tp_cum + fp_cum, 1)
    recall = tp_cum / num_gt
    return precision, recall, confs


def precision_recall_curve(frames, radius: float = 0.5):
    """``frames``: iterable of (det_xy, det_conf, gt_xy) per frame.

    Returns (precision, recall, thresholds) over the jointly sorted pool.
    """
    flags, confs, num_gt = [], [], 0
    for det_xy, det_conf, gt_xy in frames:
        tp, conf_sorted, n = match_detections(det_xy, det_conf, gt_xy, radius)
        flags.append(tp)
        confs.append(conf_sorted)
        num_gt += n
    if not flags or num_gt == 0:
        return np.ones(1), np.zeros(1), np.zeros(1)
    return precision_recall_from_pool(
        np.concatenate(flags), np.concatenate(confs), num_gt)


def average_precision(precision, recall) -> float:
    """Area under the PR curve (trapezoidal over recall)."""
    r = np.concatenate([[0.0], recall])
    p = np.concatenate([[precision[0] if len(precision) else 1.0], precision])
    return float(np.sum((r[1:] - r[:-1]) * p[1:]))


def peak_f1(precision, recall) -> float:
    f1 = 2 * precision * recall / np.maximum(precision + recall, 1e-12)
    return float(np.max(f1)) if len(f1) else 0.0


def eer(precision, recall) -> float:
    """Equal error rate point: precision == recall."""
    if len(precision) == 0:
        return 0.0
    diff = np.abs(precision - recall)
    return float(recall[np.argmin(diff)])
