"""Evaluation: a training task's metrics over a loader, the mean-box
baseline of box regression, and the serving engines' detection PR/AP and
flow EPE/AAE."""

from planar_optical_flow_tpu_torch.eval.baseline import mean_box_baseline
from planar_optical_flow_tpu_torch.eval.detection_ap import (
    average_precision,
    eer,
    match_detections,
    peak_f1,
    precision_recall_curve,
    precision_recall_from_pool,
)
from planar_optical_flow_tpu_torch.eval.evaluator import (
    DetectionEvalFrames,
    evaluate_box_regression,
    evaluate_detection_ap,
    evaluate_detection_ap_batched,
    evaluate_flow,
    evaluate_flow_serving,
    make_ap_step,
    match_batched,
    match_frames,
)

__all__ = ["DetectionEvalFrames", "average_precision", "eer",
           "evaluate_box_regression", "evaluate_detection_ap",
           "evaluate_detection_ap_batched", "evaluate_flow",
           "evaluate_flow_serving", "make_ap_step", "match_batched",
           "match_detections", "match_frames", "mean_box_baseline", "peak_f1",
           "precision_recall_curve", "precision_recall_from_pool"]
