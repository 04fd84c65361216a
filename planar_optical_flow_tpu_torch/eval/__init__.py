"""Evaluation of the port's serving engines: detection PR/AP and flow
EPE/AAE."""

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
    evaluate_detection_ap,
    evaluate_detection_ap_batched,
    evaluate_flow_serving,
    make_ap_step,
    match_batched,
    match_frames,
)

__all__ = ["DetectionEvalFrames", "average_precision", "eer",
           "evaluate_detection_ap", "evaluate_detection_ap_batched",
           "evaluate_flow_serving", "make_ap_step", "match_batched",
           "match_detections", "match_frames", "peak_f1",
           "precision_recall_curve", "precision_recall_from_pool"]
