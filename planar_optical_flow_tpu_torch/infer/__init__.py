"""Inference of the port: streaming through the module, bf16 v3 and int8c
engines, the int8 serving calibration, the other step builders of the JAX
module (fused K14, band-gate, quantized, sequence processors), and the box
regressor over point clouds."""

from planar_optical_flow_tpu_torch.infer.box_regressor import (
    BoxRegressor,
    resample_segment,
)
from planar_optical_flow_tpu_torch.infer.calibration import (
    ServeCalibration,
    calibrate_serve_v3,
)
from planar_optical_flow_tpu_torch.infer.streaming import (
    StreamingRunner,
    cast_model,
    make_fused_stream_step,
    make_quantized_stream_step,
    make_sequence_processor,
    make_serve_sequence_processor,
    make_serve_step,
    make_serve_step_v3,
    make_stream_step,
)

__all__ = ["BoxRegressor", "ServeCalibration", "StreamingRunner",
           "calibrate_serve_v3", "cast_model", "make_fused_stream_step",
           "make_quantized_stream_step", "make_sequence_processor",
           "make_serve_sequence_processor", "make_serve_step",
           "make_serve_step_v3", "make_stream_step", "resample_segment"]
