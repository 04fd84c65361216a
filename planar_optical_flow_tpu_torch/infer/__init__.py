"""Inference of the port: streaming through the module, bf16 v3 and int8c
engines, the int8 serving calibration, the other step builders of the JAX
module (fused K14, band-gate, quantized, sequence processors), the box
regressor over point clouds, and the serving and model artifacts
(``torch.export``)."""

from planar_optical_flow_tpu_torch.infer.box_regressor import (
    BoxRegressor,
    resample_segment,
)
from planar_optical_flow_tpu_torch.infer.calibration import (
    ServeCalibration,
    calibrate_serve_v3,
)
from planar_optical_flow_tpu_torch.infer.export import (
    ModelEngine,
    ServingEngine,
    export_model,
    export_serving_engine,
    load_model,
    load_serving_engine,
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

__all__ = ["BoxRegressor", "ModelEngine", "ServeCalibration",
           "ServingEngine", "StreamingRunner", "calibrate_serve_v3",
           "cast_model", "export_model", "export_serving_engine",
           "load_model", "load_serving_engine", "make_fused_stream_step",
           "make_quantized_stream_step", "make_sequence_processor",
           "make_serve_sequence_processor", "make_serve_step",
           "make_serve_step_v3", "make_stream_step", "resample_segment"]
