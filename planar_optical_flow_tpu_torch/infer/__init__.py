"""Streaming inference of the port: the module, bf16 v3 and int8c engines,
and the int8 serving calibration."""

from planar_optical_flow_tpu_torch.infer.calibration import (
    ServeCalibration,
    calibrate_serve_v3,
)
from planar_optical_flow_tpu_torch.infer.streaming import (
    StreamingRunner,
    make_serve_step_v3,
    make_stream_step,
)

__all__ = ["ServeCalibration", "StreamingRunner", "calibrate_serve_v3",
           "make_serve_step_v3", "make_stream_step"]
