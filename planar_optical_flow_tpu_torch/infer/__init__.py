"""Streaming inference of the port: the module and bf16 v3 engines."""

from planar_optical_flow_tpu_torch.infer.streaming import (
    StreamingRunner,
    make_serve_step_v3,
    make_stream_step,
)

__all__ = ["StreamingRunner", "make_serve_step_v3", "make_stream_step"]
