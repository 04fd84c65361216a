"""Model modules of the port (eval and train mode) and their registry."""

from planar_optical_flow_tpu_torch.models.blocks import (
    ConvBlock,
    ConvStack,
    DenseBlock,
)
from planar_optical_flow_tpu_torch.models.drow import (
    Drow,
    DrowBackbone,
    DrowHead,
)
from planar_optical_flow_tpu_torch.models.flow_drow import FlowDrow
from planar_optical_flow_tpu_torch.models.registry import (
    STREAMING_MODEL_TYPES,
    get_model,
    num_cutout_pts_of,
)
from planar_optical_flow_tpu_torch.models.spatial_drow import (
    SpatialAttentionGate,
    SpatialDrow,
)

__all__ = ["ConvBlock", "ConvStack", "DenseBlock", "Drow", "DrowBackbone",
           "DrowHead", "FlowDrow",
           "STREAMING_MODEL_TYPES", "SpatialAttentionGate", "SpatialDrow",
           "get_model", "num_cutout_pts_of"]
