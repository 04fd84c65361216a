"""Model modules of the port (eval-mode inference)."""

from planar_optical_flow_tpu_torch.models.blocks import ConvBlock, ConvStack
from planar_optical_flow_tpu_torch.models.drow import DrowBackbone, DrowHead
from planar_optical_flow_tpu_torch.models.flow_drow import FlowDrow
from planar_optical_flow_tpu_torch.models.spatial_drow import (
    SpatialAttentionGate,
    SpatialDrow,
)

__all__ = ["ConvBlock", "ConvStack", "DrowBackbone", "DrowHead", "FlowDrow",
           "SpatialAttentionGate", "SpatialDrow"]
