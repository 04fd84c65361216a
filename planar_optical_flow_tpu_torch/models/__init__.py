"""Model modules of the port (eval and train mode), their registry, and
the AdaBoost baseline (host numpy)."""

from planar_optical_flow_tpu_torch.models.adaboost_detector import (
    AdaBoostPersonDetector,
)
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
from planar_optical_flow_tpu_torch.models.flow_unet import (
    FlowUNet,
    FlowUNetAdditive,
    correlation_cost_volume,
)
from planar_optical_flow_tpu_torch.models.pointnet import (
    BoundingBoxRegressor,
    PointNet,
    TNet,
)
from planar_optical_flow_tpu_torch.models.polar_grid_net import (
    PolarGridDetector,
)
from planar_optical_flow_tpu_torch.models.registry import (
    FC_MODEL_TYPES,
    FLOW_MODEL_TYPES,
    STREAMING_MODEL_TYPES,
    fc_in_features_of,
    get_model,
    num_cutout_pts_of,
)
from planar_optical_flow_tpu_torch.models.spatial_drow import (
    SpatialAttentionGate,
    SpatialDrow,
)

__all__ = ["AdaBoostPersonDetector", "BoundingBoxRegressor", "ConvBlock",
           "ConvStack", "DenseBlock", "Drow", "DrowBackbone", "DrowHead",
           "FC_MODEL_TYPES", "FLOW_MODEL_TYPES", "FlowDrow", "FlowUNet",
           "FlowUNetAdditive", "PointNet", "PolarGridDetector",
           "STREAMING_MODEL_TYPES", "SpatialAttentionGate", "SpatialDrow",
           "TNet", "correlation_cost_volume", "fc_in_features_of",
           "get_model", "num_cutout_pts_of"]
