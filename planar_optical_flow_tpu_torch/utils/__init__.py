"""Host utilities of the port: the config loader."""

from planar_optical_flow_tpu_torch.utils.config import load_config

__all__ = ["load_config"]
