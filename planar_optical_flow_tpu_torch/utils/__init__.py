"""Host utilities of the port: the config loader and the run logger."""

from planar_optical_flow_tpu_torch.utils.config import load_config
from planar_optical_flow_tpu_torch.utils.logger import RunLogger

__all__ = ["RunLogger", "load_config"]
