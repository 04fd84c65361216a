"""Host utilities of the port: the config loader, the run logger and
``utils.viz`` (matplotlib plots and videos, imported on its own)."""

from planar_optical_flow_tpu_torch.utils.config import load_config
from planar_optical_flow_tpu_torch.utils.logger import RunLogger

__all__ = ["RunLogger", "load_config"]
