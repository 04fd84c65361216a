"""Weight interchange: flax variables (numpy trees, no JAX import) and the
port's own weight files."""

from planar_optical_flow_tpu_torch.interop.checkpoint import (
    load_weights,
    save_weights,
)
from planar_optical_flow_tpu_torch.interop.flax_bridge import (
    variables_to_state_dict,
)

__all__ = ["load_weights", "save_weights", "variables_to_state_dict"]
