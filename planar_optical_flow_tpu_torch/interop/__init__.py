"""Weight interchange with the JAX package (numpy trees, no JAX import)."""

from planar_optical_flow_tpu_torch.interop.flax_bridge import (
    variables_to_state_dict,
)

__all__ = ["variables_to_state_dict"]
