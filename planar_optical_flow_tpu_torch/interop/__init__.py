"""Weight interchange: flax variables (numpy trees, no JAX import), the
reference's PyTorch checkpoints (``.pth``) and the port's own weight
files."""

from planar_optical_flow_tpu_torch.interop.checkpoint import (
    load_weights,
    save_weights,
)
from planar_optical_flow_tpu_torch.interop.flax_bridge import (
    variables_to_state_dict,
)
from planar_optical_flow_tpu_torch.interop.torch_ckpt import (
    import_state_dict,
    import_torch_checkpoint,
    load_reference_checkpoint,
)

__all__ = ["import_state_dict", "import_torch_checkpoint", "load_weights",
           "load_reference_checkpoint", "save_weights",
           "variables_to_state_dict"]
