"""Meshes, partition rules, multi-process initialization, and the pipeline
and context-parallel forms (counterpart of
``planar_optical_flow_tpu/parallel``).

Training across devices runs one process a device
(``torch.distributed.run``; :func:`initialize_distributed`): a
:class:`Mesh` of ranks with a process group for each axis. Serving shards
independent streams over a mesh of local devices in one process
(``infer.streaming.make_serve_step_v3(mesh=...)``).
"""

from planar_optical_flow_tpu_torch.parallel.mesh import (  # noqa: F401
    Mesh,
    make_mesh,
    make_mesh_from_config,
    make_hybrid_mesh,
    mesh_shape,
    default_partition_rule,
    state_shardings,
    batch_sharding,
    replicated_sharding,
    shard_batch,
    replicate_batch,
    initialize_distributed,
)
from planar_optical_flow_tpu_torch.parallel.context_parallel import (  # noqa: F401
    gate_step_context_parallel,
)
from planar_optical_flow_tpu_torch.parallel.pipeline_parallel import (  # noqa: F401
    pipeline_apply,
    drow_pipeline_stages,
    drow_pipeline_train_stages,
    flow_unet_pipeline_stages,
)
