"""Training layer: the train state, the optimizer and its schedule, the
preemption-safe trainer loop, checkpoints, and the tasks (the flow U-Net's
and the DROW family's)."""

from planar_optical_flow_tpu_torch.train.optim import (
    Optimizer,
    exp_decay_schedule,
    make_optimizer,
)
from planar_optical_flow_tpu_torch.train.state import (
    TrainState,
    create_train_state,
)
from planar_optical_flow_tpu_torch.train.checkpoint import (
    latest_checkpoint,
    restore_checkpoint,
    save_checkpoint,
)
from planar_optical_flow_tpu_torch.train.trainer import Trainer
from planar_optical_flow_tpu_torch.train import tasks

__all__ = ["Optimizer", "TrainState", "Trainer", "create_train_state",
           "exp_decay_schedule", "latest_checkpoint", "make_optimizer",
           "restore_checkpoint", "save_checkpoint", "tasks"]
