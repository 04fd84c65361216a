"""Train state: the model (f32 master parameters, f32 running statistics),
the optimizer with its state, and the step and epoch counters.

Counterpart of ``planar_optical_flow_tpu/train/state.py``. JAX's state is
one immutable PyTree; here the model holds the parameters and statistics
and :meth:`TrainState.apply_gradients` updates them in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from planar_optical_flow_tpu_torch.train.optim import Optimizer

STAT_SUFFIXES = ("running_mean", "running_var")


def named_params(model: nn.Module) -> dict:
    """name -> parameter (the ``params`` collection)."""
    return dict(model.named_parameters())


def named_stats(model: nn.Module) -> dict:
    """name -> running statistic (the ``batch_stats`` collection)."""
    return {n: b for n, b in model.named_buffers()
            if n.endswith(STAT_SUFFIXES)}


def set_stats(model: nn.Module, stats: dict) -> None:
    """Replace the model's running statistics by ``stats`` (name -> tensor,
    any dtype): the buffers are reassigned, not copied into."""
    for name, value in stats.items():
        mod_name, _, leaf = name.rpartition(".")
        setattr(model.get_submodule(mod_name), leaf, value)


@dataclass
class TrainState:
    model: nn.Module
    tx: Optimizer
    opt_state: dict
    step: int = 0
    epoch: int = 0

    @property
    def params(self) -> dict:
        return named_params(self.model)

    @property
    def batch_stats(self) -> dict:
        return named_stats(self.model)

    def apply_gradients(self, grads: dict, new_batch_stats: dict | None = None,
                        sq_norm=None) -> "TrainState":
        """One optimizer update from ``grads`` (name -> tensor or None) and,
        if given, the new running statistics (cast to f32). ``sq_norm``
        (name -> tensor dict -> squared norm) gives the clip its global
        norm under a mesh. Returns ``self``."""
        self.opt_state = self.tx.apply(self.params, grads, self.opt_state,
                                       sq_norm=sq_norm)
        if new_batch_stats is not None:
            set_stats(self.model, {n: t.detach().float()
                                   for n, t in new_batch_stats.items()})
        self.step += 1
        return self


def create_train_state(model: nn.Module, tx: Optimizer) -> TrainState:
    """The state of a freshly built model: its optimizer state initialized,
    the counters at 0."""
    return TrainState(model=model, tx=tx, opt_state=tx.init(named_params(model)))


def load_pretrained_subtree(state: TrainState, sub_name: str,
                            pretrained_params: dict,
                            pretrained_stats: dict | None = None
                            ) -> TrainState:
    """Graft pre-trained weights into the submodule ``sub_name`` (the
    FlowDROW frozen-detector workflow): ``pretrained_params`` (name ->
    tensor, named within the submodule) must cover its parameters,
    ``pretrained_stats`` its running statistics when given. The optimizer
    state is left as it is, as in JAX."""
    sub = state.model.get_submodule(sub_name)
    own = named_params(sub)
    if set(pretrained_params) != set(own):
        raise KeyError(f"{sub_name}: pretrained parameters "
                       f"{sorted(set(pretrained_params) ^ set(own))} do not "
                       "match the submodule's")
    with torch.no_grad():
        for name, value in pretrained_params.items():
            own[name].copy_(value)
    if pretrained_stats is not None:
        stats = named_stats(sub)
        if set(pretrained_stats) != set(stats):
            raise KeyError(f"{sub_name}: pretrained statistics "
                           f"{sorted(set(pretrained_stats) ^ set(stats))} "
                           "do not match the submodule's")
        set_stats(sub, {n: v.detach().float().to(stats[n].device)
                        for n, v in pretrained_stats.items()})
    return state
