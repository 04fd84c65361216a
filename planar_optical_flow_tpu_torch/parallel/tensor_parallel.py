"""Tensor parallelism over a mesh's ``model`` axis: the leaves that
:func:`parallel.mesh.default_partition_rule` splits, held as each rank's
shard, and the forward forms of the layers that own them.

:func:`shard_state_` replaces every split parameter, running statistic and
optimizer moment by this rank's slice and marks the owning layer;
:func:`unshard_state_` gathers them back (a checkpoint, or the state a
training run returns, is whole). The marked layers (``models/blocks.py``)
compute on their shard with Megatron's collectives
(``parallel/comm.py``):

* a column-split ``Linear`` (the gate ``embed``): the input through
  :func:`comm.copy_to`, the rank's output columns, gathered over ``model``
  before the ``embed_bn`` that JAX's rule leaves whole (so the banded
  similarity contracts the whole embedding on each rank);
* a column-split ``ConvBlock`` (``block3``'s third): the input through
  :func:`comm.copy_to`, the rank's output channels with their bias and
  BatchNorm, left split for the next layer;
* a row-split ``ConvBlock`` (``block4``'s first): the rank's input
  channels, the partial sums all-reduced over ``model`` (:func:`comm.
  reduce_sum`), then the whole bias and BatchNorm.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist
from torch import nn

from planar_optical_flow_tpu_torch.parallel.mesh import split_dim

MOMENTS = ("mu", "nu", "nu_max")


@dataclass(frozen=True)
class TensorParallel:
    """The mark on a split layer: ``kind`` ``"col"`` or ``"row"`` over
    ``group``."""
    kind: str
    group: object


def _owner(model: nn.Module, name: str):
    """(owning module, leaf name) of a parameter or buffer name."""
    mod_name, _, leaf = name.rpartition(".")
    return model.get_submodule(mod_name), leaf


def _layer_of(model: nn.Module, name: str):
    """The layer a split weight marks: the ``ConvBlock`` around a
    ``conv.weight``, else the weight's own module (a ``Linear``)."""
    if name.endswith(".conv.weight"):
        return model.get_submodule(name[:-len(".conv.weight")])
    return _owner(model, name)[0]


def _set(mod: nn.Module, leaf: str, value: torch.Tensor):
    old = getattr(mod, leaf)
    if isinstance(old, nn.Parameter):
        value = nn.Parameter(value, requires_grad=old.requires_grad)
    setattr(mod, leaf, value)


def split_names(specs: dict) -> dict:
    """Name -> split dimension of the leaves ``specs`` splits."""
    out = {}
    for n, s in specs.items():
        d = split_dim(s)
        if d is not None:
            out[n] = d
    return out


def shard_state_(state, mesh, specs: dict) -> None:
    """Replace the split leaves of ``state`` (model and optimizer moments)
    by this rank's slice over ``model``, and mark their layers."""
    group = mesh.group("model")
    n, k = mesh.axis_size("model"), mesh.axis_index("model")
    model = state.model
    for name, d in split_names(specs).items():
        mod, leaf = _owner(model, name)
        full = getattr(mod, leaf)
        if full.shape[d] % n:
            raise ValueError(f"{name}: dimension {d} of {tuple(full.shape)} "
                             f"does not split over model={n}")
        _set(mod, leaf, full.detach().chunk(n, dim=d)[k].clone())
        for key in MOMENTS:
            moments = state.opt_state.get(key, {})
            if name in moments:
                moments[name] = moments[name].chunk(n, dim=d)[k].clone()
        if name.endswith("weight") and (name.endswith(".conv.weight")
                                        or isinstance(mod, nn.Linear)):
            _layer_of(model, name).tp = TensorParallel(
                "col" if d == 0 else "row", group)


def _gather(t: torch.Tensor, group, d: int) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.detach().contiguous(), group=group)
    return torch.cat(parts, dim=d)


def unshard_state_(state, mesh, specs: dict) -> None:
    """Gather the split leaves of ``state`` back whole on every rank and
    take the marks off their layers (a collective over ``model``)."""
    group = mesh.group("model")
    model = state.model
    for name, d in split_names(specs).items():
        mod, leaf = _owner(model, name)
        _set(mod, leaf, _gather(getattr(mod, leaf), group, d))
        for key in MOMENTS:
            moments = state.opt_state.get(key, {})
            if name in moments:
                moments[name] = _gather(moments[name], group, d)
        layer = _layer_of(model, name) if name.endswith("weight") else None
        if layer is not None and hasattr(layer, "tp"):
            del layer.tp
