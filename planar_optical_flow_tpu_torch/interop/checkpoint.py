"""Weights of a port model in a file: its ``state_dict`` through
``torch.save``.

The JAX package's ``--ckpt`` is an orbax checkpoint, which cannot be read
without JAX. The port's CLIs read this format instead: :func:`save_weights`
writes a model's ``state_dict``, :func:`load_weights` reads it on the CPU
(``weights_only=True``: tensors only, no pickled code) and loads it with
``strict=True``, so a missing or unused key raises. An int8c
``calibration.json`` saved beside the file is found by
``ServeCalibration.find(path)``. The port's training checkpoints
(``train/checkpoint.py``) are directories that hold such a file,
:data:`WEIGHTS_FILE`; :func:`load_weights` takes either. An orbax
checkpoint of the JAX package is not read: flax weights come across with
``interop.variables_to_state_dict``.
"""

from __future__ import annotations

import os

import torch
from torch import nn

WEIGHTS_FILE = "weights.pt"  # a training checkpoint's weights


def save_weights(model: nn.Module, path) -> str:
    """Write ``model.state_dict()`` to ``path`` (its directory is made).
    Returns the path."""
    path = os.fspath(path)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in model.state_dict().items()},
               path)
    return path


def load_weights(model: nn.Module, path) -> nn.Module:
    """Load the ``state_dict`` at ``path`` (a weights file, or a training
    checkpoint directory) into ``model`` (every key must match). Returns
    the model."""
    path = os.fspath(path)
    if os.path.isdir(path):
        path = os.path.join(path, WEIGHTS_FILE)
    state = torch.load(path, map_location="cpu", weights_only=True)
    model.load_state_dict(state, strict=True)
    return model
