"""Train-state checkpoints with the JAX package's semantics: periodic epoch
checkpoints ``ckpt_e{N}`` and the preemption checkpoint, each a directory.

Counterpart of ``planar_optical_flow_tpu/train/checkpoint.py`` in the port's
own format (JAX writes orbax): ``weights.pt``, the model's ``state_dict``
as ``interop.checkpoint.save_weights`` writes it (so ``cli.infer --ckpt``
and ``cli.evaluate --ckpt`` read a training checkpoint directly), and
``train_state.pt`` with the step and epoch counters and the optimizer
state. Both are read with ``weights_only=True`` (tensors and plain
containers only).
"""

from __future__ import annotations

import os
import re

import torch

from planar_optical_flow_tpu_torch.interop.checkpoint import (
    WEIGHTS_FILE,
    load_weights,
    save_weights,
)
from planar_optical_flow_tpu_torch.train.state import STAT_SUFFIXES

TRAIN_STATE_FILE = "train_state.pt"


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if torch.is_tensor(tree) else tree


def save_checkpoint(path: str, state) -> str:
    """Write ``state`` to the directory ``path`` (made, or overwritten)."""
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    save_weights(state.model, os.path.join(path, WEIGHTS_FILE))
    tmp = os.path.join(path, TRAIN_STATE_FILE + ".tmp")
    torch.save({"step": int(state.step), "epoch": int(state.epoch),
                "opt_state": _to(state.opt_state, "cpu")}, tmp)
    os.replace(tmp, os.path.join(path, TRAIN_STATE_FILE))
    return path


def _read_counters(path: str) -> dict:
    return torch.load(os.path.join(path, TRAIN_STATE_FILE),
                      map_location="cpu", weights_only=True)


def restore_checkpoint(path: str, state):
    """Restore the weights, statistics, optimizer state and counters at
    ``path`` into ``state`` (every key must match). Returns ``state``."""
    path = os.path.abspath(path)
    restore_variables(path, state)
    saved = _read_counters(path)["opt_state"]
    if set(saved) != set(state.opt_state) or any(
            isinstance(v, dict) and set(v) != set(state.opt_state[k])
            for k, v in saved.items()):
        raise KeyError(f"{path}: the optimizer state does not match the "
                       "train state's")
    params = state.params
    state.opt_state = {k: ({n: t.to(params[n].device) for n, t in v.items()}
                           if isinstance(v, dict) else v)
                       for k, v in saved.items()}
    return state


def restore_variables(path: str, state):
    """Restore the weights, statistics and counters at ``path``, keeping
    ``state``'s optimizer state (for consumers whose optimizer differs from
    the trainer's). Returns ``state``."""
    path = os.path.abspath(path)
    load_weights(state.model, path)  # copied into the model's own tensors
    counters = _read_counters(path)
    state.step, state.epoch = int(counters["step"]), int(counters["epoch"])
    return state


def load_checkpoint_tree(path: str) -> dict:
    """The raw checkpoint without a train state to restore into: ``step``,
    ``epoch``, ``opt_state``, ``params`` and ``batch_stats`` (name ->
    tensor, from the weights by name), for grafting and inspection."""
    path = os.path.abspath(path)
    tree = _read_counters(path)
    weights = torch.load(os.path.join(path, WEIGHTS_FILE), map_location="cpu",
                         weights_only=True)
    tree["params"] = {k: v for k, v in weights.items()
                      if not k.endswith((*STAT_SUFFIXES,
                                         "num_batches_tracked"))}
    tree["batch_stats"] = {k: v for k, v in weights.items()
                           if k.endswith(STAT_SUFFIXES)}
    return tree


def latest_checkpoint(ckpt_dir: str) -> str | None:
    """The ``ckpt_e{N}`` directory with the largest N under ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_e = None, -1
    for name in os.listdir(ckpt_dir):
        m = re.fullmatch(r"ckpt_e(\d+)", name)
        if m and int(m.group(1)) > best_e:
            best, best_e = os.path.join(ckpt_dir, name), int(m.group(1))
    return best
