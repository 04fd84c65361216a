"""Carry flax weights across: JAX ``{"params", "batch_stats"}`` -> torch
``state_dict`` of the port's modules.

The port names its modules after the flax ones, so the mapping is
mechanical:

* ``ConvBlock_i`` -> ``blocks.i``, ``Conv_0`` -> ``conv``, ``Dense_0`` ->
  ``dense`` (a ``DenseBlock``'s), ``BatchNorm_0`` -> ``bn``; every other
  module name (``dr_spaam``, ``backbone``, ``block1..4``, ``gate``,
  ``embed``, ``embed_bn``, ``head``, ``cls``, ``reg``, ``flow_conv1..3``,
  ``flow_out``; the flow U-Net's ``encoder_0..2``, ``decoder_0..1``,
  ``flow_reg``, ``flow_reg_linear``, ``conv1..4``; the box regressor's
  ``backbone``, ``fc1..3`` and the ``DenseBlock_i`` of its ``PointNet``,
  and of ``TNet``; the fc detector's ``embed``, ``embed_bn``, ``ctx1``,
  ``ctx2``, ``cls``, ``reg``) is kept;
* conv ``kernel (K, Cin, Cout)`` -> ``weight (Cout, Cin, K)``; dense
  ``kernel (in, out)`` -> ``weight (out, in)`` (a bare flax ``Dense``, such
  as ``flow_reg_linear``, maps to an ``nn.Linear`` of that name);
  ``bias`` -> ``bias``;
* BatchNorm ``scale``/``bias``/``mean``/``var`` -> ``weight``/``bias``/
  ``running_mean``/``running_var``.

Works for any port module given the matching flax sub-tree (a whole
``FlowDrow``, ``PolarGridDetector`` or ``BoundingBoxRegressor``, or e.g.
one ``ConvBlock``).
Raises on a missing or unused key and on a shape mismatch. Load with
``model.load_state_dict(variables_to_state_dict(variables_np, model))``.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch import nn

_RENAME = {"Conv_0": "conv", "Dense_0": "dense", "BatchNorm_0": "bn"}
_LEAF = {("params", "kernel"): "weight", ("params", "scale"): "weight",
         ("params", "bias"): "bias", ("batch_stats", "mean"): "running_mean",
         ("batch_stats", "var"): "running_var"}


def _torch_name(flax_name: str) -> str:
    m = re.fullmatch(r"ConvBlock_(\d+)", flax_name)
    if m:
        return f"blocks.{m.group(1)}"
    return _RENAME.get(flax_name, flax_name)


def _flatten(tree, collection, prefix=()):
    for name, sub in tree.items():
        path = prefix + (name,)
        if isinstance(sub, dict) or hasattr(sub, "items"):
            yield from _flatten(sub, collection, path)
        else:
            yield collection, path, np.asarray(sub)


def variables_to_state_dict(variables_np, model: nn.Module) -> dict:
    """flax variables (numpy leaves) -> ``state_dict`` for ``model``.

    ``num_batches_tracked`` buffers (no flax counterpart, unused in eval)
    are filled with zeros.
    """
    target = model.state_dict()
    out = {}
    for collection in ("params", "batch_stats"):
        for coll, path, arr in _flatten(variables_np.get(collection, {}),
                                        collection):
            leaf = _LEAF.get((coll, path[-1]))
            if leaf is None:
                raise KeyError(f"unknown flax leaf {coll}/{'/'.join(path)}")
            key = ".".join([_torch_name(p) for p in path[:-1]] + [leaf])
            if key not in target:
                raise KeyError(
                    f"flax leaf {coll}/{'/'.join(path)} maps to {key!r}, "
                    f"which {type(model).__name__} does not have")
            if path[-1] == "kernel":
                arr = (arr.transpose(2, 1, 0) if arr.ndim == 3 else arr.T)
            t = torch.from_numpy(np.array(arr, dtype=np.float32))  # a copy
            if tuple(t.shape) != tuple(target[key].shape):
                raise ValueError(f"{key}: flax shape {tuple(t.shape)} vs "
                                 f"port shape {tuple(target[key].shape)}")
            out[key] = t
    for key, val in target.items():
        if key.endswith("num_batches_tracked") and key not in out:
            out[key] = torch.zeros_like(val)
    missing = sorted(set(target) - set(out))
    if missing:
        raise KeyError(f"flax variables lack {missing}")
    return out

