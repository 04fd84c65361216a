"""Weights from the seed: one f32 state dict, made on the device.

Both sides get the same tensors: the port's model loads them, the plain
reference reads them by key. The draws are two large calls (one normal,
one uniform) on a ``torch.Generator`` of the device, split by leaf:

* conv and linear weights: normal with the Kaiming-leaky std of their fan-in
  (``sqrt(2 / (1 + 0.1^2) / fan_in)``), as the models initialise them;
* biases: normal, std 0.05;
* BatchNorm scale ``U(0.8, 1.2)``, shift normal std 0.1, running mean normal
  std 0.1, running variance ``U(0.5, 1.5)``: statistics that move every
  channel, so no normalisation is the identity.

The harness then sets the running statistics to the data's own
(``reference.model.fit_batch_norm``), as training leaves them.
"""

from __future__ import annotations

import math

import torch

SLOPE = 0.1


def _kind(key: str) -> str:
    leaf = key.rsplit(".", 1)[-1]
    parent = key.rsplit(".", 2)[-2] if key.count(".") >= 1 else ""
    if leaf == "num_batches_tracked":
        return "count"
    if leaf in ("running_mean", "running_var"):
        return leaf
    if parent.endswith("bn"):
        return "bn_" + leaf
    return leaf  # "weight" or "bias" of a conv or linear


def make_state_dict(template: dict, seed: int, device) -> dict:
    """A state dict with the keys, shapes and dtypes of ``template`` (a
    model's ``state_dict()``), drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (2 ** 63))
    floats = [(k, v) for k, v in template.items() if v.is_floating_point()]
    total = sum(v.numel() for _, v in floats)
    normal = torch.randn(total, generator=gen, device=device)
    uniform = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for key, like in template.items():
        if not like.is_floating_point():
            out[key] = torch.zeros_like(like, device=device)
            continue
        n = like.numel()
        z = normal[at:at + n].view(like.shape)
        u = uniform[at:at + n].view(like.shape)
        at += n
        kind = _kind(key)
        if kind == "weight":
            fan_in = like[0].numel()
            t = z * (math.sqrt(2.0 / (1.0 + SLOPE ** 2)) / math.sqrt(fan_in))
        elif kind == "bias":
            t = z * 0.05
        elif kind == "bn_weight":
            t = 0.8 + 0.4 * u
        elif kind in ("bn_bias", "running_mean"):
            t = z * 0.1
        elif kind == "running_var":
            t = 0.5 + u
        else:
            raise ValueError(f"no draw for state-dict key {key!r}")
        out[key] = t.to(like.dtype).contiguous()
    return out
