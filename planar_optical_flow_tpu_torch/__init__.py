"""PyTorch/CUDA port of ``planar_optical_flow_tpu``.

The JAX package is the reference; this package computes the same functions
with PyTorch around hand-written CUDA kernels for Hopper (``csrc/``). Its
layout mirrors the JAX package (``ops/``, ``models/``, ``data/``,
``train/``, ``eval/``, ``infer/``, ``interop/``, ``cli/``) so each
counterpart is found by name.

Entry points take a ``device`` argument that defaults to ``"cuda"``; without
a card they raise instead of falling back to the CPU. Pass ``device="cpu"``
to run the plain PyTorch versions of the kernels (what the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; raises if CUDA is asked for and
    ``torch.cuda.is_available()`` is false (no silent CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch versions")
    return dev


__all__ = ["resolve_device"]
