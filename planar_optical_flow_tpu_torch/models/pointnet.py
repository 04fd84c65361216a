"""PointNet box regressor for lidar segments, in eval and in train mode.

Counterpart of ``planar_optical_flow_tpu/models/pointnet.py``: a per-point
MLP (1x1 convolutions are Dense layers on ``(B, N, C)``), a channelwise
max over the points to a global feature, and an FC head that regresses
``[l, w, ori]`` (2D) or ``[cz, l, w, h, ori]`` (3D). Built on the port's
:class:`DenseBlock` (BatchNorm over every axis but the features, as flax's)
with flax's submodule names (``backbone``, ``fc1``-``fc3``, ``DenseBlock_i``
inside), so the flax bridge carries JAX weights across by name.

The max over the points is ``amax``: like ``jnp.max`` it splits the
gradient in equal parts between tied maxima, which the repeated points of
a resampled segment make the rule (``max(dim).values`` would send all of
it to one of them).
"""

from __future__ import annotations

import torch
from torch import nn

from planar_optical_flow_tpu_torch.models.blocks import DenseBlock, dropout


def _dense_stack(module: nn.Module, in_features: int, widths,
                 generator: torch.Generator, start: int = 0) -> int:
    """Add ``DenseBlock_{start + i}`` of each width to ``module``; returns
    the last width."""
    for i, f in enumerate(widths):
        setattr(module, f"DenseBlock_{start + i}",
                DenseBlock(in_features, f, generator=generator))
        in_features = f
    return in_features


class PointNet(nn.Module):
    """Per-point MLP + global max: ``(B, N, C_in) -> (B, 1024)``."""

    WIDTHS = (64, 64, 128, 1024)

    def __init__(self, input_dim: int = 4, *, generator: torch.Generator):
        super().__init__()
        _dense_stack(self, input_dim, self.WIDTHS, generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(len(self.WIDTHS)):
            x = getattr(self, f"DenseBlock_{i}")(x, train)
        return x.amax(dim=-2)


class TNet(nn.Module):
    """Input-transform net predicting a ``(C, C)`` matrix per sample (kept
    for parity with the JAX package, which does not wire it into the
    regressor either)."""

    def __init__(self, input_dim: int = 3,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.input_dim = input_dim
        width = _dense_stack(self, input_dim, (64, 128, 1024), generator)
        width = _dense_stack(self, width, (512, 256), generator, start=3)
        self.DenseBlock_5 = DenseBlock(width, input_dim ** 2, use_bn=False,
                                       use_act=False, generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        for i in range(3):
            x = getattr(self, f"DenseBlock_{i}")(x, train)
        x = x.amax(dim=-2)
        for i in range(3, 6):
            x = getattr(self, f"DenseBlock_{i}")(x, train)
        return x.reshape(-1, self.input_dim, self.input_dim)


class BoundingBoxRegressor(nn.Module):
    """PointNet backbone + a 3-layer FC head.

    ``input_dim``: 2 or 3 point coordinates, +1 with the input-angle
    channel. ``target_dim``: 3 for 2D boxes ``[l, w, ori]``, 5 for 3D
    ``[cz, l, w, h, ori]``. ``dropout`` after ``fc2`` in train mode, its
    mask drawn from the ``rng`` generator."""

    def __init__(self, input_dim: int = 4, target_dim: int = 5,
                 dropout: float = 0.3,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.input_dim, self.target_dim = input_dim, target_dim
        self.dropout = dropout
        self.backbone = PointNet(input_dim, generator=generator)
        self.fc1 = DenseBlock(PointNet.WIDTHS[-1], 512, generator=generator)
        self.fc2 = DenseBlock(512, 256, generator=generator)
        self.fc3 = DenseBlock(256, target_dim, use_bn=False, use_act=False,
                              generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        x = self.backbone(x, train)
        x = self.fc2(self.fc1(x, train), train)
        x = dropout(x, self.dropout, train, rng)
        return self.fc3(x, train)
