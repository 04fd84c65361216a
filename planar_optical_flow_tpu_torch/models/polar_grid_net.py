"""Detector over fully-connected per-beam encodings (fc1d / fc1d_fea /
fc2d).

Counterpart of ``planar_optical_flow_tpu/models/polar_grid_net.py``. Every
encoding is a ``(B, S, R, P)`` stack: S scans x R per-beam features x P
beams (``R`` = 1 for ``fc1d``'s raw ranges, the cutout points for
``fc1d_fea``'s transposed cutouts, the range bins for ``fc2d``'s polar
grid). Each beam's ``S*R`` column is embedded by one dense layer, then
BatchNorm, LeakyReLU 0.1 and dropout; two k=3 conv blocks along the beams
give local context; per-beam ``cls`` and ``reg`` dense heads. flax infers
the embedding's width from the first input; the port builds it with
``in_features = S*R`` (``models.registry.fc_in_features_of``).

No kernel of the port runs here: the JAX module reaches no
``pallas_call``. The layers are cuBLAS and cuDNN calls and plain torch,
through ``models/blocks.py``, so that the bf16 and BatchNorm rounding rules
of the other modules hold here too.
"""

from __future__ import annotations

import torch
from torch import nn

from planar_optical_flow_tpu_torch.models.blocks import (
    ConvBlock,
    batch_norm,
    dropout,
    leaky_relu,
    linear,
    make_batch_norm,
    make_linear,
)


class PolarGridDetector(nn.Module):
    """fc-family detector: ``(B, S, R, P)`` -> per-beam (cls ``(B, P,
    num_classes)``, reg ``(B, P, 2)``)."""

    def __init__(self, in_features: int, num_classes: int = 4,
                 hidden: int = 256, dropout: float = 0.0,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.in_features = in_features
        self.dropout = dropout
        self.embed = make_linear(in_features, hidden, generator)
        self.embed_bn = make_batch_norm(hidden)
        self.ctx1 = ConvBlock(hidden, hidden, 3, generator=generator)
        self.ctx2 = ConvBlock(hidden, hidden // 2, 3, generator=generator)
        self.cls = make_linear(hidden // 2, num_classes, generator,
                               kaiming=False)
        self.reg = make_linear(hidden // 2, 2, generator, kaiming=False)

    def forward(self, grid: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None):
        b, s, r, p = grid.shape
        if s * r != self.in_features:
            raise ValueError(
                f"PolarGridDetector was built for {self.in_features} "
                f"features a beam, got S*R = {s}*{r}")
        # (B, P, S*R): one embedding product per beam column
        x = grid.permute(0, 3, 1, 2).reshape(b, p, s * r)
        x = leaky_relu(batch_norm(linear(x, self.embed), self.embed_bn, 2,
                                  train))
        x = dropout(x, self.dropout, train, rng)
        # local beam context (k=3 convs along P)
        x = self.ctx2(self.ctx1(x, train), train)
        return linear(x, self.cls), linear(x, self.reg)
