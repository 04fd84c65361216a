"""DROW backbone and head, eval mode.

Counterpart of ``planar_optical_flow_tpu/models/drow.py``: a conv backbone
over each cutout (blocks 1-2) and the post-fusion conv stack with average
pooling feeding per-cutout classification logits and a 2-D center vote
(blocks 3-4 + cls/reg). Channels-last at the public functions.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from planar_optical_flow_tpu_torch.models.blocks import (
    ConvStack,
    linear,
    make_linear,
    mean_over,
)


class DrowBackbone(nn.Module):
    """Per-cutout feature extractor: ``(N, n_pts, 1) -> (N, n_pts//4, 256)``."""

    def __init__(self, *, generator: torch.Generator):
        super().__init__()
        self.block1 = ConvStack(1, (64, 64, 128), generator=generator)
        self.block2 = ConvStack(128, (128, 128, 256), generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.block1.forward_ncl(x.transpose(1, 2))
        y = F.max_pool1d(y, 2)
        y = self.block2.forward_ncl(y)
        y = F.max_pool1d(y, 2)
        return y.transpose(1, 2)


class DrowHead(nn.Module):
    """``(N, n_pts//4, 256)`` features -> (cls ``(N, num_classes)``,
    reg ``(N, 2)``)."""

    def __init__(self, num_classes: int = 4, *, generator: torch.Generator):
        super().__init__()
        self.block3 = ConvStack(256, (256, 256, 512), generator=generator)
        self.block4 = ConvStack(512, (256, 128), generator=generator)
        self.cls = make_linear(128, num_classes, generator, kaiming=False)
        self.reg = make_linear(128, 2, generator, kaiming=False)

    def forward(self, x: torch.Tensor):
        y = self.block3.forward_ncl(x.transpose(1, 2))
        y = F.max_pool1d(y, 2)
        y = self.block4.forward_ncl(y)
        y = mean_over(y, -1)  # (N, 128)
        return linear(y, self.cls), linear(y, self.reg)
