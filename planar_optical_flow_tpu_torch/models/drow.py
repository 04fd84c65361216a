"""DROW backbone, head and the single-scan-fusion detector.

Counterpart of ``planar_optical_flow_tpu/models/drow.py``: a conv backbone
over each cutout (blocks 1-2) and the post-fusion conv stack with average
pooling feeding per-cutout classification logits and a 2-D center vote
(blocks 3-4 + cls/reg); :class:`Drow` (type ``"drow"``) sums the backbone's
features over the scan axis before the head. Channels-last at the public
functions. ``train`` selects BatchNorm on batch statistics and dropout
(drawn from ``rng``) as in flax.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from planar_optical_flow_tpu_torch.models.blocks import (
    ConvStack,
    child_seed,
    dropout,
    generator_from,
    linear,
    make_linear,
    mean_over,
    remat,
)


class DrowBackbone(nn.Module):
    """Per-cutout feature extractor: ``(N, n_pts, 1) -> (N, n_pts//4, 256)``."""

    def __init__(self, dropout: float = 0.0, *, generator: torch.Generator):
        super().__init__()
        self.dropout = dropout
        self.block1 = ConvStack(1, (64, 64, 128), generator=generator)
        self.block2 = ConvStack(128, (128, 128, 256), generator=generator)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None) -> torch.Tensor:
        y = self.block1.forward_ncl(x.transpose(1, 2), train)
        y = dropout(F.max_pool1d(y, 2), self.dropout, train, rng)
        y = self.block2.forward_ncl(y, train)
        y = dropout(F.max_pool1d(y, 2), self.dropout, train, rng)
        return y.transpose(1, 2)


def encode_cutouts(backbone: DrowBackbone, x: torch.Tensor, train: bool,
                   rng: torch.Generator | None, use_remat: bool):
    """``backbone(x)``, rematerialized in the backward when ``use_remat``
    and the forward records gradients (flax ``nn.remat``): the dropout
    masks then come from a generator seeded from ``rng`` once, so the
    recompute draws the same ones."""
    if not (use_remat and train and torch.is_grad_enabled()):
        return backbone(x, train, rng)
    seed = child_seed(rng if backbone.dropout > 0 else None)
    return remat(lambda t: backbone(t, train, generator_from(seed, t.device)),
                 x)


class DrowHead(nn.Module):
    """``(N, n_pts//4, 256)`` features -> (cls ``(N, num_classes)``,
    reg ``(N, 2)``)."""

    def __init__(self, num_classes: int = 4, dropout: float = 0.0, *,
                 generator: torch.Generator):
        super().__init__()
        self.dropout = dropout
        self.block3 = ConvStack(256, (256, 256, 512), generator=generator)
        self.block4 = ConvStack(512, (256, 128), generator=generator)
        self.cls = make_linear(128, num_classes, generator, kaiming=False)
        self.reg = make_linear(128, 2, generator, kaiming=False)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None):
        y = self.block3.forward_ncl(x.transpose(1, 2), train)
        y = dropout(F.max_pool1d(y, 2), self.dropout, train, rng)
        y = self.block4.forward_ncl(y, train)
        y = mean_over(y, -1)  # (N, 128)
        return linear(y, self.cls), linear(y, self.reg)


class Drow(nn.Module):
    """Full DROW: backbone per (cutout, scan), sum over the scans, head.

    ``(B, n_cutout, n_scan, n_pts)`` cutouts -> (cls ``(B, n_cutout, C)``,
    reg ``(B, n_cutout, 2)``); ``pedestrian_only`` selects one logit."""

    def __init__(self, dropout: float = 0.0, pedestrian_only: bool = False,
                 remat: bool = False,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.remat = remat
        self.backbone = DrowBackbone(dropout, generator=generator)
        self.head = DrowHead(1 if pedestrian_only else 4, dropout,
                             generator=generator)

    def encode_cutouts(self, x: torch.Tensor, train: bool = False,
                       rng: torch.Generator | None = None) -> torch.Tensor:
        """``(B, ct, S, pts)`` -> ``(B, ct, S, L, C)``."""
        b, ct, s, p = x.shape
        f = encode_cutouts(self.backbone, x.reshape(b * ct * s, p, 1), train,
                           rng, self.remat)
        return f.reshape(b, ct, s, f.shape[-2], f.shape[-1])

    def fused_head(self, fused: torch.Tensor, train: bool = False,
                   rng: torch.Generator | None = None):
        """``(B, ct, L, C)`` -> per-cutout (cls, reg)."""
        b, ct = fused.shape[:2]
        cls, reg = self.head(fused.reshape(b * ct, *fused.shape[2:]), train,
                             rng)
        return cls.reshape(b, ct, -1), reg.reshape(b, ct, 2)

    def forward(self, x: torch.Tensor, train: bool = False,
                rng: torch.Generator | None = None):
        feats = self.encode_cutouts(x, train, rng)
        return self.fused_head(feats.sum(dim=2), train, rng)
