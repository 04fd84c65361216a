"""Planar-flow U-Net with a banded correlation cost volume.

Counterpart of ``planar_optical_flow_tpu/models/flow_unet.py``: a shared
1-D conv encoder over both scans of a pair (three stride-2 blocks, 450 ->
225 -> 113 -> 57 beams), a correlation layer that matches 3-point feature
patches between the scans within a +-``max_displacement`` band, and a
skip-connected decoder regressing per-point 2-D flow. The public shapes are
channels-last ``(B, P, C)`` as in JAX; every block runs in its input's
dtype on its f32 parameters, as the DROW modules do.

The correlation is one batched product of the patches, ``(B, P, P)``, and
a gather of the clamped band: what XLA lowers the JAX ``einsum`` and
``take_along_axis`` to. It has no Pallas kernel in JAX, so none here.

The modules are named after the flax ones (``encoder_0..2``,
``decoder_0..1``, ``flow_reg`` or ``flow_reg_linear``, ``conv1..4``), so
``interop.variables_to_state_dict`` carries flax weights across. flax
infers the input widths; here they are written out.
"""

from __future__ import annotations

import torch
from torch import nn

from planar_optical_flow_tpu_torch.models.blocks import (
    ConvBlock,
    linear,
    make_linear,
    upsample_nearest,
)

FLOW_SLOPE = 0.01  # the U-Net's LeakyReLU slope (JAX ``negative_slope``)


def _patch_features(feat: torch.Tensor, kernel_size: int = 3) -> torch.Tensor:
    """Each point's +-half-kernel neighbourhood, edges clamped:
    ``(B, P, C) -> (B, P, K*C)``."""
    b, p, c = feat.shape
    hk = kernel_size // 2
    ids = torch.clamp(torch.arange(p, device=feat.device)[:, None]
                      + torch.arange(-hk, hk + 1, device=feat.device)[None],
                      0, p - 1)  # (P, K)
    return feat[:, ids, :].reshape(b, p, kernel_size * c)


def correlation_cost_volume(feat1: torch.Tensor, feat2: torch.Tensor,
                            max_displacement: int = 5,
                            kernel_size: int = 3) -> torch.Tensor:
    """Banded patch correlation: ``(B, P, C) x2 -> (B, P, 2*d+1)``; entry
    ``[b, p, j]`` is patch ``p`` of scan 1 against patch ``clamp(p + j -
    d)`` of scan 2."""
    b, p, _ = feat1.shape
    corr = torch.bmm(_patch_features(feat1, kernel_size),
                     _patch_features(feat2, kernel_size).transpose(1, 2))
    band = torch.clamp(
        torch.arange(p, device=feat1.device)[:, None]
        + torch.arange(-max_displacement, max_displacement + 1,
                       device=feat1.device)[None], 0, p - 1)  # (P, 2d+1)
    return torch.gather(corr, 2, band.expand(b, p, -1))


class FlowUNet(nn.Module):
    """Encoder/correlation/decoder flow net over ``(B, P, in_channels)``
    scan pairs -> per-point flow ``(B, P, 2)``. The head is a pointwise
    conv block, or with ``linear_head`` a bare dense layer."""

    def __init__(self, in_channels: int = 2, max_displacement: int = 5,
                 linear_head: bool = False, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.max_displacement = max_displacement
        self.linear_head = linear_head
        kw = dict(generator=generator, negative_slope=FLOW_SLOPE)
        self.encoder_0 = ConvBlock(in_channels, 64, 3, 2, **kw)
        self.encoder_1 = ConvBlock(64, 128, 3, 2, **kw)
        self.encoder_2 = ConvBlock(128, 256, 3, 2, **kw)
        self.decoder_1 = ConvBlock(128 + 2 * max_displacement + 1, 128, 3, 1,
                                   **kw)
        self.decoder_0 = ConvBlock(64 + 128, 128, 3, 1, **kw)
        if linear_head:
            # flax's nn.Dense default: lecun-normal kernel, zero bias
            self.flow_reg_linear = make_linear(in_channels + 128, 2,
                                               generator, kaiming=False)
        else:
            self.flow_reg = ConvBlock(in_channels + 128, 2, 1, 1, **kw)

    def encode(self, scan1: torch.Tensor, scan2: torch.Tensor,
               train: bool = False):
        """The shared encoder and the correlation -> the decoder's inputs
        ``(cost, f1_1, f1_0, scan1)``."""
        f1_0 = self.encoder_0(scan1, train)  # (B, 225, 64)
        f2_0 = self.encoder_0(scan2, train)
        f1_1 = self.encoder_1(f1_0, train)  # (B, 113, 128)
        f2_1 = self.encoder_1(f2_0, train)
        f1_2 = self.encoder_2(f1_1, train)  # (B, 57, 256)
        f2_2 = self.encoder_2(f2_1, train)
        cost = correlation_cost_volume(f1_2, f2_2, self.max_displacement)
        return cost, f1_1, f1_0, scan1

    def decode(self, cost, f1_1, f1_0, scan1, train: bool = False):
        """The skip-connected decoder and the flow head."""
        up1 = torch.cat([f1_1, upsample_nearest(cost, f1_1.shape[1])], -1)
        up1 = self.decoder_1(up1, train)
        up0 = torch.cat([f1_0, upsample_nearest(up1, f1_0.shape[1])], -1)
        up0 = self.decoder_0(up0, train)
        out = torch.cat([scan1, upsample_nearest(up0, scan1.shape[1])], -1)
        if self.linear_head:
            return linear(out, self.flow_reg_linear)
        return self.flow_reg(out, train)

    def forward(self, scan1: torch.Tensor, scan2: torch.Tensor,
                train: bool = False, rng=None) -> torch.Tensor:
        """``rng`` is accepted for the tasks' common call (no dropout)."""
        return self.decode(*self.encode(scan1, scan2, train), train=train)


class FlowUNetAdditive(nn.Module):
    """The additive-fusion variant: a shared 2-conv encoder, the two
    scans' features concatenated, a conv decoder and a pointwise flow
    head."""

    def __init__(self, in_channels: int = 2, *,
                 generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        kw = dict(generator=generator, negative_slope=FLOW_SLOPE)
        self.conv1 = ConvBlock(in_channels, 32, 3, 1, **kw)
        self.conv2 = ConvBlock(32, 64, 3, 1, **kw)
        self.conv3 = ConvBlock(128, 64, 3, 1, **kw)
        self.conv4 = ConvBlock(64, 32, 3, 1, **kw)
        self.flow_reg = ConvBlock(32, 2, 1, 1, **kw)

    def forward(self, scan1: torch.Tensor, scan2: torch.Tensor,
                train: bool = False, rng=None) -> torch.Tensor:
        f1 = self.conv2(self.conv1(scan1, train), train)
        f2 = self.conv2(self.conv1(scan2, train), train)
        f = self.conv4(self.conv3(torch.cat([f1, f2], -1), train), train)
        return self.flow_reg(f, train)
