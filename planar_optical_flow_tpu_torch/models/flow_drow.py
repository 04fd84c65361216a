"""Joint detection + per-point flow from a DR-SPAAM detector.

Counterpart of ``planar_optical_flow_tpu/models/flow_drow.py``. The flow head
takes ``window + 1`` input channels (the similarity band plus the current
range), as the JAX head does.

With ``freeze_detector`` (the default) :meth:`FlowDrow.forward` runs the
detector in eval mode without recording gradients and returns its outputs
detached (JAX: ``train=False`` and ``stop_gradient``): no gradient reaches
the detector's parameters, and its running statistics do not move. The
flow head trains.
"""

from __future__ import annotations

import torch
from torch import nn

from planar_optical_flow_tpu_torch.models.blocks import ConvBlock
from planar_optical_flow_tpu_torch.models.spatial_drow import SpatialDrow


class FlowDrow(nn.Module):
    def __init__(self, alpha: float = 0.5, window_size: int = 7,
                 pedestrian_only: bool = False, num_cutout_pts: int = 48,
                 dropout: float = 0.0, freeze_detector: bool = True,
                 remat: bool = False, banded_chunk: int = 0,
                 *, generator: torch.Generator | None = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.alpha = alpha
        self.window_size = window_size
        self.freeze_detector = freeze_detector
        self.dr_spaam = SpatialDrow(alpha, window_size, pedestrian_only,
                                    num_cutout_pts, dropout, remat,
                                    banded_chunk, generator=generator)
        self.flow_conv1 = ConvBlock(window_size + 1, 128, 3,
                                    generator=generator)
        self.flow_conv2 = ConvBlock(128, 64, 3, generator=generator)
        self.flow_conv3 = ConvBlock(64, 32, 3, generator=generator)
        # a pointwise conv *block* (conv + BN + LeakyReLU), as the reference
        self.flow_out = ConvBlock(32, 2, 1, generator=generator)

    def flow_head(self, sim_band: torch.Tensor, cur_scan: torch.Tensor,
                  train: bool = False) -> torch.Tensor:
        """``sim_band (B, ct, window)``, ``cur_scan (B, ct)`` -> canonical
        flow ``(B, ct, 2)``, in the inputs' dtype."""
        feat = torch.cat([sim_band, cur_scan[..., None]], dim=-1)
        y = feat.transpose(1, 2)
        for block in (self.flow_conv1, self.flow_conv2, self.flow_conv3,
                      self.flow_out):
            y = block.forward_ncl(y, train)
        return y.transpose(1, 2)

    def forward(self, x: torch.Tensor, cur_scan: torch.Tensor,
                train: bool = False, rng: torch.Generator | None = None):
        """``x (B, ct, S, pts)`` cutouts, ``cur_scan (B, ct)`` current
        ranges -> (cls, reg, flow)."""
        if self.freeze_detector:
            with torch.no_grad():
                pred_cls, pred_reg, sim_band = self.dr_spaam(x, False)
        else:
            pred_cls, pred_reg, sim_band = self.dr_spaam(x, train, rng)
        return pred_cls, pred_reg, self.flow_head(sim_band, cur_scan, train)

    def stream_step(self, x: torch.Tensor, cur_scan: torch.Tensor,
                    template: torch.Tensor | None = None):
        """Returns (cls, reg, flow, new_template)."""
        pred_cls, pred_reg, new_template, sim_band = self.dr_spaam.stream_step(
            x, template)
        return pred_cls, pred_reg, self.flow_head(sim_band, cur_scan), \
            new_template
