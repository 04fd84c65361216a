"""Frozen-detector FlowDROW forward on the serving kernels, for training.

Counterpart of ``planar_optical_flow_tpu/train/fused_frozen.py``. FlowDROW
trains only its flow head; no gradient flows through the frozen DR-SPAAM
detector, so its forward may run the inference kernels of the bf16 serving
step: K1 cutout (``ops/kernels/cutout_kernel.cutout``), K2 backbone with
layer 1 and the gate embed inside (``conv_stack.backbone_bf16``), K3 gate
in bf16 (``infer/fast_gate.gate``) through scans 1..S-1, and K4 head
(``conv_stack.head``). On CPU tensors each wrapper runs its plain version.

BatchNorm is folded here as JAX folds it inside the traced step
(:func:`fold_detector`): from the parameters and statistics cast to the
step's compute dtype (bf16 under ``compute_dtype: bfloat16``), then in f32
with ``rsqrt`` in f32. The serving fold (``ops/kernels/fold.py``) takes the
root in float64 instead; the two agree to JAX's bf16 bar, not to the bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from planar_optical_flow_tpu_torch.infer.fast_gate import gate
from planar_optical_flow_tpu_torch.models.spatial_drow import (
    FEAT_CHANNELS,
    SpatialDrow,
)
from planar_optical_flow_tpu_torch.ops.kernels.conv_stack import (
    backbone_bf16,
    head,
)
from planar_optical_flow_tpu_torch.ops.kernels.cutout_kernel import cutout
from planar_optical_flow_tpu_torch.ops.kernels.fold import GateParams

BN_EPS = 1e-5


class FoldedDetector(NamedTuple):
    layer1: tuple      # (w (3, 1, 64) f32, b (64,) f32)
    backbone: list     # [(w (3*Cin, Cout) bf16, b (Cout,) f32)] x 5
    head_convs: list   # [(w (3*Cin, Cout) bf16, b (Cout,) f32)] x 5
    head_dense: tuple  # (wc (128, nc) bf16, bc f32, wr (128, 2) bf16, br f32)
    gate: GateParams   # bf16 w (D, 128) and b (128,)


def _cast(t: torch.Tensor, dtype) -> torch.Tensor:
    """``t`` as the step hands it to the model (cast to ``dtype``), in f32."""
    return t.detach().to(dtype).float()


def _bn_scale(bn, dtype):
    return _cast(bn.weight, dtype) * torch.rsqrt(
        _cast(bn.running_var, dtype) + BN_EPS)


def _fold_conv_bn(block, dtype):
    """-> (w (K, Cin, Cout) f32, b (Cout,) f32) of a ConvBlock with its
    BatchNorm folded in."""
    scale = _bn_scale(block.bn, dtype)
    w = _cast(block.conv.weight, dtype).permute(2, 1, 0) * scale
    b = ((_cast(block.conv.bias, dtype) - _cast(block.bn.running_mean, dtype))
         * scale + _cast(block.bn.bias, dtype))
    return w, b


def _tapstack(blocks):
    """[(w (3, Cin, Cout), b)] -> [(wcat (3*Cin, Cout) bf16, b f32)]."""
    return [(w.reshape(-1, w.shape[-1]).to(torch.bfloat16).contiguous(),
             b.contiguous()) for w, b in blocks]


@torch.no_grad()
def fold_detector(det: SpatialDrow, alpha: float, window_size: int,
                  dtype=torch.float32) -> FoldedDetector:
    """The folded weights of a frozen SpatialDrow, from its parameters and
    statistics cast to ``dtype``, with the gate's ``alpha`` and
    ``window_size``."""
    bb = [_fold_conv_bn(blk, dtype)
          for stack in (det.backbone.block1, det.backbone.block2)
          for blk in stack.blocks]
    hd = [_fold_conv_bn(blk, dtype)
          for stack in (det.head.block3, det.head.block4)
          for blk in stack.blocks]
    h = det.head
    dense = (_cast(h.cls.weight, dtype).t().to(torch.bfloat16).contiguous(),
             _cast(h.cls.bias, dtype),
             _cast(h.reg.weight, dtype).t().to(torch.bfloat16).contiguous(),
             _cast(h.reg.bias, dtype))
    g = det.gate
    scale = _bn_scale(g.embed_bn, dtype)
    gp = GateParams(
        w=(_cast(g.embed.weight, dtype).t() * scale).to(
            torch.bfloat16).contiguous(),
        b=((_cast(g.embed.bias, dtype) - _cast(g.embed_bn.running_mean, dtype))
           * scale + _cast(g.embed_bn.bias, dtype)).to(torch.bfloat16),
        alpha=float(alpha), window_size=int(window_size))
    return FoldedDetector(bb[0], _tapstack(bb[1:]), _tapstack(hd), dense, gp)


@torch.no_grad()
def frozen_detector_forward(det, scans, *, alpha: float, window_size: int,
                            num_pts: int, ct_len: int, window_width: float,
                            window_depth: float, padding_val: float = 29.99,
                            centered: bool = True, area_mode: bool = True,
                            dtype=torch.float32, with_head: bool = True):
    """Inference forward of the frozen detector over a scan stack on K1 ->
    K2 -> K3 (S-1 times) -> K4.

    ``det``: the SpatialDrow, or its :func:`fold_detector`; ``alpha`` and
    ``window_size`` its gate's (they must match the model's); ``scans (B,
    S, P)`` f32, scan S-1 current. Returns (pred_cls ``(B, P, C)``, pred_reg
    ``(B, P, 2)``, sim_band ``(B, P, window)`` f32), none recording
    gradients. Beams are padded to a multiple of 8 (rows ``>= num_pts``
    masked), as in JAX. ``with_head=False`` skips K4 and returns None for
    cls and reg: JAX's jitted train step reads only the band and drops its
    head kernel as dead code, so the train step launches no K4.
    """
    folded = det if isinstance(det, FoldedDetector) else fold_detector(
        det, alpha, window_size, dtype)
    gp = folded.gate
    b, s_scans, p = scans.shape
    p_pad = -(-num_pts // 8) * 8
    l4 = ct_len // 4
    d_feat = l4 * FEAT_CHANNELS

    flat = F.pad(scans.float().reshape(b * s_scans, p), (0, p_pad - num_pts))
    cut = cutout(flat, num_cutout_pts=ct_len, window_width=window_width,
                 window_depth=window_depth, padding_val=padding_val,
                 centered=centered, area_mode=area_mode, p_valid=num_pts)
    feats, zx = backbone_bf16(cut, folded.layer1, folded.backbone,
                              (gp.w, gp.b), l=ct_len)
    feats = feats.reshape(b, s_scans, p_pad * d_feat)
    zx = zx.reshape(b, s_scans, p_pad * 128)

    def rows(t, i, width):
        return t[:, i].reshape(b * p_pad, width)

    # the template from scan 0, the gate through scans 1..S-1
    gate_kw = dict(ct=p_pad, ct_valid=num_pts, alpha=gp.alpha,
                   window_size=gp.window_size)
    template, z, sim = rows(feats, 0, d_feat), rows(zx, 0, 128), None
    for i in range(1, s_scans):
        template, z, sim = gate(rows(zx, i, 128), z, rows(feats, i, d_feat),
                                template, **gate_kw)
    if sim is None:  # a single scan: self-attention bootstrap
        _, _, sim = gate(z, z, template, template, **gate_kw)

    sim_band = sim.reshape(b, p_pad, -1)[:, :num_pts].float()
    if not with_head:
        return None, None, sim_band
    wc = folded.head_dense[0]
    cls, reg = head(template.reshape(b * p_pad * l4, FEAT_CHANNELS),
                    folded.head_convs, folded.head_dense,
                    num_classes=wc.shape[-1], l4=l4)
    return (cls.reshape(b, p_pad, -1)[:, :num_pts],
            reg.reshape(b, p_pad, 2)[:, :num_pts], sim_band)
