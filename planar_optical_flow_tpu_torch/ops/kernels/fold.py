"""BatchNorm folding and the stacked weights the serving kernels read.

Counterparts: ``ops/pallas/fused_drow.py`` ``fold_conv_bn`` /
``_block_params``, ``ops/pallas/conv_stack.py`` ``prepare_stack_weights`` /
``backbone_stack_weights`` / ``head_stack_weights`` and
``infer/fast_gate.py`` ``GateParams`` / ``fold_gate_params`` of the JAX
package. Folding reads the port's own modules.

Layout the conv kernels take (``csrc/conv_stack.cu``): per conv layer a
tap-major ``(3*Cin, Cout)`` bf16 weight (rows ``[0:Cin]`` = left tap, the
JAX ``wcat``) and an f32 ``(Cout,)`` bias. The JAX kernels keep f32 weights
and cast them to bf16 at the MXU; storing the bf16 cast once is the same
operand.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from planar_optical_flow_tpu_torch.models.blocks import ConvBlock, ConvStack
from planar_optical_flow_tpu_torch.models.drow import DrowBackbone, DrowHead
from planar_optical_flow_tpu_torch.models.spatial_drow import (
    SpatialAttentionGate,
)


def _bn_scale(bn):
    """``gamma / sqrt(var + eps)`` in f32 with a correctly rounded square
    root, as numpy folds in the JAX package (PyTorch's CPU ``sqrt`` can be
    one ulp off, which moves an int8 weight scale by one ulp)."""
    var = bn.running_var.float() + bn.eps
    return bn.weight.float() / torch.sqrt(var.double()).float()


@torch.no_grad()
def fold_conv_bn(block: ConvBlock):
    """Eval-mode BatchNorm folded into the conv: ``(w (K, Cin, Cout) f32,
    b (Cout,) f32)``, ``w = kernel * scale``, ``b = (bias - mean) * scale
    + beta`` with ``scale = gamma / sqrt(var + eps)``."""
    scale = _bn_scale(block.bn)
    w = block.conv.weight.float().permute(2, 1, 0) * scale
    b = ((block.conv.bias.float() - block.bn.running_mean.float()) * scale
         + block.bn.bias.float())
    return w.contiguous(), b.contiguous()


def block_params(stack: ConvStack) -> list:
    """Folded ``(w, b)`` per ConvBlock of a stack."""
    return [fold_conv_bn(block) for block in stack.blocks]


def prepare_stack_weights(folded) -> list:
    """Folded ``(w (3, Cin, Cout), b)`` list -> ``[(wcat (3*Cin, Cout) bf16,
    b (Cout,) f32), ...]`` with the taps stacked on the contraction axis."""
    out = []
    for w, b in folded:
        k, cin, cout = w.shape
        out.append((w.reshape(k * cin, cout).to(torch.bfloat16).contiguous(),
                    b.float().contiguous()))
    return out


def backbone_blocks(backbone: DrowBackbone) -> list:
    """Folded f32 ``(w, b)`` of the six backbone convs (layer 1 first)."""
    return block_params(backbone.block1) + block_params(backbone.block2)


def backbone_stack_weights(backbone: DrowBackbone):
    """-> (layer-1 ``(w (3, 1, 64) f32, b (64,) f32)``, stacked weights of
    layers 2..6)."""
    folded = backbone_blocks(backbone)
    return folded[0], prepare_stack_weights(folded[1:])


def head_conv_blocks(head: DrowHead) -> list:
    """Folded f32 ``(w, b)`` of the five head convs."""
    return block_params(head.block3) + block_params(head.block4)


@torch.no_grad()
def head_linear_weights(head: DrowHead):
    """``(wc (128, nc) bf16, bc (nc,) f32, wr (128, 2) bf16, br (2,) f32)``:
    the cls/reg linears as every head kernel reads them."""
    return tuple(t.contiguous() for t in (
        head.cls.weight.t().to(torch.bfloat16), head.cls.bias.float(),
        head.reg.weight.t().to(torch.bfloat16), head.reg.bias.float()))


def head_stack_weights(head: DrowHead):
    """-> (stacked weights of the five head convs,
    :func:`head_linear_weights`)."""
    return (prepare_stack_weights(head_conv_blocks(head)),
            head_linear_weights(head))


class GateParams(NamedTuple):
    w: torch.Tensor  # (D, 128) folded Dense + BN weight
    b: torch.Tensor  # (128,) folded bias
    alpha: float
    window_size: int


@torch.no_grad()
def fold_gate_params(gate: SpatialAttentionGate,
                     dtype=torch.float32) -> GateParams:
    """The gate's embed Dense + eval BatchNorm as one affine map."""
    scale = _bn_scale(gate.embed_bn)
    w = gate.embed.weight.float().t() * scale
    b = ((gate.embed.bias.float() - gate.embed_bn.running_mean.float())
         * scale + gate.embed_bn.bias.float())
    return GateParams(w=w.to(dtype).contiguous(), b=b.to(dtype).contiguous(),
                      alpha=float(gate.alpha),
                      window_size=int(gate.window_size))
