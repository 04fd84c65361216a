"""Shared building blocks, eval-mode inference.

Counterpart of ``planar_optical_flow_tpu/models/blocks.py``. The public
functions are channels-last ``(B, L, C)`` as in JAX; the conv stacks
transpose to PyTorch's ``(B, C, L)`` once inside and back at the end.

Initialization mirrors the JAX modules: Kaiming-normal for leaky-ReLU
(``a=0.1``) conv kernels and the gate embedding, lecun-normal for the
cls/reg heads, zero biases, unit-gamma/zero-beta batch
norms with running stats 0 and 1. Every random draw takes an explicit
``torch.Generator``; parameters are created uninitialized
(``torch.nn.utils.skip_init``) so construction draws nothing from PyTorch's
global generator.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

NEGATIVE_SLOPE = 0.1
BN_EPS = 1e-5


def kaiming_leaky_(weight: torch.Tensor, fan_in: int,
                   generator: torch.Generator) -> torch.Tensor:
    """``std = sqrt(2 / (1 + 0.1^2)) / sqrt(fan_in)`` normal init."""
    std = math.sqrt(2.0 / (1.0 + NEGATIVE_SLOPE ** 2)) / math.sqrt(fan_in)
    with torch.no_grad():
        return weight.normal_(0.0, std, generator=generator)


def make_linear(in_features: int, out_features: int,
                generator: torch.Generator, kaiming: bool = True) -> nn.Linear:
    """Dense layer: Kaiming-leaky init (the gate embed) or, with
    ``kaiming=False``, flax's default lecun-normal (the cls/reg heads)."""
    lin = nn.utils.skip_init(nn.Linear, in_features, out_features)
    with torch.no_grad():
        if kaiming:
            kaiming_leaky_(lin.weight, in_features, generator)
        else:
            lin.weight.normal_(0.0, in_features ** -0.5, generator=generator)
        lin.bias.zero_()
    return lin


def make_batch_norm(features: int) -> nn.BatchNorm1d:
    bn = nn.utils.skip_init(nn.BatchNorm1d, features, eps=BN_EPS)
    bn.reset_parameters()  # deterministic: ones/zeros, stats 0/1
    return bn


def rounded(value: float, dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float: the value a
    Python scalar takes in JAX when it meets an array of that dtype. (A
    product of two bf16 values is exact in the f32 that PyTorch computes it
    in, so multiplying by this float rounds as JAX's bf16 product does.)
    A host value: no device tensor, no synchronisation."""
    return float(torch.tensor(value, dtype=dtype))


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    """LeakyReLU 0.1 as JAX computes it: ``where(x >= 0, x, slope * x)``
    with the slope rounded to ``x``'s dtype first; ``F.leaky_relu``
    multiplies by the f32 slope, which rounds a bf16 result differently on
    about a fifth of the negatives."""
    return torch.where(x >= 0, x, x * rounded(NEGATIVE_SLOPE, x.dtype))


def linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """flax ``Dense`` in ``x``'s dtype: the product, rounded, then the
    bias (bf16 rounds twice, as flax does)."""
    return (F.linear(x, lin.weight.to(x.dtype))
            + lin.bias.to(x.dtype))


def batch_norm_eval(x: torch.Tensor, bn: nn.BatchNorm1d,
                    channel_dim: int) -> torch.Tensor:
    """Eval-mode BatchNorm in the order flax computes it: ``(x - mean) *
    (rsqrt(var + eps) * scale) + bias``. The statistics term runs in the
    parameters' dtype and the rest in the promoted one, as flax does; f32
    parameters stand for parameters cast to ``x``'s dtype (the port's f32
    model serving bf16 inputs)."""
    shape = [1] * x.ndim
    shape[channel_dim] = -1
    dt = (x.dtype if bn.running_var.dtype == torch.float32
          else bn.running_var.dtype)
    mean = bn.running_mean.to(dt).view(shape)
    mul = torch.rsqrt(bn.running_var.to(dt) + bn.eps) * bn.weight.to(dt)
    return (x - mean) * mul.view(shape) + bn.bias.to(dt).view(shape)


class ConvBlock(nn.Module):
    """Conv1d (torch-style padding ``((k-1)//2, k//2)``) + BatchNorm (eps
    1e-5) + LeakyReLU 0.1. Runs in the input's dtype (weights are cast),
    as flax does on variables cast by ``cast_variables``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, *, generator: torch.Generator):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.conv = nn.utils.skip_init(nn.Conv1d, in_features, features,
                                       kernel_size, stride=stride)
        kaiming_leaky_(self.conv.weight, in_features * kernel_size,
                       generator)
        with torch.no_grad():
            self.conv.bias.zero_()
        self.bn = make_batch_norm(features)

    def forward_ncl(self, x: torch.Tensor) -> torch.Tensor:
        k = self.kernel_size
        if k > 1:
            x = F.pad(x, ((k - 1) // 2, k // 2))
        # the bias after the rounded product, as flax's Conv adds it
        y = (F.conv1d(x, self.conv.weight.to(x.dtype), stride=self.stride)
             + self.conv.bias.to(x.dtype)[:, None])
        return leaky_relu(batch_norm_eval(y, self.bn, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """``(B, L, Cin)`` -> ``(B, L', Cout)``."""
        return self.forward_ncl(x.transpose(1, 2)).transpose(1, 2)


class ConvStack(nn.Module):
    """A sequence of same-kernel ConvBlocks (flax ``ConvStack``)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 kernel_size: int = 3, *, generator: torch.Generator):
        super().__init__()
        chans = [in_features, *features]
        self.blocks = nn.ModuleList(
            ConvBlock(chans[i], chans[i + 1], kernel_size,
                      generator=generator)
            for i in range(len(features)))

    def forward_ncl(self, x: torch.Tensor) -> torch.Tensor:
        for block in self.blocks:
            x = block.forward_ncl(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.forward_ncl(x.transpose(1, 2)).transpose(1, 2)


def max_pool1d(x: torch.Tensor, window: int = 2) -> torch.Tensor:
    """Non-overlapping max pool over the length axis of ``(B, L, C)``
    (VALID: a ragged tail is dropped, as flax's ``max_pool``)."""
    b, l, c = x.shape
    lw = l // window
    return x[:, :lw * window].reshape(b, lw, window, c).amax(dim=2)


def mean_over(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.mean`` as XLA computes it: the f32 sum times the f32
    reciprocal of the count, in ``x``'s dtype."""
    recip = rounded(1.0 / rounded(x.shape[dim], torch.float32),
                    torch.float32)
    return (x.float().sum(dim=dim) * recip).to(x.dtype)


def avg_pool_full(x: torch.Tensor) -> torch.Tensor:
    """Average over the entire length axis: ``(B, L, C) -> (B, C)``."""
    return mean_over(x, -2)
