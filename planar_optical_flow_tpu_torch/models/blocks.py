"""Shared building blocks, in eval and in train mode.

Counterpart of ``planar_optical_flow_tpu/models/blocks.py``. The public
functions are channels-last ``(B, L, C)`` as in JAX; the conv stacks
transpose to PyTorch's ``(B, C, L)`` once inside and back at the end.

Every forward takes ``train`` (default False) where flax takes it: in train
mode BatchNorm normalises on the batch's statistics and advances its
running statistics as flax 0.12.3's ``nn.BatchNorm(momentum=0.9)`` does
(:func:`batch_norm_train`), and dropout draws its mask from the
``torch.Generator`` passed as ``rng`` (:func:`dropout`). Running statistics
are replaced by attribute assignment, so the trainer can hand them in cast
to its compute dtype and read the updated ones back, as flax's mutable
``batch_stats`` collection is. :func:`remat` is ``nn.remat``.

Initialization mirrors the JAX modules: Kaiming-normal for leaky-ReLU
(``a=0.1``) conv kernels and the gate embedding, lecun-normal for the
cls/reg heads, zero biases, unit-gamma/zero-beta batch
norms with running stats 0 and 1. Every random draw takes an explicit
``torch.Generator``; parameters are created uninitialized
(``torch.nn.utils.skip_init``) so construction draws nothing from PyTorch's
global generator.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

NEGATIVE_SLOPE = 0.1
BN_EPS = 1e-5
BN_MOMENTUM = 0.9  # flax's convention: ra = 0.9 * ra + 0.1 * batch stat


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


def leaky_relu(x: torch.Tensor,
               negative_slope: float = NEGATIVE_SLOPE) -> torch.Tensor:
    """LeakyReLU (slope 0.1 by default) as JAX computes it: ``where(x >= 0,
    x, slope * x)`` with the slope rounded to ``x``'s dtype first;
    ``F.leaky_relu`` multiplies by the f32 slope, which rounds a bf16
    result differently on about a fifth of the negatives."""
    return torch.where(x >= 0, x, x * rounded(negative_slope, x.dtype))


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


_STATS = threading.local()


@contextlib.contextmanager
def frozen_running_stats():
    """Inside the block, train-mode BatchNorm normalises on the batch's
    statistics but leaves the running statistics as they are: what a
    rematerialized forward (:func:`remat`'s recompute) must do."""
    prev = getattr(_STATS, "frozen", False)
    _STATS.frozen = True
    try:
        yield
    finally:
        _STATS.frozen = prev


def batch_moments(x: torch.Tensor, dims) -> tuple:
    """flax 0.12.3's ``_compute_stats``: ``x`` promoted to f32, mean and
    biased variance over ``dims`` by the fast formula ``E[x^2] - E[x]^2``
    clipped at 0; a mean is the f32 sum times the f32 reciprocal of the
    count, as XLA computes ``jnp.mean``."""
    xf = x.float()
    count = math.prod(x.shape[d] for d in dims)
    recip = rounded(1.0 / rounded(count, torch.float32), torch.float32)
    mean = xf.sum(dim=dims) * recip
    mean2 = (xf * xf).sum(dim=dims) * recip
    return mean, torch.clamp(mean2 - mean * mean, min=0.0)


def running_update(ra: torch.Tensor, stat: torch.Tensor) -> torch.Tensor:
    """flax's ``momentum * ra + (1 - momentum) * stat``: the first product
    in the running value's own dtype (bf16 where the trainer hands in cast
    statistics: 0.9 rounded to bf16, the product rounded), the second and
    the sum in f32, so the result is f32. ``torch.nn.BatchNorm1d`` instead
    takes the unbiased variance and its momentum the other way round."""
    first = ra * rounded(BN_MOMENTUM, ra.dtype)
    return first.float() + stat * rounded(1.0 - BN_MOMENTUM, torch.float32)


def batch_norm_train(x: torch.Tensor, bn: nn.BatchNorm1d,
                     channel_dim: int) -> torch.Tensor:
    """Train-mode BatchNorm as flax 0.12.3 computes it: the batch's f32
    statistics (:func:`batch_moments`), ``(x - mean) * (rsqrt(var + eps) *
    scale) + bias`` in f32 with ``scale`` and ``bias`` in ``x``'s dtype,
    rounded once to ``x``'s dtype. The running statistics advance by
    :func:`running_update` (gradients do not reach them) unless
    :func:`frozen_running_stats` is active."""
    dims = tuple(d for d in range(x.ndim) if d != channel_dim)
    mean, var = batch_moments(x, dims)
    if not getattr(_STATS, "frozen", False):
        bn.running_mean = running_update(bn.running_mean, mean.detach())
        bn.running_var = running_update(bn.running_var, var.detach())
    shape = [1] * x.ndim
    shape[channel_dim] = -1
    mul = torch.rsqrt(var + bn.eps) * bn.weight.to(x.dtype).float()
    y = ((x.float() - mean.view(shape)) * mul.view(shape)
         + bn.bias.to(x.dtype).float().view(shape))
    return y.to(x.dtype)


def batch_norm(x: torch.Tensor, bn: nn.BatchNorm1d, channel_dim: int,
               train: bool = False) -> torch.Tensor:
    """:func:`batch_norm_train` in train mode, else
    :func:`batch_norm_eval`."""
    if train:
        return batch_norm_train(x, bn, channel_dim)
    return batch_norm_eval(x, bn, channel_dim)


def dropout(x: torch.Tensor, rate: float, train: bool,
            rng: torch.Generator | None) -> torch.Tensor:
    """flax ``nn.Dropout(rate, deterministic=not train)``: each element kept
    with probability ``1 - rate`` and divided by it (in ``x``'s dtype), the
    mask drawn from ``rng``. flax's masks come from its own RNG, so only
    the statistics agree."""
    if not train or rate <= 0.0:
        return x
    if rng is None:
        raise ValueError("dropout in train mode needs an rng generator")
    keep = 1.0 - rate
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / rounded(keep, x.dtype),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def child_seed(rng: torch.Generator | None) -> int | None:
    """A seed drawn from ``rng`` (None for None): a rematerialized block
    makes its own generator from it, so that its recompute draws the same
    dropout masks."""
    if rng is None:
        return None
    return int(torch.randint(0, 2 ** 62, (1,), generator=rng,
                             device=rng.device).item())


def generator_from(seed: int | None, device) -> torch.Generator | None:
    if seed is None:
        return None
    return torch.Generator(device=device).manual_seed(seed)


def remat(fn, *args):
    """``fn(*args)`` through ``torch.utils.checkpoint`` (flax ``nn.remat``):
    its activations are recomputed in the backward instead of kept. The
    recompute runs under :func:`frozen_running_stats`, so the running
    statistics advance once. ``fn`` must draw any randomness from a
    generator it makes itself (:func:`generator_from`)."""
    ran = []

    def run(*a):
        if ran:
            with frozen_running_stats():
                return fn(*a)
        ran.append(True)
        return fn(*a)

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


class ConvBlock(nn.Module):
    """Conv1d (torch-style padding ``((k-1)//2, k//2)``) + BatchNorm (eps
    1e-5) + LeakyReLU (``negative_slope``, 0.1 by default). Runs in the
    input's dtype (weights are cast), as flax does on variables cast by
    ``cast_variables``."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, *, generator: torch.Generator,
                 negative_slope: float = NEGATIVE_SLOPE):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.negative_slope = negative_slope
        self.conv = nn.utils.skip_init(nn.Conv1d, in_features, features,
                                       kernel_size, stride=stride)
        kaiming_leaky_(self.conv.weight, in_features * kernel_size,
                       generator)
        with torch.no_grad():
            self.conv.bias.zero_()
        self.bn = make_batch_norm(features)

    def forward_ncl(self, x: torch.Tensor, train: bool = False
                    ) -> torch.Tensor:
        k = self.kernel_size
        if k > 1:
            x = F.pad(x, ((k - 1) // 2, k // 2))
        # the bias after the rounded product, as flax's Conv adds it
        y = (F.conv1d(x, self.conv.weight.to(x.dtype), stride=self.stride)
             + self.conv.bias.to(x.dtype)[:, None])
        return leaky_relu(batch_norm(y, self.bn, 1, train),
                          self.negative_slope)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        """``(B, L, Cin)`` -> ``(B, L', Cout)``."""
        return self.forward_ncl(x.transpose(1, 2), train).transpose(1, 2)


class DenseBlock(nn.Module):
    """Linear + optional BatchNorm + optional LeakyReLU 0.1 (flax
    ``DenseBlock``) on ``(..., in_features)``."""

    def __init__(self, in_features: int, features: int, use_bn: bool = True,
                 use_act: bool = True, *, generator: torch.Generator):
        super().__init__()
        self.use_bn, self.use_act = use_bn, use_act
        self.dense = make_linear(in_features, features, generator)
        self.bn = make_batch_norm(features) if use_bn else None

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = linear(x, self.dense)
        if self.use_bn:
            y = batch_norm(y, self.bn, y.ndim - 1, train)
        return leaky_relu(y) if self.use_act else y


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

    def forward_ncl(self, x: torch.Tensor, train: bool = False
                    ) -> torch.Tensor:
        for block in self.blocks:
            x = block.forward_ncl(x, train)
        return x

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.forward_ncl(x.transpose(1, 2), train).transpose(1, 2)


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


def upsample_nearest(x: torch.Tensor, new_len: int) -> torch.Tensor:
    """Nearest-neighbour resize along the length axis of ``(B, L, C)``
    (``F.interpolate(mode='nearest')``'s indices)."""
    idx = (torch.arange(new_len, device=x.device) * x.shape[1]) // new_len
    return x[:, idx, :]
