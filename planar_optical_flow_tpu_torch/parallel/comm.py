"""Collectives with their gradients, and the data-parallel context.

JAX's partitioner inserts these from the sharded data flow; the port calls
them itself. Under a mesh every rank backpropagates its own share of the
loss (the global loss over the global batch, whose numerator each rank
holds a part of), so the parameter gradients are summed over the data
ranks exactly once, by the trainer. That fixes each collective's backward:

* :func:`reduce_sum` (Megatron's ``g``): all-reduce in the forward, the
  identity in the backward. For values that every rank then uses whole
  and alike: the loss's numerator and count, a row-parallel layer's
  partial outputs.
* :func:`copy_to` (Megatron's ``f``): the identity in the forward,
  all-reduce in the backward. For the replicated input of a
  column-parallel layer, whose gradient each rank holds a part of.
* :func:`gather` : all-gather in the forward, the rank's own slice in the
  backward (the gathered tensor is used alike on every rank).
* :func:`moments_sum`: all-reduce in both directions. For BatchNorm's
  sums: each rank's rows reach the loss through the global statistics.

:func:`data_parallel` marks a step whose batch is split over a data group:
inside it train-mode BatchNorm normalizes over the global batch and the
losses take their means over it (``models/blocks.py``, ``ops/losses.py``).
"""

from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist

_CTX = threading.local()


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    dist.all_reduce(out, group=group)
    return out


class _AllReduce(torch.autograd.Function):
    """All-reduce sum in the forward (``fwd``) and of the gradient in the
    backward (``bwd``); the identity where either is False."""

    @staticmethod
    def forward(ctx, x, group, fwd, bwd):
        ctx.group, ctx.bwd = group, bwd
        return _all_reduce(x, group) if fwd else x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = _all_reduce(g, ctx.group) if ctx.bwd else g
        return g, None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.n = dist.get_world_size(group)
        ctx.dim, ctx.index = dim, dist.get_rank(group)
        x = x.detach().contiguous()
        parts = [torch.empty_like(x) for _ in range(ctx.n)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return (g.chunk(ctx.n, dim=ctx.dim)[ctx.index].contiguous(), None,
                None)


def reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum; the gradient passes unchanged."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group, True, False)


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    """The identity; the gradient is all-reduced."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group, False, True)


def moments_sum(x: torch.Tensor, group) -> torch.Tensor:
    """All-reduce sum, and its gradient all-reduced."""
    if group_size(group) == 1:
        return x
    return _AllReduce.apply(x, group, True, True)


def gather(x: torch.Tensor, group, dim: int = -1) -> torch.Tensor:
    """All-gather along ``dim`` in group-rank order; the gradient is the
    rank's own slice."""
    if group_size(group) == 1:
        return x
    return _Gather.apply(x, group, dim % x.ndim)


def all_reduce_(tensors, group) -> None:
    """Sum ``tensors`` in place over ``group``, as one flat buffer for each
    dtype (one collective, not one for each tensor), the dtypes in the
    same order on every rank."""
    tensors = [t for t in tensors if t is not None]
    if not tensors or group is None:
        return
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        same = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.reshape(-1) for t in same])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in same:
            t.copy_(flat[off:off + t.numel()].view_as(t))
            off += t.numel()


@contextlib.contextmanager
def data_parallel(group):
    """Inside the block the step's batch is split over ``group``: BatchNorm
    in train mode and the losses' means run over the global batch. A group
    of one rank (or None) changes nothing."""
    prev = getattr(_CTX, "group", None)
    _CTX.group = group if group_size(group) > 1 else None
    try:
        yield
    finally:
        _CTX.group = prev


def data_group():
    """The data group of the enclosing :func:`data_parallel` block, or
    None."""
    return getattr(_CTX, "group", None)
