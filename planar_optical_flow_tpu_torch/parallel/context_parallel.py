"""Context-parallel banded spatial attention: the gate with its cutout axis
sharded over a group.

Counterpart of ``planar_optical_flow_tpu/parallel/context_parallel.py``.
The gate is the serving cell's only cross-cutout operation, and its banded
attention couples a cutout to its +-window/2 neighbours only, so a shard of
the cutout axis needs just ``hw`` edge rows of each ring neighbour's
carried embedding and template: one exchange with both neighbours
(``batch_isend_irecv``), no gather. The per-shard math is
``infer/fast_gate.py``'s band form:

* halo rows that wrap around the ring are zeroed by the band mask of
  global validity (their attention weight is exactly zero),
* the reference's edge-clamped ``sim_band`` duplicates involve only the
  global first and last cutouts, which live on the shards that need them.

At 450 cutouts one device is faster; this is the mechanism for merged
scans of many more beams.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from planar_optical_flow_tpu_torch.infer.fast_gate import (
    _LEAKY_SLOPE,
    GateParams,
    embed,
)
from planar_optical_flow_tpu_torch.models.blocks import rounded


def gate_step_context_parallel(params: GateParams, x, template, z_t, mesh,
                               axis: str = "data"):
    """One gate update with the cutout axis sharded over ``mesh``'s
    ``axis``.

    ``x``, ``template`` ``(B, ct, D)`` and ``z_t`` ``(B, ct, Z)`` (the
    carried pre-activation embedding) are the whole tensors, as JAX's
    arrays are; rank ``k`` of the axis computes cutouts ``k * m`` to ``(k +
    1) * m - 1`` (``m = ct / n``). Returns this rank's blocks of
    (new_template, new_z, sim_band), each ``(B, m, .)``. Requires ``ct %
    n == 0`` and ``m >= hw``."""
    n = mesh.axis_size(axis)
    ct = x.shape[1]
    hw = params.window_size // 2
    if ct % n:
        raise ValueError(f"ct={ct} not divisible by mesh axis size {n}")
    m = ct // n
    if m < hw:
        raise ValueError(
            f"shard size {m} smaller than half-window {hw}: halo exchange "
            "needs each neighbor to hold the full ±hw band")
    if n > 1 and not mesh.multi_process:
        raise ValueError("gate_step_context_parallel across devices runs "
                         "one process a device (torch.distributed)")
    k = mesh.axis_index(axis)
    rows = slice(k * m, (k + 1) * m)
    ring = None
    if n > 1:
        idx = [mesh.coords[a] for a in mesh.axis_names]
        pos = mesh.axis_names.index(axis)

        def rank_at(j):
            idx[pos] = j % n
            return int(mesh.devices[tuple(idx)])

        ring = (rank_at(k - 1), rank_at(k + 1), mesh.group(axis))
    return _gate_local(x[:, rows], template[:, rows], z_t[:, rows],
                       params=params, n=n, ct=ct, base=k * m, ring=ring)


def _halo_extend(a, hw: int, ring):
    """``(B, m, F)`` -> ``(B, m + 2 hw, F)``: row ``j`` is global row ``base
    - hw + j``; the rows past the ring's ends wrap (the caller masks
    them)."""
    if ring is None:
        pad = torch.zeros_like(a[:, :hw])
        return torch.cat([pad, a, pad], dim=1)
    left_rank, right_rank, group = ring
    left = torch.empty_like(a[:, :hw]).contiguous()
    right = torch.empty_like(left)
    ops = [dist.P2POp(dist.isend, a[:, -hw:].contiguous(), right_rank,
                      group, tag=1),
           dist.P2POp(dist.isend, a[:, :hw].contiguous(), left_rank, group,
                      tag=2),
           dist.P2POp(dist.irecv, left, left_rank, group, tag=1),
           dist.P2POp(dist.irecv, right, right_rank, group, tag=2)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return torch.cat([left, a, right], dim=1)


def _gate_local(x_l, t_l, zt_l, *, params: GateParams, n: int, ct: int,
                base: int, ring):
    """The gate on one shard's ``(B, m, .)`` blocks."""
    hw = params.window_size // 2
    win = 2 * hw + 1
    m = x_l.shape[1]
    dt = x_l.dtype
    slope = rounded(_LEAKY_SLOPE, dt)

    zx = embed(params, x_l)                               # (B, m, Z)
    ex = torch.where(zx > 0, zx, slope * zx)
    zt_ext = _halo_extend(zt_l, hw, ring)                 # (B, m+2hw, Z)
    et_ext = torch.where(zt_ext > 0, zt_ext, slope * zt_ext)
    t_ext = _halo_extend(t_l, hw, ring)                   # (B, m+2hw, D)

    # slot k holds offset o = k - hw
    s = torch.stack([(ex * et_ext[:, j:j + m]).sum(-1) for j in range(win)],
                    dim=-1)                               # (B, m, win)
    gi = base + torch.arange(m, device=x_l.device)[:, None]
    off = torch.arange(-hw, hw + 1, device=x_l.device)[None, :]
    valid = (gi + off >= 0) & (gi + off < ct)             # (m, win)
    masked = torch.where(valid, s, rounded(-1e10, s.dtype))
    e = torch.exp(masked - masked.amax(-1, keepdim=True))
    attn = e / e.sum(-1, keepdim=True)
    attn = torch.where(valid, attn, 0.0)
    attn = attn / torch.clamp(attn.sum(-1, keepdim=True),
                              min=rounded(1e-20, s.dtype))

    # the reference's clamped band: out-of-range slots repeat the
    # similarity with the global first (last) cutout
    c0 = (ex * et_ext[:, hw:hw + 1]).sum(-1, keepdim=True)
    c1 = (ex * et_ext[:, hw + m - 1:hw + m]).sum(-1, keepdim=True)
    sim_band = torch.where(valid, s, torch.where(gi + off < 0, c0, c1))

    def banded_mix(ext):
        out = None
        for j in range(win):
            term = attn[..., j:j + 1] * ext[:, j:j + m]
            out = term if out is None else out + term
        return out

    a = rounded(params.alpha, dt)
    b = rounded(1.0 - a, dt)
    new_template = a * x_l + b * banded_mix(t_ext)
    new_z = a * zx + b * banded_mix(zt_ext)
    return new_template, new_z, sim_band
